"""Host time the trainer loop spends making each step's batch, ms a step,
from the program's own ``train.batch`` spans (inside
``Trainer.next_batch`` / ``next_batches``: the pixel draw, the rays from
the cameras, the staging copy) over the steps their ``steps`` counts add
up to (``benchmark.program_spans``)."""

from benchmark import program_spans


def read(run):
    return program_spans.host_ms_per_step(run, ("train.batch",))
