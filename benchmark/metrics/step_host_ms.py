"""Host time the trainer loop spends dispatching each step, ms a step, from
the program's own ``train.step`` spans (an eager ``train_step``: sampler,
renderer, loss, the double backward, the optimizer's launches) and
``train.call`` spans (a ``train_steps`` call of k replays) over the steps
their ``steps`` counts add up to (``benchmark.program_spans``)."""

from benchmark import program_spans


def read(run):
    return program_spans.host_ms_per_step(run, program_spans.STEP_SPANS)
