"""Host time the trainer loop spends making each step's batch
(``Trainer.next_batch`` / ``next_batches``: the pixel draw, the rays from
the cameras, the staging copy), ms a step, from the benchmark's own
host-clock span around those calls."""


def read(run):
    return run.host_ms_per_unit("host_batch")
