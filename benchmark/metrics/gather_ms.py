"""Device time of the gather and index kernels (the grid queries and their
TV maps), ms a step or a view, by kernel name (``benchmark.trace.KINDS``)."""


def read(run):
    return run.kind_ms_per_unit("gather")
