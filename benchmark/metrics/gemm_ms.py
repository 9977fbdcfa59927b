"""Device time of the GEMM kernels (the fields' affine layers, forward and
backward), ms a step or a view, by kernel name (``benchmark.trace.KINDS``)."""


def read(run):
    return run.kind_ms_per_unit("gemm")
