"""Device time of the elementwise, copy and cast kernels (the renderer,
the loss, the activations with the jiterator's softplus derivative, the
optimizer's passes), ms a step or a view, by kernel name
(``benchmark.trace.KINDS``)."""


def read(run):
    return run.kind_ms_per_unit("elementwise")
