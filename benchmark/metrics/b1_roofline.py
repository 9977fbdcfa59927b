"""The scatter kernel B1's share of its roofline, in %
(``benchmark.trace.TraceRun.b1_roofline``): its launches' least time a
step, from their shapes at the published HBM rate, over B1's device time
a step (its radix sort, slab, plan, main and fix-up kernels)."""


def read(run):
    return run.b1_roofline()
