"""Share of the traced window in which no kernel, copy or set ran on the
card: 1 - (union of the device intervals) / window, in %."""


def read(run):
    return run.idle_share()
