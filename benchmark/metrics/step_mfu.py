"""The window's matrix FLOPs (``counts.train_step_flops`` a step, or
``counts.render_ray_flops`` a pixel, from the configuration's widths) over
the traced window's wall time and the card's published peak for the MLP's
precision, in %."""


def read(run):
    return run.step_mfu()
