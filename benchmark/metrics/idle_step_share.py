"""Share of the traced window in which the card sat idle while the host
was dispatching a step: the idle gaps between device intervals that began
inside the program's ``train.step`` or ``train.call`` span or one of
their children (``step.sample``, ``step.render``, ``step.loss``,
``step.backward``, ``step.update``, ``graph.capture``), over the window,
in % (``benchmark.program_spans``)."""

from benchmark import program_spans


def read(run):
    return program_spans.idle_step_share(run)
