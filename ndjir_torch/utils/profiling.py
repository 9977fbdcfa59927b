"""Profiling helpers: a ``torch.profiler`` trace and the program's own spans
(the port's counterpart of ``ndjir_tpu/utils/profiling.py``).

``trace()`` captures the host's operators and, when a CUDA device is
present, the device's kernels, and writes them as a Chrome trace
(``chrome://tracing``, Perfetto).

``annotate(name, **counts)`` marks a span of the program.  Outside a
``torch.profiler`` it returns one shared no-op context manager, and a
check of the profiler's flag is its whole cost.  Under a profiler,
whoever started it (``trace()``, or a profiler of the card's activity
alone), it opens ``record_function(name)``, so that the trace's timeline
shows the range, and appends a :class:`Span` to an
in-memory list, ``spans()``: its name, start and end on
``time.time_ns()`` (the clock of the profiler's events), its id, the id
of the span that encloses it on the same thread, the global step the
training loop had set when it opened (``set_step``), and the counts it
was given (a call of k steps carries ``steps=k``).  ``trace()`` clears
the list on entry; nothing is written but the Chrome trace.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from ndjir_torch.utils.monitor import logger

TRACE_FILE = "trace.json"


class Span(NamedTuple):
    """One span of ``spans()``; times in ns on ``time.time_ns()``."""
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]   # the enclosing span on the same thread
    step: Optional[int]        # the global step set when it opened
    counts: Dict[str, int]


_OFF = contextlib.nullcontext()
_SPANS: List[Span] = []
_IDS = itertools.count(1)
_OPEN = threading.local()      # .stack: ids of this thread's open spans
_STEP: List[Optional[int]] = [None]
_profiler_enabled = torch.autograd._profiler_enabled


def spans() -> List[Span]:
    """The spans recorded since the last ``trace()`` (or since import),
    in the order they ended."""
    return _SPANS


def set_step(step: int) -> None:
    """The global step that the spans opened from now on carry."""
    _STEP[0] = step


class _Span:
    __slots__ = ("name", "counts", "rf", "start", "id", "parent", "step")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name, self.counts = name, counts
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_IDS)
        self.step = _STEP[0]
        stack.append(self.id)
        self.rf.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.rf.__exit__(*exc)
        _OPEN.stack.pop()
        _SPANS.append(Span(self.name, self.start, end, self.id, self.parent,
                           self.step, self.counts))
        return False


def annotate(name: str, **counts: int):
    """A span named ``name`` carrying ``counts``, recorded while a
    profiler runs; otherwise the shared no-op context manager."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, counts)


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the enclosed computation and write its Chrome trace to
    ``<logdir>/trace.json`` (``logdir`` defaults to ``ndjir_torch_trace``
    in the temporary directory).  Clears ``spans()`` first.  Yields
    ``logdir``."""
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "ndjir_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _SPANS.clear()
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info(f"trace written to {path}")
