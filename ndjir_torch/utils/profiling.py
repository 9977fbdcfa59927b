"""Profiling helpers: a ``torch.profiler`` trace and a wall-time decorator
(the port's counterpart of ``ndjir_tpu/utils/profiling.py``).

The reference has only a wall-time decorator (reference: helper.py:127-134);
``trace()`` captures the host's operators and, when a CUDA device is
present, the device's kernels, and writes them as a Chrome trace
(``chrome://tracing``, Perfetto).  ``annotate(name)`` marks a region that
the trace shows under that name.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from functools import wraps

from ndjir_torch.utils.monitor import logger

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the enclosed computation and write its Chrome trace to
    ``<logdir>/trace.json`` (``logdir`` defaults to ``ndjir_torch_trace``
    in the temporary directory).  Yields ``logdir``."""
    import torch

    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "ndjir_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info(f"trace written to {path}")


def annotate(name: str):
    """Named region visible in the trace timeline."""
    import torch

    return torch.profiler.record_function(name)


def watch_etime(func):
    """Wall-time print decorator (reference: helper.py:127-134)."""
    @wraps(func)
    def wrapper(*args, **kwargs):
        st = time.perf_counter()
        ret = func(*args, **kwargs)
        logger.info(f"Elapsed time ({func.__name__}) = "
                    f"{time.perf_counter() - st:.3f} s")
        return ret
    return wrapper
