"""The one seam of the port's native code (``ndjir_torch.kernels``), on the
CPU: every library of the registry has its file under ``BUILD_DIR``, named
by its source and flags, and a launch whose C function returns a nonzero
``cudaError`` raises, naming the kernel, the function and the code (a
stand-in library takes the card's place).  The file imports no JAX:
``python3 -m pytest tests/test_torch_kernels.py -q``.
"""

import contextlib
import os
import types

import pytest
import torch

from ndjir_torch import kernels

CUDA_KERNELS = sorted(kernels.LAUNCHES)


@pytest.mark.parametrize("name", sorted(kernels.LIBRARIES))
def test_library_path_is_named_by_its_source_and_flags(name, monkeypatch):
    lib = kernels.LIBRARIES[name]
    path = kernels.library_path(name)
    assert os.path.dirname(path) == kernels.BUILD_DIR
    assert os.path.basename(path).startswith(f"lib{name}-")
    assert os.path.exists(os.path.join(os.path.dirname(kernels.BUILD_DIR),
                                       lib.source))
    assert kernels.library_path(name) == path
    monkeypatch.setitem(kernels._FLAGS, lib.compiler,
                        [*kernels._FLAGS[lib.compiler], "-DNDJIR_FLAG"])
    assert kernels.library_path(name) != path


class _StandIn:
    """A loaded library whose every function records its arguments and
    returns ``code``."""

    def __init__(self, code):
        self.code, self.calls = code, []

    def __getattr__(self, symbol):
        def fn(*args):
            self.calls.append((symbol, args))
            return self.code
        return fn


@pytest.mark.parametrize("name", CUDA_KERNELS)
def test_launch_passes_the_stream_and_raises_on_a_cuda_error(name,
                                                            monkeypatch):
    stream = types.SimpleNamespace(cuda_stream=0x5EED)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: stream)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES,
                                                           0))
    device = torch.device("cuda", 0)
    symbols = list(kernels.LIBRARIES[name].functions)
    ok = _StandIn(0)
    monkeypatch.setitem(kernels._LIBS, name, ok)
    for symbol in symbols:
        kernels.launch(name, symbol, device, 1, 2)
    assert ok.calls == [(s, (1, 2, 0x5EED)) for s in symbols]
    assert not any(kernels.LAUNCHES.values())   # a launch is counted apart
    monkeypatch.setitem(kernels._LIBS, name, _StandIn(700))
    for symbol in symbols:
        with pytest.raises(RuntimeError,
                           match=f"{name}: {symbol} failed: cudaError 700"):
            kernels.launch(name, symbol, device, 1, 2)
        with pytest.raises(RuntimeError, match="cudaError 700"):
            kernels.call(name, symbol, 1)
    kernels.count(name, 3)
    assert kernels.LAUNCHES == dict(dict.fromkeys(kernels.LAUNCHES, 0),
                                    **{name: 3})

