"""Full-state checkpoints (params + optimizer + schedule position), in the
JAX package's file format (counterpart of ``ndjir_tpu/train/checkpoint.py``).

A checkpoint is one msgpack file, ``ckpt_<step>.msgpack``, holding what
``flax.serialization.to_bytes`` writes for the JAX package's state
``{"params": params, "opt_state": OptState(adam=AdamState(count, mu, nu))}``,
byte for byte, plus a JSON manifest ``ckpt_<step>.json``; files are written
atomically (tmp + rename) and pruned to the newest ``keep``.  Each package
reads the other's files.

The card's machine has neither flax nor msgpack, so this module writes and
reads the subset of msgpack that flax uses: maps with str keys, strs, ints,
bools, and arrays as ext type 1 holding the msgpack of ``(shape, dtype
name, raw C-order bytes)`` (bf16 leaves as ``"bfloat16"``).  Keys are
written sorted, as a JAX dict tree orders them.  An array of more than
2^30 bytes is split into chunks the way flax splits it
(``__msgpack_chunked_array__``).

The port's optimizer state ``{"count": int32 tensor, "mu": tree, "nu": tree}``
(:func:`ndjir_torch.train.optim.init_optimizer`) is stored as
``{"adam": {"count": int32 scalar, "mu": ..., "nu": ...}}``, the layout flax
gives the JAX package's named tuples.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: arrays above it are stored in chunks
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY = 1

# ---------------------------------------------------------------------------
# msgpack, the subset flax writes (msgpack spec: github.com/msgpack/msgpack)
# ---------------------------------------------------------------------------

_INTS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
         0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# type byte -> (kind, struct format of its length)
_SIZED = {0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _int(n: int) -> bytes:
    """The shortest msgpack int, chosen as msgpack-python's packer does."""
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if n >= 0:
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if n <= top:
                return struct.pack("B", code) + struct.pack(fmt, n)
    for code, fmt, bottom in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                              (0xd2, ">i", -0x80000000),
                              (0xd3, ">q", -0x8000000000000000)):
        if n >= bottom:
            return struct.pack("B", code) + struct.pack(fmt, n)
    raise OverflowError(n)


def _header(n: int, small: Optional[Tuple[int, int]], sized) -> bytes:
    """A length header: ``small`` = (fix code, largest n) for the fix form,
    ``sized`` = (code, struct format, largest n) forms in order."""
    if small is not None and n <= small[1]:
        return struct.pack("B", small[0] | n)
    for code, fmt, top in sized:
        if n <= top:
            return struct.pack("B", code) + struct.pack(fmt, n)
    raise OverflowError(n)


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _header(len(b), (0xa0, 31), ((0xd9, ">B", 0xff),
                                        (0xda, ">H", 0xffff),
                                        (0xdb, ">I", 0xffffffff))) + b


def _map(n: int) -> bytes:
    return _header(n, (0x80, 15), ((0xde, ">H", 0xffff),
                                   (0xdf, ">I", 0xffffffff)))


def _array(n: int) -> bytes:
    return _header(n, (0x90, 15), ((0xdc, ">H", 0xffff),
                                   (0xdd, ">I", 0xffffffff)))


def _bin(n: int) -> bytes:
    return _header(n, None, ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff),
                             (0xc6, ">I", 0xffffffff)))


def _ext(n: int, code: int) -> bytes:
    fixed = {size: c for c, size in _FIXEXT.items()}
    if n in fixed:
        return struct.pack("BB", fixed[n], code)
    return _header(n, None, ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff),
                             (0xc9, ">I", 0xffffffff))) \
        + struct.pack("B", code)


class _Leaf:
    """An array to store: its shape, dtype name and raw C-order bytes."""

    def __init__(self, shape, dtype: str, raw: memoryview):
        self.shape, self.dtype, self.raw = tuple(int(n) for n in shape), \
            dtype, raw

    @staticmethod
    def of(t) -> "_Leaf":
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                a = t.view(torch.int16).numpy()
                return _Leaf(t.shape, "bfloat16", memoryview(a).cast("B"))
            t = t.numpy()
        a = np.require(t, requirements="C")  # keeps a 0-d array 0-d
        return _Leaf(a.shape, a.dtype.name,
                     memoryview(a.reshape(-1)).cast("B"))

    def chunked(self):
        """flax's ``_chunk``: {marker, shape, chunks} of 1-D pieces."""
        itemsize = len(self.raw) // max(1, int(np.prod(self.shape)))
        step = max(1, int(MAX_CHUNK_SIZE / itemsize)) * itemsize
        chunks = [_Leaf((len(self.raw[i:i + step]) // itemsize,), self.dtype,
                        self.raw[i:i + step])
                  for i in range(0, len(self.raw), step)]
        return {_CHUNKED: True,
                "shape": {str(i): n for i, n in enumerate(self.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _encode(node, out: List[bytes]) -> None:
    """Append the msgpack of ``node`` (dict / bool / int / _Leaf) to
    ``out`` as pieces; array bytes are appended as views, not copied."""
    if isinstance(node, dict):
        out.append(_map(len(node)))
        for k, v in node.items():
            out.append(_str(k))
            _encode(v, out)
    elif isinstance(node, bool):
        out.append(b"\xc3" if node else b"\xc2")
    elif isinstance(node, int):
        out.append(_int(node))
    elif isinstance(node, _Leaf):
        if len(node.raw) > MAX_CHUNK_SIZE:
            _encode(node.chunked(), out)
            return
        head = _array(3) + _array(len(node.shape)) \
            + b"".join(_int(n) for n in node.shape) + _str(node.dtype) \
            + _bin(len(node.raw))
        out += [_ext(len(head) + len(node.raw), _EXT_NDARRAY), head,
                node.raw]
    else:
        raise TypeError(f"cannot store {type(node)}")


class _Reader:
    """Decodes the msgpack subset above from a buffer; arrays come back as
    (shape, dtype name, memoryview of the raw bytes)."""

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated checkpoint")
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        c = self.unpack("B")
        if c < 0x80:                       # positive fixint
            return c
        if c >= 0xe0:                      # negative fixint
            return c - 0x100
        if c in _INTS:
            return self.unpack(_INTS[c])
        if c in (0xc2, 0xc3):
            return c == 0xc3
        if c < 0x90:
            kind, n = "map", c & 0x0f
        elif c < 0xa0:
            kind, n = "array", c & 0x0f
        elif c < 0xc0:
            kind, n = "str", c & 0x1f
        elif c in _FIXEXT:
            kind, n = "ext", _FIXEXT[c]
        elif c in _SIZED:
            kind, fmt = _SIZED[c]
            n = self.unpack(fmt)
        else:
            raise ValueError(f"msgpack type 0x{c:02x} is not read here")
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "bin":
            return self.take(n)
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        code = self.unpack("b")
        return self.ext(code, self.take(n))

    def map(self, n: int) -> Dict[str, Any]:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return _unchunk(out) if out.get(_CHUNKED) is True else out

    @staticmethod
    def ext(code: int, data: memoryview):
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is not read here")
        shape, dtype, raw = _Reader(data).value()
        return tuple(shape), dtype, raw


def _unchunk(d):
    """flax's ``_unchunk``: the chunks concatenated, as one array."""
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    raw = b"".join(bytes(c[2]) for c in chunks)
    return shape, chunks[0][1], memoryview(raw)


_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float64": torch.float64, "float16": torch.float16,
                 "int32": torch.int32, "int64": torch.int64}


def _tensor(arr) -> torch.Tensor:
    """A CPU tensor (a copy) of a decoded (shape, dtype, raw) array."""
    shape, dtype, raw = arr
    if dtype == "bfloat16":
        a = np.frombuffer(raw, np.int16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, np.dtype(dtype))
                            .reshape(shape).copy())


# ---------------------------------------------------------------------------
# the state tree
# ---------------------------------------------------------------------------

def _leaves(tree):
    """``tree`` with every tensor as a :class:`_Leaf` and keys sorted."""
    return {k: _leaves(tree[k]) if isinstance(tree[k], dict)
            else _Leaf.of(tree[k]) for k in sorted(tree)}


def _restore(template, stored, path=()):
    """Copy the stored arrays into the template's tensors (same shape and
    dtype required), in place; returns ``template``."""
    for k, t in template.items():
        if k not in stored:
            raise ValueError(f"checkpoint has no {'/'.join(path + (k,))}")
        if isinstance(t, dict):
            _restore(t, stored[k], path + (k,))
            continue
        v = _tensor(stored[k])
        if tuple(v.shape) != tuple(t.shape) or v.dtype != t.dtype:
            raise ValueError(f"{'/'.join(path + (k,))}: checkpoint holds "
                             f"{tuple(v.shape)} {v.dtype}, the model "
                             f"{tuple(t.shape)} {t.dtype}")
        with torch.no_grad():
            t.copy_(v)
    return template


def _host(count):
    """A step count (an int, a list of them, or a tensor on any device)
    as host data."""
    return count.detach().cpu() if torch.is_tensor(count) else count


def save_checkpoint(path: str, step: int, params, opt_state=None,
                    extra: Optional[Dict[str, Any]] = None,
                    keep: int = 3) -> str:
    fpath = os.path.join(path, f"ckpt_{step:07d}.msgpack")
    os.makedirs(path, exist_ok=True)
    state = {"params": _leaves(params)}
    if opt_state is not None:
        state["opt_state"] = {"adam": {
            "count": _Leaf.of(np.asarray(_host(opt_state["count"]),
                                         np.int32)),
            "mu": _leaves(opt_state["mu"]),
            "nu": _leaves(opt_state["nu"])}}
    pieces: List[bytes] = []
    _encode(state, pieces)
    tmp = fpath + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        for p in pieces:
            f.write(p)
    os.replace(tmp, fpath)
    manifest = {"step": step, "file": os.path.basename(fpath),
                "extra": extra or {}}
    meta = os.path.join(path, f"ckpt_{step:07d}.json")
    with open(meta + f".tmp.{os.getpid()}", "w") as f:
        json.dump(manifest, f)
    os.replace(meta + f".tmp.{os.getpid()}", meta)

    ckpts = sorted(glob.glob(os.path.join(path, "ckpt_*.msgpack")))
    for old in ckpts[:-keep] if keep > 0 else []:
        os.remove(old)
        meta = old.replace(".msgpack", ".json")
        if os.path.exists(meta):
            os.remove(meta)
    return fpath


def latest_checkpoint(path: str) -> Optional[str]:
    ckpts = sorted(glob.glob(os.path.join(path, "ckpt_*.msgpack")))
    return ckpts[-1] if ckpts else None


def load_checkpoint(fpath: str, params_template, opt_state_template=None
                    ) -> Tuple[Any, Any, Dict[str, Any]]:
    """Restore (params, opt_state, manifest-extra) onto templates: the
    stored values are copied into the templates' tensors, in place, so
    they keep their dtypes and devices.  The optimizer's step count is
    copied into the template's count tensor in place (an (S,) tensor for a
    multi-scene checkpoint's stacked counts); a template whose count is an
    int gets an int, or a list of counts, one per scene."""
    with open(fpath, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(buf)
    state = _Reader(buf).value()
    params = _restore(params_template, state["params"], ("params",))
    opt_state = None
    if opt_state_template is not None:
        adam = state["opt_state"]["adam"]
        opt_state = opt_state_template
        _restore(opt_state["mu"], adam["mu"], ("opt_state", "mu"))
        _restore(opt_state["nu"], adam["nu"], ("opt_state", "nu"))
        count = _tensor(adam["count"])
        template = opt_state["count"]
        if torch.is_tensor(template):
            # in place, so a captured step keeps reading it; a multi-scene
            # checkpoint's (S,) counts go into an (S,) template
            if count.dim() > template.dim():
                raise ValueError(f"opt_state/count: checkpoint holds "
                                 f"{tuple(count.shape)}, the template "
                                 f"{tuple(template.shape)}")
            template.copy_(count)
        else:
            # a multi-scene checkpoint stacks one count per scene
            opt_state["count"] = int(count) if count.dim() == 0 \
                else count.tolist()
    meta_path = fpath.replace(".msgpack", ".json")
    extra = {}
    step = 0
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            m = json.load(f)
        step = m.get("step", 0)
        extra = m.get("extra", {})
    extra["step"] = step
    return params, opt_state, extra
