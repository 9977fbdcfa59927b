#!/usr/bin/env python3
"""Write the JAX package's initial weights as a flax-msgpack checkpoint.

    JAX_PLATFORMS=cpu python3 scripts/jax_init_checkpoint.py OUT.msgpack \
        [overrides]

This writes ``flax.serialization.to_bytes({"params": init_model(
jax.random.PRNGKey(0), conf)})`` for the default config with the given
dotted overrides: the starting point of a JAX training run of that config.
``jax.random`` is threefry, so the bits are the same on any backend; the
file is what the JAX package's quality runs started from.  It has no
manifest, so a run handed it starts at epoch 0
(``scripts/torch_quality_diagnosis.py uniforms FILE --init OUT.msgpack``).

The quality benchmark's config (``scripts/torch_quality_benchmark.py:
make_trainer``) has a 256^3 x 4 f32 grid, 256 MiB, so the file is written
twice: ``OUT.msgpack`` and ``OUT.msgpack.packed``, the same bytes split
into their four byte planes (byte i of every 4-byte word, one plane after
another) with each plane zlib-compressed: the grid's N(0, 1e-3) values have
random mantissas but few exponents, so the plane holding the exponents
shrinks and the packed file is ~15% smaller.  ``unpack`` inverts it.  To
write both for the quality benchmark's config (a few seconds on the CPU):

    JAX_PLATFORMS=cpu python3 scripts/jax_init_checkpoint.py \
        chip_smoke_out/jax_init_v2.msgpack \
        geometric_network.voxel.grid_size=256 precision.mlp_dtype=bfloat16 \
        train.mask_weight=0.1 renderer.bounding_sphere_radius=0.75
"""

from __future__ import annotations

import struct
import sys
import zlib

import numpy as np

_MAGIC = b"NDJIRPK1"


def pack(raw: bytes) -> bytes:
    """``raw`` as its four byte planes, each zlib-compressed."""
    n = len(raw)
    padded = np.frombuffer(raw + b"\0" * (-n % 4), np.uint8).reshape(-1, 4)
    planes = [zlib.compress(padded[:, i].tobytes(), 6) for i in range(4)]
    return (_MAGIC + struct.pack("<Q4Q", n, *map(len, planes))
            + b"".join(planes))


def unpack(buf: bytes) -> bytes:
    """The bytes :func:`pack` was given."""
    if buf[:8] != _MAGIC:
        raise ValueError("not a packed checkpoint")
    n, *sizes = struct.unpack_from("<Q4Q", buf, 8)
    pos = 8 + 40
    words = np.empty(((n + 3) // 4, 4), np.uint8)
    for i, s in enumerate(sizes):
        words[:, i] = np.frombuffer(zlib.decompress(buf[pos:pos + s]),
                                    np.uint8)
        pos += s
    return words.tobytes()[:n]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    from flax.serialization import to_bytes

    from ndjir_tpu.config import load_config
    from ndjir_tpu.models.fields import init_model

    conf = load_config("default", overrides=argv[1:])
    params = jax.device_get(init_model(jax.random.PRNGKey(0), conf))
    raw = to_bytes({"params": params})
    with open(argv[0], "wb") as f:
        f.write(raw)
    packed = pack(raw)
    assert unpack(packed) == raw
    with open(argv[0] + ".packed", "wb") as f:
        f.write(packed)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    print(f"{argv[0]}: {len(leaves)} leaves, {len(raw):,} bytes "
          f"({len(packed):,} packed); " + ", ".join(
              f"{jax.tree_util.keystr(p)} {tuple(v.shape)} {v.dtype}"
              for p, v in leaves if v.size > 100_000))
    return 0


if __name__ == "__main__":
    sys.exit(main())
