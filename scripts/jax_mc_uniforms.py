#!/usr/bin/env python3
"""Write the JAX package's training Monte-Carlo uniforms to an ``.npz``.

    JAX_PLATFORMS=cpu python3 scripts/jax_mc_uniforms.py OUT.npz [overrides]

With ``renderer.fixed_graph_seeds`` (the default) ``ndjir_tpu``'s trainer
draws its uniforms once, from ``make_mc_cdfs(conf, batch_size, n_rays)``,
and uses them at every step.  This writes that draw for the default config
with the given dotted overrides, one array per key (``upsample`` as
``upsample_0``, ``upsample_1``, ...), so that a run of the PyTorch port
can be handed the same numbers (``scripts/torch_quality_diagnosis.py
uniforms``).  It runs on the CPU in a few seconds.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import jax

    from ndjir_tpu.config import load_config
    from ndjir_tpu.render.renderer import make_mc_cdfs

    conf = load_config("default", overrides=argv[1:])
    cdfs = jax.device_get(jax.jit(lambda: make_mc_cdfs(
        conf, conf.train.batch_size, conf.train.n_rays))())
    arrays = {}
    for k, v in cdfs.items():
        if isinstance(v, list):
            arrays.update({f"{k}_{i}": np.asarray(u) for i, u in enumerate(v)})
        else:
            arrays[k] = np.asarray(v)
    np.savez(argv[0], **arrays)
    print(f"{argv[0]}: " + ", ".join(f"{k} {v.shape}"
                                     for k, v in arrays.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
