"""Import a reference (sony/NDJIR nnabla) .h5 checkpoint into the port's
parameter tree (the port's counterpart of
``ndjir_tpu/tools/import_reference.py``).

The reference saves ``nn.save_parameters(model_XXXXX.h5)`` — an HDF5 file
whose keys are the nnabla parameter scopes (reference: train.py:100-101).
The parameter tree mirrors those scopes by design (models/fields.py), so
migration is a name map:

  <scope>/affine-XX/affine/W            -> params[<scope>]["affine-XX"]["W"]
  <scope>/affine-XX/affine/b            -> ... ["b"]
  geometric-network/voxel_feature/F     -> params[...]["grid"]["F"]
  geometric-network/*_feature/F         -> (hash / triplane / triline / ...)
  geometric-network/gain                -> ["gain"]
  background-network/<sub>/affine-XX/.. -> nested sub-network dicts

Weight-normalized checkpoints (use_wn) carry an extra per-column scale under
``.../affine/wn/g`` which maps to ``g``.  The non-learned schedule
parameters (cos_anneal_ratio, photogrammetric gain) are skipped — they are
plain arguments here.

Each array becomes a CPU tensor of the dtype ``jnp.asarray`` gives it in
the JAX package (64-bit numbers narrowed to 32 bits), so the checkpoint
written is the JAX package's, byte for byte.  ``h5py`` is imported only to
read the file; a flat name -> array mapping from elsewhere goes through
:func:`import_flat_checkpoint`.

Usage:
  python -m ndjir_torch.tools.import_reference model.h5 out_dir \
      --config-name default [--device cuda|cpu]
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

_SKIP = ("cos_anneal_ratio", "photogrammetric-light-network/gain")

# what jnp.asarray makes of a 64-bit numpy array with x64 off (JAX's
# default): its 32-bit counterpart
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32,
           np.dtype(np.complex128): np.complex64}


def load_reference_h5(path: str) -> Dict[str, np.ndarray]:
    import h5py

    flat: Dict[str, np.ndarray] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            flat[name] = np.asarray(obj)

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return flat


def _set(tree: Dict[str, Any], keys, value) -> None:
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    a = np.asarray(value)
    node[keys[-1]] = torch.from_numpy(
        np.array(a, dtype=_NARROW.get(a.dtype, a.dtype), order="C"))


def convert_reference_params(flat: Dict[str, np.ndarray], conf
                             ) -> Tuple[Dict[str, Any], list]:
    """Flat h5 name->array mapping -> the port's parameter tree (CPU
    tensors).

    Returns (params, unmatched_keys).  The result should be validated
    against an ``init_model`` template with matching config.
    """
    grid_type = conf.geometric_network.voxel.type
    params: Dict[str, Any] = {}
    unmatched = []

    for name, arr in flat.items():
        if any(name.startswith(s) or name == s for s in _SKIP):
            continue
        parts = name.split("/")
        # grid features: <scope>/<family>_feature/F
        if len(parts) >= 3 and parts[-2].endswith("_feature") \
                and parts[-1] == "F":
            family = parts[-2]
            scope = parts[0]
            if grid_type.endswith("triplaneline"):
                key = "plane_F" if family == "triplane_feature" else "line_F"
            else:
                key = "F"
            _set(params, [scope, "grid", key], arr)
            continue
        # learnable scalar gain
        if parts[-1] == "gain":
            _set(params, parts, arr)
            continue
        # affine layers (optionally weight-normalized)
        if len(parts) >= 3 and parts[-2] == "affine" \
                and parts[-1] in ("W", "b"):
            _set(params, parts[:-2] + [parts[-1]], arr)
            continue
        if len(parts) >= 4 and parts[-3] == "affine" and parts[-2] == "wn" \
                and parts[-1] == "g":
            _set(params, parts[:-3] + ["g"], arr)
            continue
        unmatched.append(name)
    return params, unmatched


def validate_against_template(params: Dict[str, Any], template
                              ) -> list:
    """Structural check: every template leaf present with matching shape."""
    problems = []

    def walk(t, p, path):
        if isinstance(t, dict):
            for k, v in t.items():
                if not isinstance(p, dict) or k not in p:
                    problems.append(f"missing {'/'.join(path + [k])}")
                else:
                    walk(v, p[k], path + [k])
        else:
            if tuple(t.shape) != tuple(p.shape):
                problems.append(
                    f"shape {'/'.join(path)}: checkpoint {tuple(p.shape)} "
                    f"vs expected {tuple(t.shape)}")

    walk(template, params, [])
    return problems


def import_flat_checkpoint(flat: Dict[str, np.ndarray], out_dir: str, conf,
                           source: str, device="cuda") -> str:
    """Convert a flat reference name -> array mapping, check it against
    the config's model (``init_model`` drawn on ``device``) and write it as
    the step-0 checkpoint of ``out_dir``, its manifest naming ``source``.
    Returns the checkpoint's path."""
    from ndjir_torch.models.fields import init_model
    from ndjir_torch.train.checkpoint import save_checkpoint

    params, unmatched = convert_reference_params(flat, conf)
    template = init_model(conf, seed=0, device=device)
    problems = validate_against_template(template, params)
    del template
    if unmatched:
        print(f"Skipped {len(unmatched)} unmapped keys: {unmatched[:5]}...")
    if problems:
        raise ValueError("Checkpoint does not match config:\n  "
                         + "\n  ".join(problems[:20]))
    return save_checkpoint(out_dir, 0, params, None,
                           extra={"imported_from": source})


def import_reference_checkpoint(h5_path: str, out_dir: str, conf,
                                device="cuda") -> str:
    return import_flat_checkpoint(load_reference_h5(h5_path), out_dir, conf,
                                  h5_path, device)


def main(argv=None):
    import argparse

    from ndjir_torch.cli import _device
    from ndjir_torch.config import load_config

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("h5_path")
    p.add_argument("out_dir")
    p.add_argument("--config-name", default="default")
    p.add_argument("--config-path", default=None)
    p.add_argument("--device", default="cuda",
                   help="device of the model template the file is checked "
                   "against (default cuda)")
    p.add_argument("overrides", nargs="*", default=[])
    args = p.parse_args(argv)
    conf = load_config(args.config_name, overrides=args.overrides,
                       config_dir=args.config_path)
    out = import_reference_checkpoint(args.h5_path, args.out_dir, conf,
                                      _device(args))
    print(f"Imported -> {out}")


if __name__ == "__main__":
    main()
