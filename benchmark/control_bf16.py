"""The readings a bf16 training cell's limits are set from: those of
``calibrate.py`` and a second control for a configuration whose MLP runs
on bf16 operands, on the card, at the cell's own size:

    python3 benchmark/control_bf16.py --workload <cell> --seeds 1,2,3 \
        [--control 3] [--out FILE]

For every seed, ``calibrate.readings`` (the program against the plain
reference; on the first ``--control`` seeds the reference again, the TF32
control and the half-batch fault); on those seeds also ``bf16_sum``: the
reference with each affine layer's product taken by ``torch.matmul`` on
the bf16 operands, which rounds the sums to bf16 before the bias is
added, the second rounding the configuration does not make
(``reference.models.fields._matmul``); and ``f32_order``: the reference
with those products taken on the bf16 operands' values as f32 matrices
(TF32 off), exact products summed in f32 as the configuration states,
but in SIMT GEMMs' order instead of the tensor cores': how far a sound
program that sums in another order reads.  At bf16 operands the TF32
control reaches only the f32 products (the layers' backward and those
outside the MLPs), so the bf16-sum control is the precision below the
configuration's.  One JSON line a seed.  The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import calibrate  # noqa: E402  (sets the kernel cache)


def _bf16_sums(h, W, dtype):
    return (h.to(dtype) @ W.to(dtype)).float()


def _f32_order(h, W, dtype):
    return h.to(dtype).float() @ W.to(dtype).float()


PRODUCTS = {"bf16_sum": _bf16_sums, "f32_order": _f32_order}


@contextlib.contextmanager
def products(name: str):
    """The reference's affine layers on bf16 operands take their product
    by ``PRODUCTS[name]`` inside the block."""
    from benchmark.reference.models import fields

    real = fields._matmul
    form = PRODUCTS[name]

    def matmul(h, W, compute_dtype):
        if compute_dtype is None:
            return real(h, W, compute_dtype)
        return form(h, W, compute_dtype)
    fields._matmul = matmul
    try:
        yield
    finally:
        fields._matmul = real


def readings(cell_name: str, seed: int, control: bool, device="cuda",
             root=None) -> dict:
    """``calibrate.readings``, and with ``control`` the ``bf16_sum`` and
    ``f32_order`` readings against the same reference epoch, from the same
    inputs."""
    from benchmark import compare
    from benchmark.reference import follow

    real = follow.train_epoch
    first = []

    def kept(*args, **kwargs):
        out = real(*args, **kwargs)
        if not first:
            first.append((args, out))
        return out
    follow.train_epoch = kept
    try:
        out = calibrate.readings(cell_name, seed, control, device, root)
    finally:
        follow.train_epoch = real
    if control and first:
        args, ref = first[0]
        for name in PRODUCTS:
            with products(name):
                out[name] = compare.train_numbers(real(*args), ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control", type=int, default=3,
                   help="run the controls and the fault on this many of "
                   "the first seeds")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    with contextlib.ExitStack() as stack:
        f = stack.enter_context(open(args.out, "a")) if args.out else None
        for k, seed in enumerate(seeds):
            t0 = time.perf_counter()
            r = readings(args.workload, seed, k < args.control)
            r["seconds"] = time.perf_counter() - t0
            line = json.dumps(r)
            print(line, flush=True)
            if f:
                f.write(line + "\n")
                f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
