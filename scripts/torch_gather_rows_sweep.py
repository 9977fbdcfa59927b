#!/usr/bin/env python3
"""Time the row gather (``csrc/gather_rows.cu``) beside ``index_select`` over
row widths and table sizes.

    python3 scripts/torch_gather_rows_sweep.py [--cases NAME ...]

On one NVIDIA GPU: for each case, uniform random ids (seed 0) into a
table of random values; the kernel's output is held bitwise against
``index_select``, then both are timed with CUDA events over back-to-back
calls, in turns (kernel, ``index_select``, ``index_select``, kernel), and
given as ms, G rows/s and the share of the kernel's bound (the
ids read and the rows written once each, each distinct row read once, at
the card's published memory rate; a random 16-byte read from HBM moves a
32-byte sector, which the bound does not count).  The first three cases are the hash query's x_fg shape
(33,554,432 ids into 476,672 rows, the 7.6 MB table in L2) at D=4 f32, D=4
bf16 and D=64 f32: ``index_select``'s 16-byte-aligned rows (the first and
the last) take PyTorch's one-block-per-id vectorized path, the bf16 rows
of 8 bytes its other index path.  The others time the widths the grid
queries use and a 2.1 GB table in HBM.  Prints one line per case and a
JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HASH_IDS, HASH_ROWS = 33_554_432, 476_672
# name -> (ids, table rows, D, dtype name)
CASES = {
    "hash_d4_f32": (HASH_IDS, HASH_ROWS, 4, "float32"),
    "hash_d4_bf16": (HASH_IDS, HASH_ROWS, 4, "bfloat16"),
    "hash_d64_f32": (HASH_IDS, HASH_ROWS, 64, "float32"),
    "hash_d1_f32": (HASH_IDS, HASH_ROWS, 1, "float32"),
    "hash_d2_f32": (HASH_IDS, HASH_ROWS, 2, "float32"),
    "hash_d8_f32": (HASH_IDS, HASH_ROWS, 8, "float32"),
    "hash_d8_bf16": (HASH_IDS, HASH_ROWS, 8, "bfloat16"),
    "g512_d4_f32": (16_777_216, 512 ** 3, 4, "float32"),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cases", nargs="+", default=list(CASES),
                        choices=list(CASES))
    parser.add_argument("--reps", type=int, default=10,
                        help="calls timed back to back, twice a version")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_gather_rows_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from ndjir_torch import kernels
    from ndjir_torch.ops import scatter

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    card = torch.cuda.get_device_name(0)
    mem_rate, _ = chip_smoke.card_peaks(card)
    kernels.build(["gather_rows"])
    results = []
    for name in args.cases:
        n, rows, d, dtype_name = CASES[name]
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device="cuda").manual_seed(0)
        table = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
        ids = torch.randint(0, rows, (n,), generator=gen, device="cuda")
        got = scatter._gather_rows_cuda(table, ids)
        want = table.index_select(0, ids)
        if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"{name}: the kernel is not index_select "
                                 "bitwise")
        del got, want

        def kernel():
            return scatter._gather_rows_cuda(table, ids)

        def library():
            return table.index_select(0, ids)
        # in turns: kernel, library, library, kernel
        ms = [chip_smoke.cuda_ms(torch, fn, args.reps)
              for fn in (kernel, library, library, kernel)]
        kernel_ms, library_ms = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
        row_bytes = d * table.element_size()
        n_bytes = (n * (ids.element_size() + row_bytes)
                   + torch.unique(ids).numel() * row_bytes)
        bound_ms = 1e3 * n_bytes / mem_rate
        r = dict(case=name, ids=n, rows=rows, d=d, dtype=dtype_name,
                 width=scatter.gather_width(row_bytes, table.data_ptr(),
                                            0)[0],
                 ms=kernel_ms, index_select_ms=library_ms, bound_ms=bound_ms,
                 bytes=n_bytes, g_rows_per_s=n / kernel_ms / 1e6,
                 index_select_g_rows_per_s=n / library_ms / 1e6,
                 roofline=100.0 * bound_ms / kernel_ms)
        results.append(r)
        print(f"{name}: {n} ids into {rows} x {d} {dtype_name} "
              f"({r['width']}-byte vectors): kernel {kernel_ms:.4f} ms "
              f"({r['g_rows_per_s']:.2f} G rows/s, {r['roofline']:.1f}% of "
              f"the {bound_ms:.4f} ms bound), index_select "
              f"{library_ms:.4f} ms ({r['index_select_g_rows_per_s']:.2f} "
              f"G rows/s); bitwise equal ({card})", flush=True)
        del table, ids
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "gather_rows": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
