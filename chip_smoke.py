#!/usr/bin/env python3
"""Run the PyTorch + CUDA port (``ndjir_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Two paths are driven in full: the unmodified default config (G=512 f32
grid, f32 MLP; one scatter per differentiated grid query, two per step)
and the reference's production precision (``bench.py:204``: G=256 bf16 grid in
the octa layout, bf16 MLP operands; one scatter and one fold per step, and
one octa table build per ``render_image`` or ``extract`` call); the
other grid encodings' presets through training and the command line
(phase 10).  Phases, each printing its lines as it goes:

1. device  -- the card, as ``nvidia-smi`` names it, with its power limit.
2. build   -- every hand-written kernel of ``ndjir_torch/csrc``, compiled
              with ``nvcc`` for sm_90a (one process per source, in
              parallel), and the native mesh library with ``g++``.
3. kernels -- each kernel's wrapper against its plain PyTorch version on the
              card: at the shapes each path gives it and at edge cases;
              error, run-to-run repeatability, times and the bound.
4. parity  -- a small training loss and every parameter gradient on the card
              against the same computation on the CPU (the plain versions,
              which the CPU tests hold against the JAX reference), at f32
              and at the two bf16 precisions; a 16x16 rendered view and a
              32^3 SDF volume, card against CPU, at f32 and bf16.
5. train   -- per path, the ``Trainer`` on an in-memory 16-view sphere
              scene for three epochs of four steps; the lagged, warmed-up
              schedule puts the first two at lr=0, so the third is the
              first to update.  Launch counts are set to 0 just before and
              read just after.
6. profile -- per path, one more epoch under ``torch.profiler``: device
              time by kernel and the device's busy share.
7. render  -- per path, ``render_image`` of one view and ``Trainer.validate``
              (the view's PSNR, a 128^3 extraction with its six attribute
              meshes and the environment map); on the production path also
              one full ``extract`` at 512^3.  Launch counts around each
              call, times and peak memory.
8. checkpoint -- on the production path, one more epoch that saves a
              checkpoint, and a fresh ``Trainer`` on the same monitor
              directory that resumes from it, bitwise.
9. cli     -- the entry points on DTU-style scene folders: ``python3 -m
              ndjir_torch.cli make-synthetic`` in a process of its own
              (every PNG decoded back and held bitwise against the
              in-memory scene), then ``ndjir_torch.cli.main`` in this
              process: the default config's ``train`` (3 epochs, the final
              validation with its 256^3 extraction and the DTU Chamfer
              hook against a reference cloud of the scene's sphere),
              ``render`` of every view, ``eval-image``, ``extract`` at
              256^3 and ``eval-chamfer``; the production precision's
              ``train`` (one epoch), ``render`` of two views and
              ``extract``.  Launch counts around each command, host time
              per command, the Chamfer's share of the final validation.
10. encodings -- the presets of the other grid encodings at their
              published widths (``custom``: lanczos_voxel G=512 D=4;
              ``triplaneline`` G=2048 D=8; ``voxel_hash`` 16 levels):
              every scatter (B1) of one real step's ids with random
              values against its float64 sums, repeated bitwise, timed
              beside ``index_add_``; three in-memory epochs as in phase 5
              (ms/step, peak memory, launches); loss, gradients, a
              rendered view and an SDF volume on the card against the CPU
              at f32, with the weight rows that read the grid drawn
              nonzero (the hash's view with them closed); ``cli train``
              of one epoch each with its exact B1 launches; ``cli
              render`` and ``cli extract`` of triplaneline, which launch
              no kernel.
11. opt-ins and parallel -- at the default config's widths: the
              coarse-grid proposal (three epochs, its G_c=64 snapshot
              refreshed every 4 steps, exactly 2 B1 a step and none in a
              snapshot, the trained network's snapshot card against CPU,
              ms/step beside phase 5's network proposals); one step with
              ``remat_heads`` against one without (loss, gradients, ms,
              the step's peak memory); three epochs with fresh
              Monte-Carlo uniforms every step; a two-scene
              ``MultiSceneTrainer`` (three epochs, exactly 4 B1 a step, ms
              per scene-step, peak memory, its stacked checkpoint resumed
              bitwise); ``initialize_distributed`` over NCCL at world size
              1 and the sharded step's collectives on that group against
              the plain step.

Monitor files, rendered images, environment maps and the full profiles go
to ``--out`` (default ``chip_smoke_out/``); the meshes, point clouds and
checkpoints are deleted once checked.  The last two lines are the
``{"kernels": [...]}`` record and ``{"ok": true, "device": {...}}``.
Every check raises on failure, so the script exits non-zero and prints
neither; it does the same when there is no CUDA device or ``ndjir_torch``
is not beside it.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chip_smoke_out")  # --out replaces it

# The grid-feature scatter at the default step's shape: one launch per
# differentiated grid query, 8 corners x B=4 x R=512 x 128 samples.
MAIN_N, MAIN_D, MAIN_G = 8 * 4 * 512 * 128, 4, 512
MAIN_ROWS = MAIN_G ** 3

# The production-precision path (bench.py:204): its one scatter per step
# takes one octa row of width 8D = 32 for each of x_fg and x_ptb,
# 2 x B=4 x R=512 x 128 samples, into G^3 rows; its fold writes the
# (G, G, G, D) bf16 table gradient.
OCTA = ["geometric_network.voxel.grid_size=256", "precision.mlp_dtype=bfloat16",
        "precision.grid_dtype=bfloat16"]
OCTA_N, OCTA_D, OCTA_G = 2 * 4 * 512 * 128, 4, 256
OCTA_ROWS = OCTA_G ** 3

# kernel launches one training step makes, per path
STEP_LAUNCHES = {
    "default": {"scatter_add_rows": 2, "fold_octa_cotangent": 0,
                "build_octa_table": 0},
    "g256_bf16": {"scatter_add_rows": 1, "fold_octa_cotangent": 1,
                  "build_octa_table": 0}}
# octa table builds per render_image or extract call, per path
BUILDS_PER_CALL = {"default": 0, "g256_bf16": 1}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_peaks(name: str):
    """(memory bytes/s, f32 FLOP/s outside the tensor cores) from NVIDIA's
    data sheets, for the card ``name``."""
    if "H200" in name:
        return 4.8e12, 67e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12
    if "H100" in name and "NVL" in name:
        return 3.9e12, 60e12
    if "H100" in name:
        return 3.35e12, 67e12
    raise RuntimeError(f"no published peak rates for {name!r}")


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
# phase 3: the scatter kernel against its plain version
# ---------------------------------------------------------------------------

def check_scatter(torch, scatter, label, ids, vals, num_rows,
                  transposed=False):
    """Kernel wrapper vs the plain version on the same inputs, accumulated
    in float64 (so exactly, to f32 precision), with ids outside
    [0, num_rows) left out, as the kernel drops them; the kernel's sort vs
    the plain stable sort (``torch.sort`` of the same keys), its slab
    pre-pass vs its plain version (``torch.searchsorted``) and its piece
    plan vs its plain version, each exactly.
    Returns the max abs error.  Tolerance: 1e-5 of the largest exact row
    sum (no floor: all-zero sums must come out exactly zero) for f32
    outputs (the kernel's f32 sums of up to ~10^5 terms, taken in a
    fixed order, stay well inside it), one bf16 ulp (at most 2^-7 of the
    value) for bf16 outputs.  Both the kernel and the exact sums are
    deterministic, so the check is too."""
    fn = scatter.scatter_add_rows_t if transposed \
        else scatter.scatter_add_rows
    got = fn(ids, vals, num_rows)
    again = fn(ids, vals, num_rows)
    keep = (ids >= 0) & (ids < num_rows)
    want = scatter._scatter_add_rows_plain(ids[keep], vals[keep], num_rows,
                                           acc_dtype=torch.float64)
    if transposed:
        want = want.t()
    bits = 0 if transposed else scatter.bucket_bits(ids.numel(), vals,
                                                    num_rows)
    if bits:    # the bucket path: keys by bucket, carrying the rows
        ids32, moved = scatter.sort_by_bucket(ids, vals, num_rows, bits)
        plain = scatter._sort_by_bucket_plain(ids, vals, num_rows, bits)
        rows, piece, cut = 1 << bits, scatter._BUCKET_PIECE, 0
    else:
        ids32, moved = scatter.sort_updates(ids, num_rows)
        plain = scatter._sort_updates_plain(ids, num_rows)
        rows = scatter.slab_rows(vals.shape[1])
        piece, cut = scatter.piece_size(vals.shape[1]), None
    sort_ok = torch.equal(ids32, plain[0]) and torch.equal(moved, plain[1])
    del plain, moved
    starts = scatter.slab_starts(ids32, num_rows, rows, bits)
    plain_starts = scatter._slab_starts_plain(ids32, num_rows, rows, bits)
    starts_ok = torch.equal(starts, plain_starts)
    pieces = scatter.piece_plan(ids32, num_rows, rows, piece, cut, bits)
    plan_ok = torch.equal(pieces, scatter._piece_plan_plain(plain_starts,
                                                            piece, cut))
    torch.cuda.synchronize()
    want_dtype = torch.float32 if transposed else vals.dtype
    if got.shape != want.shape or got.dtype != want_dtype:
        raise AssertionError(f"{label}: got {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} {want_dtype}")
    err = (got.double() - want).abs().max().item() if got.numel() else 0.0
    scale = want.abs().max().item() if want.numel() else 0.0
    rel = 2.0 ** -7 if want_dtype == torch.bfloat16 else 1e-5
    repeatable = torch.equal(got, again)
    busy = int((starts[1:] != starts[:-1]).sum().item())
    log("kernels", f"scatter_add_rows {label}: N={ids.numel()} "
        f"D={vals.shape[1]} rows={num_rows} max_abs_err={err:.3g} "
        f"(tol {rel * scale:.3g}) bitwise_repeatable={repeatable}; "
        f"{busy} of {starts.numel() - 1} {'buckets' if bits else 'slabs'} "
        f"of {rows} rows take updates, "
        f"{pieces.shape[0]} pieces of {piece} updates; sort, pre-pass and "
        f"plan equal to their plain versions: {sort_ok}, {starts_ok}, "
        f"{plan_ok}")
    if not err <= rel * scale:
        raise AssertionError(f"{label}: kernel disagrees with the plain "
                             f"version by {err}")
    if not repeatable:
        raise AssertionError(f"{label}: two runs differ")
    if not (sort_ok and starts_ok and plan_ok):
        raise AssertionError(f"{label}: the sort, the slab pre-pass or the "
                             "piece plan differs from its plain version")
    return err


def _rand(torch, seed):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randn(n, d, dtype=torch.float32):
        return torch.randn((n, d), generator=gen, device=dev).to(dtype)

    def randint(hi, n):
        return torch.randint(0, hi, (n,), generator=gen, device=dev)
    return randn, randint


def scatter_edge_cases(torch, scatter):
    """Random ids; 700 updates to one row; no updates at all; updates in one
    slab only; ids outside [0, num_rows) mixed in; num_rows not a multiple
    of the slab; D in {1, 3, 4, 8, 32, 33}; the rows on either side of the
    kernel's slab edges (256 rows at D=4, 128 at D=8, 64 at D=32) and of
    the TPU kernel's (4096); transposed output; bf16 values; a
    20,000-update row at D=32, transposed, bf16; one D=8 slab cut into 400
    pieces; one row taking all 300,000 updates at D=8 and D=4; ids outside
    the table at a 13- and a 19-bit key width; the bucket path at 20,001
    and 476,672 rows.  Each is repeated bitwise."""
    dev = torch.device("cuda")
    randn, randint = _rand(torch, 0)
    check_scatter(torch, scatter, "random", randint(100_000, 65_536),
                  randn(65_536, 4), 100_000)
    hot = torch.cat([torch.full((700,), 1234, device=dev),
                     randint(9000, 500)])
    check_scatter(torch, scatter, "700-to-one-row", hot, randn(1200, 4), 9000)
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    for d, transposed in ((4, False), (32, True), (3, False)):
        check_scatter(torch, scatter, f"no-updates-d{d}", none,
                      randn(0, d), 10_007, transposed)
    for d, transposed in ((4, False), (32, True)):
        rows = scatter.slab_rows(d)
        one = 5 * rows + randint(rows, 3000)
        check_scatter(torch, scatter, f"one-busy-slab-d{d}", one,
                      randn(3000, d), 40 * rows + 3, transposed)
    outside = randint(70_000, 20_000) - 5000     # [-5000, 65000) into 60,001
    outside[::7] = 2 ** 31 - 1
    for d, transposed in ((4, False), (32, True), (1, False)):
        check_scatter(torch, scatter, f"ids-outside-d{d}", outside,
                      randn(20_000, d), 60_001, transposed)
    for d in (1, 3, 33):
        for transposed in (False, True):
            check_scatter(torch, scatter, f"d{d}-transposed{int(transposed)}",
                          randint(30_011, 8000), randn(8000, d), 30_011,
                          transposed)
    edges = torch.tensor([0, 31, 32, 63, 64, 127, 128, 255, 256, 511, 512,
                          2047, 2048, 4095, 4096, 6143, 6144, 8191],
                         device=dev).repeat_interleave(40)
    for d in (4, 8, 32):
        for transposed in (False, True):
            check_scatter(torch, scatter,
                          f"slab-edges-d{d}-transposed{int(transposed)}",
                          edges, randn(edges.numel(), d), 8192, transposed)
    for d in (4, 32):
        check_scatter(torch, scatter, f"transposed-d{d}",
                      randint(50_001, 20_000), randn(20_000, d), 50_001,
                      transposed=True)
    check_scatter(torch, scatter, "bf16", randint(30_000, 10_000),
                  randn(10_000, 4, torch.bfloat16), 30_000)
    hot = torch.cat([torch.full((20_000,), 4095, device=dev),
                     randint(65_536, 5000)])
    check_scatter(torch, scatter, "20000-to-one-row-d32-bf16-transposed",
                  hot[torch.randperm(hot.numel(), device=dev)],
                  randn(hot.numel(), 32, torch.bfloat16), 65_536,
                  transposed=True)
    # one D=8 slab cut into 400 pieces, each built by a warp of its own
    rows, piece = scatter.slab_rows(8), scatter.piece_size(8)
    split = 3 * rows + randint(rows, 400 * piece)
    check_scatter(torch, scatter, "one-slab-400-pieces-d8", split,
                  randn(split.numel(), 8), 10 * rows)
    # a single row takes every update: one run through every piece, summed
    # by the fix-up
    for d in (8, 4):
        one = torch.full((300_000,), 777, device=dev)
        check_scatter(torch, scatter, f"one-row-all-updates-d{d}", one,
                      randn(one.numel(), d), 6144)
    # ids outside the table at a 13- and a 19-bit key width, whose low bits
    # alias the rows the real ids take
    for num_rows in (6144, 476_672):
        bits = num_rows.bit_length()
        near = torch.cat([num_rows - 1 - randint(100, 40_000),
                          -1 - randint(2 ** 20, 5000),
                          num_rows + randint(2 ** 20, 5000),
                          (1 << bits) + num_rows - 1 - randint(100, 5000)])
        near = near[torch.randperm(near.numel(), device=dev)]
        for d in (4, 8):
            check_scatter(torch, scatter,
                          f"ids-outside-{bits}-bit-keys-d{d}", near,
                          randn(near.numel(), d), num_rows)
    # the bucket path (f32 at D=4, 8 or more updates a row): buckets of 128
    # and 2,048 rows, a row taking more updates than a piece, ids outside
    # whose low bits alias real rows, a table not a whole number of buckets
    for num_rows, n in ((20_001, 200_000), (476_672, 4_000_000)):
        ids = torch.cat([randint(num_rows, n),
                         torch.full((40_000,), num_rows // 3, device=dev),
                         -1 - randint(2 ** 20, 5000),
                         num_rows + randint(2 ** 20, 5000)])
        ids = ids[torch.randperm(ids.numel(), device=dev)]
        vals = randn(ids.numel(), 4)
        if not scatter.bucket_bits(ids.numel(), vals, num_rows):
            raise AssertionError(f"{num_rows} rows: no bucket path")
        check_scatter(torch, scatter, f"bucket-path-{num_rows}-rows", ids,
                      vals, num_rows)


def profile_once(torch, label, fn):
    """One call of ``fn`` (after a warm-up call) under ``torch.profiler``:
    the device time of every kernel it launched, by kernel name, logged
    and returned as [{"kernel", "launches", "us"}] in launch order."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [dict(kernel=e.key, launches=e.count,
                 us=e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(r["us"] for r in rows)
    log("kernels", f"{label} under the profiler: {len(rows)} kernel(s), "
        f"{total:.1f} us of device time")
    for r in rows:
        log("kernels", f"  {r['us']:9.1f} us x{r['launches']} "
            f"{r['kernel'][:110]}")
    return rows


def scatter_timings(torch, scatter, label, ids, vals, num_rows, transposed,
                    card_name):
    """The wrapper on the step's own ids against the plain version, then
    its time, the sort's and the kernel's alone, the plain version's, one
    ``index_add_`` call's (untransposed: no library call writes the
    transposed layout) and the bound."""
    dev = torch.device("cuda")
    n, d = vals.shape
    err = check_scatter(torch, scatter, f"{label}-step-ids", ids, vals,
                        num_rows, transposed)
    fn = scatter.scatter_add_rows_t if transposed \
        else scatter.scatter_add_rows
    wrapper_profile = profile_once(torch, f"scatter_add_rows {label}",
                                   lambda: fn(ids, vals, num_rows))
    bits = 0 if transposed else scatter.bucket_bits(n, vals, num_rows)
    if bits:
        def sort():
            return scatter.sort_by_bucket(ids, vals, num_rows, bits)

        def kernel():
            return scatter._launch_buckets(keys, moved, num_rows, bits)
        keys, moved = sort()
    else:
        def sort():
            return scatter.sort_updates(ids, num_rows)

        def kernel():
            return scatter._launch(keys, perm, vals, num_rows, transposed)
        keys, perm = sort()
    ids64, vals32 = ids.long(), vals.float()

    def plain():
        out = scatter._scatter_add_rows_plain(ids, vals, num_rows)
        return out.t().contiguous() if transposed else out
    ms = cuda_ms(torch, lambda: fn(ids, vals, num_rows))
    sort_ms = cuda_ms(torch, sort)
    kernel_ms = cuda_ms(torch, kernel)
    plain_ms = cuda_ms(torch, plain)
    library_ms = cuda_ms(torch, lambda: torch.zeros(
        num_rows, d, device=dev).index_add_(0, ids64, vals32))

    mem_rate, f32_rate = card_peaks(card_name)
    n_bytes = (ids.numel() * ids.element_size()
               + vals.numel() * vals.element_size() + num_rows * d * 4)
    n_ops = n * d  # one add per updated value
    bytes_ms, ops_ms = 1e3 * n_bytes / mem_rate, 1e3 * n_ops / f32_rate
    counts = torch.unique(ids, return_counts=True)[1]
    log("kernels", f"{label} step ids: {counts.numel()} distinct rows, the "
        f"most updated takes {counts.max().item()} of {n} updates")
    log("kernels", f"scatter_add_rows {label}: N={n} D={d} {vals.dtype} "
        f"transposed={transposed}, {'bucket' if bits else 'sorted'} path: "
        f"{ms:.4f} ms (sort {sort_ms:.4f} + kernel "
        f"{kernel_ms:.4f}), plain {plain_ms:.4f} ms, index_add_ "
        f"{library_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"({n_bytes} B at {mem_rate:.3g} B/s)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms, kernel_ms=kernel_ms, sort_ms=sort_ms,
                path="bucket" if bits else "sorted",
                wrapper_profile=wrapper_profile)


def scatter_main_shape(torch, scatter, main_ids, card_name):
    """At the default step's shape, with uniform ids and with the ids of
    the step's own first batch."""
    randn, randint = _rand(torch, 1)
    vals = randn(MAIN_N, MAIN_D)
    uniform_ids = randint(MAIN_ROWS, MAIN_N)
    check_scatter(torch, scatter, "main-shape-uniform-ids", uniform_ids,
                  vals, MAIN_ROWS)
    uniform_ms = cuda_ms(torch, lambda: scatter.scatter_add_rows(
        uniform_ids, vals, MAIN_ROWS))
    log("kernels", f"scatter_add_rows main shape at uniform ids: "
        f"{uniform_ms:.4f} ms")
    del uniform_ids
    return dict(name="scatter_add_rows", route="cuda",
                source="ndjir_torch/csrc/scatter_add_rows.cu",
                replaces="ndjir_tpu/ops/scatter_pallas.py:77",
                **scatter_timings(torch, scatter, "main-shape", main_ids,
                                  vals, MAIN_ROWS, False, card_name),
                ms_uniform_ids=uniform_ms, bitwise_repeatable=True)


def scatter_octa_shape(torch, scatter, octa_ids, card_name):
    """At the production path's shape: the step's own octa row ids of x_fg
    and x_ptb, bf16 rows of width 32, transposed (32, 256^3) f32 output."""
    randn, _ = _rand(torch, 2)
    vals = randn(OCTA_N, 8 * OCTA_D, torch.bfloat16)
    return dict(n=OCTA_N, d=8 * OCTA_D, rows=OCTA_ROWS, transposed=True,
                **scatter_timings(torch, scatter, "octa-shape", octa_ids,
                                  vals, OCTA_ROWS, True, card_name))


# ---------------------------------------------------------------------------
# phase 3: the fold kernel against its plain version
# ---------------------------------------------------------------------------

def bf16_ulp(torch, t):
    """One bf16 ulp of each entry of a float64 tensor."""
    e = torch.floor(torch.log2(torch.clamp_min(t.abs(), 2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def check_fold(torch, fold, label, cot, gshape):
    """The fold wrapper vs the plain version in float64 on the same input:
    the f32 output within 1e-6 of the exact result's largest entry (f32
    sums of at most 27 terms), the bf16 output the f32 one rounded once
    (bitwise) and within one bf16 ulp of the exact result plus that f32
    error (a sum that cancels to near zero has a tiny ulp); two runs
    bitwise equal.  Returns the f32 output's max abs error."""
    got32 = fold.fold_octa_cotangent(cot, gshape, torch.float32)
    got = fold.fold_octa_cotangent(cot, gshape, torch.bfloat16)
    again = fold.fold_octa_cotangent(cot, gshape, torch.bfloat16)
    want = fold._fold_octa_cotangent_plain(cot.double(), gshape,
                                           torch.float64)
    torch.cuda.synchronize()
    if got.shape != tuple(gshape) or got.dtype != torch.bfloat16:
        raise AssertionError(f"{label}: got {tuple(got.shape)} {got.dtype}")
    scale = want.abs().max().item()
    err = (got32.double() - want).abs().max().item()
    err16 = ((got.double() - want).abs() - bf16_ulp(torch, want)
             - 1e-6 * scale).max().item()
    repeatable = torch.equal(got, again) and torch.equal(
        got, got32.to(torch.bfloat16))
    log("kernels", f"fold_octa_cotangent {label}: grid {tuple(gshape)} "
        f"max_abs_err={err:.3g} (tol {1e-6 * scale:.3g}), bf16 output "
        f"within one ulp: {err16 <= 0.0}, bitwise_repeatable={repeatable}")
    if not err <= 1e-6 * scale:
        raise AssertionError(f"{label}: kernel disagrees with the plain "
                             f"version by {err}")
    if not err16 <= 0.0 or not repeatable:
        raise AssertionError(f"{label}: bf16 output off by more than one "
                             "ulp, or not the f32 output rounded, or two "
                             "runs differ")
    return err


def fold_edge_cases(torch, fold):
    """Non-cubic, tiny and single-slab grids, the far corner that sums 27
    inputs, and the TPU kernel's test shapes."""
    dev = torch.device("cuda")
    randn, _ = _rand(torch, 3)
    for gshape in [(5, 6, 7, 3), (2, 2, 2, 4), (1, 3, 2, 2), (3, 1, 1, 1),
                   (4, 2, 128, 4), (8, 2, 128, 2)]:
        M = gshape[0] * gshape[1] * gshape[2]
        check_fold(torch, fold, "random", randn(8 * gshape[3], M), gshape)
    ones = fold.fold_octa_cotangent(torch.ones(32, 4 * 3 * 5, device=dev),
                                    (4, 3, 5, 4))
    if ones[-1, -1, -1].tolist() != [27.0] * 4 \
            or ones[1, 1, 1].tolist() != [8.0] * 4:
        raise AssertionError("fold of ones: the far corner must sum 27 "
                             "inputs and an interior cell 8")
    log("kernels", "fold_octa_cotangent far corner: 27 inputs summed")


def fold_ops(gshape) -> int:
    """Adds the fold needs on this grid: per output, its inputs less one;
    along an axis of length L a cell takes 1 input at 0 (2 if L = 1), 2
    inside and 3 at L - 1, and the counts multiply over the axes."""
    Gx, Gy, Gz, D = gshape

    def per_axis(L):
        return 2 if L == 1 else 1 + 2 * (L - 2) + 3
    return D * (per_axis(Gx) * per_axis(Gy) * per_axis(Gz) - Gx * Gy * Gz)


def fold_main_shape(torch, fold, step_cot, card_name):
    """At the production path's shape, with random input and with the
    step's own cotangent; times and the bound."""
    gshape = (OCTA_G,) * 3 + (OCTA_D,)
    randn, _ = _rand(torch, 4)
    cot = randn(8 * OCTA_D, OCTA_ROWS)
    check_fold(torch, fold, "main-shape-random", cot, gshape)
    random_ms = cuda_ms(torch, lambda: fold.fold_octa_cotangent(
        cot, gshape, torch.bfloat16))
    del cot
    err = check_fold(torch, fold, "main-shape-step-cotangent", step_cot,
                     gshape)
    ms = cuda_ms(torch, lambda: fold.fold_octa_cotangent(
        step_cot, gshape, torch.bfloat16))
    plain_ms = cuda_ms(torch, lambda: fold._fold_octa_cotangent_plain(
        step_cot, gshape, torch.bfloat16))
    mem_rate, f32_rate = card_peaks(card_name)
    n_bytes = step_cot.numel() * 4 + OCTA_ROWS * OCTA_D * 2
    n_ops = fold_ops(gshape)
    bytes_ms, ops_ms = 1e3 * n_bytes / mem_rate, 1e3 * n_ops / f32_rate
    log("kernels", f"fold_octa_cotangent main shape: {ms:.4f} ms "
        f"({random_ms:.4f} ms on random input), plain "
        f"{plain_ms:.4f} ms, no single library call, bound "
        f"{max(bytes_ms, ops_ms):.4f} ms ({n_bytes} B at {mem_rate:.3g} "
        f"B/s; {n_ops} adds)")
    return dict(name="fold_octa_cotangent", route="cuda",
                source="ndjir_torch/csrc/fold_octa_cotangent.cu",
                replaces="ndjir_tpu/ops/fold_pallas.py:55",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None, ms_random_input=random_ms,
                bitwise_repeatable=True)


# ---------------------------------------------------------------------------
# phase 3: the octa table build kernel against its plain version
# ---------------------------------------------------------------------------

def check_build(torch, octa_build, label, base):
    """The build wrapper vs the plain version on the same table: a pure
    copy, so bitwise equal, and two runs bitwise equal."""
    got = octa_build.build_octa_table(base)
    again = octa_build.build_octa_table(base)
    want = octa_build._build_octa_table_plain(base)
    torch.cuda.synchronize()
    equal = got.dtype == want.dtype and got.shape == want.shape \
        and torch.equal(got, want)
    repeatable = torch.equal(got, again)
    log("kernels", f"build_octa_table {label}: grid {tuple(base.shape)} "
        f"{base.dtype}: bitwise equal to the plain version: {equal}, "
        f"bitwise_repeatable={repeatable}")
    if not equal or not repeatable:
        raise AssertionError(f"{label}: the octa build differs from its "
                             "plain version, or two runs differ")
    return got


def build_edge_cases(torch, octa_build):
    """Non-cubic grids, axes of length 1 and 2, D in {2, 3, 4}, bf16 and
    f32: cells of 4, 6, 8, 12 and 16 bytes, every vector width the kernel
    picks."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for dtype in (torch.bfloat16, torch.float32):
        for gshape in [(5, 3, 7, 4), (5, 3, 7, 2), (1, 3, 2, 4),
                       (2, 1, 1, 2), (1, 1, 1, 4), (2, 2, 2, 2),
                       (3, 1, 2, 4), (1, 2, 1, 2), (4, 5, 6, 3)]:
            base = torch.randn(gshape, generator=gen, device=dev).to(dtype)
            check_build(torch, octa_build, "edge", base)


def build_main_shape(torch, octa_build, grid, base, octa_ids, card_name):
    """At the inference shape, on the production path's trained table:
    the kernel against the plain version and one ``index_select`` that
    builds the same table from precomputed corner ids (the ids made
    outside the timing); then the wide gather of the training step's octa
    ids from the prebuilt table against ``GatherRowsOcta``'s 8-corner
    forward at the same ids."""
    dev = base.device
    Gx, Gy, Gz, D = base.shape
    table = check_build(torch, octa_build, "main-shape-trained-table", base)
    ms = cuda_ms(torch, lambda: octa_build.build_octa_table(base))
    plain_ms = cuda_ms(torch, lambda: octa_build._build_octa_table_plain(
        base))
    corners = grid.octa_corner_ids(torch.arange(Gx * Gy * Gz, device=dev),
                                   base.shape).reshape(-1)
    flat = base.reshape(-1, D)
    if not torch.equal(flat.index_select(0, corners).reshape(-1, 8 * D),
                       table):
        raise AssertionError("index_select of the corner ids is not the "
                             "octa table")
    library_ms = cuda_ms(torch, lambda: flat.index_select(0, corners))
    del corners
    mem_rate, _ = card_peaks(card_name)
    n_bytes = (base.numel() + table.numel()) * base.element_size()
    bound_ms = 1e3 * n_bytes / mem_rate
    log("kernels", f"build_octa_table main shape {tuple(base.shape)} "
        f"{base.dtype}: {ms:.4f} ms, plain {plain_ms:.4f} ms, index_select "
        f"of the 8 corner ids {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({n_bytes} B at {mem_rate:.3g} B/s; no arithmetic)")

    with torch.no_grad():
        wide = table.index_select(0, octa_ids)
        if not torch.equal(wide, grid.GatherRowsOcta.apply(base, octa_ids)):
            raise AssertionError("prebuilt-table rows differ from the "
                                 "8-corner gather")
    wide_ms = cuda_ms(torch, lambda: table.index_select(0, octa_ids))
    corner_ms = cuda_ms(torch, lambda: grid.GatherRowsOcta.apply(
        base, octa_ids))
    log("kernels", f"wide gather of the step's {octa_ids.numel()} octa ids: "
        f"{wide_ms:.4f} ms from the prebuilt table, {corner_ms:.4f} ms for "
        "GatherRowsOcta's 8-corner forward (the same rows, bitwise)")
    return dict(name="build_octa_table", route="cuda",
                source="ndjir_torch/csrc/build_octa_table.cu",
                replaces="scripts/probe_build_variants.py:153",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=library_ms,
                bitwise_repeatable=True,
                wide_gather_ms=wide_ms, corner_gather_ms=corner_ms)


# ---------------------------------------------------------------------------
# phase 4: the training loss and gradients, card against CPU
# ---------------------------------------------------------------------------

# (extra overrides, loss rtol, monitor rtol, monitor atol, gradient
# tolerance as a share of each leaf's largest entry): the tolerances of the
# CPU tests against the JAX reference (tests/test_torch_slice.py,
# tests/test_torch_slice_bf16.py); a bf16 table's gradient also gets one
# bf16 ulp per entry, since its f32 sums are rounded once
PARITY = {
    "f32": ([], 1e-5, 1e-4, 1e-8, 1e-3),
    "a: bf16 grid": (["precision.grid_dtype=bfloat16"], 1e-5, 1e-4, 1e-8,
                     1e-3),
    "b: bf16 grid and MLP": (["precision.grid_dtype=bfloat16",
                              "precision.mlp_dtype=bfloat16"],
                             2e-3, 1e-2, 1e-6, 5e-2),
}


# the parity phases' grid: a small dense voxel grid on the default config
G48 = ("geometric_network.voxel.grid_size=48",)


def open_grid_rows(torch, params, conf, scale, seed=3):
    """Draw in place the weight rows that read the grid features (the last
    rows of layer 0 and of the skip layer, all zero under the geometric
    init) N(0, (scale * s)^2), s the std of the layer's other rows, so that
    the grid queries reach the loss, the view and the table's gradient."""
    from ndjir_torch.ops.grid import GridEncoding

    C = GridEncoding(conf.geometric_network.voxel).out_dim
    gen = torch.Generator().manual_seed(seed)
    for name, layer in params["geometric-network"].items():
        if not name.startswith("affine-") or layer["W"][-C:].any():
            continue
        W = layer["W"]
        s = W[:-C][W[:-C].any(dim=1)].std().item()
        W[-C:] = scale * s * torch.randn(W[-C:].shape, generator=gen)
    return params


def parity_phase(torch, np, label, config="default", base=G48, spec=None,
                 grid_rows=0.0):
    """Loss, monitors and every gradient leaf of one small batch (B=2, R=4)
    of ``config`` with ``base`` and the overrides of ``spec`` (default
    ``PARITY[label]``), on the CPU and on the card; the weight rows that
    read the grid drawn at ``grid_rows`` (:func:`open_grid_rows`) if it is
    not 0."""
    from ndjir_torch.config import load_config
    from ndjir_torch.models.fields import init_model
    from ndjir_torch.render.renderer import make_mc_cdfs
    from ndjir_torch.train.optim import tree_leaves_with_path, tree_map
    from ndjir_torch.train.trainer import loss_and_grads

    B, R = 2, 4
    extra, loss_rtol, mon_rtol, mon_atol, grad_tol = spec or PARITY[label]
    conf = load_config(config, overrides=[*base, *extra])
    rng = np.random.RandomState(7)
    camloc = np.tile(np.asarray([[0.1, -0.2, 2.5]], np.float32), (B, 1))
    raydir = rng.randn(B, R, 3).astype(np.float32) \
        - np.asarray([0.0, 0.0, 3.0], np.float32)
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    color = rng.rand(B, R, 3).astype(np.float32)
    mask = np.ones((B, R, 1), np.float32)
    batch = [torch.from_numpy(a) for a in (camloc, raydir, color, mask)]
    params = init_model(conf, seed=0, device="cpu")
    if grid_rows:
        open_grid_rows(torch, params, conf, grid_rows)
    cdfs = make_mc_cdfs(conf, B, R, device="cpu")

    def run(device):
        cd = {k: [u.to(device) for u in v] if isinstance(v, list)
              else v.to(device) for k, v in cdfs.items()}
        loss, mons, grads = loss_and_grads(
            tree_map(lambda v: v.to(device), params),
            *[a.to(device) for a in batch],
            0.37, 0.9, conf, cdfs=cd)
        return float(loss), {k: float(v) for k, v in mons.items()}, \
            {p: g.cpu() for p, g in tree_leaves_with_path(grads)}

    loss_c, mons_c, grads_c = run("cpu")
    loss_g, mons_g, grads_g = run("cuda")
    # sums taken in another order on the card, bf16 roundings where the
    # precision asks for them: the CPU tests' tolerances (PARITY)
    if not math.isclose(loss_g, loss_c, rel_tol=loss_rtol, abs_tol=0.0):
        raise AssertionError(f"{label}: loss {loss_g} on the card, "
                             f"{loss_c} on CPU")
    worst_mon = 0.0
    for k, v in mons_c.items():
        worst_mon = max(worst_mon, abs(mons_g[k] - v) / max(abs(v), 1e-30))
        if not math.isclose(mons_g[k], v, rel_tol=mon_rtol,
                            abs_tol=mon_atol):
            raise AssertionError(f"{label}: monitor {k}: {mons_g[k]} vs {v}")
    worst = 0.0
    for path, gc in grads_c.items():
        gg = grads_g[path]
        if gg.dtype != gc.dtype:
            raise AssertionError(f"{label}: gradient of {'/'.join(path)} "
                                 f"is {gg.dtype} on the card, {gc.dtype} "
                                 "on CPU")
        gc, gg = gc.double(), gg.double()
        scale = gc.abs().max().item()
        diff = (gg - gc).abs()
        worst = max(worst, diff.max().item() / (scale + 1e-12))
        ulp = bf16_ulp(torch, gc) if grads_c[path].dtype == torch.bfloat16 \
            else 0.0
        if not bool((diff <= ulp + grad_tol * scale + 1e-12).all()):
            raise AssertionError(f"{label}: gradient of {'/'.join(path)} "
                                 f"differs by {diff.max().item()} (leaf max "
                                 f"{scale})")
    v = conf.geometric_network.voxel
    log("parity", f"{label}, {v.type} G={v.grid_size} D={v.feature_size} "
        f"B={B} R={R}, grid rows at {grid_rows}: loss {loss_g:.7g} on the "
        f"card vs {loss_c:.7g} on CPU (rel {abs(loss_g / loss_c - 1):.3g}, "
        f"tol {loss_rtol}); {len(mons_c)} monitors, worst rel "
        f"{worst_mon:.3g} (tol {mon_rtol}); {len(grads_c)} gradient "
        f"leaves, worst |diff|/leaf max {worst:.3g} (tol {grad_tol})")


# (extra overrides, absolute tolerance of the image, the normal and the
# mask, SDF tolerance as a share of the volume's largest magnitude): the
# tolerances of the CPU tests against the JAX reference
# (tests/test_torch_render.py, tests/test_torch_extract.py)
RENDER_PARITY = {
    "f32": ([], (1e-4, 1e-4, 1e-4), 1e-5),
    "b: bf16 grid and MLP": (["precision.grid_dtype=bfloat16",
                              "precision.mlp_dtype=bfloat16"],
                             (5e-3, 5e-2, 5e-3), 2.0 ** -7),
}


def render_parity_phase(torch, np, label, devices=("cpu", "cuda"),
                        config="default", base=G48, spec=None, grid_rows=0.0):
    """A 16x16 view (64x64 at valid.n_down_samples=2, one chunk) and a 32^3
    SDF volume from the same parameters (``config`` with ``base`` and the
    overrides of ``spec``, default ``RENDER_PARITY[label]``; the grid's
    weight rows as :func:`parity_phase` draws them) on the CPU and on the
    card (``devices``).  Both renders draw the same Monte-Carlo uniforms
    (made on the CPU)."""
    from ndjir_torch.config import load_config
    from ndjir_torch.data.dataset import IDRDataset
    from ndjir_torch.data.synthetic import render_sphere_scene
    from ndjir_torch.extract.mc import compute_sdf_volume
    from ndjir_torch.models.fields import init_model
    from ndjir_torch.render import image
    from ndjir_torch.train.optim import tree_map

    extra, tols, sdf_tol = spec or RENDER_PARITY[label]
    conf = load_config(config, overrides=[*base, "valid.n_down_samples=2",
                                          *extra])
    images, masks, cameras = render_sphere_scene(n_views=2, H=64, W=64)
    ds = IDRDataset(conf, images, masks, cameras, train=False, shuffle=False)
    params = init_model(conf, seed=0, device="cpu")
    if grid_rows:
        open_grid_rows(torch, params, conf, grid_rows)
    P = min(conf.valid.n_rays, 16 * 16)
    cdfs = image.make_mc_cdfs(image.chunk_conf(conf), 1, P, device="cpu")

    def same_cdfs(conf, B, R, dtype=torch.float32, device="cuda"):
        return {k: [u.to(device) for u in v] if isinstance(v, list)
                else v.to(device) for k, v in cdfs.items()}
    real = image.make_mc_cdfs
    image.make_mc_cdfs = same_cdfs
    try:
        outs = [image.render_image(
            tree_map(lambda v: v.to(dev), params), ds.poses[:1],
            ds.intrinsics[:1], (64, 64), conf, return_aux=True)
            for dev in devices]
    finally:
        image.make_mc_cdfs = real
    diffs = []
    for name, c, g, tol in zip(("image", "normal", "mask"), *outs, tols):
        if c.shape != g.shape or not np.isfinite(g).all():
            raise AssertionError(f"{label}: {name} {g.shape} on the card, "
                                 f"{c.shape} on CPU, or not finite")
        d = float(np.abs(g - c).max())
        diffs.append(f"{name} {d:.3g} (tol {tol})")
        if not d <= tol:
            raise AssertionError(f"{label}: rendered {name} differs by {d}")
    vol = [compute_sdf_volume(tree_map(lambda v: v.to(dev), params), conf,
                              32) for dev in devices]
    scale = float(np.abs(vol[0]).max())
    d = float(np.abs(vol[1] - vol[0]).max())
    if not d <= sdf_tol * scale:
        raise AssertionError(f"{label}: SDF volume differs by {d}")
    v = conf.geometric_network.voxel
    log("parity", f"render {label}, {v.type} G={v.grid_size}, grid rows at "
        f"{grid_rows}, 16x16 view: "
        f"max |card - CPU| "
        f"{', '.join(diffs)}; 32^3 SDF volume {d:.3g} (tol "
        f"{sdf_tol * scale:.3g})")


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def make_trainer(torch, overrides=(), tag="monitor", config="default"):
    from ndjir_torch.config import load_config
    from ndjir_torch.data.dataset import IDRDataset
    from ndjir_torch.data.synthetic import render_sphere_scene
    from ndjir_torch.train.trainer import Trainer

    conf = load_config(config, overrides=[
        "valid.skip=true", "data_path=synthetic/sphere",
        f"monitor_base_path={os.path.join(OUT_DIR, tag)}", *overrides])
    images, masks, cameras = render_sphere_scene(n_views=16, H=128, W=128)
    ds = IDRDataset(conf, images, masks, cameras, train=True, shuffle=True)
    return Trainer(conf, dataset=ds, device="cuda", seed=0)


def step_ids(torch, trainer):
    """The corner ids of the first grid query of one training batch: what
    the step's scatter receives (N = 8 x B x R x samples)."""
    from ndjir_torch.ops.grid import voxel_corners
    from ndjir_torch.render.sampler import sample_points

    conf = trainer.conf
    camloc, raydir, _, _ = trainer.next_batch()
    cdfs = trainer.cdfs
    with torch.no_grad():
        x_fg = sample_points(trainer.params, camloc, raydir,
                             cdfs["stratified"], cdfs["background"], conf,
                             rand_u=cdfs["upsample"])[0]
        F = trainer.params["geometric-network"]["grid"]["F"]
        r = conf.renderer.bounding_sphere_radius
        ids, _ = voxel_corners(x_fg, F.shape, (-r,) * 3, (r,) * 3)
    if ids.numel() != MAIN_N or F.shape != (MAIN_G,) * 3 + (MAIN_D,):
        raise AssertionError(f"step ids {tuple(ids.shape)}, grid "
                             f"{tuple(F.shape)}: not the default config")
    return ids.reshape(-1)


def octa_step_ids(torch, trainer):
    """The octa row ids of x_fg and x_ptb of one production-path batch, in
    the order the step's one shared gather takes them."""
    from ndjir_torch.ops.grid import use_octa_layout, voxel_octa_ids
    from ndjir_torch.render.sampler import sample_points

    conf = trainer.conf
    camloc, raydir, _, _ = trainer.next_batch()
    cdfs = trainer.cdfs
    F = trainer.params["geometric-network"]["grid"]["F"]
    r = conf.renderer.bounding_sphere_radius
    with torch.no_grad():
        x_fg = sample_points(trainer.params, camloc, raydir,
                             cdfs["stratified"], cdfs["background"], conf,
                             rand_u=cdfs["upsample"])[0]
        x_ptb = x_fg + cdfs["perturb"] * (math.sqrt(3) * 2 * r / OCTA_G)
        ids = torch.cat([voxel_octa_ids(x, F.shape, (-r,) * 3,
                                        (r,) * 3).reshape(-1)
                         for x in (x_fg, x_ptb)])
    if ids.numel() != OCTA_N or F.shape != (OCTA_G,) * 3 + (OCTA_D,) \
            or not use_octa_layout(F.shape, F.dtype):
        raise AssertionError(f"octa ids {tuple(ids.shape)}, grid "
                             f"{tuple(F.shape)} {F.dtype}: not the "
                             "production path")
    return ids


def step_cotangent(torch, trainer):
    """The (8D, G^3) f32 cotangent one production-path step hands the fold:
    one loss and gradient with the fold's entry wrapped to keep a copy."""
    from ndjir_torch.ops import grid
    from ndjir_torch.train.trainer import loss_and_grads

    kept = []
    real = grid.fold_octa_cotangent

    def keep(cot_t, gshape, out_dtype):
        kept.append(cot_t.clone())
        return real(cot_t, gshape, out_dtype)
    grid.fold_octa_cotangent = keep
    try:
        loss_and_grads(trainer.params, *trainer.next_batch(), 0.0, 1.0,
                       trainer.conf, cdfs=trainer.cdfs)
    finally:
        grid.fold_octa_cotangent = real
    if len(kept) != 1:
        raise AssertionError(f"{len(kept)} folds in one step, want 1")
    return kept[0]


def train_phase(torch, kernels, trainer, card_name, per_step):
    """Three epochs, the last at a learning rate above 0; ``per_step`` the
    launches of each kernel one step must make.  Returns (launches, ms of
    each epoch, peak bytes allocated)."""
    from ndjir_torch.train import schedules
    from ndjir_torch.train.optim import tree_leaves_with_path

    conf = trainer.conf
    iters = trainer.ds.iters_per_epoch
    epochs = 3
    # epoch e trains at the schedule of epoch e - 1 and epoch 0 at lr = 0;
    # the linear warmup starts from 0, so epoch 1 is at lr = 0 too
    lrs = [0.0] + [schedules.learning_rate(e - 1, trainer.lr_f_base, conf)
                   for e in range(1, epochs)]
    if lrs[-1] <= 0.0:
        raise AssertionError(f"learning rates {lrs}: no update to check")
    def snapshot():
        return {p: v.clone()
                for p, v in tree_leaves_with_path(trainer.params)}
    last = snapshot()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    epoch_ms, moved = [], []

    kernels.reset_launches()
    for epoch in range(epochs):
        t0 = time.perf_counter()
        trainer.train(stop_epoch=epoch + 1)
        torch.cuda.synchronize()
        epoch_ms.append(1e3 * (time.perf_counter() - t0))
        now = snapshot()
        moved.append(sum(not torch.equal(v, last[p]) for p, v in now.items()))
        last = now
    launches = dict(kernels.LAUNCHES)

    steps = epochs * iters
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    if len(hist) != steps:
        raise AssertionError(f"{len(hist)} steps recorded, {steps} run")
    for i, m in enumerate(hist):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad or not m["grads_finite"]:
            raise AssertionError(f"step {i}: non-finite {bad or 'grads'}")
    for e, (lr, n) in enumerate(zip(lrs, moved)):
        if n != (len(last) if lr > 0.0 else 0):
            raise AssertionError(f"epoch {e} at lr {lr}: {n} of {len(last)} "
                                 "parameter leaves moved")
    want = {k: n * steps for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    for e in range(epochs):
        losses = " ".join(f"{m['loss']:.6g}"
                          for m in hist[e * iters:(e + 1) * iters])
        log("train", f"epoch {e} (feature lr {lrs[e]:.3g}, {moved[e]} of "
            f"{len(last)} leaves moved): {iters} steps, "
            f"{epoch_ms[e] / iters:.1f} ms/step (host clock, synchronized), "
            f"losses {losses}")
    p = conf.precision
    log("train", f"G={conf.geometric_network.voxel.grid_size} grid "
        f"{p.grid_dtype}, MLP {p.mlp_dtype}, B={conf.train.batch_size} "
        f"R={conf.train.n_rays} {steps} steps: finite losses, launches "
        f"{launches}; peak memory allocated {peak} B "
        f"({peak / 2 ** 30:.2f} GiB) on {card_name}")
    return launches, epoch_ms, peak


def profile_phase(torch, trainer, name):
    """One more epoch under ``torch.profiler``: device time by kernel and
    the device's busy share of the wall time (written in full to ``name``
    in the output directory)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train(stop_epoch=trainer.start_epoch + 1)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    steps = trainer.ds.iters_per_epoch

    def self_us(e):
        return e.self_device_time_total
    # device-side events only: a CPU op's self device time repeats that of
    # the kernels it launched
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=self_us, reverse=True)
    busy_us = sum(self_us(e) for e in kernels)
    with open(os.path.join(OUT_DIR, name), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=80))
    if busy_us <= 0.0:
        log("profile", "the profiler recorded no device time: not measured")
        return
    log("profile", f"{steps} steps under the profiler: wall "
        f"{wall_us / 1e3 / steps:.1f} ms/step, device busy "
        f"{busy_us / 1e3 / steps:.1f} ms/step ({100 * busy_us / wall_us:.1f}"
        f"% of the wall time, idle {100 - 100 * busy_us / wall_us:.1f}%)")
    groups = (("scatter kernel", ("scatter_keys_kernel",
                                  "scatter_slab_starts_kernel",
                                  "scatter_slab_search_kernel",
                                  "scatter_plan_kernel",
                                  "scatter_add_rows_kernel",
                                  "scatter_fixup_kernel",
                                  "scatter_bucket_kernel",
                                  "scatter_bucket_combine_kernel")),
              ("fold kernel", ("fold_octa_cotangent_kernel",)),
              ("matmul", ("gemm", "Gemm")),
              ("sort", ("Sort", "sort")),
              ("gather/index", ("index", "Index", "gather")),
              ("reduction", ("reduce",)),
              ("elementwise", ("elementwise",)))
    shares = dict.fromkeys([g for g, _ in groups] + ["other"], 0.0)
    for e in kernels:
        name = next((g for g, keys in groups
                     if any(k in e.key for k in keys)), "other")
        shares[name] += self_us(e)
    log("profile", "device time by kind: " + ", ".join(
        f"{g} {v / 1e3 / steps:.2f} ms/step ({100 * v / busy_us:.1f}%)"
        for g, v in shares.items()))
    for e in kernels[:10]:
        log("profile", f"{100 * self_us(e) / busy_us:5.1f}% "
            f"{self_us(e) / 1e3 / steps:8.3f} ms/step x{e.count // steps:<5d}"
            f" {e.key[:90]}")


# ---------------------------------------------------------------------------
# phase 7: render, validate, extract
# ---------------------------------------------------------------------------

class Timed:
    """Replaces named functions of a module by wrappers that add their
    host time (ms; each ends in a device-to-host copy or host work, so the
    device is done) to ``self.ms``; ``restore()`` puts them back."""

    def __init__(self, module, names):
        self.module, self.ms, self.real = module, {}, {}
        for n in names:
            self.real[n] = getattr(module, n)
            setattr(module, n, self._wrap(n, self.real[n]))

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.ms[name] = self.ms.get(name, 0.0) \
                    + 1e3 * (time.perf_counter() - t0)
        return timed

    def restore(self):
        for n, fn in self.real.items():
            setattr(self.module, n, fn)


def expect_launches(kernels, label, want):
    got = dict(kernels.LAUNCHES)
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")
    return got


def check_meshes(label, dirname, prefix):
    """The six attribute OBJ files ``prefix``_<attr>_mesh00.obj, and the
    environment map, exist and are not empty; the base-color mesh has
    vertices and triangles and no "nan" or "inf" in its text.  Returns
    (OBJ bytes, vertices, triangles); the OBJ files (gigabytes at 512^3)
    are then deleted, the environment map kept."""
    from ndjir_torch.extract.mc import _ATTR_SPECS

    paths = [os.path.join(dirname, f"{prefix}_{attr}_mesh00.obj")
             for attr, _, _ in _ATTR_SPECS]
    png = os.path.join(dirname, "environment_map.png")
    for path in paths + [png]:
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            raise AssertionError(f"{label}: {path} missing or empty")
    with open(paths[0], "rb") as f:
        text = b"\n" + f.read()
    n_verts, n_faces = text.count(b"\nv "), text.count(b"\nf ")
    if n_verts == 0 or n_faces == 0 or b"nan" in text or b"inf" in text:
        raise AssertionError(f"{label}: {n_verts} vertices, {n_faces} "
                             "triangles, or a value not finite")
    del text
    n_bytes = sum(os.path.getsize(p) for p in paths)
    for path in paths:
        os.remove(path)
    return n_bytes, n_verts, n_faces


EXTRACT_STEPS = ["compute_sdf_volume", "mesh_from_volume",
                 "compute_vertex_attribute", "save_obj",
                 "extract_environment_map"]


def extract_times(t) -> str:
    return (f"SDF volume {t['compute_sdf_volume']:.1f} ms, marching cubes "
            f"(host) {t['mesh_from_volume']:.1f} ms, six attributes "
            f"{t['compute_vertex_attribute']:.1f} ms, OBJ text (host) "
            f"{t['save_obj']:.1f} ms, environment map "
            f"{t['extract_environment_map']:.1f} ms")


def render_phase(torch, np, kernels, trainer, path, card_name, full_extract):
    """``render_image`` of the validation view, then ``Trainer.validate``
    (render + PSNR + a rough-grid extraction), then, with
    ``full_extract``, one ``extract(train=False)`` at the config's
    ``extraction.grid_size``; launch counts set to 0 before and read
    after each call.  Returns the launches of the three calls, summed."""
    from ndjir_torch.extract import mc
    from ndjir_torch.render.image import render_image

    conf, ds = trainer.conf, trainer.ds
    builds = BUILDS_PER_CALL[path]
    none = dict.fromkeys(kernels.SOURCES, 0)
    per_call = dict(none, build_octa_table=builds)
    idx = conf.valid.index % ds.size
    dn = 2 ** conf.valid.n_down_samples
    n_chunks = -(-(ds.W // dn) * (ds.H // dn) // conf.valid.n_rays)
    total = dict(none)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    render_ms = []
    for _ in range(2):
        kernels.reset_launches()
        t0 = time.perf_counter()
        img = render_image(trainer.params, ds.poses[idx:idx + 1],
                           ds.intrinsics[idx:idx + 1], (ds.W, ds.H), conf)
        render_ms.append(1e3 * (time.perf_counter() - t0))
        add(expect_launches(kernels, f"{path} render_image", per_call))
        if img.shape != (1, 3, ds.H // dn, ds.W // dn) \
                or not np.isfinite(img).all():
            raise AssertionError(f"{path}: rendered image {img.shape} not "
                                 "finite or of the wrong shape")
    log("render", f"{path}: render_image {img.shape[3]}x{img.shape[2]} in "
        f"{n_chunks} chunks of {conf.valid.n_rays} rays, two calls: "
        + ", ".join(f"{ms:.1f} ms per image ({ms / n_chunks:.2f} ms per "
                    "chunk)" for ms in render_ms)
        + " (host clock, synchronized)")

    epoch = trainer.start_epoch
    timer = Timed(mc, EXTRACT_STEPS)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        trainer.validate(epoch)
    finally:
        timer.restore()
    validate_ms = 1e3 * (time.perf_counter() - t0)
    add(expect_launches(kernels, f"{path} validate",
                        {k: 2 * v for k, v in per_call.items()}))
    G = conf.extraction.rough_grid_size
    with open(trainer.monitor_psnr.fpath) as f:
        last = f.read().splitlines()[-1].split()
    if int(last[0]) != epoch or not math.isfinite(float(last[1])):
        raise AssertionError(f"{path}: PSNR series ends with {last}")
    n_bytes, n_verts, n_faces = check_meshes(
        f"{path} validate", trainer.monitor_path,
        f"model_{epoch:05d}_{G}grid_raw")
    png = os.path.join(trainer.monitor_image.dir, f"{epoch:06d}.png")
    if not os.path.getsize(png):
        raise AssertionError(f"{path}: {png} empty")
    log("render", f"{path}: validate (render + PSNR {float(last[1]):.4f} dB "
        f"+ {G}^3 extraction): {validate_ms:.1f} ms; "
        f"{extract_times(timer.ms)}; {n_verts} vertices, {n_faces} "
        f"triangles, {n_bytes} B of OBJ")

    if full_extract:
        out = os.path.join(OUT_DIR, f"extract_{path}")
        G = conf.extraction.grid_size
        timer = Timed(mc, EXTRACT_STEPS)
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            mc.extract(trainer.params, conf, out, "model", train=False)
        finally:
            timer.restore()
        extract_ms = 1e3 * (time.perf_counter() - t0)
        add(expect_launches(kernels, f"{path} extract", per_call))
        n_bytes, n_verts, n_faces = check_meshes(f"{path} extract", out,
                                                 f"model_{G}grid_raw")
        log("render", f"{path}: extract at {G}^3 ({G ** 3} points in "
            f"batches of {conf.extraction.batch_size}): {extract_ms:.1f} ms; "
            f"{extract_times(timer.ms)}; {n_verts} vertices, {n_faces} "
            f"triangles, {n_bytes} B of OBJ")

    peak = torch.cuda.max_memory_allocated()
    log("render", f"{path}: launches over these calls {total}; peak memory "
        f"allocated {peak} B ({peak / 2 ** 30:.2f} GiB, optimizer state "
        f"alive) on {card_name}")
    return total


# ---------------------------------------------------------------------------
# phase 8: checkpoint and resume
# ---------------------------------------------------------------------------

def checkpoint_phase(torch, trainer):
    """One more epoch with a checkpoint after it, then a fresh ``Trainer``
    (another seed) on the same monitor directory: it resumes at the next
    epoch with every parameter and optimizer leaf bitwise the saved one."""
    from ndjir_torch.train import trainer as ttrainer
    from ndjir_torch.train.checkpoint import latest_checkpoint
    from ndjir_torch.train.optim import tree_leaves_with_path

    conf = trainer.conf
    conf.train.checkpoint_interval_epochs = 1
    epoch = trainer.start_epoch
    timer = Timed(ttrainer, ["save_checkpoint", "load_checkpoint"])
    try:
        trainer.train(stop_epoch=epoch + 1)
        path = latest_checkpoint(trainer.ckpt_dir)
        if path is None or not path.endswith(f"ckpt_{epoch:07d}.msgpack"):
            raise AssertionError(f"checkpoint after epoch {epoch}: {path}")
        fresh = ttrainer.Trainer(conf, dataset=trainer.ds,
                                 device=trainer.device, seed=1)
    finally:
        timer.restore()
    if fresh.start_epoch != epoch + 1:
        raise AssertionError(f"resumed at epoch {fresh.start_epoch}, want "
                             f"{epoch + 1}")
    n = 0
    for name in ("params", "mu", "nu"):
        a = trainer.params if name == "params" else trainer.opt_state[name]
        b = fresh.params if name == "params" else fresh.opt_state[name]
        for (p, x), (q, y) in zip(tree_leaves_with_path(a),
                                  tree_leaves_with_path(b)):
            if p != q or x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"{name} {'/'.join(p)} differs after "
                                     "the resume")
            n += 1
    if fresh.opt_state["count"] != trainer.opt_state["count"]:
        raise AssertionError("optimizer step count differs after the resume")
    log("checkpoint", f"saved after epoch {epoch} ({os.path.getsize(path)} "
        f"B, {timer.ms['save_checkpoint']:.1f} ms) and resumed by a fresh "
        f"Trainer at epoch {fresh.start_epoch} "
        f"({timer.ms['load_checkpoint']:.1f} ms to load): {n} leaves and the "
        f"step count bitwise equal")
    del fresh
    shutil.rmtree(trainer.ckpt_dir)  # 689 MB; checked


# ---------------------------------------------------------------------------
# phase 9: the command line
# ---------------------------------------------------------------------------

# scene of the command-line phase: the in-memory scene of phases 5-8 as a
# DTU-style folder, and its 2-view copy for the production path's render
CLI_VIEWS, CLI_RES = 16, 128
CLI_CHAMFER = ["valid.dtumvs.downsample_density=0.01"]
CLI_GRID = 256  # extraction grid: the 512^3 one is timed in phase 7
CLI_EXTRACT = [f"extraction.grid_size={CLI_GRID}"]
# a DTU scan as IDR's preprocessed folders hold it: 49 views of 1600x1200
DTU_VIEWS, DTU_H, DTU_W = 49, 1200, 1600


def check_scene_folder(np, scene, n_views, res):
    """The folder decodes, with the port's PNG reader, bitwise to the
    in-memory scene of the same size, and its cameras are the same."""
    from ndjir_torch.data.synthetic import render_sphere_scene
    from ndjir_torch.utils.png import read_png

    images, masks, cameras = render_sphere_scene(n_views, res, res)
    for i in range(n_views):
        for sub, want in (("image", images[i]), ("mask", masks[i])):
            got = read_png(os.path.join(scene, sub, f"{i:06d}.png"))
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"{scene}/{sub}/{i:06d}.png does not "
                                     "decode to the scene's pixels")
    with np.load(os.path.join(scene, "cameras.npz")) as written:
        if sorted(written.files) != sorted(cameras) or not all(
                np.array_equal(written[k], v) for k, v in cameras.items()):
            raise AssertionError(f"{scene}/cameras.npz differs")


def read_series(path):
    """The values of a monitor ``.series.txt`` file; raises unless there
    is at least one and all are finite."""
    with open(path) as f:
        values = [float(line.split()[1]) for line in f if line.strip()]
    if not values or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{path}: {values}")
    return values


def chamfer_series(dirname, suffix):
    """The three Chamfer values in ``dirname`` (Data2STL, STL2Data, mean)
    of a mesh whose file name ends in ``_<suffix>.obj``."""
    return [read_series(os.path.join(
        dirname, f"Chamfer-Distance-{k}-{suffix}-filtered-02.series.txt"))[-1]
        for k in ("Data2STL", "STL2Data", "Mean")]


def remove_large(dirname):
    """Delete the meshes, point clouds and checkpoints under ``dirname``
    (checked, or of a failed run: gigabytes that no later phase reads).
    Returns the bytes deleted."""
    n = 0
    for top, _, names in os.walk(dirname):
        for name in names:
            if name.endswith((".obj", ".ply", ".msgpack")):
                n += os.path.getsize(os.path.join(top, name))
                os.remove(os.path.join(top, name))
    return n


def run_command(torch, kernels, times, path, command, argv, want,
                own_process=False):
    """``python -m ndjir_torch.cli <command> <argv>`` (in this process, so
    the launch counts can be read, unless ``own_process``), launch counts
    set to 0 before and read after, its host time (synchronized) into
    ``times``.  Raises unless the launches are exactly ``want``, every
    other kernel 0; returns them."""
    from ndjir_torch import cli

    kernels.reset_launches()
    t0 = time.perf_counter()
    if own_process:
        subprocess.run([sys.executable, "-m", "ndjir_torch.cli", command,
                        *argv], cwd=HERE, check=True, timeout=600)
    else:
        cli.main([command, *argv])
    torch.cuda.synchronize()
    times[f"{path} {command}"] = 1e3 * (time.perf_counter() - t0)
    got = dict(kernels.LAUNCHES)
    want = dict(dict.fromkeys(kernels.SOURCES, 0), **want)
    if got != want:
        raise AssertionError(f"{path} {command}: launches {got}, want "
                             f"{want}")
    return got


def cli_phase(torch, np, kernels, smi):
    """Phase 9 (see :func:`cli_commands`), whose large files are deleted
    whether it passes or fails."""
    root = os.path.join(OUT_DIR, "cli")
    shutil.rmtree(root, ignore_errors=True)
    try:
        return cli_commands(torch, np, kernels, smi, root)
    finally:
        log("cli", f"{remove_large(root)} B of meshes, point clouds and "
            "checkpoints deleted")


def cli_commands(torch, np, kernels, smi, root):
    """The port's entry points on DTU-style scene folders, as a user runs
    them: ``make-synthetic`` in a process of its own, then, in this
    process (so the launch counts can be read), ``train`` of the
    unmodified default config with the final validation's Chamfer hook,
    ``render``, ``eval-image``, ``extract`` and ``eval-chamfer``; then the
    production precision's ``train``, ``render`` of two views and
    ``extract``; last, the folder reader on a scan of DTU's size.  Launch
    counts set to 0 before and read after each command.  Returns the
    launches by command, per path."""
    from ndjir_torch import cli
    from ndjir_torch.data import dataset
    from ndjir_torch.extract.mc import _ATTR_SPECS
    from ndjir_torch.train import trainer as ttrainer
    from ndjir_torch.utils.mesh_io import save_ply_points

    scene = os.path.join(root, "DTU", "scan1")
    ref = os.path.join(root, "DTUMVS_ref")
    times, launches = {}, {"cli_default": {}, "cli_g256_bf16": {}}

    def run(path, command, argv, want, own_process=False):
        got = run_command(torch, kernels, times, path, command, argv, want,
                          own_process)
        if path in launches:
            launches[path][command] = got

    # the scene folder, written by the module entry point in a process of
    # its own, and the DTU-style reference: dense samples of its sphere
    run("cli", "make-synthetic", [scene, str(CLI_VIEWS), str(CLI_RES),
                                  str(CLI_RES)], {}, own_process=True)
    check_scene_folder(np, scene, CLI_VIEWS, CLI_RES)
    u = np.random.RandomState(0).randn(200_000, 3)
    os.makedirs(os.path.join(ref, "Points", "stl"))
    save_ply_points(os.path.join(ref, "Points", "stl", "stl001_total.ply"),
                    0.5 * u / np.linalg.norm(u, axis=1, keepdims=True))
    log("cli", f"make-synthetic {scene} {CLI_VIEWS} {CLI_RES} {CLI_RES} "
        f"(subprocess): {times['cli make-synthetic']:.1f} ms; every PNG "
        "decodes bitwise to render_sphere_scene's arrays; reference cloud "
        f"of 200,000 points on the r=0.5 sphere (no ObsMask file)")

    # the unmodified default config, its 1500-epoch schedule cut to 3
    # epochs of 4 steps, then the final checkpoint and the final validation
    # with the Chamfer hook.  The warm-up keeps its 22 epochs (1.5% of
    # 1500): cut in proportion it would vanish, and the second and third
    # epochs would train at the full rate, which leaves no surface
    mon = os.path.join(root, "default")
    monitor = f"{mon}_scan1"
    base = ["--config-name", "default", f"data_path={scene}",
            f"monitor_base_path={mon}"]
    timer = Timed(ttrainer, ["render_image", "extract_mesh_for_validation",
                             "evaluate_by_chamfer", "save_checkpoint"])
    load_timer = Timed(dataset, ["load_idr_folder"])
    try:
        run("cli_default", "train", base + [
            "train.epoch=3", "train.warmup_term_ratio=7.5",
            "valid.skip=false", "valid.epoch_interval=0",
            "valid.index=0", f"valid.dtumvs.ref_dir={ref}", *CLI_CHAMFER,
            *CLI_EXTRACT], {"scatter_add_rows": 24})
    finally:
        timer.restore()
        load_timer.restore()
    if not any(n.startswith("Chamfer") for n in os.listdir(monitor)):
        raise AssertionError("the final validation wrote no Chamfer series "
                             "(its reason is logged above)")
    d2s, s2d, mean = chamfer_series(monitor, "mesh00")
    for name in ("vis_001_d2s.ply", "vis_001_s2d.ply"):
        if not os.path.getsize(os.path.join(monitor, name)):
            raise AssertionError(f"{monitor}/{name} empty")
    losses = read_series(os.path.join(monitor, "Training-loss.series.txt"))
    if len(losses) != 12:
        raise AssertionError(f"{len(losses)} training losses, want 12")
    t = timer.ms
    validate_ms = sum(t[k] for k in ("render_image",
                                     "extract_mesh_for_validation",
                                     "evaluate_by_chamfer"))
    train_ms = (times["cli_default train"] - validate_ms
                - t["save_checkpoint"] - load_timer.ms["load_idr_folder"])
    log("cli", f"default train (12 steps, G=512 f32): "
        f"{times['cli_default train']:.1f} ms = folder read "
        f"{load_timer.ms['load_idr_folder']:.1f} + training and set-up "
        f"{train_ms:.1f} + final checkpoint {t['save_checkpoint']:.1f} + "
        f"final validation {validate_ms:.1f} (render "
        f"{t['render_image']:.1f}, {CLI_GRID}^3 extraction with mask "
        f"trimming {t['extract_mesh_for_validation']:.1f}, Chamfer "
        f"{t['evaluate_by_chamfer']:.1f} = "
        f"{100 * t['evaluate_by_chamfer'] / validate_ms:.1f}% of the "
        f"validation); Chamfer Data2STL {d2s:.6g}, STL2Data {s2d:.6g}, "
        f"mean {mean:.6g}; final losses {losses[-4:]}")
    ck = os.path.join(monitor, "checkpoints")

    run("cli_default", "render", base + [f"model_load_path={ck}"], {})
    rendered = sorted(os.listdir(os.path.join(monitor, "rendered")))
    if len(rendered) != 2 * CLI_VIEWS:
        raise AssertionError(f"{len(rendered)} rendered PNGs, want "
                             f"{2 * CLI_VIEWS}")
    run("cli", "eval-image", base, {})
    evals = {k: read_series(os.path.join(monitor,
                                             f"Eval-{k}.series.txt"))[-1]
             for k in ("psnr", "psnr_mask", "psnr_y", "psnr_y_mask", "ssim",
                       "ssim_mask")}
    log("cli", f"default render ({CLI_VIEWS} views at "
        f"{CLI_RES // 4}x{CLI_RES // 4}, and masked): "
        f"{times['cli_default render']:.1f} ms; eval-image "
        f"{times['cli eval-image']:.1f} ms: " + ", ".join(
            f"{k} {v:.6g}" for k, v in evals.items()))

    run("cli_default", "extract", base + [f"model_load_path={ck}",
                                          *CLI_EXTRACT], {})
    mesh = os.path.join(monitor,
                        f"mesh_{CLI_GRID}grid_raw_base_color_mesh00.obj")
    for attr, _, _ in _ATTR_SPECS:
        for kind in ("raw", "trimmed"):
            path = os.path.join(monitor, f"mesh_{CLI_GRID}grid_{kind}_{attr}"
                                "_mesh00.obj")
            if not os.path.getsize(path):
                raise AssertionError(f"{path} empty")
    vis = os.path.join(root, "eval_chamfer")
    os.makedirs(vis)
    run("cli", "eval-chamfer", base + [
        f"valid.dtumvs.mesh_path={mesh}", "valid.dtumvs.scan=scan1",
        f"valid.dtumvs.ref_dir={ref}", f"valid.dtumvs.vis_out_dir={vis}",
        *CLI_CHAMFER], {})
    e_d2s, e_s2d, e_mean = chamfer_series(vis, "mesh00")
    log("cli", f"default extract at {CLI_GRID}^3 (six attribute meshes, "
        f"raw and trimmed, environment map): "
        f"{times['cli_default extract']:.1f} ms;"
        f" eval-chamfer on its raw mesh {times['cli eval-chamfer']:.1f} ms:"
        f" Data2STL {e_d2s:.6g}, STL2Data {e_s2d:.6g}, mean {e_mean:.6g}")

    # the production precision: one epoch of 4 steps, then render of a
    # 2-view folder and one extraction from its checkpoint
    mon = os.path.join(root, "g256_bf16")
    monitor = f"{mon}_scan1"
    prod = ["--config-name", "default", f"monitor_base_path={mon}", *OCTA]
    run("cli_g256_bf16", "train", prod + [
        f"data_path={scene}", "train.epoch=1", "valid.skip=true"],
        {"scatter_add_rows": 4, "fold_octa_cotangent": 4})
    ck = os.path.join(monitor, "checkpoints")
    two = os.path.join(root, "two_views", "scan1")
    cli.main(["make-synthetic", two, "2", str(CLI_RES), str(CLI_RES)])
    check_scene_folder(np, two, 2, CLI_RES)
    two_mon = os.path.join(root, "two_views", "g256_bf16")
    run("cli_g256_bf16", "render", prod + [
        f"data_path={two}", f"monitor_base_path={two_mon}",
        f"model_load_path={ck}"], {"build_octa_table": 2})
    run("cli_g256_bf16", "extract", prod + [
        f"data_path={scene}", f"model_load_path={ck}", *CLI_EXTRACT],
        {"build_octa_table": 1})
    log("cli", f"g256_bf16 train (4 steps): "
        f"{times['cli_g256_bf16 train']:.1f} ms; render of 2 views "
        f"{times['cli_g256_bf16 render']:.1f} ms; extract at {CLI_GRID}^3 "
        f"{times['cli_g256_bf16 extract']:.1f} ms")

    # the folder reader at the size of a DTU scan's views: the reader undoes
    # the row filters one anti-diagonal at a time whatever filters a file
    # uses, so its time per view does not depend on the content
    dtu = os.path.join(root, "dtu_size", "scan1")
    cli.main(["make-synthetic", dtu, str(DTU_VIEWS), str(DTU_H), str(DTU_W)])
    t0 = time.perf_counter()
    images, masks, _ = dataset.load_idr_folder(dtu)
    read_ms = 1e3 * (time.perf_counter() - t0)
    if images.shape != (DTU_VIEWS, DTU_H, DTU_W, 3) or \
            masks.shape != (DTU_VIEWS, DTU_H, DTU_W):
        raise AssertionError(f"{dtu}: {images.shape}, {masks.shape}")
    times["load_idr_folder at DTU size"] = read_ms
    log("cli", f"load_idr_folder of {DTU_VIEWS} views at {DTU_W}x{DTU_H} "
        f"(image and mask): {read_ms:.1f} ms, {read_ms / DTU_VIEWS:.1f} ms a "
        "view")
    shutil.rmtree(os.path.dirname(dtu))
    log("cli", "per command (host clock, synchronized; " + smi + "): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in times.items()))
    log("cli", f"launches by command {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the other grid encodings
# ---------------------------------------------------------------------------

# foreground points of one training step: B=4 x R=512 x (64 + 4 x 16)
STEP_POINTS = 4 * 512 * 128
TRIPLANE_ROWS, TRILINE_ROWS = 3 * 2048 ** 2, 3 * 2048
HASH_ROWS = 476_672  # the voxel_hash preset's (n_params / D, D) view
# preset -> (grid type, the scatters (B1) of one training step as
# (updates, D, rows), largest first).  Every gather of a query or of its
# TV map is one scatter: lanczos_voxel's 64-tap main and perturbed queries
# and its 4-corner TV; triplaneline's triplane (12 taps) and triline (6)
# queries at x_fg and x_ptb and its TV maps (9 and 6 corners);
# voxel_hash's 8 corners x 16 levels twice and its TV (4 x 16).
ENCODINGS = {
    "custom": ("lanczos_voxel",
               [(64 * STEP_POINTS, 4, 512 ** 3)] * 2
               + [(4 * STEP_POINTS, 4, 512 ** 3)]),
    "triplaneline": ("triplaneline",
                     [(12 * STEP_POINTS, 8, TRIPLANE_ROWS)] * 2
                     + [(9 * STEP_POINTS, 8, TRIPLANE_ROWS)]
                     + [(6 * STEP_POINTS, 8, TRILINE_ROWS)] * 3),
    "voxel_hash": ("voxel_hash",
                   [(128 * STEP_POINTS, 4, HASH_ROWS)] * 2
                   + [(64 * STEP_POINTS, 4, HASH_ROWS)]),
}

# the scales at which phase 10's parity checks draw the weight rows that
# read the grid (:func:`open_grid_rows`): (loss and gradients, view).  The
# grid's features change sharply from cell to cell (2,048 cells a plane,
# 7,005 at the hash's finest level), so once the grid reaches the network a
# sample position's ulp moves the result: on the CPU alone a 1-ulp shift of
# the camera moves the hash's rendered normal by more than its tolerance
# at every scale the grid is felt at, so its view is held with the rows
# closed (scripts/torch_grid_rows_sweep.py measures both on the card and
# the CPU)
GRID_ROWS = {"custom": (0.003, 0.01), "triplaneline": (0.1, 0.0003),
             "voxel_hash": (0.03, 0.0)}


def step_scatters(torch, scatter, trainer):
    """Every scatter (B1) of one real training step of ``trainer``, as
    (ids, values' shape, values' dtype, rows), in launch order."""
    from ndjir_torch.train.trainer import loss_and_grads

    kept, real = [], scatter.scatter_add_rows

    def keep(ids, vals, num_rows):
        kept.append((ids.clone(), vals.shape, vals.dtype, num_rows))
        return real(ids, vals, num_rows)
    scatter.scatter_add_rows = keep
    try:
        loss_and_grads(trainer.params, *trainer.next_batch(), 0.0, 1.0,
                       trainer.conf, cdfs=trainer.cdfs)
    finally:
        scatter.scatter_add_rows = real
    return kept


def encoding_scatters(torch, kernels, scatter, preset, card_name):
    """The preset's training path on the in-memory sphere: every scatter
    of one real step at its own ids, with N(0, 1) values (at
    initialisation the queries' cotangents are all zero: the weight rows
    that read the grid start at 0), each against its float64 plain sums,
    repeated bitwise, timed beside ``index_add_`` and its bound; then
    three epochs of 4 steps (:func:`train_phase`, the last moving every
    leaf) and one more under the profiler.
    Returns (scatter records, ms per step, peak bytes)."""
    grid_type, want = ENCODINGS[preset]
    trainer = make_trainer(torch, tag=f"monitor_{preset}", config=preset)
    if trainer.conf.geometric_network.voxel.type != grid_type:
        raise AssertionError(f"{preset}: grid type "
                             f"{trainer.conf.geometric_network.voxel.type}")
    kept = step_scatters(torch, scatter, trainer)
    shapes = sorted(((ids.numel(), shape[1], n)
                     for ids, shape, _, n in kept), reverse=True)
    if shapes != want:
        raise AssertionError(f"{preset}: one step's scatters {shapes}, want "
                             f"{want}")
    records = []
    for i, (ids, shape, dtype, rows) in enumerate(kept):
        counts = torch.unique(ids, return_counts=True)[1]
        vals = _rand(torch, 10 + i)[0](*shape, dtype)
        r = scatter_timings(torch, scatter, f"{preset}-{i}", ids, vals, rows,
                            False, card_name)
        del vals
        records.append(dict(
            preset=preset, grid=grid_type, launch=i, n=ids.numel(),
            d=shape[1], rows=rows, distinct_rows=counts.numel(),
            max_updates_per_row=counts.max().item(),
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms", "kernel_ms",
                                 "sort_ms", "path")}))
    del kept
    torch.cuda.empty_cache()

    launches, epoch_ms, peak = train_phase(
        torch, kernels, trainer, card_name,
        dict(dict.fromkeys(kernels.SOURCES, 0), scatter_add_rows=len(want)))
    ms_step = epoch_ms[-1] / trainer.ds.iters_per_epoch
    log("encodings", f"{preset} ({grid_type}): launches {launches}; epoch 2 "
        f"{ms_step:.1f} ms/step (host clock, synchronized); peak memory "
        f"allocated {peak} B ({peak / 2 ** 30:.2f} GiB) on {card_name}")
    profile_phase(torch, trainer, f"profile_{preset}.txt")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return records, ms_step, peak


def encoding_phase(torch, np, kernels, scatter, card_name, smi):
    """Phase 10 (see :func:`encoding_commands`), whose large files are
    deleted whether it passes or fails."""
    root = os.path.join(OUT_DIR, "encodings")
    shutil.rmtree(root, ignore_errors=True)
    try:
        return encoding_commands(torch, np, kernels, scatter, card_name,
                                 smi, root)
    finally:
        log("encodings", f"{remove_large(root)} B of meshes and checkpoints "
            "deleted")


def encoding_commands(torch, np, kernels, scatter, card_name, smi, root):
    """The presets of the other grid encodings at their published widths:
    per preset, the B1 checks and timings at one real step's shapes and
    three in-memory epochs and a profiled one (:func:`encoding_scatters`);
    the loss, every gradient leaf, a rendered view and an SDF volume on the
    card against the CPU at f32 (B=2, R=4, the preset's own tables, the
    weight rows that read them drawn at ``GRID_ROWS``); then
    ``cli train`` of one
    epoch of 4 steps on a 16-view folder, with its exact B1 launches and
    finite losses.  Last ``cli render`` of 2 views and ``cli extract`` at
    256^3 of triplaneline, which launch no kernel: no backward, and no
    octa table for these leaves.  Returns (scatter records, launches by
    command per preset path)."""
    from ndjir_torch import cli

    records, launches, summary = [], {}, []
    for preset in ENCODINGS:
        t0 = time.perf_counter()
        recs, ms_step, peak = encoding_scatters(torch, kernels, scatter,
                                                preset, card_name)
        records += recs
        rows, view_rows = GRID_ROWS[preset]
        parity_phase(torch, np, f"{preset} f32", config=preset, base=(),
                     spec=PARITY["f32"], grid_rows=rows)
        render_parity_phase(torch, np, f"{preset} f32", config=preset,
                            base=(), spec=RENDER_PARITY["f32"],
                            grid_rows=view_rows)
        gc.collect()
        torch.cuda.empty_cache()
        summary.append(f"{preset} {ms_step:.1f} ms/step, peak "
                       f"{peak / 2 ** 30:.2f} GiB")
        log("encodings", f"{preset}: kernels, training and parity in "
            f"{time.perf_counter() - t0:.1f} s")

    times = {}

    def run(path, command, argv, want):
        launches.setdefault(path, {})[command] = run_command(
            torch, kernels, times, path, command, argv, want)

    scene = os.path.join(root, "scene", "scan1")
    two = os.path.join(root, "two_views", "scan1")
    cli.main(["make-synthetic", scene, str(CLI_VIEWS), str(CLI_RES),
              str(CLI_RES)])
    cli.main(["make-synthetic", two, "2", str(CLI_RES), str(CLI_RES)])
    for preset, (_, per_step) in ENCODINGS.items():
        mon = os.path.join(root, preset)
        path = f"cli_{preset}"
        base = ["--config-name", preset, f"monitor_base_path={mon}"]
        run(path, "train", base + [f"data_path={scene}", "train.epoch=1",
                                   "valid.skip=true"],
            {"scatter_add_rows": 4 * len(per_step)})
        losses = read_series(os.path.join(f"{mon}_scan1",
                                          "Training-loss.series.txt"))
        if len(losses) != 4:
            raise AssertionError(f"{path}: {len(losses)} losses, want 4")
        log("encodings", f"{path} train (4 steps): "
            f"{times[f'{path} train']:.1f} ms, losses {losses}")
        if preset != "triplaneline":
            remove_large(f"{mon}_scan1")
            continue
        ck = os.path.join(f"{mon}_scan1", "checkpoints")
        run(path, "render", base + [
            f"data_path={two}", f"monitor_base_path={mon}_two",
            f"model_load_path={ck}"], {})
        rendered = os.listdir(os.path.join(f"{mon}_two_scan1", "rendered"))
        if len(rendered) != 4:
            raise AssertionError(f"{path} render: {len(rendered)} PNGs, "
                                 "want 4")
        run(path, "extract", base + [f"data_path={scene}",
                                     f"model_load_path={ck}", *CLI_EXTRACT],
            {})
        n_bytes, n_verts, _ = check_meshes(
            f"{path} extract", f"{mon}_scan1", f"mesh_{CLI_GRID}grid_raw")
        log("encodings", f"{path} render of 2 views "
            f"{times[f'{path} render']:.1f} ms; extract at {CLI_GRID}^3 "
            f"{times[f'{path} extract']:.1f} ms ({n_verts} vertices, "
            f"{n_bytes} B of raw OBJ); no kernel launched")
    log("encodings", "per preset (" + smi + "): " + "; ".join(summary))
    log("encodings", "per command (host clock, synchronized): " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in times.items()))
    return records, launches


# ---------------------------------------------------------------------------
# phase 11: the opt-ins and the parallel package
# ---------------------------------------------------------------------------

# the coarse-grid proposal, its G_c=64 snapshot refreshed every 4 steps
COARSE = ["renderer.proposal_method=coarse_grid",
          "renderer.proposal_refresh_interval=4"]
# every n-th lattice point of the snapshot is computed on the CPU too
SNAPSHOT_STRIDE = 8
# a full-width step's loss, monitors and gradients computed twice on the
# card: a rematerialized head, or a sum over a group of one, repeats the
# same float32 operations; held to this share of each leaf's largest entry
# (and the loss to this relative error), and reported bitwise or not
REPEAT_TOL = 1e-6


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _compare_steps(torch, a, b, label):
    """(loss, monitors, grads) of two runs of one step: the largest error
    of each against ``REPEAT_TOL``; returns whether they are bitwise."""
    from ndjir_torch.train.optim import tree_leaves_with_path

    (la, ma, ga), (lb, mb, gb) = a, b
    bitwise = torch.equal(la, lb)
    if abs(la.item() - lb.item()) > REPEAT_TOL * abs(lb.item()):
        raise AssertionError(f"{label}: loss {la.item()} vs {lb.item()}")
    for k in mb:
        if abs(ma[k].item() - mb[k].item()) > REPEAT_TOL * abs(mb[k].item()) \
                + 1e-12:
            raise AssertionError(f"{label}: monitor {k} {ma[k].item()} vs "
                                 f"{mb[k].item()}")
        bitwise = bitwise and torch.equal(ma[k], mb[k])
    worst = 0.0
    for (path, x), (_, y) in zip(tree_leaves_with_path(ga),
                                 tree_leaves_with_path(gb)):
        scale = y.abs().max().item()
        err = (x - y).abs().max().item()
        if err > REPEAT_TOL * scale:
            raise AssertionError(f"{label}: gradient {'/'.join(path)} "
                                 f"differs by {err} (largest {scale})")
        worst = max(worst, err / scale if scale else 0.0)
        bitwise = bitwise and torch.equal(x, y)
    return bitwise, worst


def coarse_grid_phase(torch, kernels, card_name, net_ms_step):
    """The coarse-grid proposal at the default widths: three epochs of 4
    steps with the G_c=64 snapshot refreshed before steps 0, 4 and 8 (exactly
    2 B1 a step, none in a snapshot: it is built under ``no_grad``), then
    the trained network's snapshot on the card against the same lattice
    points on the CPU.  Returns (launches, ms/step of epoch 2)."""
    from ndjir_torch.models.fields import geometric_apply
    from ndjir_torch.render import sampler
    from ndjir_torch.train import trainer as ttrainer
    from ndjir_torch.train.optim import tree_map

    trainer = make_trainer(torch, COARSE, tag="monitor_coarse_grid")
    conf = trainer.conf
    Gc = conf.renderer.proposal_grid_size
    refreshes, steps = [], []
    real, real_step = ttrainer.make_proposal_grid, ttrainer.train_step

    def counted(params, c):
        refreshes.append(len(steps))
        return real(params, c)

    def step(*a, **k):
        steps.append(1)
        return real_step(*a, **k)
    ttrainer.make_proposal_grid, ttrainer.train_step = counted, step
    try:
        launches, epoch_ms, peak = train_phase(
            torch, kernels, trainer, card_name, STEP_LAUNCHES["default"])
    finally:
        ttrainer.make_proposal_grid, ttrainer.train_step = real, real_step
    iters = trainer.ds.iters_per_epoch
    want = list(range(0, 3 * iters, conf.renderer.proposal_refresh_interval))
    if refreshes != want or trainer.proposal_grid is None:
        raise AssertionError(f"snapshots refreshed before steps {refreshes}"
                             f", want {want}")

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = sampler.make_proposal_grid(trainer.params, conf)
    torch.cuda.synchronize()
    snap_ms = 1e3 * (time.perf_counter() - t0)
    expect_launches(kernels, "snapshot", dict.fromkeys(kernels.SOURCES, 0))
    if snap.shape != (Gc,) * 3 + (1,) or snap.requires_grad \
            or not bool(torch.isfinite(snap).all()):
        raise AssertionError(f"snapshot {tuple(snap.shape)}")
    geo = tree_map(lambda t: t.cpu(), trainer.params["geometric-network"])
    r = conf.renderer.bounding_sphere_radius
    lin = torch.linspace(-r, r, Gc)
    pts = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"),
                      dim=-1).reshape(-1, 3)[::SNAPSHOT_STRIDE]
    with torch.no_grad():
        cpu = geometric_apply(geo, pts, conf)[0].reshape(-1)
    card = snap.reshape(-1)[::SNAPSHOT_STRIDE].cpu()
    err = (card - cpu).abs().max().item()
    scale = cpu.abs().max().item()
    if err > 1e-5 * scale + 1e-6:
        raise AssertionError(f"snapshot card vs CPU: {err} (largest "
                             f"{scale})")
    ms = epoch_ms[-1] / iters
    log("opt-ins", f"coarse_grid: snapshots refreshed before steps "
        f"{refreshes}; G_c={Gc} snapshot of the trained network "
        f"{snap_ms:.1f} ms, 0 launches, {pts.shape[0]} lattice points card "
        f"vs CPU within {err:.3g} (largest |sdf| {scale:.3g}); epoch 2 "
        f"{ms:.1f} ms/step (network proposals, phase 5: {net_ms_step:.1f}); "
        f"peak {peak / 2 ** 30:.2f} GiB on {card_name}")
    del trainer, snap, geo
    gc.collect()
    torch.cuda.empty_cache()
    return launches, ms


def remat_phase(torch, card_name):
    """One full-width step's loss and gradients with ``remat_heads`` on and
    off, in turns (off, on, on, off, off, on), after a warm-up step of
    each: the two agree to ``REPEAT_TOL``; ms and peak memory of each."""
    from ndjir_torch.train.trainer import loss_and_grads

    trainer = make_trainer(torch, tag="monitor_remat")
    conf = trainer.conf
    batch = trainer.next_batch()
    for remat in (False, True):
        conf.train.remat_heads = remat
        loss_and_grads(trainer.params, *batch, 0.5, 1.0, conf,
                       cdfs=trainer.cdfs)
    kept, ms, peak = {}, {False: [], True: []}, {}
    for remat in (False, True, True, False, False, True):
        conf.train.remat_heads = remat
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = loss_and_grads(trainer.params, *batch, 0.5, 1.0, conf,
                             cdfs=trainer.cdfs)
        torch.cuda.synchronize()
        ms[remat].append(1e3 * (time.perf_counter() - t0))
        # the step's own peak, above what was allocated before it (the
        # parameters, moments and the other run's kept gradients)
        peak[remat] = max(peak.get(remat, 0),
                          torch.cuda.max_memory_allocated() - before)
        kept.setdefault(remat, out)
        del out
    bitwise, worst = _compare_steps(torch, kept[True], kept[False],
                                    "remat_heads")
    log("opt-ins", f"remat_heads: loss {kept[True][0].item():.9g} and every "
        f"gradient leaf against no remat: "
        f"{'bitwise equal' if bitwise else f'within {worst:.3g} of the largest entry'}"
        f"; the step's peak above its inputs {peak[True] / 2 ** 30:.2f} GiB "
        f"(no remat {peak[False] / 2 ** 30:.2f}, saved "
        f"{(peak[False] - peak[True]) / 2 ** 30:.2f}); step "
        f"{' '.join(f'{t:.1f}' for t in ms[True])} ms (no remat "
        f"{' '.join(f'{t:.1f}' for t in ms[False])}) on {card_name}")
    del trainer, kept
    gc.collect()
    torch.cuda.empty_cache()
    return peak, ms


def fresh_seeds_phase(torch, kernels, card_name):
    """``fixed_graph_seeds: false``: three epochs drawing every step's
    uniforms anew, all losses finite, exactly 2 B1 a step."""
    trainer = make_trainer(torch, ["renderer.fixed_graph_seeds=false"],
                           tag="monitor_fresh_seeds")
    if trainer.cdfs is not None:
        raise AssertionError("fresh seeds: the trainer cached a draw")
    launches, epoch_ms, _ = train_phase(torch, kernels, trainer, card_name,
                                        STEP_LAUNCHES["default"])
    ms = epoch_ms[-1] / trainer.ds.iters_per_epoch
    log("opt-ins", f"fixed_graph_seeds=false: {len(trainer.history)} "
        f"steps, fresh uniforms each, finite losses; epoch 2 {ms:.1f} "
        "ms/step")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches, ms


def multi_scene_phase(torch, kernels, card_name, one_scene_peak):
    """Two in-memory scenes (spheres of radius 0.5 and 0.4) in one
    ``MultiSceneTrainer`` at the default widths, three epochs of 4 steps
    (exactly 4 B1 a step), then its stacked checkpoint resumed by a fresh
    trainer, bitwise.  Returns (launches, ms per scene-step, peak)."""
    from ndjir_torch.config import load_config
    from ndjir_torch.data.dataset import IDRDataset
    from ndjir_torch.data.synthetic import render_sphere_scene
    from ndjir_torch.parallel import multi_scene
    from ndjir_torch.train.optim import tree_leaves_with_path

    S, epochs = 2, 3
    base = os.path.join(OUT_DIR, "monitor_multi")
    conf = load_config("default", overrides=[
        "valid.skip=true", f"monitor_base_path={base}",
        f"train.epoch={epochs}", "train.checkpoint_interval_epochs=0",
        "train.keep_checkpoints=1"])
    scenes = [render_sphere_scene(n_views=16, H=128, W=128,
                                  radius=0.5 - 0.1 * i) for i in range(S)]

    def datasets():
        return [IDRDataset(conf, *sc, train=True, shuffle=True)
                for sc in scenes]
    names = [os.path.join(OUT_DIR, "multi", f"sphere{i}") for i in range(S)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mt = multi_scene.MultiSceneTrainer(conf, names, datasets=datasets())
    state = sum(t.numel() * t.element_size() + 8 * t.numel()
                for p in mt.params for _, t in tree_leaves_with_path(p))
    log("multi-scene", f"reckoned peak: {S} scenes' parameters and Adam "
        f"moments {state / 2 ** 30:.2f} GiB beside one scene's step "
        f"(phase 5's peak, its own state included: "
        f"{one_scene_peak / 2 ** 30:.2f} GiB), ~"
        f"{(one_scene_peak + state / S * (S - 1)) / 2 ** 30:.2f} GiB of 80")
    step_ms = []
    real = multi_scene.multi_scene_train_step

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        return out
    multi_scene.multi_scene_train_step = timed
    kernels.reset_launches()
    try:
        t0 = time.perf_counter()
        history = mt.train()
        train_s = time.perf_counter() - t0
    finally:
        multi_scene.multi_scene_train_step = real
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    iters = min(ds.iters_per_epoch for ds in mt.datasets)
    steps = epochs * iters
    want = dict.fromkeys(kernels.SOURCES, 0)
    want["scatter_add_rows"] = 2 * S * steps
    if launches != want:
        raise AssertionError(f"multi-scene launches {launches}, want {want}")
    if len(history) != steps or any(
            not m["grads_finite"] or not math.isfinite(m["loss"])
            for mons in history for m in mons):
        raise AssertionError("multi-scene: a step non-finite or missing")
    last = step_ms[-iters:]
    per_scene = sum(last) / len(last) / S

    t0 = time.perf_counter()
    fresh = multi_scene.MultiSceneTrainer(conf, names, datasets=datasets())
    load_s = time.perf_counter() - t0
    if fresh.start_epoch != epochs:
        raise AssertionError(f"resumed at epoch {fresh.start_epoch}")
    n = 0
    for i in range(S):
        if fresh.opt_states[i]["count"] != mt.opt_states[i]["count"]:
            raise AssertionError(f"scene {i}: step count after the resume")
        for a, b in ((mt.params[i], fresh.params[i]),
                     (mt.opt_states[i]["mu"], fresh.opt_states[i]["mu"]),
                     (mt.opt_states[i]["nu"], fresh.opt_states[i]["nu"])):
            for (p, x), (_, y) in zip(tree_leaves_with_path(a),
                                      tree_leaves_with_path(b)):
                if not torch.equal(x, y):
                    raise AssertionError(f"scene {i} {'/'.join(p)} differs "
                                         "after the resume")
                n += 1
    size = sum(os.path.getsize(os.path.join(mt.ckpt_dir, f))
               for f in os.listdir(mt.ckpt_dir))
    losses = " ".join(f"{m['loss']:.6g}" for m in history[-1])
    log("multi-scene", f"S={S}: {steps} steps in {train_s:.1f} s (the "
        f"final stacked checkpoint's save included), launches {launches}; "
        f"epoch 2 {per_scene:.1f} ms per scene-step (steps "
        f"{' '.join(f'{t:.1f}' for t in last)} ms); last losses {losses}; "
        f"peak {peak} B ({peak / 2 ** 30:.2f} GiB) on {card_name}")
    log("multi-scene", f"stacked checkpoint ({size} B) resumed by a fresh "
        f"trainer in {load_s:.1f} s at epoch {fresh.start_epoch}: {n} "
        "leaves and the step counts bitwise equal")
    del mt, fresh
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(f"{base}_multiscene")  # the stacked checkpoint; checked
    return launches, per_scene, peak


def nccl_phase(torch, card_name):
    """``initialize_distributed`` over NCCL at world size 1, then the
    sharded step's collectives on that group of one (the counts summed
    before the division, the gradients and monitors summed after, the
    global finite flag) against the plain step."""
    import torch.distributed as dist

    from ndjir_torch.parallel.mesh import ShardReducer
    from ndjir_torch.parallel.multi_scene import initialize_distributed
    from ndjir_torch.train.optim import apply_updates
    from ndjir_torch.train.trainer import loss_and_grads

    initialize_distributed(f"localhost:{_free_port()}", 1, 0,
                           device="cuda")
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"process group {dist.get_backend()}")
        trainer = make_trainer(torch, tag="monitor_nccl")
        conf = trainer.conf
        batch = trainer.next_batch()
        args = (trainer.params, *batch, 0.5, 1.0, conf)
        plain = loss_and_grads(*args, cdfs=trainer.cdfs)
        red = ShardReducer(None)
        loss, mons, grads = loss_and_grads(*args, cdfs=trainer.cdfs,
                                           reduce_counts=red.counts)
        sharded = (loss, red.monitors(mons), red.grads(grads))
        bitwise, worst = _compare_steps(torch, sharded, plain,
                                        "sharded step")
        if not apply_updates(trainer.params, sharded[2], trainer.opt_state,
                             1e-3, 1e-3, conf, group=red.group):
            raise AssertionError("sharded step: gradients not finite")
        log("nccl", f"initialize_distributed: backend "
            f"{dist.get_backend()}, world size {dist.get_world_size()}; the "
            f"sharded step (counts, gradients and monitors all-reduced, "
            f"global finite flag) against the plain step: "
            f"{'bitwise equal' if bitwise else f'within {worst:.3g}'}, "
            f"loss {loss.item():.9g}, update taken on {card_name}")
        del trainer, plain, sharded, grads
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()


def opt_ins_phase(torch, kernels, card_name, net_ms_step, one_scene_peak):
    """Phase 11.  Returns B1's launches by path and the phase's numbers."""
    launches, numbers = {}, {}
    launches["coarse_grid"], numbers["coarse_grid_ms_step"] = \
        coarse_grid_phase(torch, kernels, card_name, net_ms_step)
    numbers["remat_peak"], numbers["remat_ms"] = remat_phase(torch,
                                                             card_name)
    launches["fresh_seeds"], numbers["fresh_seeds_ms_step"] = \
        fresh_seeds_phase(torch, kernels, card_name)
    launches["multi_scene"], numbers["ms_per_scene_step"], \
        numbers["multi_scene_peak"] = multi_scene_phase(
            torch, kernels, card_name, one_scene_peak)
    nccl_phase(torch, card_name)
    return launches, numbers


def main() -> int:
    global OUT_DIR
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=OUT_DIR,
                        help="directory for the monitor files and the "
                        "profile (default: chip_smoke_out/ in the repo)")
    OUT_DIR = os.path.abspath(parser.parse_args().out)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "ndjir_torch")):
        print("chip_smoke: ndjir_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card_name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    log("device", f"{card_name}, {torch.cuda.device_count()} device(s), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from ndjir_torch import kernels
    from ndjir_torch.extract import native
    from ndjir_torch.ops import fold, grid, octa_build, scatter

    t0 = time.perf_counter()
    reports = kernels.build()
    for name, report in reports.items():
        lines = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln]
        log("build", f"{name}: {' | '.join(lines)}")
    log("build", f"{len(kernels.SOURCES)} kernel(s) ready in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    native.build()
    log("build", f"native mesh library ready in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    scatter_edge_cases(torch, scatter)
    fold_edge_cases(torch, fold)
    build_edge_cases(torch, octa_build)
    log("kernels", f"edge cases done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for label in PARITY:
        parity_phase(torch, np, label)
    for label in RENDER_PARITY:
        render_parity_phase(torch, np, label)
    log("parity", f"done in {time.perf_counter() - t0:.1f} s")

    # path 1: the default config
    t0 = time.perf_counter()
    trainer = make_trainer(torch, tag="monitor_default")
    main_ids = step_ids(torch, trainer)
    scatter_record = scatter_main_shape(torch, scatter, main_ids, card_name)
    del main_ids
    torch.cuda.empty_cache()
    log("kernels", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    default_launches, default_ms, default_peak = train_phase(
        torch, kernels, trainer, card_name, STEP_LAUNCHES["default"])
    launches = {"default": default_launches}
    net_ms_step = default_ms[-1] / trainer.ds.iters_per_epoch
    log("train", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    profile_phase(torch, trainer, "profile.txt")
    log("profile", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rendered = {"default": render_phase(torch, np, kernels, trainer,
                                        "default", card_name, False)}
    log("render", f"done in {time.perf_counter() - t0:.1f} s")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # path 2: the production precision, octa layout
    t0 = time.perf_counter()
    trainer = make_trainer(torch, OCTA, tag="monitor_g256_bf16")
    octa_ids = octa_step_ids(torch, trainer)
    scatter_record["at_octa_shape"] = scatter_octa_shape(
        torch, scatter, octa_ids, card_name)
    cot = step_cotangent(torch, trainer)
    fold_record = fold_main_shape(torch, fold, cot, card_name)
    del cot
    torch.cuda.empty_cache()
    log("kernels", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches["g256_bf16"] = train_phase(torch, kernels, trainer, card_name,
                                        STEP_LAUNCHES["g256_bf16"])[0]
    log("train", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    profile_phase(torch, trainer, "profile_g256_bf16.txt")
    log("profile", f"done in {time.perf_counter() - t0:.1f} s")

    # the octa build at the inference shape, on the trained table
    t0 = time.perf_counter()
    build_record = build_main_shape(
        torch, octa_build, grid,
        trainer.params["geometric-network"]["grid"]["F"], octa_ids,
        card_name)
    del octa_ids
    torch.cuda.empty_cache()
    log("kernels", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rendered["g256_bf16"] = render_phase(torch, np, kernels, trainer,
                                         "g256_bf16", card_name, True)
    log("render", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    checkpoint_phase(torch, trainer)
    log("checkpoint", f"done in {time.perf_counter() - t0:.1f} s")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cli_launches = cli_phase(torch, np, kernels, smi)
    log("cli", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    scatter_record["at_encoding_shapes"], enc_launches = encoding_phase(
        torch, np, kernels, scatter, card_name, smi)
    cli_launches.update(enc_launches)
    log("encodings", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    opt_launches, _ = opt_ins_phase(torch, kernels, card_name, net_ms_step,
                                    default_peak)
    log("opt-ins", f"done in {time.perf_counter() - t0:.1f} s")

    # main-path launches: the training steps' and the render, validation
    # and extraction calls', then each command's of the command line, then
    # phase 11's training paths'
    records = [scatter_record, fold_record, build_record]
    for r in records:
        by_path = {path: {"train": launches[path][r["name"]],
                          "render_validate_extract": rendered[path][r["name"]]}
                   for path in launches}
        for path, by_command in cli_launches.items():
            by_path[path] = {c: n[r["name"]] for c, n in by_command.items()}
        for path, n in opt_launches.items():
            by_path[path] = {"train": n[r["name"]]}
        r["launches"] = sum(sum(v.values()) for v in by_path.values())
        r["launches_by_path"] = by_path
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']} was never launched on the "
                                 "main path")
    log("total", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
