#!/usr/bin/env python3
"""Run the PyTorch + CUDA port (``ndjir_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Two paths are driven: the unmodified default config (G=512 f32 grid, f32
MLP; one scatter per differentiated grid query, two per step) and the
reference's production precision (``bench.py:204``: G=256 bf16 grid in
the octa layout, bf16 MLP operands; one scatter and one fold per step, and
one octa table build per ``render_image`` or ``extract`` call).  Phases,
each printing its lines as it goes:

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

Monitor files, rendered images, environment maps and the full profiles go
to ``--out`` (default ``chip_smoke_out/``); the meshes and the checkpoint
are deleted once checked.  The last two lines are the ``{"kernels": [...]}``
record and ``{"ok": true, "device": {...}}``.  Every check raises on
failure, so the script exits non-zero and prints neither; it does the same
when there is no CUDA device or ``ndjir_torch`` is not beside it.
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
    [0, num_rows) left out, as the kernel drops them; the kernel's slab
    pre-pass vs its plain version (``torch.searchsorted``), exactly.
    Returns the max abs error.  Tolerance: 1e-5 of the largest row sum for
    f32 outputs (the kernel's f32 sums of up to ~10^5 terms, taken in a
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
    ids32 = scatter.sort_updates(ids)[0]
    rows = scatter.slab_rows(vals.shape[1])
    starts = scatter.slab_starts(ids32, num_rows, rows)
    starts_ok = torch.equal(starts, scatter._slab_starts_plain(
        ids32, num_rows, rows))
    torch.cuda.synchronize()
    want_dtype = torch.float32 if transposed else vals.dtype
    if got.shape != want.shape or got.dtype != want_dtype:
        raise AssertionError(f"{label}: got {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} {want_dtype}")
    err = (got.double() - want).abs().max().item() if got.numel() else 0.0
    scale = max(1.0, want.abs().max().item() if want.numel() else 0.0)
    rel = 2.0 ** -7 if want_dtype == torch.bfloat16 else 1e-5
    repeatable = torch.equal(got, again)
    busy = int((starts[1:] != starts[:-1]).sum().item())
    log("kernels", f"scatter_add_rows {label}: N={ids.numel()} "
        f"D={vals.shape[1]} rows={num_rows} max_abs_err={err:.3g} "
        f"(tol {rel * scale:.3g}) bitwise_repeatable={repeatable}; "
        f"{busy} of {starts.numel() - 1} slabs of {rows} rows take updates, "
        f"pre-pass equal to searchsorted: {starts_ok}")
    if not err <= rel * scale:
        raise AssertionError(f"{label}: kernel disagrees with the plain "
                             f"version by {err}")
    if not repeatable:
        raise AssertionError(f"{label}: two runs differ")
    if not starts_ok:
        raise AssertionError(f"{label}: the slab pre-pass differs from "
                             "searchsorted")
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
    kernel's slab edges (256 rows at D=4, 64 at D=32) and of the TPU
    kernel's (4096); transposed output; bf16 values; a 20,000-update row at
    D=32, transposed, bf16."""
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
    edges = torch.tensor([0, 31, 32, 63, 64, 255, 256, 511, 512, 2047, 2048,
                          4095, 4096, 6143, 6144, 8191],
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
    ids32, perm = scatter.sort_updates(ids)
    ids64, vals32 = ids.long(), vals.float()

    def plain():
        out = scatter._scatter_add_rows_plain(ids, vals, num_rows)
        return out.t().contiguous() if transposed else out
    ms = cuda_ms(torch, lambda: fn(ids, vals, num_rows))
    sort_ms = cuda_ms(torch, lambda: scatter.sort_updates(ids))
    kernel_ms = cuda_ms(torch, lambda: scatter._launch(ids32, perm, vals,
                                                       num_rows, transposed))
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
        f"transposed={transposed}: {ms:.4f} ms (sort {sort_ms:.4f} + kernel "
        f"{kernel_ms:.4f}), plain {plain_ms:.4f} ms, index_add_ "
        f"{library_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"({n_bytes} B at {mem_rate:.3g} B/s)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms, kernel_ms=kernel_ms, sort_ms=sort_ms,
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


def parity_phase(torch, np, label):
    from ndjir_torch.config import load_config
    from ndjir_torch.models.fields import init_model
    from ndjir_torch.render.renderer import make_mc_cdfs
    from ndjir_torch.train.optim import tree_leaves_with_path, tree_map
    from ndjir_torch.train.trainer import loss_and_grads

    B, R = 2, 4
    extra, loss_rtol, mon_rtol, mon_atol, grad_tol = PARITY[label]
    conf = load_config("default", overrides=[
        "geometric_network.voxel.grid_size=48", *extra])
    rng = np.random.RandomState(7)
    camloc = np.tile(np.asarray([[0.1, -0.2, 2.5]], np.float32), (B, 1))
    raydir = rng.randn(B, R, 3).astype(np.float32) \
        - np.asarray([0.0, 0.0, 3.0], np.float32)
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    color = rng.rand(B, R, 3).astype(np.float32)
    mask = np.ones((B, R, 1), np.float32)
    batch = [torch.from_numpy(a) for a in (camloc, raydir, color, mask)]
    params = init_model(conf, seed=0, device="cpu")
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
    log("parity", f"{label}, G=48 B={B} R={R}: loss {loss_g:.7g} on the "
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


def render_parity_phase(torch, np, label, devices=("cpu", "cuda")):
    """A 16x16 view (64x64 at valid.n_down_samples=2, one chunk) and a 32^3
    SDF volume from the same G=48 parameters on the CPU and on the card
    (``devices``).  Both renders draw the same Monte-Carlo uniforms (made
    on the CPU)."""
    from ndjir_torch.config import load_config
    from ndjir_torch.data.dataset import IDRDataset
    from ndjir_torch.data.synthetic import render_sphere_scene
    from ndjir_torch.extract.mc import compute_sdf_volume
    from ndjir_torch.models.fields import init_model
    from ndjir_torch.render import image
    from ndjir_torch.train.optim import tree_map

    extra, tols, sdf_tol = RENDER_PARITY[label]
    conf = load_config("default", overrides=[
        "geometric_network.voxel.grid_size=48", "valid.n_down_samples=2",
        *extra])
    images, masks, cameras = render_sphere_scene(n_views=2, H=64, W=64)
    ds = IDRDataset(conf, images, masks, cameras, train=False, shuffle=False)
    params = init_model(conf, seed=0, device="cpu")
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
    log("parity", f"render {label}, G=48, 16x16 view: max |card - CPU| "
        f"{', '.join(diffs)}; 32^3 SDF volume {d:.3g} (tol "
        f"{sdf_tol * scale:.3g})")


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def make_trainer(torch, overrides=(), tag="monitor"):
    from ndjir_torch.config import load_config
    from ndjir_torch.data.dataset import IDRDataset
    from ndjir_torch.data.synthetic import render_sphere_scene
    from ndjir_torch.train.trainer import Trainer

    conf = load_config("default", overrides=[
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
    """Three epochs; ``per_step`` the launches of each kernel one step must
    make."""
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
    return launches


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
    groups = (("scatter kernel", ("scatter_add_rows_kernel",
                                  "scatter_slab_starts_kernel")),
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
    launches = {"default": train_phase(torch, kernels, trainer, card_name,
                                       STEP_LAUNCHES["default"])}
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
                                        STEP_LAUNCHES["g256_bf16"])
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

    # main-path launches: the training steps' and the render, validation
    # and extraction calls'
    records = [scatter_record, fold_record, build_record]
    for r in records:
        by_path = {path: {"train": launches[path][r["name"]],
                          "render_validate_extract": rendered[path][r["name"]]}
                   for path in launches}
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
