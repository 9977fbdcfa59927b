#!/usr/bin/env python3
"""Run the PyTorch + CUDA port (``ndjir_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Two training paths are driven: the unmodified default config (G=512 f32
grid, f32 MLP; one scatter per differentiated grid query, two per step)
and the reference's production precision (``bench.py:204``: G=256 bf16
grid in the octa layout, bf16 MLP operands; one scatter and one fold per
step).  Phases, each printing its lines as it goes:

1. device  -- the card, as ``nvidia-smi`` names it, with its power limit.
2. build   -- every hand-written kernel of ``ndjir_torch/csrc``, compiled
              with ``nvcc`` for sm_90a (one process per source, in parallel).
3. kernels -- each kernel's wrapper against its plain PyTorch version on the
              card: at the shapes each training path gives it and at edge
              cases; error, run-to-run repeatability, times and the bound.
4. parity  -- a small training loss and every parameter gradient on the card
              against the same computation on the CPU (the plain versions,
              which the CPU tests hold against the JAX reference), at f32
              and at the two bf16 precisions.
5. train   -- per path, the ``Trainer`` on an in-memory 16-view sphere
              scene for three epochs of four steps; the lagged, warmed-up
              schedule puts the first two at lr=0, so the third is the
              first to update.  Launch counts are set to 0 just before and
              read just after.
6. profile -- per path, one more epoch under ``torch.profiler``: device
              time by kernel and the device's busy share.

Monitor files and the full profiles go to ``--out`` (default
``chip_smoke_out/``).  The last two lines are the ``{"kernels": [...]}``
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
    in float64 (so exactly, to f32 precision); returns the max abs error.
    Tolerance: 1e-5 of the largest row sum for f32 outputs (the kernel's
    f32 sums of up to ~10^5 terms, taken in a fixed order, stay well inside
    it), one bf16 ulp (at most 2^-7 of the value) for bf16 outputs.  Both the kernel
    and the exact sums are deterministic, so the check is too."""
    fn = scatter.scatter_add_rows_t if transposed \
        else scatter.scatter_add_rows
    got = fn(ids, vals, num_rows)
    again = fn(ids, vals, num_rows)
    want = scatter._scatter_add_rows_plain(ids, vals, num_rows,
                                           acc_dtype=torch.float64)
    if transposed:
        want = want.t()
    torch.cuda.synchronize()
    want_dtype = torch.float32 if transposed else vals.dtype
    if got.shape != want.shape or got.dtype != want_dtype:
        raise AssertionError(f"{label}: got {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} {want_dtype}")
    err = (got.double() - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    rel = 2.0 ** -7 if want_dtype == torch.bfloat16 else 1e-5
    repeatable = torch.equal(got, again)
    log("kernels", f"scatter_add_rows {label}: N={ids.numel()} "
        f"D={vals.shape[1]} rows={num_rows} max_abs_err={err:.3g} "
        f"(tol {rel * scale:.3g}) bitwise_repeatable={repeatable}")
    if not err <= rel * scale:
        raise AssertionError(f"{label}: kernel disagrees with the plain "
                             f"version by {err}")
    if not repeatable:
        raise AssertionError(f"{label}: two runs differ")
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
    """Random ids; 700 updates to one row; the rows on either side of the
    kernel's slab edges at D=4 (2048-row slabs) and of the TPU kernel's
    (4096); D in {4, 8, 32}; transposed output; bf16 values."""
    dev = torch.device("cuda")
    randn, randint = _rand(torch, 0)
    check_scatter(torch, scatter, "random", randint(100_000, 65_536),
                  randn(65_536, 4), 100_000)
    hot = torch.cat([torch.full((700,), 1234, device=dev),
                     randint(9000, 500)])
    check_scatter(torch, scatter, "700-to-one-row", hot, randn(1200, 4), 9000)
    edges = torch.tensor([0, 2047, 2048, 4095, 4096, 8191],
                         device=dev).repeat_interleave(40)
    for d in (4, 8, 32):
        check_scatter(torch, scatter, f"slab-edges-d{d}", edges,
                      randn(edges.numel(), d), 8192)
    for d in (4, 32):
        check_scatter(torch, scatter, f"transposed-d{d}",
                      randint(50_001, 20_000), randn(20_000, d), 50_001,
                      transposed=True)
    check_scatter(torch, scatter, "bf16", randint(30_000, 10_000),
                  randn(10_000, 4, torch.bfloat16), 30_000)


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
    ids32, vals_s = scatter.sort_updates(ids, vals)
    ids64, vals32 = ids.long(), vals.float()

    def plain():
        out = scatter._scatter_add_rows_plain(ids, vals, num_rows)
        return out.t().contiguous() if transposed else out
    ms = cuda_ms(torch, lambda: fn(ids, vals, num_rows))
    sort_ms = cuda_ms(torch, lambda: scatter.sort_updates(ids, vals))
    kernel_ms = cuda_ms(torch, lambda: scatter._launch(ids32, vals_s,
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
                library_ms=library_ms, kernel_ms=kernel_ms, sort_ms=sort_ms)


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
    groups = (("scatter kernel", ("scatter_add_rows_kernel",)),
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
    from ndjir_torch.ops import fold, scatter

    t0 = time.perf_counter()
    reports = kernels.build()
    for name, report in reports.items():
        lines = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln]
        log("build", f"{name}: {' | '.join(lines)}")
    log("build", f"{len(kernels.SOURCES)} kernel(s) ready in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    scatter_edge_cases(torch, scatter)
    fold_edge_cases(torch, fold)
    log("kernels", f"edge cases done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for label in PARITY:
        parity_phase(torch, np, label)
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
    launches_default = train_phase(
        torch, kernels, trainer, card_name,
        {"scatter_add_rows": 2, "fold_octa_cotangent": 0})
    log("train", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    profile_phase(torch, trainer, "profile.txt")
    log("profile", f"done in {time.perf_counter() - t0:.1f} s")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # path 2: the production precision, octa layout
    t0 = time.perf_counter()
    trainer = make_trainer(torch, OCTA, tag="monitor_g256_bf16")
    octa_ids = octa_step_ids(torch, trainer)
    scatter_record["at_octa_shape"] = scatter_octa_shape(
        torch, scatter, octa_ids, card_name)
    del octa_ids
    cot = step_cotangent(torch, trainer)
    fold_record = fold_main_shape(torch, fold, cot, card_name)
    del cot
    torch.cuda.empty_cache()
    log("kernels", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches_octa = train_phase(
        torch, kernels, trainer, card_name,
        {"scatter_add_rows": 1, "fold_octa_cotangent": 1})
    log("train", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    profile_phase(torch, trainer, "profile_g256_bf16.txt")
    log("profile", f"done in {time.perf_counter() - t0:.1f} s")

    records = [scatter_record, fold_record]
    for r in records:
        by_path = {"default": launches_default[r["name"]],
                   "g256_bf16": launches_octa[r["name"]]}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
    log("total", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
