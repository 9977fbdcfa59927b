"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without an NVIDIA
GPU (the kernels have no CPU mode; on a CPU tensor a wrapper runs the plain
version, which the other ``test_torch_*`` files hold against the JAX
reference).  The file imports no JAX, so it also runs on a machine that has
only PyTorch: ``python3 -m pytest tests/test_torch_cuda.py -q``.
``chip_smoke.py`` runs the same comparison at the training step's shape;
the edge cases are held here alone.
"""

import numpy as np
import pytest
import torch

from ndjir_torch import kernels
from ndjir_torch.models.fields import affine_apply
from ndjir_torch.ops import fold, grid, octa_build
from ndjir_torch.ops import scatter
from ndjir_torch.ops.scatter import (
    _scatter_add_rows_plain,
    gather_rows,
    scatter_add_rows,
    scatter_add_rows_t,
)

torch.set_num_threads(2)

M = 8192


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(case, d, device):
    rng = np.random.RandomState(11)
    if case == "random":
        ids = rng.randint(0, M, 3000)
    elif case == "hot_row":     # a run far longer than a block has threads
        ids = np.concatenate([np.full(20_000, 4095), rng.randint(0, M, 300)])
    elif case == "heavy_slabs":  # like the triline gathers: every slab cut
        ids = rng.permutation(np.concatenate(
            [np.full(30_000, 300), rng.randint(0, 600, 40_000)]))
    elif case == "updates_over_rows":  # like the hash
        ids = rng.randint(0, 48, 60_000) * 170 + 7
    elif case == "outside_narrow":  # ids outside, aliasing the last rows
        ids = rng.permutation(np.concatenate([
            rng.randint(M - 300, M, 20_000), rng.randint(M, M + 300, 5000),
            rng.randint(-300, 0, 5000), np.full(50, -2 ** 31),
            np.full(50, 2 ** 31 - 1)]))
    else:                       # rows either side of the kernel's slabs
        ids = np.repeat([0, 31, 32, 63, 64, 127, 128, 255, 256, 4095, 4096,
                         8191], 25)
    vals = rng.randn(len(ids), d).astype(np.float32)
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(vals).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "hot_row", "slab_edges",
                                  "heavy_slabs", "updates_over_rows",
                                  "outside_narrow"])
@pytest.mark.parametrize("d", [4, 8, 32])
def test_scatter_kernel_matches_plain_version(cuda, case, d):
    ids, vals = _inputs(case, d, cuda)
    kernels.reset_launches()
    got = scatter_add_rows(ids, vals, M)
    again = scatter_add_rows(ids, vals, M)
    got_t = scatter_add_rows_t(ids, vals, M)
    assert kernels.LAUNCHES["scatter_add_rows"] == 3
    assert torch.equal(got, again)           # no atomics: bitwise repeatable
    want = _scatter_add_rows_plain(ids, vals, M, acc_dtype=torch.float64)
    # f32 sums in the kernel's fixed order against exact ones: 1e-5 of the
    # largest row sum (~150 for the 20000-update row)
    tol = 1e-5 * max(1.0, want.abs().max().item())
    assert (got.double() - want).abs().max().item() <= tol
    assert (got_t.double() - want.t()).abs().max().item() <= tol


def _edge_inputs(case, rng):
    """(ids, num_rows, D, transposed, values' dtype) of one edge case."""
    if case == "no_updates":
        return np.zeros(0, np.int64), 10_007, 32, True, torch.float32
    if case.startswith("no_updates_d"):
        return np.zeros(0, np.int64), 10_007, int(case[12:]), False, \
            torch.float32
    if case == "one_busy_slab":             # every slab empty but one
        rows = scatter.slab_rows(4)
        return 5 * rows + rng.randint(0, rows, 3000), 40 * rows + 3, 4, \
            False, torch.float32
    if case == "one_busy_slab_d32":
        rows = scatter.slab_rows(32)
        return 5 * rows + rng.randint(0, rows, 3000), 40 * rows + 3, 32, \
            True, torch.float32
    if case.startswith("ids_outside"):      # dropped, as XLA drops them
        ids = rng.randint(-5000, 65_000, 20_000)
        ids[::7] = 2 ** 31 - 1
        if case == "ids_outside":
            return ids, 60_001, 32, True, torch.float32
        return ids, 60_001, int(case[13:]), False, torch.float32
    if case.startswith("ragged_"):          # rows not a multiple of a slab
        transposed = case.startswith("ragged_t_d")
        return rng.randint(0, 30_011, 8000), 30_011, \
            int(case.split("_d")[1]), transposed, torch.float32
    if case == "bf16_d4":                   # bf16 values and output
        return rng.randint(0, 30_000, 10_000), 30_000, 4, False, \
            torch.bfloat16
    if case == "hot_row_d32_bf16":
        ids = np.concatenate([np.full(20_000, 4095),
                              rng.randint(0, 65_536, 5000)])
        return rng.permutation(ids), 65_536, 32, True, torch.bfloat16
    if case == "split_slab_d8":             # one slab over many pieces
        rows = scatter.slab_rows(8)
        return 3 * rows + rng.randint(0, rows, 400 * scatter.piece_size(8)), \
            10 * rows, 8, False, torch.float32
    if case.startswith("one_row_d"):        # every update to one row
        return np.full(300_000, 777), 6144, int(case[9:]), False, \
            torch.float32
    if case.startswith("outside_bits"):     # a 13- or 19-bit key range
        narrow = case.startswith("outside_bits13")
        num_rows = 6144 if narrow else 476_672
        ids = np.concatenate([rng.randint(num_rows - 100, num_rows, 8000),
                              rng.randint(-2000, 0, 2000),
                              num_rows + rng.randint(0, 1 << 20, 2000)])
        if "_d" in case:                    # f32, untransposed, any D
            return rng.permutation(ids), num_rows, int(case[16:]), False, \
                torch.float32
        return rng.permutation(ids), num_rows, 8 if narrow else 4, narrow, \
            torch.bfloat16 if narrow else torch.float32
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["no_updates", "one_busy_slab",
                                  "ids_outside", "ragged_d1", "ragged_d3",
                                  "ragged_d33", "hot_row_d32_bf16",
                                  "split_slab_d8", "one_row_d8", "one_row_d4",
                                  "outside_bits13", "outside_bits19",
                                  "no_updates_d4", "no_updates_d3",
                                  "one_busy_slab_d32", "ids_outside_d4",
                                  "ids_outside_d1", "ragged_t_d1",
                                  "ragged_t_d3", "ragged_t_d33", "bf16_d4",
                                  "outside_bits13_d4", "outside_bits13_d8",
                                  "outside_bits19_d8"])
def test_scatter_kernel_edge_cases(cuda, case):
    ids_np, num_rows, d, transposed, dtype = _edge_inputs(
        case, np.random.RandomState(21))
    rng = np.random.RandomState(22)
    ids = torch.from_numpy(ids_np).to(cuda)
    vals = torch.from_numpy(rng.randn(len(ids_np), d).astype(np.float32)) \
        .to(dtype).to(cuda)
    fn = scatter_add_rows_t if transposed else scatter_add_rows
    got, again = fn(ids, vals, num_rows), fn(ids, vals, num_rows)
    assert torch.equal(got, again)           # no atomics: bitwise repeatable
    keep = (ids >= 0) & (ids < num_rows)
    want = _scatter_add_rows_plain(ids[keep], vals[keep], num_rows,
                                   acc_dtype=torch.float64)
    want = want.t() if transposed else want
    # the transposed form sums into f32; the other returns the values' dtype
    out_dtype = torch.float32 if transposed else dtype
    assert got.shape == want.shape and got.dtype == out_dtype
    # f32 sums against exact ones; a bf16 output rounds them once (2^-7);
    # no floor: all-zero sums must come out exactly zero
    rel = 2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-5
    tol = rel * (want.abs().max().item() if want.numel() else 0.0)
    assert (got.double() - want).abs().max().item() <= tol
    if case == "no_updates":
        assert not got.any()
    _sort_and_plan_are_plain(ids, vals, num_rows, transposed)


def _sort_and_plan_are_plain(ids, vals, num_rows, transposed):
    """The sort, the slab pre-pass and the piece plan of one call, each
    against its plain version, exactly (the bucket path's where it takes
    the call)."""
    d = vals.shape[1]
    bits = 0 if transposed else scatter.bucket_bits(ids.numel(), vals,
                                                    num_rows)
    if bits:
        keys, moved = scatter.sort_by_bucket(ids, vals, num_rows, bits)
        plain = scatter._sort_by_bucket_plain(ids, vals, num_rows, bits)
        rows, piece, cut = 1 << bits, scatter._BUCKET_PIECE, 0
    else:
        keys, moved = scatter.sort_updates(ids, num_rows)
        plain = scatter._sort_updates_plain(ids, num_rows)
        rows, piece, cut = scatter.slab_rows(d), scatter.piece_size(d), None
    assert torch.equal(keys, plain[0]) and torch.equal(moved, plain[1])
    starts = scatter.slab_starts(keys, num_rows, rows, bits)
    plain_starts = scatter._slab_starts_plain(keys, num_rows, rows, bits)
    assert torch.equal(starts, plain_starts)
    assert torch.equal(scatter.piece_plan(keys, num_rows, rows, piece, cut,
                                          bits),
                       scatter._piece_plan_plain(plain_starts, piece, cut))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4, 32])
def test_slab_pre_pass_is_searchsorted(cuda, d):
    rng = np.random.RandomState(23)
    ids = np.concatenate([rng.randint(-50, 20_050, 6000),
                          np.full(500, 4100)])
    rows = scatter.slab_rows(d)
    for num_rows in (20_000, 4 * rows, 4 * rows + 1):
        ids32 = scatter.sort_updates(torch.from_numpy(ids).to(cuda),
                                     num_rows)[0]
        got = scatter.slab_starts(ids32, num_rows, rows)
        assert torch.equal(got, scatter._slab_starts_plain(ids32, num_rows,
                                                           rows))


@pytest.mark.cuda
@pytest.mark.parametrize("num_rows", [1, 6144, 8192, 476_672, 512 ** 3])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_sort_kernel_is_the_plain_sort_bitwise(cuda, num_rows, dtype):
    rng = np.random.RandomState(24)
    ids = np.concatenate([rng.randint(max(0, num_rows - 300), num_rows,
                                      50_000),
                          rng.randint(-3000, 0, 3000),
                          num_rows + rng.randint(0, 1 << 20, 3000),
                          np.full(10, 2 ** 31 - 1)])
    ids = torch.from_numpy(rng.permutation(ids)).to(dtype)
    if dtype == torch.int64:    # ids past int32 are outside too
        ids[:10] = 2 ** 40
    got = scatter.sort_updates(ids.to(cuda), num_rows)
    want = scatter.sort_updates(ids, num_rows)     # CPU: the plain sort
    # a stable sort has one answer
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def _bucket_inputs(case, rng):
    """(ids, num_rows) the bucket path takes: 8 or more updates a row."""
    num_rows = 476_672 if case == "hash_table" else 20_001
    n = 9 * num_rows
    ids = rng.randint(0, num_rows, n)
    if case == "hot_row":       # a row over several pieces
        ids[: 3 * scatter._BUCKET_PIECE] = num_rows // 3
    if case == "ids_outside":   # aliasing the rows in their low bits
        ids[::11] = -rng.randint(1, 1 << 20, len(ids[::11]))
        ids[5::11] = num_rows + rng.randint(0, 1 << 20, len(ids[5::11]))
    return rng.permutation(ids), num_rows


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "hot_row", "ids_outside",
                                  "hash_table"])
def test_bucket_path_matches_plain_version(cuda, case):
    rng = np.random.RandomState(26)
    ids_np, num_rows = _bucket_inputs(case, rng)
    ids = torch.from_numpy(ids_np).to(cuda)
    vals = torch.from_numpy(rng.randn(len(ids_np), 4).astype(np.float32)) \
        .to(cuda)
    bits = scatter.bucket_bits(len(ids_np), vals, num_rows)
    assert bits == num_rows.bit_length() - 8
    got, again = (scatter_add_rows(ids, vals, num_rows) for _ in range(2))
    assert torch.equal(got, again)
    want = _scatter_add_rows_plain(ids, vals, num_rows,
                                   acc_dtype=torch.float64)
    tol = 1e-5 * want.abs().max().item()
    assert (got.double() - want).abs().max().item() <= tol
    # its sort and plan against their plain versions, exactly
    keys, moved = scatter.sort_by_bucket(ids, vals, num_rows, bits)
    plain = scatter._sort_by_bucket_plain(ids, vals, num_rows, bits)
    assert torch.equal(keys, plain[0]) and torch.equal(moved, plain[1])
    rows = 1 << bits
    starts = scatter.slab_starts(keys, num_rows, rows, bits)
    assert torch.equal(starts, scatter._slab_starts_plain(keys, num_rows,
                                                          rows, bits))
    pieces = scatter.piece_plan(keys, num_rows, rows, scatter._BUCKET_PIECE,
                                0, bits)
    assert torch.equal(pieces, scatter._piece_plan_plain(
        starts, scatter._BUCKET_PIECE, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("piece", [1, 16, 256])
def test_piece_plan_kernel_matches_plain_version(cuda, piece):
    rng = np.random.RandomState(25)
    ids = np.concatenate([rng.randint(0, 20_000, 30_000),
                          np.full(5000, 4100), rng.randint(0, 300, 5000)])
    ids32 = torch.sort(torch.from_numpy(ids).to(torch.int32))[0]
    for rows in (1, 128, 256):
        got = scatter.piece_plan(ids32.to(cuda), 20_000, rows, piece)
        want = scatter.piece_plan(ids32, 20_000, rows, piece)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_gather_rows_backward_on_the_card_matches_cpu(cuda):
    rng = np.random.RandomState(3)
    table = torch.from_numpy(rng.randn(5000, 4).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 5000, (8, 3000)))
    cot = torch.from_numpy(rng.randn(8, 3000, 4).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda):
        t = table.to(dev).requires_grad_(True)
        out = gather_rows(t, ids.to(dev))
        (g,) = torch.autograd.grad(out, t, cot.to(dev))
        grads.append(g.cpu())
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_scatter_refuses_what_the_kernel_does_not_take(cuda):
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        scatter_add_rows(ids, torch.zeros(4, 1025, device=cuda), 10)
    with pytest.raises(ValueError):
        scatter_add_rows(ids.cpu(), torch.zeros(4, 4, device=cuda), 10)


@pytest.mark.cuda
@pytest.mark.parametrize("gshape", [(5, 6, 7, 3), (2, 2, 2, 4), (1, 3, 2, 2),
                                    (4, 2, 128, 4), (33, 17, 65, 4),
                                    (3, 1, 1, 1), (8, 2, 128, 2)])
def test_fold_kernel_matches_plain_version(cuda, gshape):
    rng = np.random.RandomState(12)
    M = int(np.prod(gshape[:3]))
    cot = torch.from_numpy(rng.randn(8 * gshape[3], M).astype(np.float32))
    cot = cot.to(cuda)
    kernels.reset_launches()
    got32 = fold.fold_octa_cotangent(cot, gshape)
    got = fold.fold_octa_cotangent(cot, gshape, torch.bfloat16)
    again = fold.fold_octa_cotangent(cot, gshape, torch.bfloat16)
    assert kernels.LAUNCHES["fold_octa_cotangent"] == 3
    # the plain version's expression tree: bitwise its f32 result, and the
    # bf16 output is that rounded once; no atomics, so runs repeat bitwise
    assert torch.equal(got32, fold._fold_octa_cotangent_plain(cot, gshape))
    assert torch.equal(got, got32.to(torch.bfloat16))
    assert torch.equal(got, again)
    want = fold._fold_octa_cotangent_plain(cot.double(), gshape,
                                           torch.float64)
    assert (got32.double() - want).abs().max().item() \
        <= 1e-6 * want.abs().max().item()


@pytest.mark.cuda
def test_octa_gather_backward_on_the_card_matches_cpu(cuda):
    rng = np.random.RandomState(13)
    gshape = (9, 8, 7, 4)
    table = torch.from_numpy(rng.randn(*gshape).astype(np.float32)) \
        .to(torch.bfloat16)
    x = torch.from_numpy(rng.uniform(-1.1, 1.1, (3000, 3)).astype(np.float32))
    cot = torch.from_numpy(rng.randn(3000, 32).astype(np.float32)) \
        .to(torch.bfloat16)
    grads = []
    kernels.reset_launches()
    for dev in ("cpu", cuda):
        t = table.to(dev).requires_grad_(True)
        ids = grid.voxel_octa_ids(x.to(dev), gshape)
        rows = grid.GatherRowsOcta.apply(t, ids)
        (g,) = torch.autograd.grad(rows, t, cot.to(dev))
        assert g.dtype == torch.bfloat16
        grads.append(g.cpu())
    assert kernels.LAUNCHES == {"scatter_add_rows": 1,
                                "fold_octa_cotangent": 1,
                                "build_octa_table": 0,
                                "lanczos_voxel_gather": 0,
                                "adam_update": 0,
                                "softplus_grad_grad": 0,
                                "gather_rows": 0}
    # f32 sums in another order, each rounded once to bf16: one ulp, and
    # f32 rounding (1e-6 of the largest) where a sum cancels to near zero
    want = grads[0].double()
    d = (grads[1].double() - want).abs()
    tol = want.abs() * 2.0 ** -7 + 1e-6 * want.abs().max()
    assert bool((d <= tol).all())


@pytest.mark.cuda
def test_bf16_affine_on_the_card_sums_in_f32(cuda):
    rng = np.random.RandomState(14)
    p = {"W": torch.from_numpy(rng.randn(300, 256).astype(np.float32) / 10),
         "b": torch.from_numpy(rng.randn(256).astype(np.float32))}
    h = torch.from_numpy(rng.randn(4, 500, 300).astype(np.float32))
    want = affine_apply(p, h, torch.bfloat16)            # the plain form
    pc = {k: v.to(cuda) for k, v in p.items()}
    got = affine_apply(pc, h.to(cuda), torch.bfloat16).cpu()
    assert got.dtype == torch.float32 and got.shape == want.shape
    # exact products, f32 sums in another order
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    # and the same in bf16 storage: one rounding of nearly equal sums
    got16 = affine_apply(pc, h.to(cuda), torch.bfloat16,
                         out_dtype=torch.bfloat16).cpu()
    assert bool(((got16.double() - want.double()).abs()
                 <= want.double().abs() * 2.0 ** -7 + 1e-5).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gshape", [(5, 3, 7, 4), (5, 3, 7, 2), (1, 3, 2, 4),
                                    (2, 1, 1, 2), (1, 1, 1, 4), (2, 2, 2, 2),
                                    (4, 5, 6, 3), (16, 16, 16, 4),
                                    (3, 1, 2, 4), (1, 2, 1, 2)], ids=str)
def test_octa_build_kernel_is_the_plain_version_bitwise(cuda, gshape, dtype):
    """Every vector width the kernel picks (cells of 4, 6, 8, 12 and 16
    bytes), non-cubic grids and axes of length 1 and 2."""
    base = torch.from_numpy(np.random.RandomState(17).randn(*gshape)
                            .astype(np.float32)).to(dtype)
    want = octa_build._build_octa_table_plain(base)
    kernels.reset_launches()
    got = octa_build.build_octa_table(base.to(cuda))
    again = octa_build.build_octa_table(base.to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["build_octa_table"] == 2
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_render_call_builds_the_table_once_on_the_octa_layout(cuda):
    from ndjir_torch.config import load_config
    from ndjir_torch.data.dataset import IDRDataset
    from ndjir_torch.data.synthetic import render_sphere_scene
    from ndjir_torch.models.fields import init_model
    from ndjir_torch.render.image import render_image

    tiny = ["geometric_network.voxel.grid_size=16",
            "geometric_network.feature_size=64", "renderer.n_samples0=8",
            "renderer.n_samples1=4", "renderer.n_bg_samples=4",
            "renderer.n_thetas=2", "valid.n_down_samples=1",
            "valid.n_rays=24"]
    images, masks, cameras = render_sphere_scene(n_views=2, H=16, W=16)
    for extra, builds in (([], 0), (["precision.grid_dtype=bfloat16"], 1)):
        conf = load_config("default", overrides=tiny + extra)
        ds = IDRDataset(conf, images, masks, cameras, train=False,
                        shuffle=False)
        params = init_model(conf, seed=0, device=cuda)
        kernels.reset_launches()
        img = render_image(params, ds.poses[:1], ds.intrinsics[:1],
                           (16, 16), conf)
        assert kernels.LAUNCHES["build_octa_table"] == builds
        assert img.shape == (1, 3, 8, 8) and np.isfinite(img).all()


def _tiny_conf(extra=()):
    from ndjir_torch.config import load_config

    return load_config("default", overrides=[
        "valid.skip=true", "data_path=synthetic/sphere",
        "geometric_network.voxel.grid_size=16",
        "geometric_network.feature_size=64", "train.batch_size=2",
        "train.n_rays=8", "renderer.n_samples0=8", "renderer.n_samples1=4",
        "renderer.n_bg_samples=4", "renderer.n_thetas=2", *extra])


def _tiny_batches(conf, lead, device, seed=3):
    B, R = conf.train.batch_size, conf.train.n_rays
    rng = np.random.RandomState(seed)
    camloc = np.tile(np.float32([0.1, -0.2, 2.5]), (*lead, B, 1))
    raydir = rng.randn(*lead, B, R, 3).astype(np.float32) * 0.5
    raydir[..., 2] -= 1.0
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    color = rng.rand(*lead, B, R, 3).astype(np.float32)
    mask = (rng.rand(*lead, B, R, 1) < 0.7).astype(np.float32)
    return [torch.from_numpy(a).to(device)
            for a in (camloc, raydir, color, mask)]


def _state(params, opt):
    from ndjir_torch.train.optim import tree_leaves_with_path

    return [t for tree in (params, opt["mu"], opt["nu"])
            for _, t in tree_leaves_with_path(tree)] + [opt["count"]]


@pytest.mark.cuda
@pytest.mark.parametrize("seeds", ["fixed", "fresh"])
def test_sharded_train_steps_replays_equal_eager_over_nccl(cuda, seeds,
                                                           tmp_path):
    """``train_steps`` with a ``ShardReducer`` over an NCCL group of one:
    one warm-up step and a capture, then replays with the collectives in
    the graph, bitwise equal to the eager sharded steps."""
    import socket

    import torch.distributed as dist

    from ndjir_torch.models.fields import init_model
    from ndjir_torch.parallel.mesh import ShardReducer
    from ndjir_torch.render.renderer import make_mc_cdfs
    from ndjir_torch.train.graph import CapturedStep
    from ndjir_torch.train.optim import init_optimizer
    from ndjir_torch.train.trainer import train_step, train_steps

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        conf = _tiny_conf([f"renderer.fixed_graph_seeds="
                           f"{str(seeds == 'fixed').lower()}"])
        B, R, K = conf.train.batch_size, conf.train.n_rays, 5
        batches = _tiny_batches(conf, (K,), cuda)
        red = ShardReducer(None)
        cdfs = make_mc_cdfs(conf, B, R, device=cuda) \
            if seeds == "fixed" else None

        def draw(g):
            return make_mc_cdfs(conf, B, R, step=g, device=cuda)
        sched = (0.5, 1.0, 1e-3, 1e-3)
        p = init_model(conf, seed=0, device=cuda)
        o = init_optimizer(p)
        eager = [train_step(p, o, *(b[j] for b in batches), *sched, conf,
                            cdfs=cdfs if cdfs is not None else draw(j),
                            step=j, reducer=red) for j in range(K)]
        q = init_model(conf, seed=0, device=cuda)
        s = init_optimizer(q)
        graph = CapturedStep(train_step, conf)
        kernels.reset_launches()
        mons = train_steps(q, s, *batches, *sched, 0, conf, cdfs=cdfs,
                           graph=graph, reducer=red, step_cdfs=draw)
        assert graph.captures == 1 and graph.replays == K - 1
        assert kernels.LAUNCHES["scatter_add_rows"] == 2 * K
        for a, b in zip(_state(q, s), _state(p, o)):
            assert torch.equal(a, b)
        for k in mons:
            assert torch.equal(mons[k], torch.stack([m[k] for m in eager]))
        graph.release()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_multi_scene_graph_equals_eager(cuda, tmp_path):
    """``MultiSceneTrainer`` on the card (one captured iteration of both
    scenes' steps, replayed) against a twin trainer's epochs run eagerly,
    each iteration ``multi_scene_train_step`` on its ``next_batch()`` as
    ``train_epoch`` runs it on the CPU, bitwise; one capture, one replay
    an iteration after the first."""
    from torch_parallel_worker import datasets

    from ndjir_torch.parallel.multi_scene import (
        MultiSceneTrainer,
        multi_scene_train_step,
    )
    from ndjir_torch.train.graph import device_scalars
    from ndjir_torch.train.trainer import epoch_schedule, fetch_monitors

    def trainer(tag):
        conf = _tiny_conf(["train.epoch=3", "train.warmup_term_ratio=0",
                           "train.checkpoint_interval_epochs=0",
                           f"monitor_base_path={tmp_path}/{tag}"])
        return MultiSceneTrainer(conf, [f"{tmp_path}/s0", f"{tmp_path}/s1"],
                                 datasets=datasets(conf, 2), device=cuda)
    graphed, eager = trainer("graph"), trainer("eager")
    graphed.train(epochs=2)
    iters = min(ds.iters_per_epoch for ds in eager.datasets)
    history = []
    for e in range(2):
        lr_w, lr_f, car, lvg = device_scalars(epoch_schedule(
            e, eager.lr_w_base, eager.lr_f_base, eager.conf), eager.device)
        for it in range(iters):
            g = e * iters + it
            cdfs = eager.cdfs if eager.cdfs is not None \
                else eager._shard_cdfs(g)
            history.append(fetch_monitors(multi_scene_train_step(
                eager.params, eager.opt_states, *eager.next_batch(), car,
                lvg, lr_w, lr_f, g, eager.conf, cdfs=cdfs,
                reducer=eager.plan.row_reducer)))
    assert graphed.history == history
    assert graphed.graph.captures == 1
    assert graphed.graph.replays == 2 * iters - 1
    for i in range(2):
        for a, b in zip(_state(graphed.params[i], graphed.opt_states[i]),
                        _state(eager.params[i], eager.opt_states[i])):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("beta", [1.0, 100.0])
def test_softplus_grad_kernel_matches_plain_version(cuda, dtype, beta):
    """The softplus first derivative's one-pass kernel (jiterator) against
    its plain version (the fused op's backward, then the zeros), bitwise,
    across the threshold, at +-0, NaN, +-inf and subnormals."""
    from ndjir_torch.ops import activations

    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1 << 16, generator=gen) * 0.3
    x[:40] = torch.linspace(19.9 / beta, 20.1 / beta, 40)
    x[40:48] = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                             -float("inf"), 1e-40, -1e-40, 1e-30])
    g = torch.randn(x.shape, generator=gen)
    g[100:104] = float("nan")
    x, g = x.to(dtype).to(cuda), g.to(dtype).to(cuda)
    got = activations._softplus_grad(g, x, beta)
    want = activations._softplus_grad_plain(g, x, beta)
    assert got.dtype == dtype
    assert torch.equal(got.float().view(torch.int32),
                       want.float().view(torch.int32))


@pytest.mark.cuda
def test_softplus_grad_refuses_a_dtype_without_kernel(cuda):
    """On the card the softplus first derivative launches its kernel or
    raises: float64 has no kernel, and g and x of two dtypes neither."""
    from ndjir_torch.ops import activations

    x = torch.linspace(-1, 1, 64, device=cuda)
    with pytest.raises(TypeError):
        activations._softplus_grad(x.double(), x.double(), 100.0)
    with pytest.raises(TypeError):
        activations._softplus_grad(x.bfloat16(), x, 100.0)


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _softplus_operands(dtype, beta, layout, device):
    """gg, g and x of shape (300, 213) (not a multiple of 16 bytes): x
    across the threshold, at +-0, NaN, +-inf and subnormals, gg and g with
    NaNs.  ``layout``: all contiguous; ``g_rows``, g a slice of 256-wide
    rows (the skip concatenation's cotangent); ``unaligned``, every
    operand one element off 16 bytes."""
    gen = torch.Generator().manual_seed(5)
    n = 300 * 213
    x = torch.randn(n, generator=gen) * 3 / beta
    x[:64] = torch.linspace(19.5 / beta, 20.5 / beta, 64)
    x[64:76] = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                             -float("inf"), 1e-40, -1e-40, 1e-30, -1e-30,
                             3e-38, 1e-45, -1e-45])
    gg = torch.randn(n, generator=gen)
    gg[100:104] = float("nan")
    gg[104:106] = torch.tensor([float("inf"), 0.0])
    wide = torch.randn(300, 256, generator=gen)
    wide.view(-1)[200:204] = float("nan")

    def put(t):
        t = t.to(dtype).to(device)
        if layout != "unaligned":
            return t.contiguous()
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=device)
        buf[1:].copy_(t.reshape(-1))
        return buf[1:].view(t.shape)
    g = wide.to(dtype).to(device)[:, :213] if layout == "g_rows" \
        else put(wide[:, :213])
    return put(gg.view(300, 213)), g, put(x.view(300, 213))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "g_rows", "unaligned"])
@pytest.mark.parametrize("needs", [(True, True), (True, False),
                                   (False, True)], ids=["both", "dg", "dx"])
@pytest.mark.parametrize("beta", [1.0, 100.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_softplus_grad_grad_kernel_matches_plain_version(cuda, dtype, beta,
                                                         needs, layout):
    """The softplus second derivative's one-pass kernel against its plain
    form (the jiterator kernel for dg, PyTorch's eight ops for dx),
    bitwise, in one launch."""
    from ndjir_torch.ops import activations

    gg, g, x = _softplus_operands(dtype, beta, layout, cuda)
    kernels.reset_launches()
    got = activations._softplus_grad_grad(gg, g, x, beta, *needs)
    assert kernels.LAUNCHES["softplus_grad_grad"] == 1
    want = activations._softplus_grad_grad_plain(gg, g, x, beta, *needs)
    for a, b, need in zip(got, want, needs):
        if not need:
            assert a is None and b is None
            continue
        assert a.dtype == dtype and a.shape == x.shape and a.is_contiguous()
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_softplus_grad_grad_refuses_a_dtype_without_kernel(cuda):
    """On the card the kernel takes every call: f64 and f16, which it has
    no instantiation for, raise for either output; a transposed gg is read
    through a contiguous copy, in one launch, bitwise the plain form."""
    from ndjir_torch.ops import activations

    gg, g, x = _softplus_operands(torch.float32, 100.0, "contiguous", cuda)
    for dtype in (torch.float64, torch.float16):
        for needs in [(True, True), (True, False), (False, True)]:
            with pytest.raises(TypeError):
                activations._softplus_grad_grad(gg.to(dtype), g.to(dtype),
                                                x.to(dtype), 100.0, *needs)
    kernels.reset_launches()
    got = activations._softplus_grad_grad(gg.t().contiguous().t(), g, x,
                                          100.0, True, True)
    assert kernels.LAUNCHES["softplus_grad_grad"] == 1
    want = activations._softplus_grad_grad_plain(gg, g, x, 100.0)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


def _eikonal_grads(conf, device):
    """The geometric MLP's parameter gradients of an eikonal loss (a
    double backward) and an SDF term at 4096 points, from seed 0."""
    from ndjir_torch.models.fields import geometric_apply, init_model
    from ndjir_torch.train.optim import tree_leaves_with_path

    params = init_model(conf, seed=0, device=device)["geometric-network"]
    leaves = [t.requires_grad_() for _, t in tree_leaves_with_path(params)]
    gen = torch.Generator(device=device).manual_seed(4)
    x = (torch.rand(4096, 3, generator=gen, device=device) - 0.5) * 1.2
    x.requires_grad_()
    sdf = geometric_apply(params, x, conf)[0]
    (grad,) = torch.autograd.grad(sdf.sum(), x, create_graph=True)
    loss = (grad.norm(dim=-1) - 1).square().mean() + sdf.abs().mean()
    return torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.cuda
@pytest.mark.parametrize("mlp_dtype", ["float32", "bfloat16"])
def test_eikonal_double_backward_kernel_equals_plain(cuda, mlp_dtype,
                                                     monkeypatch):
    """The geometric MLP's (8 layers, a skip) parameter gradients under the
    eikonal double backward: one kernel launch a hidden layer (7), bitwise
    those of the plain form run in its place."""
    from ndjir_torch.ops import activations

    conf = _tiny_conf([f"precision.mlp_dtype={mlp_dtype}"])
    kernels.reset_launches()
    fast = _eikonal_grads(conf, cuda)
    assert kernels.LAUNCHES["softplus_grad_grad"] == 7
    monkeypatch.setattr(activations, "_softplus_grad_grad",
                        activations._softplus_grad_grad_plain)
    kernels.reset_launches()
    plain = _eikonal_grads(conf, cuda)
    assert kernels.LAUNCHES["softplus_grad_grad"] == 0
    assert len(fast) == len(plain) and fast[0] is not None
    for a, b in zip(fast, plain):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mlp_dtype", ["float32", "bfloat16"])
def test_captured_step_replays_seven_second_derivatives(cuda, mlp_dtype,
                                                        monkeypatch):
    """A captured default step (8-layer geometric MLP) holds 7 launches of
    the second derivative's kernel: each replay adds 7 to ``LAUNCHES``.
    Its trained parameters and monitors equal, bitwise, those of the same
    captured training with the plain form in the kernel's place.  A
    process's first captured training after an eikonal double backward
    lands ulps from its later ones with either form (``PERF.md`` §6,
    PR 19), so a first training warms up and is not compared."""
    from ndjir_torch.models.fields import init_model
    from ndjir_torch.ops import activations
    from ndjir_torch.render.renderer import make_mc_cdfs
    from ndjir_torch.train.graph import CapturedStep
    from ndjir_torch.train.optim import init_optimizer, tree_leaves_with_path
    from ndjir_torch.train.trainer import train_step, train_steps

    conf = _tiny_conf([f"precision.mlp_dtype={mlp_dtype}"])
    B, R, K = conf.train.batch_size, conf.train.n_rays, 4
    batches = _tiny_batches(conf, (K,), cuda)
    cdfs = make_mc_cdfs(conf, B, R, device=cuda)
    sched = (0.5, 1.0, 1e-3, 1e-3)

    def train(launches):
        p = init_model(conf, seed=0, device=cuda)
        o = init_optimizer(p)
        graph = CapturedStep(train_step, conf)
        kernels.reset_launches()
        mons = train_steps(p, o, *batches, *sched, 0, conf, cdfs=cdfs,
                           graph=graph)
        assert graph.captures == 1 and graph.replays == K - 1
        assert graph.tally["softplus_grad_grad"] == launches
        assert kernels.LAUNCHES["softplus_grad_grad"] == launches * K
        graph.release()
        return [t for _, t in tree_leaves_with_path(p)], mons

    train(7)
    fast, fast_mons = train(7)
    monkeypatch.setattr(activations, "_softplus_grad_grad",
                        activations._softplus_grad_grad_plain)
    plain, plain_mons = train(0)
    assert len(fast) == len(plain)
    assert all(torch.equal(a, b) for a, b in zip(fast, plain))
    assert fast_mons.keys() == plain_mons.keys()
    assert all(torch.equal(fast_mons[k], plain_mons[k]) for k in fast_mons)


_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")


@pytest.mark.cuda
def test_spans_hold_their_launches_under_a_cuda_only_profiler(cuda,
                                                              monkeypatch):
    """A profiler of the card's activity alone, as the benchmark's traced
    window runs it, still turns the spans on; the runtime calls that
    launched the kernels of a span lie within it on the profiler's
    clock."""
    from torch.profiler import ProfilerActivity, profile

    from ndjir_torch.utils import profiling

    monkeypatch.setattr(profiling, "_SPANS", [])
    x = torch.randn(1 << 20, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert torch.autograd._profiler_enabled()
        x.cos()
        with profiling.annotate("outer", steps=1):
            with profiling.annotate("inner"):
                for _ in range(4):
                    x.sin()
            x.exp()
        torch.cuda.synchronize()
    inner, outer = profiling.spans()
    assert inner.parent_id == outer.span_id and outer.counts == {"steps": 1}
    events = list(prof.profiler.kineto_results.events())
    kernels = [e for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and "Memset" not in e.name() and "Memcpy" not in e.name()]
    launches = [(e.start_ns(), e.start_ns() + e.duration_ns())
                for e in events if e.name() in _LAUNCHES]
    assert len(kernels) == len(launches) == 6

    def within(s):
        return sum(s.start_ns <= a and b <= s.end_ns for a, b in launches)
    assert (within(inner), within(outer)) == (4, 5)


@pytest.mark.cuda
def test_train_steps_records_one_capture_and_its_calls(cuda, tmp_path,
                                                       monkeypatch):
    """The ``Trainer`` at ``steps_per_call`` 4 under a profiler of the
    card's activity alone: one ``graph.capture`` (the warm-up step and
    the captured one, five phases each) inside the first ``train.call``,
    whose ``steps`` add up to the epochs' steps."""
    from torch.profiler import ProfilerActivity, profile

    from ndjir_torch.data.dataset import IDRDataset
    from ndjir_torch.data.synthetic import render_sphere_scene
    from ndjir_torch.train.trainer import Trainer
    from ndjir_torch.utils import profiling

    monkeypatch.setattr(profiling, "_SPANS", [])
    conf = _tiny_conf(["train.epoch=3", "train.steps_per_call=4",
                       "train.checkpoint_interval_epochs=0",
                       f"monitor_base_path={tmp_path}/m"])
    images, masks, cameras = render_sphere_scene(n_views=16, H=16, W=16)
    ds = IDRDataset(conf, images, masks, cameras, train=True, shuffle=True)
    tr = Trainer(conf, dataset=ds, device=cuda, seed=0)
    iters = ds.iters_per_epoch
    assert iters == 8
    with profile(activities=[ProfilerActivity.CUDA]):
        tr.train(stop_epoch=2)
    spans = profiling.spans()
    calls = [s for s in spans if s.name == "train.call"]
    (capture,) = [s for s in spans if s.name == "graph.capture"]
    assert tr.graph.captures == 1 and len(tr.history) == 2 * iters
    assert len(calls) == 4 and sum(s.counts["steps"] for s in calls) == 16
    assert [s.step for s in calls] == [0, 4, 8, 12]
    assert capture.parent_id == calls[0].span_id
    phases = [s.name for s in spans if s.parent_id == capture.span_id]
    assert phases == ["step.sample", "step.render", "step.loss",
                      "step.backward", "step.update"] * 2
    assert not [s for s in spans if s.name == "train.step"]
