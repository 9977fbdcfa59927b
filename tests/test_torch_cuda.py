"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without an NVIDIA
GPU (the kernels have no CPU mode; on a CPU tensor a wrapper runs the plain
version, which the other ``test_torch_*`` files hold against the JAX
reference).  The file imports no JAX, so it also runs on a machine that has
only PyTorch: ``python3 -m pytest tests/test_torch_cuda.py -q``.
``chip_smoke.py`` runs the same comparison at the training step's shape.
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
    if case == "one_busy_slab":             # every slab empty but one
        rows = scatter.slab_rows(4)
        return 5 * rows + rng.randint(0, rows, 3000), 40 * rows + 3, 4, \
            False, torch.float32
    if case == "ids_outside":               # dropped, as XLA drops them
        ids = rng.randint(-5000, 65_000, 20_000)
        ids[::7] = 2 ** 31 - 1
        return ids, 60_001, 32, True, torch.float32
    if case.startswith("ragged_d"):         # rows not a multiple of a slab
        return rng.randint(0, 30_011, 8000), 30_011, int(case[8:]), False, \
            torch.float32
    if case == "hot_row_d32_bf16":
        ids = np.concatenate([np.full(20_000, 4095),
                              rng.randint(0, 65_536, 5000)])
        return rng.permutation(ids), 65_536, 32, True, torch.bfloat16
    if case == "split_slab_d8":             # one slab over many pieces
        rows = scatter.slab_rows(8)
        return 3 * rows + rng.randint(0, rows, 200 * scatter.piece_size(8)), \
            10 * rows, 8, False, torch.float32
    if case.startswith("one_row_d"):        # every update to one row
        return np.full(100_000, 777), 6144, int(case[9:]), False, \
            torch.float32
    if case.startswith("outside_bits"):     # a 13- or 19-bit key range
        narrow = case.endswith("13")
        num_rows = 6144 if narrow else 476_672
        ids = np.concatenate([rng.randint(num_rows - 100, num_rows, 8000),
                              rng.randint(-2000, 0, 2000),
                              num_rows + rng.randint(0, 1 << 20, 2000)])
        return rng.permutation(ids), num_rows, 8 if narrow else 4, narrow, \
            torch.bfloat16 if narrow else torch.float32
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["no_updates", "one_busy_slab",
                                  "ids_outside", "ragged_d1", "ragged_d3",
                                  "ragged_d33", "hot_row_d32_bf16",
                                  "split_slab_d8", "one_row_d8", "one_row_d4",
                                  "outside_bits13", "outside_bits19"])
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
    assert got.shape == want.shape and got.dtype == torch.float32
    tol = 1e-5 * max(1.0, want.abs().max().item() if want.numel() else 0.0)
    assert (got.double() - want).abs().max().item() <= tol
    if case == "no_updates":
        assert not got.any()


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
                                    (4, 2, 128, 4), (33, 17, 65, 4)])
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
                                "build_octa_table": 0}
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
                                    (4, 5, 6, 3), (16, 16, 16, 4)], ids=str)
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
