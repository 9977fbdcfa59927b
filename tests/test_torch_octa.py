"""The port's octa table layout and its backward against the JAX reference
(CPU).

The octa layout reads all 8 corners of a point's cell as one 8D-wide row
(``ndjir_tpu/ops/grid.py:137-169``); its backward is the transposed
scatter (B1) followed by the fold (B2, ``ndjir_torch/ops/fold.py``), whose
plain version runs here.  Same numpy inputs through both packages: the
fold against the reference's ``flat2d`` form, the autodiff VJP of the
table build and the Pallas fold kernel in interpret mode; the gather, the
interpolation, the TV map and the grid queries against their reference
functions, values and gradients, the eikonal grad-of-grad included.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ndjir_tpu.ops.grid as jgrid

from ndjir_torch.ops import grid
from ndjir_torch.ops.fold import _fold_octa_cotangent_plain, fold_octa_cotangent

torch.set_num_threads(2)

VMIN, VMAX = (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _f32(a):
    """A JAX or torch array as float32 numpy (bf16 exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_ulp(a):
    """One bf16 ulp of each entry (8 significant bits; the ulp of the
    smallest normal below it)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


# ---------------------------------------------------------------------------
# the fold (B2's plain version)
# ---------------------------------------------------------------------------

FOLD_SHAPES = [(5, 6, 7, 3), (2, 2, 2, 4), (1, 3, 2, 2), (4, 2, 128, 4)]


@pytest.mark.parametrize("gshape", FOLD_SHAPES)
def test_fold_matches_flat2d_and_the_build_vjp(gshape):
    rng = np.random.RandomState(5)
    M = int(np.prod(gshape[:3]))
    cot = rng.randn(8 * gshape[3], M).astype(np.float32)
    got = fold_octa_cotangent(_t(cot), gshape)
    assert got.shape == gshape and got.dtype == torch.float32
    want = jgrid._fold_octa_cotangent_flat2d(jnp.asarray(cot), gshape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the adjoint of the table build, by autodiff
    _, vjp = jax.vjp(jgrid._voxel_octa_flat, jnp.zeros(gshape, jnp.float32))
    want_vjp = np.asarray(vjp(jnp.asarray(cot.T))[0])
    np.testing.assert_allclose(got.numpy(), want_vjp, rtol=1e-6, atol=1e-6)
    # a bf16 result is the f32 sums rounded once
    got_bf16 = fold_octa_cotangent(_t(cot), gshape, torch.bfloat16)
    assert torch.equal(got_bf16, got.to(torch.bfloat16))


def test_fold_far_corner_sums_27_inputs():
    """Along each axis the last cell receives its shifted neighbour and its
    own clamped duplicate, so cell (G-1, G-1, G-1) sums 3^3 = 27 inputs,
    not 8."""
    gshape = (4, 3, 5, 2)
    Gx, Gy, Gz, D = gshape
    M = Gx * Gy * Gz
    ones = fold_octa_cotangent(torch.ones(8 * D, M), gshape)
    assert ones[-1, -1, -1].tolist() == [27.0] * D
    assert ones[1, 1, 1].tolist() == [8.0] * D          # an interior cell
    # the 27 inputs of the corner, all set, distinct, everything else zero
    cot = np.zeros((8 * D, M), np.float32)
    rng = np.random.RandomState(2)
    rows = set()
    for dx in range(2):
        for dy in range(2):
            for dz in range(2):
                b = dx * 4 + dy * 2 + dz
                for x in ([Gx - 1] if not dx else [Gx - 2, Gx - 1]):
                    for y in ([Gy - 1] if not dy else [Gy - 2, Gy - 1]):
                        for z in ([Gz - 1] if not dz else [Gz - 2, Gz - 1]):
                            i = (x * Gy + y) * Gz + z
                            cot[b * D:(b + 1) * D, i] = rng.rand(D) + 1.0
                            rows.add((b, i))
    assert len(rows) == 27
    got = fold_octa_cotangent(_t(cot), gshape).numpy()
    _, vjp = jax.vjp(jgrid._voxel_octa_flat, jnp.zeros(gshape, jnp.float32))
    want = np.asarray(vjp(jnp.asarray(cot.T))[0])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[-1, -1, -1],
                               cot.reshape(8, D, M).sum(axis=(0, 2)),
                               rtol=1e-6)


@pytest.fixture()
def interp_fold(monkeypatch):
    """The reference's Pallas fold kernel in interpret mode, as
    tests/test_fold_pallas.py runs it."""
    monkeypatch.setenv("NDJIR_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("NDJIR_FOLD_BLOCK", "512")
    import ndjir_tpu.ops.fold_pallas as fp

    importlib.reload(fp)
    yield fp
    monkeypatch.delenv("NDJIR_PALLAS_INTERPRET")
    monkeypatch.delenv("NDJIR_FOLD_BLOCK")
    importlib.reload(fp)


@pytest.mark.parametrize("gshape", [(4, 2, 128, 2), (4, 2, 128, 4),
                                    (8, 2, 128, 2)])
def test_fold_matches_pallas_interpret(interp_fold, gshape):
    assert interp_fold.fold_pallas_supported(gshape)
    rng = np.random.RandomState(9)
    M = int(np.prod(gshape[:3]))
    cot = rng.randn(8 * gshape[3], M).astype(np.float32)
    want = np.asarray(interp_fold.fold_octa_cotangent_pallas(
        jnp.asarray(cot), gshape))
    got = fold_octa_cotangent(_t(cot), gshape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_fold_rejects_bad_arguments():
    with pytest.raises(ValueError):
        fold_octa_cotangent(torch.zeros(24, 10), (2, 2, 2, 3))
    with pytest.raises(TypeError):
        fold_octa_cotangent(torch.zeros(24, 8), (2, 2, 2, 3), torch.float16)
    # the plain version in float64 is the exact reference for the kernel
    c = torch.randn(16, 8, dtype=torch.float64)
    assert _fold_octa_cotangent_plain(c, (2, 2, 2, 2),
                                      torch.float64).dtype == torch.float64


# ---------------------------------------------------------------------------
# the octa gather and the queries on it
# ---------------------------------------------------------------------------

GSHAPE = (6, 5, 7, 4)


def _octa_inputs(dtype, n=40, seed=3):
    rng = np.random.RandomState(seed)
    base = rng.randn(*GSHAPE).astype(np.float32)
    base = np.asarray(jnp.asarray(base).astype(dtype).astype(jnp.float32))
    x = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)   # some outside
    x[0] = VMAX                                             # far corner
    x[1] = VMIN
    x[2] = [1.0, -1.0, 1.0]
    cot = rng.randn(n, 8 * GSHAPE[3]).astype(np.float32)
    cot = np.asarray(jnp.asarray(cot).astype(dtype).astype(jnp.float32))
    return base, x, cot


def test_use_octa_layout_matches_the_reference():
    for gshape in [(256, 256, 256, 4), (512, 512, 512, 4), (48, 48, 48, 4),
                   (300, 300, 300, 4), GSHAPE]:
        for jd, td in [(jnp.bfloat16, torch.bfloat16),
                       (jnp.float32, torch.float32)]:
            assert grid.use_octa_layout(gshape, td) == \
                jgrid.use_octa_layout(gshape, jd), (gshape, td)
    assert grid.use_octa_layout((256,) * 3 + (4,), torch.bfloat16)
    assert not grid.use_octa_layout((512,) * 3 + (4,), torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_octa_gather_forward_is_the_reference_rows(dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    base, x, _ = _octa_inputs(jd)
    ids = grid.voxel_octa_ids(_t(x), GSHAPE)
    want_ids = np.asarray(jgrid.voxel_octa_ids(jnp.asarray(x), GSHAPE))
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    got = grid.GatherRowsOcta.apply(_t(base).to(td), ids)
    want = jgrid._voxel_octa_flat(jnp.asarray(base).astype(jd))[want_ids]
    assert got.dtype == td
    # a pure copy: the same bits
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_octa_gather_backward_matches_reference_vjp(dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    base, x, cot = _octa_inputs(jd, n=300)
    ids = np.asarray(jgrid.voxel_octa_ids(jnp.asarray(x), GSHAPE))
    _, vjp = jax.vjp(lambda b: jgrid.gather_rows_octa(b, jnp.asarray(ids),
                                                      GSHAPE),
                     jnp.asarray(base).astype(jd))
    want = _f32(vjp(jnp.asarray(cot).astype(jd))[0])

    tb = _t(base).to(td).requires_grad_(True)
    rows = grid.GatherRowsOcta.apply(tb, _t(ids))
    (got,) = torch.autograd.grad(rows, tb, _t(cot).to(td))
    assert got.dtype == td and got.shape == GSHAPE
    got = _f32(got)
    scale = np.abs(want).max()
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-5 * scale
    else:
        # f32 sums rounded once to bf16 on both sides; sums taken in
        # another order may round to the neighbouring value
        assert np.all(np.abs(got - want) <= _bf16_ulp(want) + 1e-6 * scale)


def test_octa_gather_backward_is_not_differentiable_again():
    base, x, cot = _octa_inputs(jnp.bfloat16)
    tb = _t(base).to(torch.bfloat16).requires_grad_(True)
    ids = grid.voxel_octa_ids(_t(x), GSHAPE)
    rows = grid.GatherRowsOcta.apply(tb, ids)
    (g,) = torch.autograd.grad(rows, tb, _t(cot).to(torch.bfloat16),
                               create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.float().sum(), tb)


def _jax_octa_losses(weight, with_tv, sym, interp_only):
    def query(F, x):
        if interp_only:
            ids = jgrid.voxel_octa_ids(x, F.shape)
            f = jgrid.gather_rows_octa(F, ids, F.shape)
            return jgrid.voxel_interp_octa(x, f, F.shape, VMIN, VMAX,
                                           weight), \
                jgrid.voxel_tv_octa(f, x.dtype, sym) if with_tv else None
        if with_tv:
            return jgrid.query_voxel_and_tv(x, F, VMIN, VMAX, weight, sym)
        return jgrid.query_voxel(x, F, VMIN, VMAX, weight), None

    def first(F, x, cot):
        f, tv = query(F, x)
        out = jnp.sum(f * cot)
        return out + (jnp.sum(tv * cot) if with_tv else 0.0)

    def second(F, x, cot, k):
        gx = jax.grad(first, argnums=1)(F, x, cot)
        return jnp.sum(gx * k) + jnp.sum(gx ** 2)
    return query, first, second


def _torch_octa_query(weight, with_tv, sym, interp_only):
    def query(F, x):
        if interp_only:
            ids = grid.voxel_octa_ids(x, F.shape)
            f = grid.GatherRowsOcta.apply(F, ids.reshape(-1)).reshape(
                *ids.shape, 8 * F.shape[-1])
            return grid.voxel_interp_octa(x, f, F.shape, VMIN, VMAX,
                                          weight), \
                grid.voxel_tv_octa(f, x.dtype, sym) if with_tv else None
        if with_tv:
            return grid.query_voxel_and_tv(x, F, VMIN, VMAX, weight, sym)
        return grid.query_voxel(x, F, VMIN, VMAX, weight), None
    return query


@pytest.mark.parametrize("entry", ["interp_tv_octa", "query_voxel"])
@pytest.mark.parametrize("weight", ["linear", "cosine"])
@pytest.mark.parametrize("with_tv,sym", [(False, True), (True, True),
                                         (True, False)])
def test_octa_queries_values_and_gradients(entry, weight, with_tv, sym):
    """``voxel_interp_octa`` / ``voxel_tv_octa`` on gathered rows, and
    ``query_voxel[_and_tv]`` dispatching to the octa branch of a bf16
    table: values, the spatial gradient and a loss on it (grad-of-grad)
    against the reference on the same bf16 rows; the table gradient to
    one bf16 ulp."""
    rng = np.random.RandomState(8)
    F, x, _ = _octa_inputs(jnp.bfloat16)
    x = x.reshape(4, 10, 3)
    cot = rng.randn(4, 10, GSHAPE[3]).astype(np.float32)
    k = rng.randn(4, 10, 3).astype(np.float32)
    interp_only = entry == "interp_tv_octa"
    assert grid.use_octa_layout(GSHAPE, torch.bfloat16)

    jquery, jfirst, jsecond = _jax_octa_losses(weight, with_tv, sym,
                                               interp_only)
    jF = jnp.asarray(F).astype(jnp.bfloat16)
    jx, jcot, jk = map(jnp.asarray, (x, cot, k))
    want_f, want_tv = jquery(jF, jx)
    want_dF, want_dx = jax.grad(jfirst, argnums=(0, 1))(jF, jx, jcot)
    want_ddx = jax.grad(jsecond, argnums=1)(jF, jx, jcot, jk)

    tF = _t(F).to(torch.bfloat16).requires_grad_(True)
    tx = _t(x).requires_grad_(True)
    got_f, got_tv = _torch_octa_query(weight, with_tv, sym, interp_only)(
        tF, tx)
    first = torch.sum(got_f * _t(cot))
    if with_tv:
        first = first + torch.sum(got_tv * _t(cot))
    got_dF, got_dx = torch.autograd.grad(first, (tF, tx), create_graph=True)
    second = torch.sum(got_dx * _t(k)) + torch.sum(got_dx ** 2)
    (got_ddx,) = torch.autograd.grad(second, (tx,))

    # the same bf16 rows and f32 weights on both sides: agreement to
    # 1e-6 relative (values of O(1), gradients of O(10-1e3))
    def close(got, want, msg):
        want = _f32(want)
        np.testing.assert_allclose(_f32(got), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=msg)
    close(got_f, want_f, "features")
    if with_tv:
        close(got_tv, want_tv, "tv")
    close(got_dx, want_dx, "d x")
    close(got_ddx, want_ddx, "d x of d x")
    # the table gradient: the port rounds each row's cotangent to bf16,
    # the dtype of the rows, as the reference's code says; XLA on the CPU
    # drops that bf16 round trip before the f32 scatter (excess precision),
    # so its sums take the unrounded values: one ulp plus 1e-3 of the
    # largest entry (the worst measured is 2.5e-4 of it)
    want_dF = _f32(want_dF)
    scale = np.abs(want_dF).max()
    assert got_dF.dtype == torch.bfloat16
    assert np.all(np.abs(_f32(got_dF) - want_dF)
                  <= _bf16_ulp(want_dF) + 1e-3 * scale)


def test_gather_multi_shares_one_gather():
    """Two point sets, one gather: the rows of each are those of its own
    query, and the table gradient of both is that of the two queries."""
    F, x, _ = _octa_inputs(jnp.bfloat16, n=30)
    tF = _t(F).to(torch.bfloat16).requires_grad_(True)
    a, b = _t(x[:20]).reshape(4, 5, 3), _t(x[20:])
    fa, fb = grid.voxel_gather_multi([a, b], tF, VMIN, VMAX)
    assert fa.shape == (4, 5, 32) and fb.shape == (10, 32)
    ra = grid.GatherRowsOcta.apply(tF, grid.voxel_octa_ids(a, GSHAPE)
                                   .reshape(-1)).reshape(4, 5, 32)
    assert torch.equal(fa, ra)
    (g,) = torch.autograd.grad(fa.float().sum() + 2 * fb.float().sum(), tF)
    (ga,) = torch.autograd.grad(ra.float().sum(), tF)
    assert g.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        grid.voxel_gather_multi([a], tF.detach().float(), VMIN, VMAX)
    assert not torch.equal(g, ga)           # fb's rows contribute too
