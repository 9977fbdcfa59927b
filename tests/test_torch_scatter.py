"""The port's grid-feature scatter-add against the JAX reference (CPU).

``ndjir_torch.ops.scatter`` on CPU tensors runs the kernel's plain version
(``zeros(num_rows, D).index_add_``).  The reference function
``ndjir_tpu.ops.scatter_pallas.scatter_add_rows`` is run both ways it can
run on a CPU: through XLA's ``.at[].add``, and through the Pallas kernel in
interpret mode (the reload fixture of ``tests/test_scatter_pallas.py``).
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndjir_torch.ops.scatter import (
    _slab_starts_plain,
    gather_rows,
    scatter_add_rows,
    scatter_add_rows_t,
    slab_rows,
    slab_starts,
    sort_updates,
)

torch.set_num_threads(2)

M = 8192  # four of the TPU kernel's 2048-row slabs


def _ids(case, rng):
    if case == "random":
        return rng.randint(0, M, 3000)
    if case == "hot_row":   # 700 updates to one row among random ones
        return np.concatenate([np.full(700, 4095), rng.randint(0, M, 300)])
    if case == "slab_edges":  # rows either side of the reference's slabs
        return np.repeat([0, 4095, 4096, 8191], 25)
    raise ValueError(case)


def _inputs(case, d):
    rng = np.random.RandomState(11)
    ids = _ids(case, rng).astype(np.int32)
    vals = rng.randn(len(ids), d).astype(np.float32)
    return ids, vals


def _port(ids, vals, transposed):
    fn = scatter_add_rows_t if transposed else scatter_add_rows
    return fn(torch.from_numpy(ids), torch.from_numpy(vals), M).numpy()


def _reference(sp, ids, vals, transposed):
    fn = sp.scatter_add_rows_t if transposed else sp.scatter_add_rows
    return np.asarray(fn(jnp.asarray(ids), jnp.asarray(vals), M))


@pytest.fixture()
def interp_scatter(monkeypatch):
    monkeypatch.setenv("NDJIR_PALLAS_INTERPRET", "1")
    import ndjir_tpu.ops.scatter_pallas as sp

    importlib.reload(sp)
    yield sp
    monkeypatch.delenv("NDJIR_PALLAS_INTERPRET")
    importlib.reload(sp)


CASES = pytest.mark.parametrize("case", ["random", "hot_row", "slab_edges"])
WIDTHS = pytest.mark.parametrize("d", [4, 8, 32])
LAYOUTS = pytest.mark.parametrize("transposed", [False, True])


@CASES
@WIDTHS
@LAYOUTS
def test_scatter_matches_xla(case, d, transposed):
    import ndjir_tpu.ops.scatter_pallas as sp

    ids, vals = _inputs(case, d)
    got = _port(ids, vals, transposed)
    want = _reference(sp, ids, vals, transposed)
    assert got.shape == want.shape == ((d, M) if transposed else (M, d))
    assert got.dtype == np.float32
    # both add the same f32 values, possibly in another order: the 700-term
    # row sum (~30) may differ in its last bits
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@CASES
@WIDTHS
@LAYOUTS
def test_scatter_matches_pallas_interpret(interp_scatter, case, d,
                                          transposed):
    ids, vals = _inputs(case, d)
    got = _port(ids, vals, transposed)
    want = _reference(interp_scatter, ids, vals, transposed)
    assert got.shape == want.shape
    # the TPU kernel sums a hi/lo bf16 split on its matrix unit, exact to
    # ~2^-16 of each value; over 700 terms of |v| < 5 that stays under 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_scatter_keeps_values_dtype():
    ids, vals = _inputs("random", 4)
    v16 = torch.from_numpy(vals).to(torch.bfloat16)
    got = scatter_add_rows(torch.from_numpy(ids), v16, M)
    assert got.dtype == torch.bfloat16
    want = scatter_add_rows(torch.from_numpy(ids), v16.float(), M)
    # f32 accumulation, one rounding to bf16 at the end (scatter_pallas:207)
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)
    got_t = scatter_add_rows_t(torch.from_numpy(ids), v16, M)
    assert got_t.dtype == torch.float32 and got_t.shape == (4, M)


def test_scatter_rejects_bad_shapes():
    ids = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError):
        scatter_add_rows(ids, torch.zeros(4, 3), M)
    with pytest.raises(TypeError):
        scatter_add_rows(ids.float(), torch.zeros(5, 3), M)
    with pytest.raises(ValueError):
        scatter_add_rows(ids, torch.zeros(5, 3), 0)


def test_gather_rows_forward_and_backward_match_jax():
    from ndjir_tpu.ops.scatter_pallas import gather_rows as jax_gather_rows

    rng = np.random.RandomState(3)
    table = rng.randn(500, 4).astype(np.float32)
    ids = rng.randint(0, 500, (8, 300)).astype(np.int32)
    ids[:, :40] = 17                     # repeated rows accumulate
    cot = rng.randn(8, 300, 4).astype(np.float32)

    want, vjp = jax.vjp(lambda t: jax_gather_rows(t, jnp.asarray(ids)),
                        jnp.asarray(table))
    (want_dt,) = vjp(jnp.asarray(cot))

    t = torch.from_numpy(table).requires_grad_(True)
    got = gather_rows(t, torch.from_numpy(ids).long())
    (got_dt,) = torch.autograd.grad(got, t, torch.from_numpy(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    # the same f32 cotangents summed per row, possibly in another order
    np.testing.assert_allclose(got_dt.numpy(), np.asarray(want_dt),
                               rtol=1e-5, atol=1e-5)


def test_gather_rows_backward_is_not_differentiable_again():
    t = torch.randn(10, 4, requires_grad=True)
    ids = torch.tensor([1, 1, 3])
    out = gather_rows(t, ids)
    (g,) = torch.autograd.grad(out.sum(), t, create_graph=True)
    # once_differentiable: a second derivative through the scatter is an
    # error, not a silent zero
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.sum(), t)


# the wrapper's helpers around the kernel: the stable key sort, the slab
# size and the plain version of the kernel's slab pre-pass

STARTS_CASES = pytest.mark.parametrize("case", [
    "random", "hot_row", "slab_edges", "outside", "empty"])


def _sorted_ids(case):
    rng = np.random.RandomState(31)
    if case == "outside":       # ids below 0 and at or past num_rows
        ids = np.concatenate([rng.randint(-40, M + 40, 3000),
                              np.full(5, 2 ** 31 - 1)])
    elif case == "empty":
        ids = np.zeros(0, np.int64)
    else:
        ids = _ids(case, rng)
    return torch.sort(torch.from_numpy(ids).to(torch.int32))[0]


@STARTS_CASES
@pytest.mark.parametrize("rows", [1, 256, 2048, 2730, M])
@pytest.mark.parametrize("num_rows", [M, M - 3])
def test_slab_starts_match_a_direct_count(case, rows, num_rows):
    ids = _sorted_ids(case)
    got = slab_starts(ids, num_rows, rows)     # CPU: the plain version
    n_slabs = -(-num_rows // rows)
    assert got.dtype == torch.int32 and got.shape == (n_slabs + 1,)
    # start of slab s = how many sorted ids lie below its first row
    bounds = [min(s * rows, num_rows) for s in range(n_slabs + 1)]
    want = [int((ids.long() < b).sum()) for b in bounds]
    assert got.tolist() == want
    assert torch.equal(got, _slab_starts_plain(ids, num_rows, rows))
    # the slabs' ranges cover exactly the ids in [0, num_rows)
    inside = int(((ids >= 0) & (ids < num_rows)).sum())
    assert int(got[-1] - got[0]) == inside


@pytest.mark.parametrize("d", [1, 3, 4, 8, 32, 33, 257, 1024])
def test_slab_rows_fill_the_slab_in_groups_of_four(d):
    from ndjir_torch.ops.scatter import _SLAB_FLOATS

    F = _SLAB_FLOATS[d > 4]
    rows = slab_rows(d)
    assert 1 <= rows and (rows * d <= F or rows == 1)
    assert rows % 4 == 0 or rows < 4
    assert rows * d > F - 4 * d  # no smaller than it needs to be


def test_sort_updates_is_stable_and_sorts_only_the_keys():
    rng = np.random.RandomState(32)
    ids = torch.from_numpy(rng.randint(0, 50, 4000))
    ids_s, perm = sort_updates(ids)
    assert ids_s.dtype == torch.int32 and perm.dtype == torch.int64
    assert torch.equal(ids_s.long(), ids[perm])
    assert bool((ids_s[1:] >= ids_s[:-1]).all())
    # stable: equal ids keep their input order, so the permutation rises
    # inside every run
    same = ids_s[1:] == ids_s[:-1]
    assert bool((perm[1:][same] > perm[:-1][same]).all())
