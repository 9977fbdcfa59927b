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
    _piece_plan_plain,
    _slab_starts_plain,
    gather_rows,
    piece_plan,
    piece_size,
    scatter_add_rows,
    scatter_add_rows_t,
    slab_rows,
    slab_starts,
    sort_keys_plain,
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
    if case == "heavy_slabs":
        # like the triline gathers: many updates into a few hundred rows,
        # every slab of the kernel's far above its piece size, one row
        # taking 2,000 updates across several pieces
        return rng.permutation(np.concatenate(
            [np.full(2000, 300), rng.randint(0, 600, 4000)]))
    if case == "updates_over_rows":
        # like the hash: 48 rows spread over the table take ~125 updates
        # each
        return rng.randint(0, 48, 6000) * 170 + 7
    if case == "outside_narrow":
        # ids below 0 and at or past M mixed into the table's last rows,
        # where a sort over the low key bits alone would alias them onto
        # real rows (the XLA reference wraps ids in [-M, 0), so the
        # negative ones lie below -M)
        ids = np.concatenate([rng.randint(M - 300, M, 2000),
                              rng.randint(M, M + 300, 500),
                              -M - rng.randint(1, 300, 500),
                              np.full(50, -2 ** 31), np.full(50, 2 ** 31 - 1)])
        return rng.permutation(ids)
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


CASES = pytest.mark.parametrize("case", [
    "random", "hot_row", "slab_edges", "heavy_slabs", "updates_over_rows",
    "outside_narrow"])
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
    # both add the same f32 values, possibly in another order: the 700- and
    # 2,000-term row sums (~30-50) may differ in their last bits
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
    # ~2^-16 of each value; over 2,000 terms of |v| < 5 that stays under
    # 1e-3
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
    from ndjir_torch.ops.scatter import _SLAB_FLOATS, _width_class

    F = _SLAB_FLOATS[_width_class(d)]
    rows = slab_rows(d)
    assert 1 <= rows and (rows * d <= F or rows == 1)
    assert rows % 4 == 0 or rows < 4
    assert rows * d > F - 4 * d  # no smaller than it needs to be


def test_sort_updates_is_stable_and_sorts_only_the_keys():
    rng = np.random.RandomState(32)
    ids = torch.from_numpy(rng.randint(0, 50, 4000))
    ids_s, perm = sort_updates(ids, 50)
    assert ids_s.dtype == torch.int32 and perm.dtype == torch.int32
    assert torch.equal(ids_s.long(), ids[perm])
    assert bool((ids_s[1:] >= ids_s[:-1]).all())
    # stable: equal ids keep their input order, so the permutation rises
    # inside every run
    same = ids_s[1:] == ids_s[:-1]
    assert bool((perm[1:][same] > perm[:-1][same]).all())


# the kernel's sort over bit_length(num_rows) key bits, and its plan that
# cuts the heavy slabs into pieces

def _key_bits(num_rows):
    """The key bits the kernel's radix sort orders: enough for every row
    and the sentinel num_rows (key_bits in csrc/scatter_add_rows.cu)."""
    return num_rows.bit_length()


def _lsd_radix_sort(keys, bits, digit=8):
    """A stable LSD radix sort of uint32 keys over their low ``bits`` bits,
    ``digit`` bits a pass, as the kernel's sort runs it: the permutation."""
    perm = np.arange(len(keys))
    for lo in range(0, bits, digit):
        width = min(digit, bits - lo)
        d = (keys[perm] >> np.uint32(lo)) & np.uint32((1 << width) - 1)
        perm = perm[np.argsort(d, kind="stable")]
    return perm


@pytest.mark.parametrize("num_rows", [6144, 8191, 8192, 476_672])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_narrow_key_sort_is_stable_and_drops_ids_outside(num_rows, dtype):
    rng = np.random.RandomState(33)
    # a narrow key range at the table's end, with ids below 0 and at or
    # past num_rows whose low bits alias real rows
    ids = np.concatenate([
        rng.randint(num_rows - 200, num_rows, 3000),
        rng.randint(-500, 0, 400), rng.randint(num_rows, num_rows + 500, 400),
        np.full(30, -2 ** 31), np.full(30, 2 ** 31 - 1),
        num_rows + (1 << _key_bits(num_rows)) * np.arange(1, 31)])
    ids = rng.permutation(ids).astype(dtype)
    bits = _key_bits(num_rows)
    assert (1 << (bits - 1)) <= num_rows < (1 << bits)

    keys = sort_keys_plain(torch.from_numpy(ids), num_rows).numpy()
    inside = (ids >= 0) & (ids < num_rows)
    np.testing.assert_array_equal(keys, np.where(inside, ids, num_rows))
    ids_s, perm = sort_updates(torch.from_numpy(ids), num_rows)
    assert ids_s.dtype == torch.int32 and perm.dtype == torch.int32
    want = np.argsort(np.where(inside, ids, num_rows), kind="stable")
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(ids_s.numpy(), keys[want])
    # every key fits the sort's bits, so the radix sort over those bits
    # alone gives the same permutation ...
    np.testing.assert_array_equal(
        _lsd_radix_sort(keys.astype(np.uint32), bits), want)
    # ... where over the raw ids it would put those outside among the rows
    raw = _lsd_radix_sort(ids.astype(np.uint32), bits)
    assert not np.array_equal(raw, want)
    # the ids outside sort last and fall in no slab
    n_in = int(inside.sum())
    assert (ids_s.numpy()[n_in:] == num_rows).all()
    starts = slab_starts(ids_s, num_rows, 128)
    assert int(starts[-1] - starts[0]) == n_in


PLAN_CASES = pytest.mark.parametrize("case", [
    "random", "hot_row", "heavy_slabs", "updates_over_rows", "empty"])


@PLAN_CASES
@pytest.mark.parametrize("rows", [1, 128, 256, 2730])
@pytest.mark.parametrize("piece", [1, 16, 64, 256])
def test_piece_plan_matches_a_direct_count(case, rows, piece):
    rng = np.random.RandomState(34)
    ids = np.zeros(0, np.int64) if case == "empty" else _ids(case, rng)
    ids_s = torch.sort(torch.from_numpy(ids).to(torch.int32))[0]
    got = piece_plan(ids_s, M, rows, piece)        # CPU: the plain version
    want = []
    for s in range(-(-M // rows)):
        u = int(((ids >= s * rows) & (ids < min(M, (s + 1) * rows))).sum())
        if u > piece:
            want += [(s, k) for k in range(-(-u // piece))]
    assert got.dtype == torch.int32
    assert got.reshape(-1, 2).tolist() == [list(w) for w in want]
    starts = _slab_starts_plain(ids_s, M, rows)
    assert torch.equal(got, _piece_plan_plain(starts, piece))
    # the pieces of a slab cover its sorted range exactly, and there are
    # never more than the kernel's scratch holds
    counts = (starts[1:] - starts[:-1]).long()
    assert len(want) <= 2 * -(-len(ids) // piece) + 1
    for s in set(w[0] for w in want):
        n = sum(1 for w in want if w[0] == s)
        assert (n - 1) * piece < counts[s] <= n * piece


@pytest.mark.parametrize("d", [1, 4, 5, 8, 9, 32, 1024])
def test_piece_size_by_width_class(d):
    from ndjir_torch.ops.scatter import _PIECE, _width_class

    assert piece_size(d) == _PIECE[_width_class(d)] >= 1
    assert _width_class(d) == (0 if d <= 4 else 1 if d <= 8 else 2)


def test_plain_version_drops_ids_outside():
    rng = np.random.RandomState(35)
    ids = rng.permutation(np.concatenate([rng.randint(0, 100, 500),
                                          rng.randint(-300, 0, 50),
                                          rng.randint(100, 400, 50)]))
    vals = rng.randn(len(ids), 3).astype(np.float32)
    got = scatter_add_rows(torch.from_numpy(ids), torch.from_numpy(vals), 100)
    want = np.zeros((100, 3), np.float64)
    for i, v in zip(ids, vals):
        if 0 <= i < 100:
            want[i] += v
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# a model of the kernel's pieces and fix-up

def _model_kernel(keys, vals, num_rows, rows, piece):
    """The kernel's partition of the work, in numpy, with float64 sums:
    every slab (or piece of a cut slab) writes the rows from the one after
    the previous piece's last id to its own last id, but the row of a run
    that goes on past its end (its tail), which the fix-up writes from the
    tail and the heads of the pieces after it.  Returns (out, how often
    each row was written)."""
    d = vals.shape[1]
    out = np.zeros((num_rows, d))
    written = np.zeros(num_rows, np.int64)
    starts = _slab_starts_plain(torch.from_numpy(keys), num_rows, rows).numpy()
    heads, tails, cut = {}, {}, []
    for s in range(len(starts) - 1):
        start, end = starts[s], starts[s + 1]
        row0, nrows = s * rows, min(rows, num_rows - s * rows)
        if end == start:
            written[row0:row0 + nrows] += 1
            continue
        bounds = [(lo, min(lo + piece, end)) for lo in range(
            start, end, piece if end - start > piece else end - start)]
        for k, (lo, hi) in enumerate(bounds):
            acc = np.zeros((nrows, d))
            for j in range(lo, hi):
                acc[keys[j] - row0] += vals[j]
            first, last = keys[lo], keys[hi - 1]
            left = lo > start and keys[lo - 1] == first
            right = hi < end and keys[hi] == last
            a = 0 if lo == start else keys[lo - 1] + 1 - row0
            b = nrows if hi == end else last + 1 - row0
            if left:
                heads[(s, k)] = acc[first - row0]
            if right and not (left and first == last):
                tails[(s, k)] = acc[last - row0]
                cut.append((s, k, bounds, last))
                b -= 1
            out[row0 + a:row0 + b] = acc[a:b]
            written[row0 + a:row0 + b] += 1
    for s, k, bounds, row in cut:
        total = tails[(s, k)].copy()
        for k2 in range(k + 1, len(bounds)):
            if keys[bounds[k2][0]] != row:
                break
            total += heads[(s, k2)]
        out[row] = total
        written[row] += 1
    return out, written


@pytest.mark.parametrize("case,num_rows,d,rows,piece", [
    ("heavy_slabs", M, 8, 128, 256),        # the lines' regime
    ("heavy_slabs", M, 8, 128, 64),
    ("updates_over_rows", M, 4, 256, 256),  # the hash's regime
    ("updates_over_rows", M, 4, 256, 64),
    ("hot_row", M, 4, 256, 16),
    ("random", M, 32, 64, 16),
    ("outside_narrow", M, 4, 256, 32),
    ("one_row", 6144, 4, 256, 16),
])
def test_model_of_the_kernel_writes_every_row_once(case, num_rows, d, rows,
                                                    piece):
    rng = np.random.RandomState(37)
    ids = np.full(5000, 777) if case == "one_row" else _ids(case, rng)
    vals = rng.randn(len(ids), d)
    keys, perm = sort_updates(torch.from_numpy(ids), num_rows)
    keys, perm = keys.numpy(), perm.numpy()
    inside = keys < num_rows
    got, written = _model_kernel(keys[inside], vals[perm][inside], num_rows,
                                 rows, piece)
    assert (written == 1).all()
    want = np.zeros((num_rows, d))
    for i, v in zip(ids, vals):
        if 0 <= i < num_rows:
            want[i] += v
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


# the bucket path: where it is taken, its sort by bucket, its slab starts
# and its plan

@pytest.mark.parametrize("n,d,num_rows,dtype,want", [
    (33_554_432, 4, 476_672, torch.float32, 11),   # the voxel hash
    (16_777_216, 4, 476_672, torch.float32, 11),   # its TV map
    (3_813_376, 4, 476_672, torch.float32, 11),    # 8 updates a row
    (3_813_375, 4, 476_672, torch.float32, 0),     # fewer
    (16_777_216, 4, 512 ** 3, torch.float32, 0),   # a bucket past 32 KB
    (1_572_864, 8, 6144, torch.float32, 0),        # D=8
    (33_554_432, 4, 476_672, torch.bfloat16, 0),   # 8-byte rows
    (2000, 4, 200, torch.float32, 0),              # 8 key bits: one pass
])
def test_bucket_bits_by_shape(n, d, num_rows, dtype, want):
    from ndjir_torch.ops.scatter import bucket_bits

    assert bucket_bits(n, torch.zeros(1, d, dtype=dtype), num_rows) == want


@pytest.mark.parametrize("num_rows,bits", [(20_001, 7), (476_672, 11),
                                           (8192, 6)])
def test_bucket_sort_and_plan_match_a_direct_count(num_rows, bits):
    from ndjir_torch.ops.scatter import _BUCKET_PIECE, sort_by_bucket

    rng = np.random.RandomState(38)
    ids = rng.permutation(np.concatenate([
        rng.randint(0, num_rows, 9 * num_rows),
        np.full(3 * _BUCKET_PIECE, num_rows // 3),
        -rng.randint(1, 1 << 20, 500),
        num_rows + rng.randint(0, 1 << 20, 500)]))
    vals = torch.from_numpy(rng.randn(len(ids), 4).astype(np.float32))
    keys, moved = sort_by_bucket(torch.from_numpy(ids), vals, num_rows, bits)
    rows = 1 << bits
    sentinel = -(-num_rows // rows) * rows   # the bucket past the table
    k = np.where((ids >= 0) & (ids < num_rows), ids, sentinel)
    order = np.argsort(k >> bits, kind="stable")
    np.testing.assert_array_equal(keys.numpy(), k[order])
    assert torch.equal(moved, vals[torch.from_numpy(order)])
    starts = slab_starts(keys, num_rows, rows, bits)
    n_buckets = -(-num_rows // rows)
    want = [int((k < min(b * rows, num_rows)).sum())
            for b in range(n_buckets + 1)]
    assert starts.tolist() == want
    # every bucket with an update is cut into pieces that cover it
    pieces = piece_plan(keys, num_rows, rows, _BUCKET_PIECE, 0, bits)
    counts = np.diff(want)
    want_pieces = [(b, j) for b in range(n_buckets)
                   for j in range(-(-counts[b] // _BUCKET_PIECE))]
    assert pieces.tolist() == [list(w) for w in want_pieces]
