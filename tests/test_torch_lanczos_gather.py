"""The Lanczos-voxel query's gather kernel against the composite it stands
in for.

``query_voxel_lanczos`` launches ``csrc/lanczos_voxel_gather.cu`` for a
query on the card that builds no autograd graph, and runs the composite of
PyTorch ops everywhere else.  The tests marked ``cuda`` (skipped without an
NVIDIA GPU) hold the kernel to the composite on the card bitwise: at the
proposal sampler's shapes on the 512^3 x 4 table, at points outside the
box, on its faces and corners, near grid nodes (the sinc polynomial
branch), infinite points, and D = 1 and 8 on a table of three different
sides; they also check that a NaN point comes out NaN, which calls launch
the kernel, and that output counts PyTorch sums in another order than the
kernel's take the composite.  The CPU tests check that the dispatch leaves
the CPU to the composite.  The file imports no JAX:
``python3 -m pytest tests/test_torch_lanczos_gather.py -q``.
"""

import numpy as np
import pytest
import torch

from ndjir_torch import kernels
from ndjir_torch.ops import grid, lanczos_gather

torch.set_num_threads(2)

BOX = ((-1.0,) * 3, (1.0,) * 3)
# a box of three sides and an off-centre table of three sides, so that a
# mixed-up axis, stride or bound shows
ODD_BOX = ((-1.0, -0.5, -2.0), (1.5, 0.5, 2.0))
ODD_SIDES = (40, 50, 64)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the gather kernel has no CPU mode")
    return torch.device("cuda")


def _composite(x, table, box):
    with torch.no_grad():
        return grid._query_voxel_lanczos_composite(x, table, *box, 2)


def _kernel(x, table, box):
    with torch.no_grad():
        return lanczos_gather.lanczos_voxel_gather(x, table, *box)


def _assert_bitwise(got, want, label):
    """Equal bits, NaN included; on failure the largest difference in ulp
    among the finite values."""
    g = got.cpu().contiguous().view(torch.int32)
    w = want.cpu().contiguous().view(torch.int32)
    if torch.equal(g, w):
        return
    # ulp distance on the ordered integer line of f32 bit patterns
    def ordered(b):
        b = b.long()
        return torch.where(b < 0, -(b & 0x7FFFFFFF), b)
    finite = torch.isfinite(got.cpu()) & torch.isfinite(want.cpu())
    ulp = (ordered(g) - ordered(w)).abs()[finite]
    raise AssertionError(
        f"{label}: {int((g != w).sum())} of {g.numel()} values differ, "
        f"largest {int(ulp.max()) if ulp.numel() else 'n/a'} ulp among "
        f"finite ones; NaN where the composite has none: "
        f"{int((torch.isnan(got.cpu()) & ~torch.isnan(want.cpu())).sum())}")


def _table(sides, d, device, seed=5):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((*sides, d), generator=g, device=device)


def _ray_points(rng, rays, samples):
    """Points along rays from cameras outside the unit box towards its
    middle, sorted along each ray, some past the box: the proposal
    sampler's queries."""
    cam = rng.normal(size=(rays, 1, 3))
    cam *= rng.uniform(2.0, 3.5, (rays, 1, 1)) / np.linalg.norm(
        cam, axis=-1, keepdims=True)
    target = rng.uniform(-0.6, 0.6, (rays, 1, 3))
    d = (target - cam) / np.linalg.norm(target - cam, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0.5, 6.0, (rays, samples, 1)), axis=1)
    return (cam + t * d).astype(np.float32)


def _edge_points(sides, box):
    """Outside the box, on its faces and corners, on and within 1e-4 grid
    units of the nodes (the sinc polynomial branch, |pi r| < 0.1), either
    side of that branch's edge (r = 0.1 / pi)."""
    rng = np.random.RandomState(3)
    lo, hi = np.array(box[0]), np.array(box[1])
    g1 = np.array(sides) - 1.0
    span = hi - lo
    pts = [rng.uniform(lo - 0.6 * span, hi + 0.6 * span, (200, 3))]
    corners = np.array([[(lo, hi)[b >> a & 1][a] for a in range(3)]
                        for b in range(8)])
    pts.append(corners)
    face = rng.uniform(lo, hi, (60, 3))
    for a in range(3):
        face[20 * a:20 * a + 10, a] = lo[a]
        face[20 * a + 10:20 * a + 20, a] = hi[a]
    pts.append(face)
    nodes = rng.randint(0, g1.astype(int) + 1, (40, 3)).astype(np.float64)
    for off in (0.0, 1e-7, -1e-6, 1e-5, -3e-5, 1e-4, 0.1 / np.pi - 1e-6,
                0.1 / np.pi + 1e-6, -0.1 / np.pi):
        pts.append(lo + (nodes + off) * span / g1)
    return np.concatenate(pts).astype(np.float32)


def _special_points(box):
    """Points with a NaN or an infinite coordinate among finite ones,
    enough finite ones that both the kernel's call and the composite's on
    the points it runs sum in the kernel's order."""
    rng = np.random.RandomState(4)
    x = rng.uniform(box[0], box[1], (48, 3))
    x[0, 0] = x[1, 1] = x[2, 2] = np.nan
    x[3, 0], x[4, 1], x[5, 2] = np.inf, -np.inf, np.inf
    x[6] = np.nan
    x[7] = (np.nan, np.inf, -np.inf)
    return x.astype(np.float32)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("samples", [64, 16])
def test_kernel_is_the_composite_at_the_sampler_shapes(cuda, samples):
    table = _table((512,) * 3, 4, cuda)
    x = torch.from_numpy(_ray_points(np.random.RandomState(samples), 2048,
                                     samples)).to(cuda)
    got, want = _kernel(x, table, BOX), _composite(x, table, BOX)
    assert got.shape == want.shape == (2048, samples, 4)
    _assert_bitwise(got, want, f"2048 x {samples} points, 512^3 x 4")


@pytest.mark.cuda
@pytest.mark.parametrize("sides,box", [((512,) * 3, BOX),
                                       (ODD_SIDES, ODD_BOX)])
def test_kernel_is_the_composite_at_edges(cuda, sides, box):
    table = _table(sides, 4, cuda)
    x = torch.from_numpy(_edge_points(sides, box)).to(cuda)
    got, want = _kernel(x, table, box), _composite(x, table, box)
    _assert_bitwise(got, want, f"edge points, {sides}")


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(1, 128), (1, 1000), (4, 32), (4, 3001),
                                 (8, 16), (8, 777)])
def test_kernel_is_the_composite_at_every_width(cuda, d, n):
    table = _table(ODD_SIDES, d, cuda)
    rng = np.random.RandomState(d * 10_000 + n)
    lo, hi = np.array(ODD_BOX[0]), np.array(ODD_BOX[1])
    x = torch.from_numpy(rng.uniform(lo - 0.2, hi + 0.2, (n, 3))
                         .astype(np.float32)).to(cuda)
    got, want = _kernel(x, table, ODD_BOX), _composite(x, table, ODD_BOX)
    assert got.shape == (n, d)
    _assert_bitwise(got, want, f"D={d}, N={n}")


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(1, 1), (1, 127), (1, 1001), (4, 1),
                                 (4, 31), (8, 1), (8, 15)])
def test_query_takes_the_composite_where_the_sum_order_differs(cuda, d, n):
    """N*D below 128 or not a multiple of 4: PyTorch sums the taps in
    another order than the kernel's, so the query keeps the composite and
    the kernel refuses the call."""
    table = _table(ODD_SIDES, d, cuda)
    rng = np.random.RandomState(d * 10_000 + n)
    x = torch.from_numpy(rng.uniform(-1.0, 1.0, (n, 3))
                         .astype(np.float32)).to(cuda)
    before = kernels.LAUNCHES["lanczos_voxel_gather"]
    with torch.no_grad():
        got = grid.query_voxel_lanczos(x, table, *ODD_BOX)
    assert kernels.LAUNCHES["lanczos_voxel_gather"] == before
    _assert_bitwise(got, _composite(x, table, ODD_BOX), f"D={d}, N={n}")
    with pytest.raises(ValueError):
        _kernel(x, table, ODD_BOX)


@pytest.mark.cuda
def test_query_launches_the_kernel_only_where_no_graph_is_built(cuda):
    table = _table(ODD_SIDES, 4, cuda)
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1.0, 1.0, (300, 3)).astype(np.float32)).to(cuda)

    def launches(fn):
        before = kernels.LAUNCHES["lanczos_voxel_gather"]
        out = fn()
        return out, kernels.LAUNCHES["lanczos_voxel_gather"] - before

    with torch.no_grad():
        ref, n = launches(lambda: grid.query_voxel_lanczos(x, table,
                                                           *ODD_BOX))
    assert n == 1
    _, n = launches(lambda: grid.query_voxel_lanczos(x, table, *ODD_BOX))
    assert n == 1   # grad mode on, but nothing requires grad
    table.requires_grad_(True)
    with torch.no_grad():
        _, n = launches(lambda: grid.query_voxel_lanczos(x, table,
                                                         *ODD_BOX))
    assert n == 1   # the sampler's case: leaves require grad, grad mode off
    for xg, tg in ((True, False), (False, True), (True, True)):
        xq = x.clone().requires_grad_(xg)
        table.requires_grad_(tg)
        with torch.enable_grad():
            out, n = launches(lambda: grid.query_voxel_lanczos(xq, table,
                                                               *ODD_BOX))
        assert n == 0 and out.grad_fn is not None
        _assert_bitwise(out.detach(), ref, "the composite's graph")
        out.sum().backward()
        assert (xq.grad is not None) == xg
        assert (table.grad is not None) == tg
        table.grad = None


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    table = _table(ODD_SIDES, 4, cuda)
    x = torch.zeros(64, 3, device=cuda)
    with pytest.raises(TypeError):
        lanczos_gather.lanczos_voxel_gather(x, table.bfloat16(), *BOX)
    with pytest.raises(TypeError):
        lanczos_gather.lanczos_voxel_gather(x.double(), table, *BOX)
    with pytest.raises(ValueError):
        lanczos_gather.lanczos_voxel_gather(x, table.transpose(0, 1), *BOX)
    with pytest.raises(ValueError):
        lanczos_gather.lanczos_voxel_gather(x.cpu(), table, *BOX)
    # a bf16 table on the card is the composite's
    before = kernels.LAUNCHES["lanczos_voxel_gather"]
    with torch.no_grad():
        out = grid.query_voxel_lanczos(x, table.bfloat16(), *BOX)
    assert kernels.LAUNCHES["lanczos_voxel_gather"] == before
    assert out.shape == (64, 4)


@pytest.mark.cuda
def test_kernel_propagates_nan_and_inf(cuda):
    """A NaN or infinite coordinate makes every channel of its point NaN.
    The composite agrees bitwise where it runs: at infinite coordinates,
    whose taps clamp into the table.  At a NaN one its taps' int64 cast
    lies outside the table and its ``index_select`` asserts on the card,
    so there the kernel's NaN is checked alone."""
    table = _table(ODD_SIDES, 4, cuda)
    x = torch.from_numpy(_special_points(ODD_BOX)).to(cuda)
    got = _kernel(x, table, ODD_BOX)
    assert torch.isnan(got[:8]).all() and not torch.isnan(got[8:]).any()
    runs = ~torch.isnan(x).any(-1)
    assert int(runs[:8].sum()) == 3
    _assert_bitwise(got[runs], _composite(x[runs], table, ODD_BOX),
                    "infinite and finite points")


# --------------------------------------------------------------------------
# on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d,shape", [(4, (2, 17)), (1, (31,)), (8, (5, 3))])
def test_cpu_query_is_the_composite_with_and_without_grad(monkeypatch, d,
                                                          shape):
    def refuse(*args):
        raise AssertionError("the gather kernel was called on the CPU")
    monkeypatch.setattr(grid, "lanczos_voxel_gather", refuse)
    rng = np.random.RandomState(d)
    table = torch.from_numpy(rng.randn(*ODD_SIDES, d).astype(np.float32))
    x = torch.from_numpy(_edge_points(ODD_SIDES, ODD_BOX)[:np.prod(shape)]
                         .reshape(*shape, 3))
    with torch.no_grad():
        no_grad = grid.query_voxel_lanczos(x, table, *ODD_BOX)
    xg = x.clone().requires_grad_(True)
    with torch.enable_grad():
        with_grad = grid.query_voxel_lanczos(xg, table, *ODD_BOX)
    assert no_grad.shape == (*shape, d) and with_grad.grad_fn is not None
    assert torch.equal(no_grad, with_grad.detach())
    assert torch.equal(no_grad, _composite(x, table, ODD_BOX))


@pytest.mark.parametrize("outputs,takes", [
    (1, False), (2, False), (124, False), (127, False), (128, True),
    (130, False), (2048 * 64 * 4, True)])
def test_kernel_takes_the_output_counts_summed_in_warps(outputs, takes):
    assert lanczos_gather.sums_in_warps(outputs) is takes


def test_kernel_is_registered_and_refuses_cpu_tensors():
    lib = kernels.LIBRARIES["lanczos_voxel_gather"]
    assert (lib.source, lib.compiler) == ("lanczos_voxel_gather.cu", "nvcc")
    assert list(lib.functions) == ["lanczos_voxel_gather"]
    assert "lanczos_voxel_gather" in kernels.LAUNCHES
    with pytest.raises(ValueError):
        lanczos_gather.lanczos_voxel_gather(torch.zeros(4, 3),
                                            torch.zeros(8, 8, 8, 4), *BOX)
