"""The port's other grid encodings and their TV maps against the JAX package.

Same numpy inputs (seeded) through each ``ndjir_tpu.ops.grid`` /
``ndjir_tpu.ops.tv_loss`` function and its ``ndjir_torch`` counterpart on
the CPU, where the port's ``gather_rows`` backward is the scatter kernel's
plain version and the JAX package's runs as its own tests run it: values,
the table gradient, the gradient in the query point and the gradient of a
loss on that gradient (the eikonal double backward).  Also the voxel hash's
ids where uint32 products wrap and the hash sizing, and ``GridEncoding``
for every type.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ndjir_tpu.ops.grid as jgrid
import ndjir_tpu.ops.tv_loss as jtv
from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.models.fields import init_model as jax_init_model

from ndjir_torch.bridge import params_to_numpy
from ndjir_torch.config import load_config
from ndjir_torch.models.fields import init_model
from ndjir_torch.ops import grid, lattice, tv_loss
from ndjir_torch.ops.encoding import pe_dim
from ndjir_torch.train.optim import tree_leaves_with_path

torch.set_num_threads(2)

VMIN, VMAX = (-0.7,) * 3, (0.7,) * 3
# a small hash: 4 levels from G=5, tables of at most 2^6 rows (the finer
# levels collide), D=2
HASH = dict(G0=5, growth_factor=1.6, T0=2 ** 6, L=4, D=2)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, rtol, atol, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _points(rng, n=60):
    """Query points, some outside the box (where Lanczos taps clamp and
    ``floor`` is not clamped first), none on a grid node."""
    return rng.uniform(-0.8, 0.8, (3, n // 3, 3)).astype(np.float32)


def _table(rng, name):
    if name.startswith("voxel_hash"):
        n = jgrid.hash_num_params(HASH["G0"], HASH["growth_factor"],
                                  HASH["T0"], HASH["L"], HASH["D"])
        return rng.randn(n).astype(np.float32)
    if name.startswith("voxel"):
        return rng.randn(6, 5, 7, 3).astype(np.float32)
    if name.startswith("triplane"):
        return rng.randn(3, 6, 6, 4).astype(np.float32)
    return rng.randn(3, 9, 4).astype(np.float32)  # triline


def _queries(name, lib):
    """``(x, F) -> features`` of the query ``name`` in ``lib``."""
    base, _, weight = name.partition(":")
    if base.startswith("voxel_hash"):
        fn = getattr(lib, f"query_{base}")
        return lambda x, F: fn(x, F, *HASH.values(), VMIN, VMAX)
    fn = getattr(lib, f"query_{base}")
    if weight:
        return lambda x, F: fn(x, F, VMIN, VMAX, weight)
    return lambda x, F: fn(x, F, VMIN, VMAX)


QUERIES = ["voxel_lanczos", "triplane:linear", "triplane:cosine",
           "triplane_lanczos", "triline:linear", "triline:cosine",
           "triline_lanczos", "voxel_hash", "voxel_hash_lanczos"]


def _jax_all(jq, F, x, cot, k, dtype):
    """Features, d table, d x, and d table and d x of a loss on d x, by
    the JAX package at ``dtype``."""
    F, x, cot, k = (jnp.asarray(a, dtype) for a in (F, x, cot, k))

    def first(F, x):
        return jnp.sum(jq(x, F) * cot)

    def second(F, x):
        gx = jax.grad(first, argnums=1)(F, x)
        return jnp.sum(gx * k) + jnp.sum(gx ** 2)

    out = [jq(x, F), *jax.grad(first, argnums=(0, 1))(F, x),
           *jax.grad(second, argnums=(0, 1))(F, x)]
    return [np.asarray(o, np.float64) for o in out]


def _torch_all(tq, F, x, cot, k, dtype):
    """The same five by the port at ``dtype``."""
    F, x, cot, k = (_t(a).to(dtype) for a in (F, x, cot, k))
    F.requires_grad_(True)
    x.requires_grad_(True)
    f = tq(x, F)
    dF, dx = torch.autograd.grad(torch.sum(f * cot), (F, x),
                                 create_graph=True)
    # a linear weight's d x does not depend on x: no d x of d x then
    ddF, ddx = torch.autograd.grad(torch.sum(dx * k) + torch.sum(dx ** 2),
                                   (F, x), allow_unused=True)
    ddx = torch.zeros_like(x) if ddx is None else ddx
    return [o.detach().double().numpy() for o in (f, dF, dx, ddF, ddx)]


NAMES = ["features", "d table", "d x", "d table of d x", "d x of d x"]


@pytest.mark.parametrize("name", QUERIES)
def test_query_values_and_gradients(name):
    """In f64 the port computes the JAX package's numbers: each of the five
    within 1e-6 of its largest entry (both sum a table's gradient in f32).
    In f32, where a Lanczos tap's sinc cancels near its own node and the
    derivatives scale by (G-1)/(vmax-vmin) once or twice, the port is no
    further from the f64 numbers than twice the JAX package's own f32
    error, plus 1e-6 of the largest entry."""
    rng = np.random.RandomState(11)
    F = _table(rng, name)
    x = _points(rng)
    jq, tq = _queries(name, jgrid), _queries(name, grid)
    D = np.asarray(jq(jnp.asarray(x), jnp.asarray(F))).shape[-1]
    cot = rng.randn(*x.shape[:-1], D).astype(np.float32)
    k = rng.randn(*x.shape).astype(np.float32)
    args = (F, x, cot, k)

    with jax.enable_x64(True):
        exact = _jax_all(jq, *args, jnp.float64)
    want32 = _jax_all(jq, *args, jnp.float32)
    got64 = _torch_all(tq, *args, torch.float64)
    got32 = _torch_all(tq, *args, torch.float32)
    for n, e, w, g64, g32 in zip(NAMES, exact, want32, got64, got32):
        scale = max(np.abs(e).max(), 1e-30)
        assert g32.shape == e.shape, n
        assert np.abs(g64 - e).max() <= 1e-6 * scale, n
        assert np.abs(g32 - e).max() \
            <= 2 * np.abs(w - e).max() + 1e-6 * scale, n


def test_lanczos_window_has_no_cutoff():
    x = np.linspace(-3.5, 3.5, 141).astype(np.float32)
    got = grid.lanczos_window(_t(x))
    # beyond |x| = 2 the reference keeps sinc(x) sinc(x/2), nonzero
    assert np.abs(got.numpy()[np.abs(x) > 2.2]).max() > 1e-3
    _close(got, jgrid.lanczos_window(jnp.asarray(x)), 1e-6, 1e-6)


TV = ["voxel", "triplane", "triline", "voxel_hash"]


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("family", TV)
def test_tv_values_and_table_gradient(family, sym):
    rng = np.random.RandomState(3)
    F = _table(rng, family)
    x = _points(rng)
    hash_args = tuple(HASH.values()) if family == "voxel_hash" else ()

    def jtv_fn(F, x):
        return getattr(jtv, f"tv_loss_{family}")(x, F, *hash_args, VMIN,
                                                 VMAX, sym_backward=sym)

    want = jtv_fn(jnp.asarray(F), jnp.asarray(x))
    cot = rng.randn(*want.shape).astype(np.float32)
    want_dF = jax.grad(lambda F: jnp.sum(jtv_fn(F, jnp.asarray(x)) * cot))(
        jnp.asarray(F))

    tF = _t(F).requires_grad_(True)
    got = getattr(tv_loss, f"tv_loss_{family}")(_t(x), tF, *hash_args, VMIN,
                                                VMAX, sym_backward=sym)
    (got_dF,) = torch.autograd.grad(torch.sum(got * _t(cot)), tF)
    # f32 differences and square roots: a few ulp of O(1)
    _close(got, want, 1e-5, 1e-5, "tv")
    _close(got_dF, want_dF, 1e-5, 1e-5, "d table")


def test_tv_asymmetric_backward_stops_the_base_corner():
    rng = np.random.RandomState(4)
    F = _table(rng, "triline")
    x = _t(_points(rng))
    grads = []
    for sym in (True, False):
        tF = _t(F).requires_grad_(True)
        tv = tv_loss.tv_loss_triline(x, tF, VMIN, VMAX, sym_backward=sym)
        grads.append(torch.autograd.grad(tv.sum(), tF)[0])
    assert not torch.equal(grads[0], grads[1])


# (G, T): level 15 of the voxel_hash preset, int(16 * 1.5^15) = 7006 and
# 2^15 rows, and a coarse level whose table holds every corner
@pytest.mark.parametrize("G,T", [(7006, 2 ** 15), (16, 4096), (1000, 4099)])
def test_hash_index_where_int32_products_overflow(G, T):
    rng = np.random.RandomState(G)
    x = rng.uniform(-1.05, 1.05, (200, 3)).astype(np.float32)
    x[:4] = [[1, 1, 1], [0.99999, 0.99999, 0.99999], [-1, 1, -1],
             [1, -1, 1]]     # corners reach G - 1 on every axis
    got = grid.hash_index(_t(x), G, T).numpy()
    want = np.asarray(jgrid.hash_index(jnp.asarray(x), G, T))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < T
    if G > 1000:
        # the wrapped product is what an int32 multiply would get wrong
        assert (G - 1) * jgrid._HASH_PRIMES[1] > 2 ** 31


@pytest.mark.parametrize("G,T", [(7006, 2 ** 15), (11, 1331)])
def test_hash_index_leveled_matches(G, T):
    rng = np.random.RandomState(T)
    ixyz = rng.randint(0, G, (3, 500, 2)).astype(np.int32)
    ixyz[:, 0] = G - 1
    Ts = np.asarray([T, 97], np.uint32)
    got = grid._hash_index(*map(lambda a: _t(a).long(), ixyz),
                           _t(Ts.astype(np.int64)))
    want = jgrid._hash_index_leveled(*map(jnp.asarray, ixyz),
                                     jnp.asarray(Ts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("G0,growth,T0,L,D", [
    (16, 1.5, 2 ** 15, 16, 4),     # the voxel_hash preset
    (16, 1.5, 2 ** 15, 16, 2),
    (5, 1.6, 2 ** 6, 4, 2),
    (3, 2.0, 100, 6, 3),           # T*D not a multiple of 8: the quirk
])
def test_hash_sizing(G0, growth, T0, L, D):
    assert grid.hash_num_params(G0, growth, T0, L, D) \
        == jgrid.hash_num_params(G0, growth, T0, L, D)
    assert lattice.hash_level_offsets(G0, growth, T0, L, D) \
        == jgrid.hash_level_offsets(G0, growth, T0, L, D)
    for size in (0, 3, 4, 12, 13, 100):
        assert lattice._force_align(size) == jgrid._force_align(size)


def test_hash_preset_rows():
    # the voxel_hash preset: 476,672 rows of 4, levels 0 and 1 of 4,096
    # and 13,824 rows (every corner), the rest 2^15
    levels = lattice.hash_level_offsets(16, 1.5, 2 ** 15, 16, 4)
    assert grid.hash_num_params(16, 1.5, 2 ** 15, 16, 4) == 476_672 * 4
    assert [T for _, _, T in levels[:3]] == [4096, 13824, 32768]


TYPES = [t for t in grid.GridEncoding.TYPES if t != "none"]


def _conf(lib_load, t, extra=()):
    return lib_load("tiny_test", [f"geometric_network.voxel.type={t}",
                                  "geometric_network.voxel.grid_size=8",
                                  "geometric_network.voxel.hash_levels=3",
                                  "geometric_network.voxel.hash_table_size=64",
                                  *extra])


@pytest.mark.parametrize("t", TYPES)
def test_grid_encoding_apply_with_tv(t):
    """Every type through ``GridEncoding.apply_with_tv``: features, TV map
    and the table gradient of both, from the same table."""
    jenc = jgrid.GridEncoding(_conf(jax_load_config, t)
                              .geometric_network.voxel, radius=0.7)
    tenc = grid.GridEncoding(_conf(load_config, t).geometric_network.voxel,
                             radius=0.7)
    assert tenc.out_dim == jenc.out_dim
    params = jax.tree_util.tree_map(np.asarray,
                                    jenc.init(jax.random.PRNGKey(1)))
    rng = np.random.RandomState(9)
    params = {k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()}
    x = _points(rng)

    def jfn(p):
        f, tv = jenc.apply_with_tv(p, jnp.asarray(x))
        return jnp.sum(f * jnp.cos(f)) + jnp.sum(tv), (f, tv)

    (_, (want_f, want_tv)), want_g = jax.value_and_grad(jfn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    tp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    got_f, got_tv = tenc.apply_with_tv(tp, _t(x))
    got_g = torch.autograd.grad(torch.sum(got_f * torch.cos(got_f))
                                + torch.sum(got_tv), list(tp.values()))
    assert got_f.shape == want_f.shape and got_tv.shape == want_tv.shape
    # f32 sums of up to 64 taps over many points, reassociated: each array
    # within 1e-5 of its largest entry
    for n, g, w in [("features", got_f, want_f), ("tv", got_tv, want_tv)] \
            + [(k, g, want_g[k]) for k, g in zip(tp, got_g)]:
        w = np.asarray(w)
        assert np.abs(g.detach().numpy() - w).max() \
            <= 1e-5 * np.abs(w).max(), n


@pytest.mark.parametrize("t", TYPES)
def test_grid_encoding_init_under_bf16_grid(t):
    """``out_dim``, and ``init_model``'s grid leaves: the JAX package's
    names and shapes, every one in ``precision.grid_dtype`` (bf16 here),
    N(0, 1e-3), and the geometric MLP's input width from ``out_dim``."""
    extra = ["precision.grid_dtype=bfloat16"]
    jconf = _conf(jax_load_config, t, extra)
    want = jax.eval_shape(lambda: jax_init_model(jax.random.PRNGKey(0),
                                                 jconf))
    got = init_model(_conf(load_config, t, extra), seed=0, device="cpu")
    want_leaves = dict(tree_leaves_with_path(want))
    got_leaves = dict(tree_leaves_with_path(got))
    assert set(got_leaves) == set(want_leaves)
    for path, w in want_leaves.items():
        g = got_leaves[path]
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
    grid_leaves = got["geometric-network"]["grid"]
    assert set(grid_leaves) == ({"plane_F", "line_F"}
                                if t.endswith("triplaneline") else {"F"})
    for leaf in grid_leaves.values():
        assert leaf.dtype == torch.bfloat16
        assert abs(leaf.float().std().item() / 1e-3 - 1) < 0.1
    g = _conf(load_config, t).geometric_network
    W0 = params_to_numpy(got)["geometric-network"]["affine-00"]["W"]
    assert W0.shape[0] == pe_dim(3, g.pe_bands) \
        + grid.GridEncoding(g.voxel).out_dim
