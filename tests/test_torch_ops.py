"""The port's leaf ops and dense-voxel grid query against the JAX reference.

Same numpy inputs (seeded) through each ``ndjir_tpu`` function and its
``ndjir_torch`` counterpart on the CPU.  The grid query is compared on the
reference's 8-corner branch (the one the default G=512 f32 grid takes,
forced here by a zero z-dup budget) and on its z-dup branch, which gives
the same numbers: values, table gradients, the spatial gradient and the
gradient of a loss on the spatial gradient (the eikonal double backward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ndjir_tpu.ops.grid as jgrid
from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.models import brdf as jbrdf
from ndjir_tpu.ops import activations as jact
from ndjir_tpu.ops import directions as jdir
from ndjir_tpu.ops import encoding as jenc
from ndjir_tpu.ops import intersect as jint

from ndjir_torch.config import load_config
from ndjir_torch.models import brdf
from ndjir_torch.ops import activations, directions, encoding, grid, intersect
from ndjir_torch.ops.tv_loss import tv_sqrt

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, rtol=1e-6, atol=1e-6, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# encoding and activations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [0, 4, 6])
def test_positional_encoding(M):
    x = np.random.RandomState(0).uniform(-1, 1, (5, 7, 3)).astype(np.float32)
    got = encoding.positional_encoding(_t(x), M)
    assert got.shape[-1] == encoding.pe_dim(3, M) == jenc.pe_dim(3, M)
    # sin/cos of 2^k x: the two libraries' f32 sin agree to a few ulp
    _close(got, jenc.positional_encoding(jnp.asarray(x), M), 1e-5, 1e-6)


def test_activations():
    x = np.linspace(-0.5, 0.5, 2001).astype(np.float32)
    x = np.concatenate([x, [-30.0, -3.0, 0.0, 3.0, 30.0]]).astype(np.float32)
    for beta in (1.0, 100.0):
        # the port's fused softplus and the reference's stable form agree
        # to f32 rounding
        _close(activations.softplus(_t(x), beta),
               jact.softplus(jnp.asarray(x), beta), 1e-6, 1e-7)
    for name in ("relu", "softplus", "squareplus"):
        _close(activations.get_activation(name)(_t(x)),
               jact.get_activation(name)(jnp.asarray(x)), 1e-6, 1e-7, name)
    for name in ("relu", "softplus", "sigmoid"):
        _close(activations.get_last_activation(name, 0.5)(_t(x)),
               jact.get_last_activation(name, 0.5)(jnp.asarray(x)),
               1e-6, 1e-7, name)


# ---------------------------------------------------------------------------
# ray intersections
# ---------------------------------------------------------------------------

def _rays():
    """Cameras outside and inside the unit box, rays that hit, miss, graze
    a face and run parallel to an axis."""
    rng = np.random.RandomState(1)
    camloc = np.asarray([[0.1, -0.2, 2.5], [0.2, 0.1, 0.3],
                         [1.0, 1.0, 3.0]], np.float32)
    raydir = rng.randn(3, 40, 3).astype(np.float32)
    raydir[0, :20] -= np.asarray([0.0, 0.0, 4.0], np.float32)
    raydir[:, 0] = [0.0, 0.0, -1.0]                 # axis-parallel
    raydir[:, 1] = [1.0, 0.0, 0.0]
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    return camloc, raydir


def test_ray_sphere_intersection():
    camloc, raydir = _rays()
    got = intersect.ray_sphere_intersection(_t(camloc), _t(raydir), 1.0)
    want = jint.ray_sphere_intersection(jnp.asarray(camloc),
                                        jnp.asarray(raydir), 1.0)
    for g, w, name in zip(got, want, ("t_near", "t_far", "n_hits")):
        _close(g, w, 1e-5, 1e-5, name)


def test_ray_aabb_intersection_with_face_snapping():
    camloc, raydir = _rays()
    box = ([-1.0] * 3, [1.0] * 3)
    got = intersect.ray_aabb_intersection(_t(camloc), _t(raydir), *box)
    want = jint.ray_aabb_intersection(jnp.asarray(camloc),
                                      jnp.asarray(raydir), *box)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w, name in zip(got[:2], want[:2], ("t_near", "t_far")):
        _close(g, w, 1e-5, 1e-5, name)


# ---------------------------------------------------------------------------
# light directions and the BRDF
# ---------------------------------------------------------------------------

def _normals():
    rng = np.random.RandomState(2)
    n = rng.randn(2, 6, 3).astype(np.float32)
    # degenerate frames: exactly along +-z, and a hair off it
    n[0, 0] = [0.0, 0.0, 1.0]
    n[0, 1] = [0.0, 0.0, -1.0]
    n[0, 2] = [1e-9, 0.0, 1.0]
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def test_uniform_and_importance_directions():
    rng = np.random.RandomState(3)
    normal = _normals()
    the = rng.rand(2, 6, 8).astype(np.float32)
    phi = rng.rand(2, 6, 16).astype(np.float32)
    alpha = rng.uniform(0.05, 1.0, (2, 6, 1)).astype(np.float32)
    got = directions.sample_uniform_directions(_t(normal), _t(the), _t(phi))
    want = jdir.sample_uniform_directions(jnp.asarray(normal),
                                          jnp.asarray(the), jnp.asarray(phi))
    assert got.shape == (2, 6, 128, 3)
    _close(got, want, 1e-5, 1e-5, "uniform")
    got = directions.sample_importance_directions(
        _t(normal), _t(the), _t(phi), _t(alpha))
    want = jdir.sample_importance_directions(
        jnp.asarray(normal), jnp.asarray(the), jnp.asarray(phi),
        jnp.asarray(alpha))
    _close(got, want, 1e-5, 1e-5, "importance")
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("sampling", ["importance", "uniform"])
@pytest.mark.parametrize("model", ["filament", "ue4"])
def test_specular_brdf(model, sampling):
    rng = np.random.RandomState(4)
    ov = [f"specular_brdf.model={model}",
          f"specular_brdf.sampling={sampling}"]
    conf, jconf = load_config("default", ov), jax_load_config("default", ov)
    normal = _normals()
    view = -_normals()[:, :, None, :] * 0.5 + 0.3
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    light = rng.randn(2, 6, 16, 3).astype(np.float32)
    light /= np.linalg.norm(light, axis=-1, keepdims=True)
    rough = rng.uniform(0.05, 1.0, (2, 6, 1)).astype(np.float32)
    C = conf.specular_reflectance_network.channels
    spec = rng.uniform(0.0, 0.16, (2, 6, C)).astype(np.float32)
    got = brdf.specular_brdf_model(_t(normal), _t(view), _t(light),
                                   _t(rough), _t(spec), conf)
    want = jbrdf.specular_brdf_model(*map(jnp.asarray, (
        normal, view, light, rough, spec)), jconf)
    for g, w, name in zip(got, want, ("brdf", "cos")):
        assert g.shape == w.shape, name
        _close(g, w, 1e-5, 1e-6, name)


# ---------------------------------------------------------------------------
# dense voxel grid query (8-corner branch) with TV
# ---------------------------------------------------------------------------

G, D = 6, 4
VMIN, VMAX = (-0.7,) * 3, (0.7,) * 3


def _grid_inputs():
    rng = np.random.RandomState(5)
    F = rng.randn(G, G, G, D).astype(np.float32)
    x = rng.uniform(-0.8, 0.8, (3, 50, 3)).astype(np.float32)  # some outside
    x[0, 0] = [0.0, 0.0, 0.0]       # on a grid node
    x[0, 1] = VMAX                  # the far corner
    cot = rng.randn(3, 50, D).astype(np.float32)
    k = rng.randn(3, 50, 3).astype(np.float32)
    return F, x, cot, k


@pytest.fixture(params=["8corner", "zdup"])
def layout(request, monkeypatch):
    if request.param == "8corner":
        monkeypatch.setattr(jgrid, "_ZDUP_MAX_BYTES", 0)
    assert jgrid.use_zdup_layout((G, G, G, D)) == (request.param == "zdup")
    return request.param


def _jax_losses(weight, with_tv, sym):
    """Scalar functions of (F, x) whose gradients the test compares:
    the query against a cotangent (table and point gradients), and a
    loss on the spatial gradient of the query (the double backward)."""
    def query(F, x):
        if with_tv:
            f, tv = jgrid.query_voxel_and_tv(x, F, VMIN, VMAX, weight, sym)
            return f, tv
        return jgrid.query_voxel(x, F, VMIN, VMAX, weight), None

    def first(F, x, cot):
        f, tv = query(F, x)
        out = jnp.sum(f * cot)
        return out + (jnp.sum(tv * cot) if with_tv else 0.0)

    def second(F, x, cot, k):
        gx = jax.grad(first, argnums=1)(F, x, cot)
        return jnp.sum(gx * k) + jnp.sum(gx ** 2)
    return query, first, second


def _torch_query(weight, with_tv, sym):
    def query(F, x):
        if with_tv:
            return grid.query_voxel_and_tv(x, F, VMIN, VMAX, weight, sym)
        return grid.query_voxel(x, F, VMIN, VMAX, weight), None
    return query


@pytest.mark.parametrize("weight", ["linear", "cosine"])
@pytest.mark.parametrize("with_tv,sym", [(False, True), (True, True),
                                         (True, False)])
def test_voxel_query_values_and_gradients(layout, weight, with_tv, sym):
    F, x, cot, k = _grid_inputs()
    jquery, jfirst, jsecond = _jax_losses(weight, with_tv, sym)
    jF, jx, jcot, jk = map(jnp.asarray, (F, x, cot, k))
    want_f, want_tv = jquery(jF, jx)
    want_dF, want_dx = jax.grad(jfirst, argnums=(0, 1))(jF, jx, jcot)
    want_ddF, want_ddx = jax.grad(jsecond, argnums=(0, 1))(jF, jx, jcot, jk)

    tF = _t(F).requires_grad_(True)
    tx = _t(x).requires_grad_(True)
    got_f, got_tv = _torch_query(weight, with_tv, sym)(tF, tx)
    first = torch.sum(got_f * _t(cot))
    if with_tv:
        first = first + torch.sum(got_tv * _t(cot))
    got_dF, got_dx = torch.autograd.grad(first, (tF, tx), create_graph=True)
    second = torch.sum(got_dx * _t(k)) + torch.sum(got_dx ** 2)
    got_ddF, got_ddx = torch.autograd.grad(second, (tF, tx))

    # f32 sums of 8 weighted corners (and their derivatives) taken in
    # possibly another order: agreement to a few ulp of O(10) values
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(got_f, want_f, **tol, msg="features")
    if with_tv:
        _close(got_tv, want_tv, **tol, msg="tv")
    _close(got_dF, want_dF, **tol, msg="d table")
    _close(got_dx, want_dx, rtol=1e-5, atol=1e-4, msg="d x")
    # the double backward multiplies by the grid scale (G-1)/(vmax-vmin)
    # twice for cosine weights: values reach ~1e3
    _close(got_ddF, want_ddF, rtol=1e-4, atol=1e-3, msg="d table of d x")
    _close(got_ddx, want_ddx, rtol=1e-4, atol=1e-3, msg="d x of d x")


def test_grid_encoding_types():
    conf = load_config("default")
    enc = grid.GridEncoding(conf.geometric_network.voxel)
    assert (enc.type, enc.out_dim, enc.kind) == ("voxel", 4, "linear")
    # the other encodings are accepted and build the JAX package's leaves
    # at the default widths (on the meta device)
    for t in ("triplane", "voxel_hash", "lanczos_voxel"):
        c = load_config("default", [f"geometric_network.voxel.type={t}"])
        enc = grid.GridEncoding(c.geometric_network.voxel)
        jenc = jgrid.GridEncoding(jax_load_config(
            "default", [f"geometric_network.voxel.type={t}"])
            .geometric_network.voxel)
        assert (enc.type, enc.out_dim) == (t, jenc.out_dim)
        got = enc.init(torch.Generator(), device="meta")
        want = jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0)))
        assert {k: tuple(v.shape) for k, v in got.items()} \
            == {k: tuple(v.shape) for k, v in want.items()}
    with pytest.raises(ValueError, match="Unknown grid type"):
        grid.GridEncoding(load_config("default", [
            "geometric_network.voxel.type=octree"]).geometric_network.voxel)


def test_tv_sqrt_gradient_is_finite_at_zero():
    s = torch.tensor([0.0, 1e-30, 4.0], requires_grad=True)
    (g,) = torch.autograd.grad(tv_sqrt(s).sum(), s)
    # the reference's stabilized backward 0.5 * rsqrt(s + 1e-12)
    np.testing.assert_allclose(g.numpy(), 0.5 / np.sqrt([1e-12, 1e-12,
                                                          4.0 + 1e-12]),
                               rtol=1e-6)
    assert torch.isfinite(g).all()
