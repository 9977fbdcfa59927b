"""The port's octa table build (B3), prebuilt-table queries, ``render_image``
and image metrics against the JAX reference (CPU).

Sizes are tiny (G=16 grid, 64-wide geometry MLP, 8 + 4x4 samples per ray):
an f32 grid, which takes the 8-corner path, and a bf16 grid with a bf16
MLP, which takes the octa layout and so builds the octa table once per
``render_image`` call.  Both packages start from the JAX ``init_model``
parameters (bridged as numpy) and draw the same Monte-Carlo uniforms: the
port's ``make_mc_cdfs`` is replaced by the JAX package's draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ndjir_torch.render.image as timage
from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.data.cameras import generate_all_pixels as jax_all_pixels
from ndjir_tpu.eval.image import psnr as jax_psnr
from ndjir_tpu.eval.image import ssim as jax_ssim
from ndjir_tpu.models.fields import init_model as jax_init_model
from ndjir_tpu.ops.grid import _voxel_octa_flat
from ndjir_tpu.render.image import render_image as jax_render_image
from ndjir_tpu.render.renderer import make_mc_cdfs as jax_make_mc_cdfs

from ndjir_torch.bridge import params_from_numpy
from ndjir_torch.config import load_config
from ndjir_torch.data.cameras import generate_all_pixels
from ndjir_torch.data.dataset import IDRDataset
from ndjir_torch.data.synthetic import render_sphere_scene
from ndjir_torch.eval.image import psnr, ssim
from ndjir_torch.models.fields import with_octa_table
from ndjir_torch.ops import grid
from ndjir_torch.ops.octa_build import (
    _build_octa_table_plain,
    build_octa_table,
)

torch.set_num_threads(2)

TINY = ["geometric_network.voxel.grid_size=16",
        "geometric_network.feature_size=64", "renderer.n_samples0=8",
        "renderer.n_samples1=4", "renderer.n_bg_samples=4",
        "renderer.n_thetas=2",
        # an 8x8 view (16x16 halved) in chunks of 24 rays: 64 pixels
        # padded to 72
        "valid.n_down_samples=1", "valid.n_rays=24"]
BF16 = ["precision.grid_dtype=bfloat16", "precision.mlp_dtype=bfloat16"]
RUNS = {"f32": TINY, "bf16": TINY + BF16}
RES = (16, 16)
VMIN, VMAX = (-1.0,) * 3, (1.0,) * 3

# render tolerances, absolute, on [0, 1] colors, unit normals and [0, 1]
# masks.  f32: sums taken in another order move values by float32 ulps,
# which the composite keeps near 1e-5 (measured: 2e-6 color, 7e-6 normal).
# bf16 MLP: the two frameworks round at other places (JAX on the CPU keeps
# some bf16 values in f32), so colors and masks agree to about one bf16 ulp
# of their scale (2^-8; measured 1.1e-3), and the normal, a spatial
# gradient through the bf16 layers, to the bf16 slice test's gradient
# tolerance, 5e-2 of its unit scale (measured 2.1e-2)
TOL = {"f32": dict(image=1e-4, normal=1e-4, mask=1e-4),
       "bf16": dict(image=5e-3, normal=5e-2, mask=5e-3)}

# edge shapes of the octa build: non-cubic, axes of length 1 and 2
EDGE_SHAPES = [(5, 3, 7, 4), (5, 3, 7, 2), (1, 3, 2, 4), (2, 1, 1, 2),
               (1, 1, 1, 4), (2, 2, 2, 2), (3, 2, 1, 4)]


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _view():
    images, masks, cameras = render_sphere_scene(n_views=4, H=16, W=16)
    conf = load_config("default", overrides=TINY)
    ds = IDRDataset(conf, images, masks, cameras, train=False,
                    shuffle=False)
    return ds.poses[1:2], ds.intrinsics[1:2]


@pytest.fixture(scope="module")
def ref():
    """Per run: the port's conf and params, the reference's cdfs for one
    chunk and its rendered view (image, normal, mask)."""
    pose, intrinsic = _view()
    out = {"view": (pose, intrinsic)}
    for run, overrides in RUNS.items():
        jconf = jax_load_config("default", overrides=overrides)
        jparams = jax.jit(lambda k: jax_init_model(k, jconf))(
            jax.random.PRNGKey(0))
        conf = load_config("default", overrides=overrides)
        P = conf.valid.n_rays
        cdfs = _np(jax.jit(lambda: jax_make_mc_cdfs(jconf, 1, P))())
        out[run] = dict(
            conf=conf,
            params=params_from_numpy(_np(jparams), device="cpu", conf=conf),
            cdfs=cdfs,
            image=jax_render_image(jparams, pose, intrinsic, RES, jconf,
                                   return_aux=True))
    return out


def _render(ref, run, monkeypatch, **kw):
    r = ref[run]

    def cdfs(conf, B, R, dtype=torch.float32, device="cpu"):
        assert (B, R) == (1, conf.valid.n_rays)
        return {k: [torch.from_numpy(u).to(device) for u in v]
                if isinstance(v, list) else torch.from_numpy(v).to(device)
                for k, v in r["cdfs"].items()}
    monkeypatch.setattr(timage, "make_mc_cdfs", cdfs)
    return timage.render_image(r["params"], *ref["view"], RES, r["conf"],
                               return_aux=True, **kw)


# ---------------------------------------------------------------------------
# B3: the octa table build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gshape", EDGE_SHAPES, ids=str)
def test_octa_build_plain_is_the_reference_build_bitwise(gshape, dtype):
    a = np.random.RandomState(3).randn(*gshape).astype(np.float32)
    ja = jnp.asarray(a, dtype)
    want = np.asarray(_voxel_octa_flat(ja).astype(jnp.float32))
    base = torch.from_numpy(np.array(ja.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = _build_octa_table_plain(base)
    assert got.dtype == base.dtype
    assert got.shape == (np.prod(gshape[:3]), 8 * gshape[3])
    # bitwise: bf16 -> f32 is exact, so equal f32 values are equal bits
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(build_octa_table(base), got)


def test_octa_build_rows_are_the_clamped_corners():
    base = torch.randn(4, 3, 5, 2)
    table = build_octa_table(base)
    ids = torch.arange(4 * 3 * 5)
    corners = grid.octa_corner_ids(ids, base.shape)
    want = base.reshape(-1, 2)[corners.reshape(-1)].reshape(-1, 16)
    assert torch.equal(table, want)


def test_octa_build_refuses_a_table_that_requires_grad():
    base = torch.randn(2, 2, 2, 4, requires_grad=True)
    with pytest.raises(ValueError, match="frozen"):
        build_octa_table(base)
    with pytest.raises(ValueError, match="Gx, Gy, Gz, D"):
        build_octa_table(torch.zeros(4, 4))


# ---------------------------------------------------------------------------
# queries from a prebuilt table
# ---------------------------------------------------------------------------

def _octa_inputs():
    rng = np.random.RandomState(5)
    F = torch.from_numpy(rng.randn(16, 16, 16, 4).astype(np.float32)) \
        .to(torch.bfloat16)
    # points inside and outside the box, so ids clamp at every face
    x = torch.from_numpy(rng.uniform(-1.2, 1.2, (37, 5, 3))
                         .astype(np.float32))
    return F, x


@pytest.mark.parametrize("weight", ["linear", "cosine"])
@pytest.mark.parametrize("with_tv", [False, True])
def test_prebuilt_table_query_is_the_gather_bitwise(weight, with_tv):
    """Values bitwise equal to ``GatherRowsOcta``'s forward, and the same
    spatial gradient (it flows through the weights alone)."""
    F, x = _octa_inputs()
    table = build_octa_table(F)
    outs = []
    for t in (None, table):
        xx = x.clone().requires_grad_(True)
        if with_tv:
            v, tv = grid.query_voxel_and_tv(xx, F, VMIN, VMAX, weight,
                                            octa_table=t)
            y = v.sum() + tv.sum()
        else:
            v = grid.query_voxel(xx, F, VMIN, VMAX, weight, octa_table=t)
            tv, y = None, v.sum()
        (gx,) = torch.autograd.grad(y, xx)
        outs.append((v.detach(), tv if tv is None else tv.detach(), gx))
    (v0, tv0, g0), (v1, tv1, g1) = outs
    assert torch.equal(v0, v1)
    assert tv0 is None or torch.equal(tv0, tv1)
    assert torch.equal(g0, g1)
    a, b = grid.voxel_gather_multi([x, x[:3]], F, VMIN, VMAX, table)
    a0, b0 = grid.voxel_gather_multi([x, x[:3]], F, VMIN, VMAX)
    assert torch.equal(a, a0) and torch.equal(b, b0)


def test_prebuilt_table_refuses_a_base_that_requires_grad():
    F, x = _octa_inputs()
    table = build_octa_table(F)
    with pytest.raises(RuntimeError, match="GatherRowsOcta"):
        grid.query_voxel(x, F.clone().requires_grad_(True), VMIN, VMAX,
                         octa_table=table)
    with pytest.raises(ValueError, match="not the build"):
        grid.query_voxel(x, F, VMIN, VMAX, octa_table=table[:-1])


def test_with_octa_table_attaches_only_on_the_octa_layout(ref):
    p32 = ref["f32"]["params"]
    assert with_octa_table(p32, ref["f32"]["conf"]) is p32
    p16, conf = ref["bf16"]["params"], ref["bf16"]["conf"]
    got = with_octa_table(p16, conf)
    g = got["geometric-network"]["grid"]
    assert "octa_table" not in p16["geometric-network"]["grid"]
    assert torch.equal(g["octa_table"], _build_octa_table_plain(g["F"]))
    assert g["F"] is p16["geometric-network"]["grid"]["F"]
    assert with_octa_table(got, conf) is got   # built once per call


# ---------------------------------------------------------------------------
# render_image
# ---------------------------------------------------------------------------

def test_generate_all_pixels_matches():
    np.testing.assert_array_equal(generate_all_pixels(5, 3),
                                  jax_all_pixels(5, 3))


@pytest.mark.parametrize("run", list(RUNS))
def test_render_image_matches_the_reference(ref, run, monkeypatch):
    got = _render(ref, run, monkeypatch)
    want = ref[run]["image"]
    for name, g, w in zip(("image", "normal", "mask"), got, want):
        assert g.shape == w.shape and g.dtype == np.float32, name
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL[run][name],
                                   err_msg=name)
    assert got[0].shape == (1, 3, 8, 8)
    assert got[0].min() >= 0.0 and got[0].max() <= 1.0


def test_render_image_builds_the_table_once_per_call(ref, monkeypatch):
    """Every chunk of a bf16 view reads one prebuilt table: the build runs
    once per call, and the result is the one gathered from the base."""
    import ndjir_torch.models.fields as tfields

    calls = []
    real = tfields.build_octa_table

    def counted(base):
        calls.append(tuple(base.shape))
        return real(base)
    monkeypatch.setattr(tfields, "build_octa_table", counted)
    _render(ref, "bf16", monkeypatch)
    assert calls == [(16, 16, 16, 4)]
    _render(ref, "f32", monkeypatch)
    assert len(calls) == 1


def test_render_image_takes_the_given_gain(ref, monkeypatch):
    """``lv_gain`` reaches the photogrammetric light: an explicit value
    other than the schedule's end changes the image."""
    a = _render(ref, "f32", monkeypatch)[0]
    b = _render(ref, "f32", monkeypatch, lv_gain=0.1)[0]
    assert not np.array_equal(a, b)


# ---------------------------------------------------------------------------
# image metrics
# ---------------------------------------------------------------------------

def test_psnr_and_ssim_match():
    rng = np.random.RandomState(2)
    a = rng.rand(1, 3, 20, 24)
    b = np.clip(a + 0.05 * rng.randn(*a.shape), 0, 1)
    mask = rng.rand(1, 1, 20, 24) > 0.3
    assert psnr(a, b) == jax_psnr(a, b)
    assert psnr(a, b, mask) == jax_psnr(a, b, mask)
    assert psnr(a, a) == float("inf")
    hw = a[0].transpose(1, 2, 0), b[0].transpose(1, 2, 0)
    assert ssim(*hw) == jax_ssim(*hw)
    assert ssim(hw[0][..., 0], hw[1][..., 0]) \
        == jax_ssim(hw[0][..., 0], hw[1][..., 0])
