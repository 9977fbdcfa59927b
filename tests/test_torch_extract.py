"""The port's mesh extraction against the JAX reference (CPU): SDF volume,
iso-surface, per-vertex attributes, environment map, mask trimming,
components and OBJ text.

Sizes are tiny (G=16 grid, 64-wide geometry MLP, a 12^3 SDF volume in
batches of 500 points, so the last batch is padded), at an f32 grid and at
a bf16 grid with a bf16 MLP, which takes the octa layout.  Both packages
start from the JAX ``init_model`` parameters, bridged as numpy.  The host
steps (iso-surface, trimming, components, files) get identical inputs and
must give identical outputs.
"""

import os
import subprocess

import cv2
import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

import ndjir_torch.models.fields as tfields
from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.extract import mc as jmc
from ndjir_tpu.extract import native as jnative
from ndjir_tpu.models.fields import init_model as jax_init_model
from ndjir_tpu.utils import mesh_io as jmesh_io

from ndjir_torch.bridge import params_from_numpy
from ndjir_torch.config import load_config
from ndjir_torch.data.dataset import IDRDataset
from ndjir_torch.data.synthetic import render_sphere_scene
from ndjir_torch.extract import mc
from ndjir_torch.utils import mesh_io
from ndjir_torch.utils.png import encode_png

torch.set_num_threads(2)

TINY = ["geometric_network.voxel.grid_size=16",
        "geometric_network.feature_size=64", "extraction.batch_size=500",
        "extraction.rough_grid_size=12"]
BF16 = ["precision.grid_dtype=bfloat16", "precision.mlp_dtype=bfloat16"]
RUNS = {"f32": TINY, "bf16": TINY + BF16}
G = 12
ATTRS = [a for a, _, _ in mc._ATTR_SPECS]

# SDF and attribute tolerances, absolute, as shares of the largest value:
# f32 sums in another order agree to float32 ulps (measured below 1e-6 of
# the scale); with a bf16 MLP the frameworks round at other places (JAX
# on the CPU keeps some bf16 values in f32), so the SDF agrees to one bf16
# ulp of the volume's largest magnitude (2^-7 of it; measured 1.0e-2 at a
# largest value near 1.7) and the attributes, which take the normal
# through the bf16 layers, to the bf16 slice test's gradient tolerance
# (5e-2 of the scale)
SDF_TOL = {"f32": 1e-5, "bf16": 2.0 ** -7}
ATTR_TOL = {"f32": 1e-5, "bf16": 5e-2}


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


@pytest.fixture(scope="module", autouse=True)
def jax_mesh_library(tmp_path_factory):
    """The JAX package's mesh library, compiled from its own source with
    its Makefile's flags into a path of this module's own.  Its loader
    otherwise runs ``make`` in place on ``csrc/libndjir_native.so``, and a
    test process running beside this one may do the same at the same
    time: a half-written library would then fail to load."""
    out = str(tmp_path_factory.mktemp("jax_native") / "libndjir_native.so")
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-Wall",
                    "-march=native", "-shared", "-o", out,
                    os.path.join(jnative._CSRC, "marching_cubes.cpp")],
                   check=True, capture_output=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_LIB_PATH", out)
    mp.setattr(jnative, "_lib", None)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def ref():
    """Per run: the port's conf and params, the reference's params, SDF
    volume, mesh and per-vertex attributes."""
    out = {}
    for run, overrides in RUNS.items():
        jconf = jax_load_config("default", overrides=overrides)
        jparams = jax.jit(lambda k: jax_init_model(k, jconf))(
            jax.random.PRNGKey(0))
        conf = load_config("default", overrides=overrides)
        vol = jmc.compute_sdf_volume(jparams, jconf, G)
        verts, tris = jmc.mesh_from_volume(
            vol, jconf.extraction.level,
            jconf.renderer.bounding_sphere_radius)
        out[run] = dict(
            conf=conf, jconf=jconf, jparams=jparams,
            params=params_from_numpy(_np(jparams), device="cpu", conf=conf),
            vol=vol, verts=verts, tris=tris,
            attrs={a: jmc.compute_vertex_attribute(jparams, jconf, verts, a)
                   for a in ATTRS})
    return out


@pytest.fixture(scope="module")
def scene():
    images, masks, cameras = render_sphere_scene(n_views=4, H=16, W=16)
    conf = load_config("default", overrides=TINY)
    return IDRDataset(conf, images, masks, cameras, train=False,
                      shuffle=False)


# ---------------------------------------------------------------------------
# volume, iso-surface, attributes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", list(RUNS))
def test_sdf_volume_matches(ref, run):
    r = ref[run]
    got = mc.compute_sdf_volume(r["params"], r["conf"], G)
    assert got.shape == (G, G, G) and got.dtype == np.float32
    scale = np.abs(r["vol"]).max()
    np.testing.assert_allclose(got, r["vol"], rtol=0,
                               atol=SDF_TOL[run] * scale)
    assert (got < 0).any() and (got > 0).any()   # a surface to extract


@pytest.mark.parametrize("direction", ["descent", "ascent"])
def test_mesh_from_volume_is_the_references(ref, direction):
    vol = ref["f32"]["vol"]
    v, t = mc.mesh_from_volume(vol, 0.01, 1.0, direction)
    jv, jt = jmc.mesh_from_volume(vol, 0.01, 1.0, direction)
    assert len(v) > 0
    assert v.dtype == jv.dtype and t.dtype == jt.dtype
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t, jt)


@pytest.mark.parametrize("attr", ATTRS)
@pytest.mark.parametrize("run", list(RUNS))
def test_vertex_attribute_matches(ref, run, attr):
    r = ref[run]
    got = mc.compute_vertex_attribute(r["params"], r["conf"], r["verts"],
                                      attr)
    want = r["attrs"][attr]
    assert len(r["verts"]) % r["conf"].extraction.batch_size != 0
    assert got.shape == want.shape and got.dtype == np.float32
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATTR_TOL[run] * scale)


# ---------------------------------------------------------------------------
# environment map and PNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", list(RUNS))
def test_environment_map_matches(ref, run, tmp_path, monkeypatch):
    """The light values agree within the attribute tolerance; from the
    same values the two PNGs, decoded, are pixel-equal (the uint8
    truncation would turn an ulp of difference into a pixel step) and the
    min/max files equal."""
    r = ref[run]
    dirs = mc.environment_map_directions()
    env = r["jparams"]["environment-light-network"]
    # eagerly, as extract_environment_map calls it
    want = np.array(jmc.fields.environment_light_apply(
        env, jnp.asarray(dirs), r["jconf"]))
    got = tfields.environment_light_apply(
        r["params"]["environment-light-network"], torch.from_numpy(dirs),
        r["conf"]).numpy()
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATTR_TOL[run] * scale)

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jmc.extract_environment_map(r["jparams"], r["jconf"],
                                str(tmp_path / "jax"))
    monkeypatch.setattr(tfields, "environment_light_apply",
                        lambda p, d, c: torch.from_numpy(want.copy()))
    mc.extract_environment_map(r["params"], r["conf"], str(tmp_path / "port"))
    a = imageio.imread(tmp_path / "port" / "environment_map.png")
    b = imageio.imread(tmp_path / "jax" / "environment_map.png")
    assert a.shape == b.shape == (256, 512) and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    name = "environment_map_min_max.txt"
    assert (tmp_path / "port" / name).read_text() \
        == (tmp_path / "jax" / name).read_text()


@pytest.mark.parametrize("shape", [(7, 5), (4, 9, 3), (3, 2, 1)], ids=str)
def test_png_decodes_to_the_image(shape, tmp_path):
    img = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    path = tmp_path / "a.png"
    path.write_bytes(encode_png(img))
    np.testing.assert_array_equal(imageio.imread(path),
                                  img[..., 0] if shape[-1] == 1 else img)


# ---------------------------------------------------------------------------
# mask trimming, components, OBJ files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("margin", range(0, 51))
def test_ellipse_footprint_is_cv2s(margin):
    want = cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                     (2 * margin + 1, 2 * margin + 1))
    np.testing.assert_array_equal(mc.ellipse_footprint(margin),
                                  want.astype(bool))


@pytest.mark.parametrize("margin", [0, 1, 3, 7, 20])
def test_dilate_is_cv2s_and_scipys(margin):
    rng = np.random.RandomState(margin)
    mask = rng.rand(31, 45) > 0.97
    mask[0, 5] = mask[-1, -1] = True     # edges
    fp = mc.ellipse_footprint(margin)
    got = mc.dilate(mask, fp)
    want = cv2.dilate(mask.astype(np.float32), fp.astype(np.uint8)) >= 0.5
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, scipy.ndimage.binary_dilation(mask, structure=fp))


@pytest.mark.parametrize("margin", [1, 3])
def test_clean_points_by_mask_matches(ref, scene, margin):
    r = ref["f32"]
    conf = load_config("default", overrides=TINY + [
        f"valid.dtumvs.pixel_margin={margin}"])
    jconf = jax_load_config("default", overrides=TINY + [
        f"valid.dtumvs.pixel_margin={margin}"])
    got = mc.clean_points_by_mask(r["verts"], scene, conf)
    want = jmc.clean_points_by_mask(r["verts"], scene, jconf)
    assert got.dtype == bool and 0 < got.sum() < len(got)
    np.testing.assert_array_equal(got, want)


def _assert_meshes_equal(got, want):
    assert len(got) == len(want) > 0
    for (gv, gt), (wv, wt) in zip(got, want):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gt, wt)


def test_trimmed_and_largest_components_match(ref):
    r = ref["f32"]
    verts, tris = r["verts"], r["tris"]
    # split the sphere into several pieces
    keep = np.abs(verts[:, 0]) > 0.15
    _assert_meshes_equal(mc.trimmed_component_meshes(verts, tris, keep),
                         jmc.trimmed_component_meshes(verts, tris, keep))
    _assert_meshes_equal(mc.largest_component_meshes(verts, tris, top_k=2),
                         jmc.largest_component_meshes(verts, tris, top_k=2))
    none = np.zeros(len(verts), bool)
    assert mc.trimmed_component_meshes(verts, tris, none) == []


def test_sample_surface_is_the_references(ref):
    """Area-weighted surface samples of the reference's mesh: the port's
    copy of the mesh library's ``sample_triangles`` draws the JAX
    package's points bitwise, for two seeds."""
    from ndjir_torch.extract import native
    r = ref["f32"]
    for seed in (0, 7):
        got = native.sample_surface(r["verts"], r["tris"], 5000, seed=seed)
        want = jnative.sample_surface(r["verts"], r["tris"], 5000,
                                      seed=seed)
        assert got.shape == (5000, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, native.sample_surface(
        r["verts"], r["tris"], 5000, seed=0))


@pytest.mark.parametrize("colors", ["rgb", "one_channel", "none"])
def test_obj_files_are_textually_equal(ref, colors, tmp_path):
    r = ref["f32"]
    verts, tris = r["verts"], r["tris"]
    c = {"rgb": r["attrs"]["base_color"],
         "one_channel": r["attrs"]["roughness"] * 1.3 - 0.1,
         "none": None}[colors]
    mesh_io.save_obj(str(tmp_path / "port.obj"), verts, tris, c)
    jmesh_io.save_obj(str(tmp_path / "jax.obj"), verts, tris, c)
    text = (tmp_path / "port.obj").read_text()
    assert text == (tmp_path / "jax.obj").read_text()
    for a, b in zip(mesh_io.load_obj(str(tmp_path / "port.obj")),
                    jmesh_io.load_obj(str(tmp_path / "jax.obj"))):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
    empty = np.zeros((0, 3))
    mesh_io.save_obj(str(tmp_path / "e1.obj"), empty, empty.astype(int))
    jmesh_io.save_obj(str(tmp_path / "e2.obj"), empty, empty.astype(int))
    assert (tmp_path / "e1.obj").read_text() \
        == (tmp_path / "e2.obj").read_text()


# ---------------------------------------------------------------------------
# the whole pipeline
# ---------------------------------------------------------------------------

def test_extract_writes_every_output_with_one_table_build(
        ref, scene, tmp_path, monkeypatch):
    """A final extraction on the bf16 grid: the environment map, the six
    raw attribute meshes and the trimmed components' meshes, with the octa
    table built once for the whole call."""
    r = ref["bf16"]
    calls = []
    real = tfields.build_octa_table
    monkeypatch.setattr(tfields, "build_octa_table",
                        lambda base: calls.append(1) or real(base))
    fpath = mc.extract(r["params"], r["conf"], str(tmp_path), "model",
                       dataset=scene, final=True, train=True)
    assert calls == [1]
    files = os.listdir(tmp_path)
    assert "environment_map.png" in files
    for attr in ATTRS:
        raw = f"model_12grid_raw_{attr}_mesh00.obj"
        assert raw in files and os.path.getsize(tmp_path / raw) > 0
    trimmed = [f for f in files if "_trimmed_" in f]
    assert len(trimmed) % len(ATTRS) == 0 and trimmed
    assert os.path.basename(fpath) in trimmed
    v, f, c = mesh_io.load_obj(str(tmp_path / f"model_12grid_raw_"
                                   "base_color_mesh00.obj"))
    assert len(v) > 0 and len(f) > 0 and c.shape == v.shape
