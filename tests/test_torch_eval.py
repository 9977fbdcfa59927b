"""The port's evaluation against the JAX package's (CPU): PLY writers byte
for byte, the DTU Chamfer protocol with and without the ObsMask / Plane
files, the image metrics, the rendered-image evaluation, and the quality
benchmark's scoring, all on the same inputs at rtol 1e-6."""

import functools
import importlib.util
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import scipy.io
import torch

from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.data.synthetic import make_synthetic_scene
from ndjir_tpu.eval import chamfer as jchamfer
from ndjir_tpu.eval import image as jimage
from ndjir_tpu.eval import rendered as jrendered
from ndjir_tpu.extract.native import marching_cubes, sample_surface
from ndjir_tpu.utils import mesh_io as jmesh_io

from ndjir_torch.config import load_config
from ndjir_torch.data.dataset import IDRDataset
from ndjir_torch.eval import chamfer, image, rendered
from ndjir_torch.models.fields import init_model
from ndjir_torch.utils import mesh_io

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6


def _sphere(G=32, r=0.5, shift=0.0):
    lin = np.linspace(-1, 1, G).astype(np.float32)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    verts, tris = marching_cubes(np.sqrt((X - shift) ** 2 + Y ** 2 + Z ** 2)
                                 - r, 0.0)
    return (verts * 2 / (G - 1) - 1).astype(np.float32), tris


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# PLY writers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("colors", [None, "rgb"])
def test_ply_points_are_the_jax_packages_bytes(colors, tmp_path):
    rng = np.random.RandomState(0)
    pts = rng.randn(257, 3)
    c = None if colors is None else rng.uniform(-0.2, 1.2, (257, 3))
    mesh_io.save_ply_points(str(tmp_path / "p.ply"), pts, c)
    jmesh_io.save_ply_points(str(tmp_path / "j.ply"), pts, c)
    assert _bytes(tmp_path / "p.ply") == _bytes(tmp_path / "j.ply")


@pytest.mark.parametrize("colors", [None, 1, 3])
def test_ply_mesh_is_the_jax_packages_bytes(colors, tmp_path):
    verts, tris = _sphere(16)
    c = None if colors is None else np.random.RandomState(1).uniform(
        0, 1, (len(verts), colors))
    mesh_io.save_ply_mesh(str(tmp_path / "p.ply"), verts, tris, c)
    jmesh_io.save_ply_mesh(str(tmp_path / "j.ply"), verts, tris, c)
    assert _bytes(tmp_path / "p.ply") == _bytes(tmp_path / "j.ply")


# ---------------------------------------------------------------------------
# the Chamfer protocol's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iterations", [0, 3])
def test_laplacian_smooth_matches(iterations):
    verts, tris = _sphere(20)
    verts = verts + np.random.RandomState(2).randn(*verts.shape).astype(
        np.float32) * 0.01
    np.testing.assert_allclose(
        chamfer.laplacian_smooth(verts, tris, iterations),
        jchamfer.laplacian_smooth(verts, tris, iterations), rtol=RTOL)


@pytest.mark.parametrize("thresh", [0.02, 0.05])
def test_sample_tri_grid_and_radius_downsample_match(thresh):
    verts, tris = _sphere(24)
    got = chamfer.sample_tri_grid(verts, tris, thresh)
    want = jchamfer.sample_tri_grid(verts, tris, thresh)
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_allclose(got, want, rtol=RTOL)
    (gd, gm), (wd, wm) = (chamfer.radius_downsample(got, thresh),
                          jchamfer.radius_downsample(want, thresh))
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_allclose(gd, wd, rtol=RTOL)


@pytest.fixture(scope="module")
def dtu(tmp_path_factory):
    """A mesh a little larger than the reference sphere, the reference
    cloud, the scene folder, and ObsMask / Plane files for scan 1 that keep
    part of the space and the points above a tilted plane."""
    root = tmp_path_factory.mktemp("dtu")
    verts, tris = _sphere(32)
    mesh_path = str(root / "mesh_model.obj")
    jmesh_io.save_obj(mesh_path, verts * 1.03, tris)
    ref = root / "ref"
    (ref / "Points" / "stl").mkdir(parents=True)
    jmesh_io.save_ply_points(str(ref / "Points" / "stl" / "stl001_total.ply"),
                             sample_surface(verts, tris, 20000, seed=5))
    obs = root / "obs"
    (obs / "Points" / "stl").mkdir(parents=True)
    os.link(ref / "Points" / "stl" / "stl001_total.ply",
            obs / "Points" / "stl" / "stl001_total.ply")
    (obs / "ObsMask").mkdir()
    res = 0.05
    mask = np.ones((24, 24, 24), np.uint8)
    mask[:, :6] = 0
    scipy.io.savemat(str(obs / "ObsMask" / "ObsMask1_10.mat"), {
        "ObsMask": mask, "BB": np.array([[-0.6, -0.6, -0.6],
                                          [0.6, 0.6, 0.6]]),
        "Res": np.array([[res]])})
    scipy.io.savemat(str(obs / "ObsMask" / "Plane1.mat"),
                     {"P": np.array([[0.1], [0.2], [1.0], [0.2]])})
    scene = make_synthetic_scene(str(root / "scene"), n_views=2, H=16, W=16)
    return root, mesh_path, scene


@pytest.mark.parametrize("refs", ["obsmask", "no_obsmask", "no_stl"])
@pytest.mark.parametrize("filter_iters", [0, 2])
def test_evaluate_by_chamfer_matches(dtu, refs, filter_iters, tmp_path):
    root, mesh_path, scene = dtu
    ref_dir = {"obsmask": root / "obs", "no_obsmask": root / "ref",
               "no_stl": root / "none"}[refs]
    out = {}
    for side, load, evaluate in (
            ("port", load_config, chamfer.evaluate_by_chamfer),
            ("jax", jax_load_config, jchamfer.evaluate_by_chamfer)):
        (tmp_path / side).mkdir()
        conf = load("tiny_test", overrides=[
            f"data_path={scene}", f"valid.dtumvs.mesh_path={mesh_path}",
            "valid.dtumvs.scan=scan1", f"valid.dtumvs.ref_dir={ref_dir}",
            f"valid.dtumvs.vis_out_dir={tmp_path / side}",
            "valid.dtumvs.downsample_density=0.04",
            f"valid.filter_iters={filter_iters}"])
        out[side] = evaluate(conf)
    if refs == "no_stl":
        assert out["port"] is None and out["jax"] is None
        assert os.listdir(tmp_path / "port") == []
        return
    assert all(np.isfinite(out["port"])) and 0.0 < out["port"][2] < 0.1
    np.testing.assert_allclose(out["port"], out["jax"], rtol=RTOL)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert "vis_001_d2s.ply" in names and "vis_001_s2d.ply" in names
    assert f"Chamfer-Distance-Mean-model-filtered-{filter_iters:02d}" \
        ".series.txt" in names
    for name in names:
        if name.endswith(".ply"):
            assert _bytes(tmp_path / "port" / name) \
                == _bytes(tmp_path / "jax" / name), name
        else:
            np.testing.assert_allclose(np.loadtxt(tmp_path / "port" / name),
                                       np.loadtxt(tmp_path / "jax" / name),
                                       rtol=RTOL, err_msg=name)


def test_evaluate_by_chamfer_takes_the_trainers_dataset(dtu, tmp_path):
    """With a dataset handed in, its scale and translation undo the scene
    normalization (the final validation's call)."""
    root, mesh_path, scene = dtu
    conf = load_config("tiny_test", overrides=[
        f"data_path={scene}", f"valid.dtumvs.mesh_path={mesh_path}",
        "valid.dtumvs.scan=1", f"valid.dtumvs.ref_dir={root / 'ref'}",
        f"valid.dtumvs.vis_out_dir={tmp_path}",
        "valid.dtumvs.downsample_density=0.04"])
    ds = IDRDataset.from_folder(conf, train=False)
    base = chamfer.evaluate_by_chamfer(conf, dataset=ds)
    ds.scale, ds.trans = 2.0, np.array([0.5, 0.0, 0.0])
    moved = chamfer.evaluate_by_chamfer(conf, dataset=ds)
    assert moved[2] > 10 * base[2]


def test_read_ply_points_reads_binary_and_ascii(tmp_path):
    pts = np.random.RandomState(3).randn(50, 3).astype(np.float32)
    mesh_io.save_ply_points(str(tmp_path / "b.ply"), pts,
                            np.full((50, 3), 0.5))
    np.testing.assert_array_equal(chamfer._read_ply_points(
        str(tmp_path / "b.ply")), pts.astype(np.float64))
    with open(tmp_path / "a.ply", "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 50\nproperty float x"
                "\nproperty float y\nproperty float z\nend_header\n")
        f.writelines(f"{a!r} {b!r} {c!r}\n" for a, b, c in pts.tolist())
    for path in ("a.ply", "b.ply"):
        np.testing.assert_allclose(
            chamfer._read_ply_points(str(tmp_path / path)),
            jchamfer._read_ply_points(str(tmp_path / path)), rtol=RTOL)


# ---------------------------------------------------------------------------
# image metrics and the rendered-image evaluation
# ---------------------------------------------------------------------------

@pytest.fixture
def images():
    rng = np.random.RandomState(4)
    gt = rng.uniform(0, 1, (32, 40, 3))
    pred = np.clip(gt + 0.1 * rng.randn(*gt.shape), 0, 1)
    mask = np.zeros((32, 40, 1))
    mask[8:24, 10:34] = 1.0
    return pred, gt, mask


def test_rgb_to_ycbcr_matches(images):
    pred, _, _ = images
    np.testing.assert_allclose(image.rgb_to_ycbcr(pred),
                               jimage.rgb_to_ycbcr(pred), rtol=RTOL)


def test_ssim_masked_matches(images):
    pred, gt, mask = images
    for m in (mask, mask[..., 0], np.zeros_like(mask)):
        got, want = (image.ssim_masked(pred, gt, m),
                     jimage.ssim_masked(pred, gt, m))
        np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.isnan(image.ssim_masked(pred, gt, np.zeros_like(mask)))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("luma", [False, True])
def test_masked_psnr_and_ssim_match(images, masked, luma):
    pred, gt, mask = (a * 255.0 for a in images)
    m = mask / 255.0 if masked else None
    np.testing.assert_allclose(rendered.masked_psnr(pred, gt, m, luma),
                               jrendered.masked_psnr(pred, gt, m, luma),
                               rtol=RTOL)
    np.testing.assert_allclose(rendered.masked_ssim(pred, gt, m),
                               jrendered.masked_ssim(pred, gt, m), rtol=RTOL)


def test_lpips_is_none_without_torchvision_weights(images):
    pred, gt, _ = images
    assert rendered.lpips_vgg(pred * 255, gt * 255) is None


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("downsampled", [False, True])
def test_evaluate_rendered_images_matches(scale, downsampled, tmp_path):
    scene = make_synthetic_scene(str(tmp_path / "scene"), n_views=3, H=32,
                                 W=32)
    rng = np.random.RandomState(5)
    step = 2 if downsampled else 1
    for i in range(3):   # the same rendered views on both sides
        gt = imageio.imread(os.path.join(scene, "image", f"{i:06d}.png"))
        gt = gt[::step, ::step].astype(int)
        noisy = np.clip(gt + rng.randint(-20, 21, gt.shape), 0, 255)
        for side in ("port", "jax"):
            rd = tmp_path / f"{side}_scene" / "rendered"
            rd.mkdir(parents=True, exist_ok=True)
            imageio.imwrite(rd / f"{i:06d}.png", noisy.astype(np.uint8))
    out = {}
    for side, load, evaluate in (
            ("port", load_config, rendered.evaluate_rendered_images),
            ("jax", jax_load_config, jrendered.evaluate_rendered_images)):
        conf = load("tiny_test", overrides=[
            f"data_path={scene}", f"monitor_base_path={tmp_path / side}"])
        out[side] = evaluate(conf, scale=scale)
    assert sorted(out["port"]) == sorted(out["jax"]) == sorted(
        ["psnr", "psnr_mask", "psnr_y", "psnr_y_mask", "ssim", "ssim_mask"])
    for k, v in out["jax"].items():
        assert np.isfinite(out["port"][k])
        np.testing.assert_allclose(out["port"][k], v, rtol=RTOL, err_msg=k)
        np.testing.assert_allclose(
            np.loadtxt(tmp_path / "port_scene" / f"Eval-{k}.series.txt"),
            np.loadtxt(tmp_path / "jax_scene" / f"Eval-{k}.series.txt"),
            rtol=RTOL)


# ---------------------------------------------------------------------------
# the quality benchmark's scoring
# ---------------------------------------------------------------------------

def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quality_chamfer_to_gt_is_the_jax_scripts():
    port = _script("torch_quality_benchmark")
    jax_script = _script("quality_benchmark")
    a, at = _sphere(24)
    b, bt = _sphere(28, r=0.52, shift=0.02)
    got = port.chamfer_to_gt(a, at, b, bt, n_samples=5000)
    want = jax_script.chamfer_to_gt(a, at, b, bt, n_samples=5000)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert 0.01 < got[0] < 0.05


def test_quality_score_on_a_tiny_scene(tmp_path, monkeypatch):
    """The script's scoring end to end on the CPU: a 2-view 16x16 v2 scene
    written by the port, a tiny untrained model, a 24^3 mesh, 3,000
    surface samples a side (the untrained sphere lies far from the scene's
    surface, where nearest-neighbour queries of 150,000 are slow)."""
    from ndjir_torch.data.synthetic import make_hard_synthetic_scene_v2

    port = _script("torch_quality_benchmark")
    monkeypatch.setattr(port, "chamfer_to_gt", functools.partial(
        port.chamfer_to_gt, n_samples=3000))
    scene = make_hard_synthetic_scene_v2(str(tmp_path / "scene"), n_views=2,
                                         H=16, W=16)
    conf = load_config("tiny_test", overrides=[
        f"data_path={scene}", "renderer.bounding_sphere_radius=0.75",
        "valid.n_rays=128"])
    ds = IDRDataset.from_folder(conf, train=False)
    params = init_model(conf, seed=0, device="cpu")
    result = port.score(params, conf, ds, scene, grid=24)
    assert sorted(result) == ["accuracy", "chamfer", "completeness",
                              "psnr_masked", "ssim", "ssim_obj"]
    assert all(np.isfinite(v) for v in result.values())
    # the untrained model is the SAL init sphere: far from the blobby shape
    # at the scale of the scene, not at the scale of a grid cell
    assert 0.01 < result["chamfer"] < 0.5
