"""The port's command line against the JAX package's (CPU), the slice as a
whole: an IDR folder on disk, ``train`` resumed from a checkpoint of the JAX
CLI, then ``render``, ``extract``, ``eval-image`` and ``eval-chamfer`` from
one checkpoint through both CLIs.

The JAX CLI trains ``tiny_test`` two epochs on a sphere folder (a
checkpoint after each), and its monitor directory is copied twice; each
package's CLI continues one copy to ``train.epoch=3``.  Both resume from the
same checkpoint with the same data order, and the lagged, warmed-up
schedule makes epoch 2 the first that updates, so the two final checkpoints
differ by what one training step's arithmetic allows.  The port draws its
Monte-Carlo uniforms from ``torch.Generator``s, so its trainer and renderer
are handed the JAX package's here, as ``tests/test_torch_render.py`` does.
"""

import glob
import os
import shutil
import subprocess
import sys

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from ndjir_tpu import cli as jcli
from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.data.synthetic import make_synthetic_scene as jax_make_scene
from ndjir_tpu.extract.native import marching_cubes, sample_surface
from ndjir_tpu.ops.grid import GridEncoding as JaxGridEncoding
from ndjir_tpu.render.renderer import make_mc_cdfs as jax_make_mc_cdfs
from ndjir_tpu.utils.mesh_io import save_obj, save_ply_points

from ndjir_torch import cli
from ndjir_torch.config import load_config
from ndjir_torch.models.fields import init_model
from ndjir_torch.ops.grid import GridEncoding
from ndjir_torch.render import image as timage
from ndjir_torch.train import schedules
from ndjir_torch.train import trainer as ttrainer
from ndjir_torch.train.checkpoint import latest_checkpoint, load_checkpoint
from ndjir_torch.train.optim import tree_leaves_with_path
from ndjir_torch.train.trainer import check_supported
from ndjir_torch.utils.mesh_io import load_obj
from ndjir_torch.utils.png import read_png

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = os.path.join(REPO, "ndjir_tpu", "configs")
NAMES = sorted(os.path.basename(f)[:-5]
               for f in glob.glob(os.path.join(JAX_CONFIGS, "*.yaml")))

N_VIEWS, H, W = 3, 24, 24
EXTRACT = ["extraction.grid_size=32", "extraction.batch_size=4096"]


def _args(scene, mon, *extra):
    return ["--config-name", "tiny_test", f"data_path={scene}",
            f"monitor_base_path={mon}", "valid.skip=true", *extra]


def _jax_cdfs(conf, B, R, dtype=torch.float32, device="cpu"):
    """The JAX package's Monte-Carlo uniforms for B x R rays of
    ``tiny_test``, as tensors."""
    cdfs = jax.jit(lambda: jax_make_mc_cdfs(jax_load_config("tiny_test"),
                                            B, R))()

    def tensor(u):
        return torch.from_numpy(np.array(u)).to(device)
    return {k: [tensor(u) for u in v] if isinstance(v, list) else tensor(v)
            for k, v in cdfs.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The folder, the JAX CLI's two epochs, and each CLI's third one."""
    root = tmp_path_factory.mktemp("cli")
    scene = str(root / "DTU" / "scan1")
    jax_make_scene(scene, n_views=N_VIEWS, H=H, W=W)
    jcli.main(["train", *_args(scene, root / "first", "train.epoch=2")])
    for side in ("jax", "port"):
        shutil.copytree(root / "first_scan1", root / f"{side}_scan1")
    jcli.main(["train", *_args(scene, root / "jax", "train.epoch=3")])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrainer, "make_mc_cdfs", _jax_cdfs)
        cli.main(["train", "--device", "cpu",
                  *_args(scene, root / "port", "train.epoch=3")])
    return root, scene


def _checkpoint(path, conf):
    params = init_model(conf, seed=0, device="cpu")
    params, _, extra = load_checkpoint(latest_checkpoint(path), params)
    return dict(tree_leaves_with_path(params)), extra["step"]


def test_resumed_training_step_matches(run):
    root, scene = run
    conf = load_config("tiny_test", [f"data_path={scene}", "train.epoch=3"])
    got, got_step = _checkpoint(root / "port_scan1" / "checkpoints", conf)
    want, want_step = _checkpoint(root / "jax_scan1" / "checkpoints", conf)
    before, _ = _checkpoint(root / "first_scan1" / "checkpoints", conf)
    assert got_step == want_step == 2
    # epoch 2 trains at the schedule of epoch 1: one step at this rate
    lr = max(schedules.learning_rate(1, base, conf)
             for base in schedules.scaled_base_lrs(conf))
    assert lr > 0.0
    moved = apart = total = 0
    for path, w in want.items():
        g, w = got[path].numpy(), w.numpy()
        moved += int(np.sum(w != before[path].numpy()))
        diff = np.abs(g - w)
        # an Adam step moves an entry by ~lr * sign(g); where |g| is at f32
        # noise the sign may differ, and nearly every entry agrees far
        # tighter (tests/test_torch_slice.py's bounds)
        assert diff.max() <= 2 * lr, path
        apart += int(np.sum(diff > 1e-2 * lr))
        total += diff.size
    assert moved > 0
    assert apart <= 1e-3 * total, (apart, total)
    # the losses of epoch 2's steps, as each CLI's monitor recorded them
    first = np.loadtxt(root / "first_scan1" / "Training-loss.series.txt",
                       ndmin=2)
    series = [np.loadtxt(root / f"{side}_scan1" / "Training-loss.series.txt",
                         ndmin=2) for side in ("port", "jax")]
    g, w = (s[s[:, 0] > first[:, 0].max()] for s in series)
    assert len(g) > 0
    np.testing.assert_array_equal(g[:, 0], w[:, 0])
    np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=1e-4)


def test_render_matches_within_one_step(run, tmp_path, monkeypatch):
    root, scene = run
    monkeypatch.setattr(timage, "make_mc_cdfs", _jax_cdfs)
    ck = str(root / "jax_scan1" / "checkpoints")
    extra = [f"model_load_path={ck}", "valid.n_down_samples=1"]
    jcli.main(["render", *_args(scene, tmp_path / "jax", *extra)])
    cli.main(["render", "--device", "cpu",
              *_args(scene, tmp_path / "port", *extra)])
    names = sorted(os.listdir(tmp_path / "jax_scan1" / "rendered"))
    assert len(names) == 2 * N_VIEWS
    assert sorted(os.listdir(tmp_path / "port_scan1" / "rendered")) == names
    for name in names:
        got = read_png(str(tmp_path / "port_scan1" / "rendered" / name))
        want = imageio.imread(tmp_path / "jax_scan1" / "rendered" / name)
        assert got.shape == want.shape == (H // 2, W // 2, 3)
        # the same light values up to f32 rounding; uint8 truncation turns
        # an ulp into at most one step
        assert np.abs(got.astype(int) - want).max() <= 1, name


def test_extract_matches(run, tmp_path):
    root, scene = run
    ck = str(root / "jax_scan1" / "checkpoints")
    jcli.main(["extract", *_args(scene, tmp_path / "jax",
                                 f"model_load_path={ck}", *EXTRACT)])
    cli.main(["extract", "--device", "cpu",
              *_args(scene, tmp_path / "port", f"model_load_path={ck}",
                     *EXTRACT)])
    jdir, pdir = tmp_path / "jax_scan1", tmp_path / "port_scan1"
    objs = sorted(os.path.basename(p) for p in glob.glob(str(jdir / "*.obj")))
    assert len(objs) >= 12         # six attributes, raw and trimmed
    assert sorted(os.path.basename(p)
                  for p in glob.glob(str(pdir / "*.obj"))) == objs
    assert os.path.exists(pdir / "environment_map.png")
    r = load_config("tiny_test").renderer.bounding_sphere_radius
    for name in objs:
        gv, gf, _ = load_obj(str(pdir / name))
        wv, wf, _ = load_obj(str(jdir / name))
        assert len(gv) == len(wv) and len(gf) == len(wf), name
        np.testing.assert_array_equal(gf, wf)
        # SDF values agree to 1e-5 of their scale (tests/test_torch_
        # extract.py); a vertex interpolated between two lattice points
        # moves by at most that over the SDF step, within one cell
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-3 * 2 * r / 31,
                                   err_msg=name)


def test_eval_image_matches(run, tmp_path):
    """Both CLIs score the same rendered views."""
    root, scene = run
    ck = str(root / "jax_scan1" / "checkpoints")
    extra = [f"model_load_path={ck}", "valid.n_down_samples=1"]
    jcli.main(["render", *_args(scene, tmp_path / "jax", *extra)])
    shutil.copytree(tmp_path / "jax_scan1" / "rendered",
                    tmp_path / "port_scan1" / "rendered")
    jcli.main(["eval-image", *_args(scene, tmp_path / "jax", *extra)])
    cli.main(["eval-image", *_args(scene, tmp_path / "port", *extra)])
    series = sorted(os.path.basename(p) for p in
                    glob.glob(str(tmp_path / "jax_scan1" / "Eval-*")))
    assert len(series) == 6
    for name in series:
        got = np.loadtxt(tmp_path / "port_scan1" / name)
        want = np.loadtxt(tmp_path / "jax_scan1" / name)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


def test_eval_chamfer_matches(run, tmp_path):
    """Both CLIs score the same mesh against the same reference cloud."""
    root, scene = run
    G = 32
    lin = np.linspace(-1, 1, G).astype(np.float32)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    verts, tris = marching_cubes(np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.5, 0.0)
    w = (verts * 2 / (G - 1) - 1).astype(np.float32)
    ref = tmp_path / "ref"
    (ref / "Points" / "stl").mkdir(parents=True)
    save_ply_points(str(ref / "Points" / "stl" / "stl001_total.ply"),
                    sample_surface(w, tris, 4000, seed=5))
    mesh_path = str(tmp_path / "mesh.obj")
    save_obj(mesh_path, w * 1.02, tris)
    for side, main in (("jax", jcli.main), ("port", cli.main)):
        out = tmp_path / side
        out.mkdir()
        main(["eval-chamfer", *_args(scene, out,
                                     f"valid.dtumvs.mesh_path={mesh_path}",
                                     "valid.dtumvs.scan=scan1",
                                     f"valid.dtumvs.ref_dir={ref}",
                                     f"valid.dtumvs.vis_out_dir={out}",
                                     "valid.dtumvs.downsample_density=0.05")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len([n for n in names if n.startswith("Chamfer")]) == 3
    for name in names:
        if name.endswith(".ply"):
            with open(tmp_path / "port" / name, "rb") as a, \
                    open(tmp_path / "jax" / name, "rb") as b:
                assert a.read() == b.read(), name
        else:
            got = np.loadtxt(tmp_path / "port" / name)
            want = np.loadtxt(tmp_path / "jax" / name)
            assert np.isfinite(got).all() and got[1] > 0.0
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


def test_module_entry_makes_the_jax_packages_scene(tmp_path):
    """``python -m ndjir_torch.cli make-synthetic`` in a fresh process
    writes files that decode to the JAX package's pixels."""
    subprocess.run([sys.executable, "-m", "ndjir_torch.cli", "make-synthetic",
                    str(tmp_path / "port"), "2", "16", "20"], check=True,
                   cwd=REPO, timeout=120)
    jax_make_scene(str(tmp_path / "jax"), n_views=2, H=16, W=20)
    for sub in ("image", "mask"):
        for i in range(2):
            name = os.path.join(sub, f"{i:06d}.png")
            np.testing.assert_array_equal(
                read_png(str(tmp_path / "port" / name)),
                imageio.imread(tmp_path / "jax" / name))


def test_no_cuda_device_is_an_error_not_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", *_args(tmp_path / "DTU" / "scan1", tmp_path / "m")])
    assert not os.path.exists(tmp_path / "m_scan1")


def test_render_missing_checkpoint_errors(tmp_path):
    scene = str(tmp_path / "s")
    cli.main(["make-synthetic", scene, "2", "16", "16"])
    with pytest.raises(FileNotFoundError, match="model_load_path"):
        cli.main(["render", "--device", "cpu",
                  *_args(scene, tmp_path / "m",
                         "model_load_path=/nonexistent")])


def test_unknown_config_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        cli.main(["train", "--device", "cpu", "--config-name",
                  "no_such_config", f"data_path={tmp_path}"])


@pytest.mark.parametrize("name", NAMES)
def test_every_preset_is_the_jax_packages(name):
    """The port holds every preset of the JAX package, and its reader
    loads each equal to ``ndjir_tpu.config.load_config``."""
    assert os.path.exists(os.path.join(REPO, "ndjir_torch", "configs",
                                       f"{name}.yaml"))
    assert load_config(name).to_dict() == jax_load_config(name).to_dict()


@pytest.mark.parametrize("name", ["custom", "triplaneline", "voxel_hash"])
def test_presets_of_the_other_encodings_are_accepted(name):
    """The presets of the other encodings (refused until they were ported)
    are accepted, and their grid's leaves at the published widths have the
    JAX package's names and shapes (built on the meta device)."""
    conf = load_config(name)
    check_supported(conf)
    jconf = jax_load_config(name)
    radius = conf.renderer.bounding_sphere_radius
    enc = GridEncoding(conf.geometric_network.voxel, radius)
    jenc = JaxGridEncoding(jconf.geometric_network.voxel, radius)
    assert enc.out_dim == jenc.out_dim
    got = enc.init(torch.Generator(), device="meta")
    want = jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0)))
    assert {k: tuple(v.shape) for k, v in got.items()} \
        == {k: tuple(v.shape) for k, v in want.items()}
