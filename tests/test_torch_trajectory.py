"""The port's ``Trainer`` against the JAX package's over 30 epochs (90
steps) on the CPU: both read one v2-scene folder (6 views of 32x32) with
the quality benchmark's overrides at ``tiny_test`` widths, and the port is
handed the JAX package's initial weights and Monte-Carlo uniforms.

With f32 MLP operands the two loss series agree step for step to f32
rounding over the whole run.  With bf16 operands the two round in
different places from the first step, and training, which amplifies small
differences, lets each step's loss wander by a few percent while the run's
mean stays put.
"""

import jax
import numpy as np
import pytest
import torch

from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.data.synthetic import make_hard_synthetic_scene_v2
from ndjir_tpu.render.renderer import make_mc_cdfs as jax_make_mc_cdfs
from ndjir_tpu.train.trainer import Trainer as JaxTrainer

from ndjir_torch.bridge import params_from_numpy
from ndjir_torch.config import load_config
from ndjir_torch.train import trainer as ttrainer

torch.set_num_threads(2)

EPOCHS = 30
# (rtol of every step's loss, rtol of the mean loss over the run)
TOLS = {"float32": (1e-4, 1e-5), "bfloat16": (0.1, 1e-2)}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_hard_synthetic_scene_v2(
        str(tmp_path_factory.mktemp("traj") / "scene"), n_views=6, H=32,
        W=32)


def _losses(monitor):
    return np.loadtxt(f"{monitor}_scene/Training-loss.series.txt", ndmin=2)


@pytest.mark.parametrize("mlp_dtype", sorted(TOLS))
def test_trainer_tracks_the_jax_trainer(scene, tmp_path, monkeypatch,
                                        mlp_dtype):
    def overrides(side):
        return [f"data_path={scene}", f"monitor_base_path={tmp_path}/{side}",
                "train.mask_weight=0.1", "renderer.bounding_sphere_radius=0.75",
                "valid.skip=true", f"train.epoch={EPOCHS}",
                "train.checkpoint_interval_epochs=0",
                f"precision.mlp_dtype={mlp_dtype}"]

    jconf = jax_load_config("tiny_test", overrides("jax"))
    jt = JaxTrainer(jconf)
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(jt.params))
    jt.train()
    cdfs = jax.device_get(jax.jit(lambda: jax_make_mc_cdfs(
        jconf, jconf.train.batch_size, jconf.train.n_rays))())

    def jax_draw(conf, B, R, dtype=torch.float32, device="cpu"):
        def t(u):
            return torch.from_numpy(np.array(u)).to(device)
        return {k: [t(u) for u in v] if isinstance(v, list) else t(v)
                for k, v in cdfs.items()}

    monkeypatch.setattr(ttrainer, "make_mc_cdfs", jax_draw)
    monkeypatch.setattr(
        ttrainer, "init_model", lambda conf, seed=0, device="cpu":
        params_from_numpy(init, device=device, conf=conf))
    ttrainer.Trainer(load_config("tiny_test", overrides("port")),
                     device="cpu").train()

    got, want = _losses(tmp_path / "port"), _losses(tmp_path / "jax")
    assert len(got) == len(want) == 3 * EPOCHS
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    step_rtol, mean_rtol = TOLS[mlp_dtype]
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=step_rtol)
    np.testing.assert_allclose(got[:, 1].mean(), want[:, 1].mean(),
                               rtol=mean_rtol)
