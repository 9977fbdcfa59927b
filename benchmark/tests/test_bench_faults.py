"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU
at the fixture cells' size and held to the committed limits of the cells
they stand in for.  One case for each fault a cell can have: a step that
leaves its state unchanged, half of the batch left out (the mean taken
over the rest), an answer altered where it is produced.  (No cell shares
anything between chips, so there is no exchange to leave out.)"""

import argparse
import subprocess
import sys
import time
import types

import pytest
import torch

from conftest import REPO


def run(root, cell, seed=2 ** 31 + 3):
    from benchmark import harness
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.3,
                              trace=0)
    return harness.run(args, time.perf_counter(), require_card=False,
                       device="cpu", root=root)


def unchanged_step(real):
    """The step's monitors, its state put back as it was."""
    def step(params, opt_state, *args, **kwargs):
        from ndjir_torch.train.optim import tree_leaves_with_path
        keep = [t.clone() for _, t in tree_leaves_with_path(params)] \
            + [t.clone() for _, t in tree_leaves_with_path(opt_state)]
        mons = real(params, opt_state, *args, **kwargs)
        for (_, t), k in zip(list(tree_leaves_with_path(params))
                             + list(tree_leaves_with_path(opt_state)),
                             keep):
            t.copy_(k)
        return mons
    return step


def half_batch_step(real):
    """The step on the first half of its batch and uniforms."""
    def step(params, opt_state, camloc, raydir, color, mask, *args,
             cdfs=None, **kwargs):
        h = camloc.shape[0] // 2
        cdfs = {k: ([u[:h] for u in v] if isinstance(v, list) else v[:h])
                for k, v in cdfs.items()}
        return real(params, opt_state, camloc[:h], raydir[:h], color[:h],
                    mask[:h], *args, cdfs=cdfs, **kwargs)
    return step


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-train-k3"])
@pytest.mark.parametrize("fault", [unchanged_step, half_batch_step],
                         ids=["state_unchanged", "half_batch"])
def test_training_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    from ndjir_torch.train import trainer
    monkeypatch.setattr(trainer, "train_step", fault(trainer.train_step))
    out = run(tiny_root, cell)
    assert not out["correct"], out["checks"]


def test_a_sound_training_run_is_correct(tiny_root):
    assert run(tiny_root, "tiny-train")["correct"]


def test_altered_pixel_is_not_correct(tiny_root, monkeypatch):
    from ndjir_torch.render import image
    real = image.render_image

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        v = out[0][0, :, 0, 0]
        out[0][0, :, 0, 0] = torch.where(torch.as_tensor(v) > 0.5,
                                         torch.as_tensor(v) - 0.25,
                                         torch.as_tensor(v) + 0.25).numpy()
        return out
    monkeypatch.setattr(image, "render_image", altered)
    out = run(tiny_root, "tiny-render")
    assert not out["correct"], out["checks"]


def test_run_refuses_without_a_card(tmp_path):
    """No card (this machine's CPU build): exit code not 0, no result."""
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "default-dtu49-k8", "--seed", str(2 ** 31 + 9),
                        "--seconds", "1", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                            "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "refused" in p.stderr


def test_forbidden_modules_are_found(monkeypatch):
    from benchmark import harness
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax"]
