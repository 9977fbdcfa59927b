"""The port's reference-checkpoint import (``ndjir_torch/tools/
import_reference.py``) against the JAX package's, on the synthetic
nnabla-style h5 files of ``tests/test_import_reference.py``: the
checkpoints byte-equal for each grid type and feature family, the default
config's scope names mapped completely; and the port's profiling and
runtime helpers (``ndjir_torch/utils/profiling.py``, ``runtime.py``)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import test_import_reference as ref
from ndjir_torch.config import load_config as load_config_port
from ndjir_tpu.config import load_config as load_config_jax

# (grid type, the family name its F lives under in the reference's h5)
GRIDS = [("voxel", "voxel_feature"),
         ("voxel_hash", "voxel_hash_feature"),
         ("lanczos_voxel", "voxel_feature"),
         ("triplane", "triplane_feature"),
         ("triline", "triline_feature"),
         ("triplaneline", None)]


def _overrides(gtype):
    return [f"geometric_network.voxel.type={gtype}",
            "geometric_network.voxel.hash_levels=4"]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _both_imports(tmp_path, h5p, gtype):
    """(JAX checkpoint path, port checkpoint path) of one h5 file."""
    from ndjir_torch.tools.import_reference import (
        import_reference_checkpoint as port_import,
    )
    from ndjir_tpu.tools.import_reference import (
        import_reference_checkpoint as jax_import,
    )

    a = jax_import(h5p, str(tmp_path / "jax"),
                   load_config_jax("tiny_test", overrides=_overrides(gtype)))
    b = port_import(h5p, str(tmp_path / "port"),
                    load_config_port("tiny_test", overrides=_overrides(gtype)),
                    device="cpu")
    return a, b


@pytest.mark.parametrize("gtype,family", GRIDS)
def test_checkpoint_byte_equal(tmp_path, monkeypatch, gtype, family):
    """The JAX template written as the reference names it, imported by both
    packages: the msgpack and its manifest byte-equal, and the port reads
    every leaf back bitwise."""
    from ndjir_torch.models.fields import init_model
    from ndjir_torch.train.checkpoint import load_checkpoint
    from ndjir_tpu.models.fields import init_model as jax_init

    monkeypatch.setattr(ref, "FAMILY", family)
    template = jax_init(jax.random.PRNGKey(3), load_config_jax(
        "tiny_test", overrides=_overrides(gtype)))
    h5p = str(tmp_path / "model.h5")
    ref._write_reference_style_h5(h5p, template)
    a, b = _both_imports(tmp_path, h5p, gtype)
    assert os.path.basename(a) == os.path.basename(b) == "ckpt_0000000.msgpack"
    assert _read(a) == _read(b)
    assert _read(a.replace(".msgpack", ".json")) == \
        _read(b.replace(".msgpack", ".json"))

    conf = load_config_port("tiny_test", overrides=_overrides(gtype))
    params, _, extra = load_checkpoint(b, init_model(conf, seed=1,
                                                     device="cpu"))
    assert extra["imported_from"] == h5p and extra["step"] == 0
    flat = jax.tree_util.tree_flatten_with_path(template)[0]
    for path, leaf in flat:
        node = params
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_checkpoint_byte_equal_from_float64(tmp_path):
    """An h5 file of float64 datasets: both packages store float32 (what
    jnp.asarray makes of float64 with x64 off), byte-equal."""
    import h5py

    from ndjir_tpu.models.fields import init_model as jax_init
    from ndjir_tpu.tools.import_reference import load_reference_h5

    ref32 = str(tmp_path / "model32.h5")
    ref._write_reference_style_h5(ref32, jax_init(
        jax.random.PRNGKey(5), load_config_jax("tiny_test")))
    h5p = str(tmp_path / "model64.h5")
    with h5py.File(h5p, "w") as f:
        for name, arr in load_reference_h5(ref32).items():
            f.create_dataset(name, data=arr.astype(np.float64))
    a, b = _both_imports(tmp_path, h5p, "voxel")
    assert _read(a) == _read(b)
    with open(b.replace(".msgpack", ".json")) as f:
        assert json.load(f)["extra"] == {"imported_from": h5p}


def test_reference_default_scope_names_map_completely():
    """Every name the reference writes for the default config maps onto a
    leaf of the port's init_model tree and back; the schedule parameters
    are skipped (the name list of tests/test_import_reference.py)."""
    from ndjir_torch.models.fields import init_model
    from ndjir_torch.tools.import_reference import (
        convert_reference_params,
        validate_against_template,
    )
    from ndjir_torch.train.optim import tree_leaves_with_path

    conf = load_config_port("default", overrides=[
        "geometric_network.voxel.grid_size=16"])
    template = init_model(conf, seed=0, device="cpu")
    n_leaves = len(list(tree_leaves_with_path(template)))
    assert len(ref.REFERENCE_DEFAULT_H5_KEYS) == n_leaves

    names = ref.REFERENCE_DEFAULT_H5_KEYS + ref.REFERENCE_SKIPPED_KEYS
    flat = {k: np.zeros((1,), np.float32) for k in names}
    params, unmatched = convert_reference_params(flat, conf)
    assert unmatched == []
    assert "cos_anneal_ratio" not in params
    assert "gain" not in params.get("photogrammetric-light-network", {})
    assert [p for p in validate_against_template(params, template)
            if p.startswith("missing")] == []
    assert len(list(tree_leaves_with_path(params))) == n_leaves


def test_import_refuses_a_mismatched_config(tmp_path, monkeypatch):
    """A file of another grid size does not match the config: both raise
    naming the leaf, and nothing is written."""
    from ndjir_torch.tools.import_reference import (
        import_reference_checkpoint,
    )
    from ndjir_tpu.models.fields import init_model as jax_init

    monkeypatch.setattr(ref, "FAMILY", "voxel_feature")
    template = jax_init(jax.random.PRNGKey(0), load_config_jax(
        "tiny_test", overrides=["geometric_network.voxel.grid_size=8"]))
    h5p = str(tmp_path / "m.h5")
    ref._write_reference_style_h5(h5p, template)
    with pytest.raises(ValueError, match="geometric-network/grid/F"):
        import_reference_checkpoint(h5p, str(tmp_path / "out"),
                                    load_config_port("tiny_test"),
                                    device="cpu")
    assert not (tmp_path / "out").exists()


def test_import_cli(tmp_path, monkeypatch):
    from ndjir_torch.tools import import_reference
    from ndjir_tpu.models.fields import init_model as jax_init

    monkeypatch.setattr(ref, "FAMILY", "voxel_feature")
    ref._write_reference_style_h5(str(tmp_path / "m.h5"), jax_init(
        jax.random.PRNGKey(0), load_config_jax("tiny_test")))
    args = [str(tmp_path / "m.h5"), str(tmp_path / "out"), "--config-name",
            "tiny_test"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            import_reference.main(args)
    import_reference.main(args + ["--device", "cpu"])
    assert (tmp_path / "out" / "ckpt_0000000.msgpack").exists()


# ---------------------------------------------------------------------------
# profiling and runtime helpers
# ---------------------------------------------------------------------------

def test_trace_holds_annotations(tmp_path):
    from ndjir_torch.utils.profiling import TRACE_FILE, annotate, trace

    with trace(str(tmp_path / "tr")) as logdir:
        with annotate("port_tools_region"):
            torch.ones(64).cumsum(0)
        with annotate("second_region"):
            torch.zeros(8).sum()
    assert logdir == str(tmp_path / "tr")
    with open(os.path.join(logdir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"port_tools_region", "second_region"} <= names


def test_trace_default_directory(tmp_path, monkeypatch):
    """Without a directory the trace goes under the temporary directory
    (TMPDIR), nowhere else."""
    import tempfile

    from ndjir_torch.utils.profiling import TRACE_FILE, trace

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    with trace() as logdir:
        torch.ones(2).sum()
    assert logdir == os.path.join(str(tmp_path), "ndjir_torch_trace")
    assert os.path.getsize(os.path.join(logdir, TRACE_FILE)) > 0


def test_runtime_has_no_compilation_cache():
    """The port compiles no graph: no cache to set up (the kernels' build
    directory is its cache); device_kind names the card."""
    from ndjir_torch.utils import runtime

    assert not hasattr(runtime, "setup_compilation_cache")
    assert "library_path" in runtime.__doc__


@pytest.mark.cuda
def test_device_kind_names_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ndjir_torch.utils.runtime import device_kind

    assert device_kind() == torch.cuda.get_device_name(0)
