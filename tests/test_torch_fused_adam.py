"""The dual-Adam update's two CUDA kernels (``csrc/adam_update.cu``)
against the optimizer's PyTorch passes, and the dispatch between them.

Tests marked ``cuda`` skip without an NVIDIA GPU; on the card each holds
``apply_updates`` (the kernels for the f32 leaves) bitwise against
``apply_updates_plain`` (PyTorch's passes for every leaf) on the same
inputs, skipped steps and signed zeros included:
``python3 -m pytest tests/test_torch_fused_adam.py -q -m cuda``.  The CPU
tests check which leaves each path takes, with the kernels replaced by
their arithmetic in PyTorch ops.  The file imports no JAX.
"""

import numpy as np
import pytest
import torch

from ndjir_torch import kernels
from ndjir_torch.config import load_config
from ndjir_torch.models.fields import init_model, is_grid_feature_path
from ndjir_torch.ops import adam_update
from ndjir_torch.train import optim
from ndjir_torch.train.optim import (
    apply_updates,
    apply_updates_plain,
    init_optimizer,
    tree_leaves_with_path,
    tree_map,
)

torch.set_num_threads(2)

LR_W, LR_F = 1e-3, 2e-2
TABLE = ("geometric-network", "grid", "F")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _conf(*overrides, grid=8):
    return load_config("default", [
        f"geometric_network.voxel.grid_size={grid}", *overrides])


def _bits(t):
    """The tensor's bit patterns (so -0.0 and +0.0 differ)."""
    return t.contiguous().view({torch.float32: torch.int32,
                                torch.bfloat16: torch.int16}[t.dtype])


def _equal(a, b):
    la, lb = list(tree_leaves_with_path(a)), list(tree_leaves_with_path(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, path
        assert torch.equal(_bits(x), _bits(y)), path


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _draw(params, seed, scale=1.0, positive=False):
    """Random f32 values shaped like ``params``' leaves, on their device."""
    rng = np.random.RandomState(seed)

    def one(p):
        x = rng.randn(*p.shape).astype(np.float32) * scale
        return torch.from_numpy(np.abs(x) if positive else x).to(p.device)
    return tree_map(one, params)


def _model(conf, device, seed=0):
    """Parameters, a state with nonzero moments, and three steps'
    gradients (in the parameters' dtypes)."""
    params = init_model(conf, seed=seed, device=device)
    state = init_optimizer(params)
    state["mu"] = _draw(params, seed + 1, 1e-2)
    state["nu"] = _draw(params, seed + 2, 1e-4, positive=True)
    grads = [_cast_like(_draw(params, seed + 3 + k, 0.1), params)
             for k in range(3)]
    return params, state, grads


def _cast_like(tree, like):
    return {k: _cast_like(v, like[k]) if isinstance(v, dict)
            else v.to(like[k].dtype) for k, v in tree.items()}


def _steps(fn, params, state, grads, lr_w, lr_f, conf):
    """``fn`` over each of ``grads`` (cloned: the plain path overwrites
    them) on copies of ``params`` and ``state``; returns the final copies
    and each step's flag."""
    params, state = _clone(params), _clone(state)
    flags = [fn(params, _clone(g), state, lr_w, lr_f, conf).item()
             for g in grads]
    return params, state, flags


def _compare(params, state, grads, conf, lr_w=LR_W, lr_f=LR_F):
    """apply_updates against apply_updates_plain over ``grads``; returns
    the kernel launches the fused steps made."""
    before = kernels.LAUNCHES["adam_update"]
    got = _steps(apply_updates, params, state, grads, lr_w, lr_f, conf)
    launches = kernels.LAUNCHES["adam_update"] - before
    want = _steps(apply_updates_plain, params, state, grads, lr_w, lr_f,
                  conf)
    _equal(got[0], want[0])
    _equal(got[1]["mu"], want[1]["mu"])
    _equal(got[1]["nu"], want[1]["nu"])
    assert got[1]["count"].item() == want[1]["count"].item()
    assert got[2] == want[2]
    return got, launches


# --- on the card -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 0.001])
@pytest.mark.parametrize("lr", ["float", "tensor"])
def test_default_tree_three_steps_bitwise(cuda, wd, lr):
    """The default tree (86 leaves, a 64^3 table) over three steps."""
    conf = _conf(f"train.weight_decay={wd}", grid=64)
    params, state, grads = _model(conf, cuda)
    assert len(list(tree_leaves_with_path(params))) == 86
    lrs = (LR_W, LR_F) if lr == "float" else (
        torch.tensor(LR_W, device=cuda), torch.tensor(LR_F, device=cuda))
    (p, s, flags), launches = _compare(params, state, grads, conf, *lrs)
    assert flags == [True] * 3 and s["count"].item() == 3
    assert launches == 2 * 3
    assert not torch.equal(p[TABLE[0]][TABLE[1]][TABLE[2]],
                           params[TABLE[0]][TABLE[1]][TABLE[2]])


@pytest.mark.cuda
def test_gradients_of_the_kernels_leaves_are_left_as_they_were(cuda):
    conf = _conf(grid=16)
    params, state, grads = _model(conf, cuda)
    g = _clone(grads[0])
    apply_updates(params, g, state, LR_W, LR_F, conf)
    _equal(g, grads[0])


@pytest.mark.cuda
def test_a_512_cube_table_leaf_bitwise(cuda):
    """One step of the default table's size (512^3 x 4 f32, 2.1 GB) beside
    one small leaf."""
    torch.manual_seed(0)
    shape = (512, 512, 512, 4)
    params = {"geometric-network": {
        "grid": {"F": torch.randn(shape, device=cuda) * 1e-2},
        "affine-00": {"b": torch.randn(256, device=cuda)}}}
    state = init_optimizer(params)
    state["nu"] = tree_map(lambda p: torch.rand_like(p) * 1e-4, params)
    grads = [tree_map(lambda p: torch.randn_like(p) * 1e-2, params)]
    (_, s, flags), launches = _compare(params, state, grads, _conf())
    assert flags == [True] and launches == 2


def _fault(kind, params, grads):
    """Puts ``kind`` into the first small leaf's gradient (a NaN, an Inf,
    or a finite g beside a finite p whose g + wd * p overflows)."""
    path = ("geometric-network", "affine-00", "W")
    g = grads[path[0]][path[1]][path[2]]
    p = params[path[0]][path[1]][path[2]]
    if kind == "nan":
        g.view(-1)[5] = float("nan")
    elif kind == "inf":
        g.view(-1)[7] = float("-inf")
    else:
        g.view(-1)[3] = 3.4028e38
        p.view(-1)[3] = 3.0e38


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["nan", "inf", "overflow"])
def test_a_non_finite_gradient_skips_bitwise(cuda, kind):
    """A skipped step leaves parameters, moments and the count as they
    were, bit for bit, +-0.0 included; then the next step updates."""
    conf = _conf("train.weight_decay=0.001", grid=16)
    params, state, grads = _model(conf, cuda)
    for tree in (params, state["mu"]):
        for _, t in tree_leaves_with_path(tree):
            t.view(-1)[-1] = 0.0
            t.view(-1)[0] = -0.0
    for _, t in tree_leaves_with_path(state["nu"]):
        t.view(-1)[0] = 0.0
    _fault(kind, params, grads[1])
    (p, s, flags), _ = _compare(params, state, grads[1:2], conf)
    assert flags == [False] and s["count"].item() == 0
    _equal(p, params)
    _equal(s["mu"], state["mu"])
    _equal(s["nu"], state["nu"])
    (_, s, flags), _ = _compare(params, state, [grads[1], grads[0]], conf)
    assert flags == [False, True] and s["count"].item() == 1


@pytest.mark.cuda
def test_leaf_sizes_and_unaligned_views_bitwise(cuda):
    """Leaves of 1, 3 and 4097 elements (scalar tails, a chunk edge), one
    of 4096 * 3 + 5, and leaves whose tensors are contiguous views that
    start 1-3 floats into their storage (no 16-byte loads)."""
    rng = np.random.RandomState(5)

    def t(n, offset=0):
        x = torch.from_numpy(rng.randn(n + offset).astype(np.float32))
        return x.to(cuda)[offset:]

    def like(p, scale, offset):
        aligned = p.data_ptr() % 16 == 0
        return t(p.numel(), 0 if aligned else offset) * scale
    sizes = {"a": 1, "b": 3, "c": 4097, "d": 4096 * 3 + 5}
    params = {"net": {k: t(n) for k, n in sizes.items()},
              "grid": {"F": t(1001, 1)}, "u": {"b": t(64, 3)}}
    assert params["grid"]["F"].data_ptr() % 16 != 0
    state = {"count": torch.zeros((), dtype=torch.int32, device=cuda),
             "mu": tree_map(lambda p: like(p, 1e-2, 1), params),
             "nu": tree_map(lambda p: like(p, 1e-4, 2).abs(), params)}
    grads = [tree_map(lambda p: like(p, 0.1, 1), params) for _ in range(3)]
    (_, s, flags), launches = _compare(params, state, grads, _conf())
    assert flags == [True] * 3 and launches == 6


@pytest.mark.cuda
def test_more_leaves_than_a_launch_takes_are_chunked(cuda):
    n = adam_update.max_leaves() * 2 + 3
    rng = np.random.RandomState(6)
    params = {"w": {f"{i}": torch.from_numpy(
        rng.randn(rng.randint(1, 300)).astype(np.float32)).to(cuda)
        for i in range(n)}}
    state = init_optimizer(params)
    grads = [_draw(params, k) for k in range(2)]
    _, launches = _compare(params, state, grads, _conf())
    assert launches == 2 * 2 * 3


@pytest.mark.cuda
def test_a_bf16_table_beside_f32_leaves(cuda):
    """The production precision's tree: the bf16 table takes PyTorch's
    passes, the 85 f32 leaves the kernels, under one span that counts
    them; a skip in the bf16 leaf skips every leaf."""
    from torch.profiler import ProfilerActivity, profile

    from ndjir_torch.utils import profiling

    conf = _conf("precision.grid_dtype=bfloat16", grid=16)
    params, state, grads = _model(conf, cuda)
    assert params[TABLE[0]][TABLE[1]][TABLE[2]].dtype == torch.bfloat16
    (_, _, flags), launches = _compare(params, state, grads, conf)
    assert flags == [True] * 3 and launches == 6
    grads[0][TABLE[0]][TABLE[1]][TABLE[2]].view(-1)[2] = float("nan")
    (_, s, flags), _ = _compare(params, state, grads, conf)
    assert flags == [False, True, True] and s["count"].item() == 2
    profiling.spans().clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        apply_updates(_clone(params), _clone(grads[1]), _clone(state),
                      LR_W, LR_F, conf)
        torch.cuda.synchronize()
    (span,) = [s for s in profiling.spans() if s.name == "optim.fused"]
    f32 = [p for _, p in tree_leaves_with_path(params)
           if p.dtype == torch.float32]
    assert span.counts == {"leaves": 85,
                           "elems": sum(p.numel() for p in f32)}


@pytest.mark.cuda
def test_captured_update_replays_as_eager_steps(cuda):
    """apply_updates captured once in a CUDA graph over static gradient
    buffers, replayed three times, against three eager plain steps; the
    launches counted at capture are the step's two."""
    conf = _conf(grid=16)
    params, state, grads = _model(conf, cuda)
    want = _steps(apply_updates_plain, params, state, grads, LR_W, LR_F,
                  conf)
    p, s = _clone(params), _clone(state)
    buf = _clone(grads[0])
    lr = torch.tensor([LR_W, LR_F], device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm-up on copies, as a capture does
        apply_updates(_clone(p), _clone(buf), _clone(s), lr[0], lr[1], conf)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernels.LAUNCHES["adam_update"]
    with torch.cuda.graph(graph):
        flag = apply_updates(p, buf, s, lr[0], lr[1], conf)
    assert kernels.LAUNCHES["adam_update"] - before == 2
    flags = []
    for g in grads:
        for (_, b), (_, x) in zip(tree_leaves_with_path(buf),
                                  tree_leaves_with_path(g)):
            b.copy_(x)
        graph.replay()
        flags.append(flag.item())
    assert flags == want[2]
    _equal(p, want[0])
    _equal(s["mu"], want[1]["mu"])
    _equal(s["nu"], want[1]["nu"])
    assert s["count"].item() == want[1]["count"].item() == 3


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    g = torch.zeros(8, 4, device=cuda)
    with pytest.raises(ValueError):
        adam_update.finite_flag([g.t()], [g.t()], 0.0)    # not contiguous
    with pytest.raises(TypeError):
        adam_update.finite_flag([g.double()], [g.double()], 0.0)
    with pytest.raises(TypeError):
        adam_update.finite_flag([g.bfloat16()], [g.bfloat16()], 0.0)
    with pytest.raises(ValueError):
        adam_update.finite_flag([g], [g[:4]], 0.0)     # sizes differ
    flag = torch.ones((), dtype=torch.int32, device=cuda)
    lr = torch.ones((), device=cuda)
    with pytest.raises(TypeError):
        adam_update.update([g], [g], [g], [g], [False], flag, lr, lr, 0.0,
                           0.9, 0.999, 1e-8)


# --- on the CPU ------------------------------------------------------------


def _fake_kernels(calls):
    """The kernels' arithmetic as PyTorch ops, recording the leaves each
    pass gets: PyTorch's own ops round as the kernels do, so the fused
    path is bitwise the plain one on the CPU too."""
    def finite_flag(gs, ps, wd):
        calls.append(("A", [p.dtype for p in ps]))
        return torch.stack([torch.isfinite(
            g.add(p, alpha=wd) if wd > 0 else g).all()
            for g, p in zip(gs, ps)]).all()

    def update(gs, ps, ms, vs, feat, finite, lr_bias_feat, lr_bias_weight,
               wd, b1, b2, eps):
        calls.append(("B", [p.dtype for p in ps], list(feat)))
        if not finite.item():
            return
        for g, p, m, v, f in zip(gs, ps, ms, vs, feat):
            g = g.add(p, alpha=wd) if wd > 0 else g
            m.mul_(torch.tensor(b1)).add_(g, alpha=1 - b1)
            v.mul_(torch.tensor(b2)).addcmul_(g, g, value=1 - b2)
            step = torch.sqrt(v).add_(eps)
            torch.div(m, step, out=step)
            p.sub_(step.mul_(lr_bias_feat if f else lr_bias_weight))
    return finite_flag, update


def _refuse(*_, **__):
    raise AssertionError("the kernels were called")


@pytest.mark.parametrize("fault", [None, "nan"])
def test_dispatch_sends_the_f32_leaves_to_the_kernels(monkeypatch, fault):
    """With every f32 leaf taken as a kernel leaf, a bf16 table beside
    them keeps PyTorch's passes; the result, skips included, is the plain
    path's, the kernels' gradients are left as they were, and the feature
    leaf takes lr_feat."""
    calls = []
    fake = _fake_kernels(calls)
    monkeypatch.setattr(optim, "_fused",
                        lambda p: p.dtype == torch.float32)
    monkeypatch.setattr(adam_update, "finite_flag", fake[0])
    monkeypatch.setattr(adam_update, "update", fake[1])
    conf = _conf("precision.grid_dtype=bfloat16")
    params, state, grads = _model(conf, "cpu")
    if fault:
        _fault(fault, params, grads[1])
    g0 = _clone(grads[0])
    (_, s, flags), _ = _compare(params, state, grads, conf)
    assert flags == [True, fault is None, True]
    leaves = list(tree_leaves_with_path(params))
    f32 = [p.dtype for _, p in leaves if p.dtype == torch.float32]
    assert len(f32) == 85
    assert calls[0] == ("A", f32)
    assert calls[1] == ("B", f32, [False] * 85)
    assert len(calls) == 6
    p, g = _clone(params), _clone(g0)
    apply_updates(p, g, _clone(state), LR_W, LR_F, conf)
    for (path, x), (_, y) in zip(tree_leaves_with_path(g),
                                 tree_leaves_with_path(g0)):
        assert torch.equal(x, y) == (x.dtype == torch.float32), path


def test_dispatch_gives_the_feature_leaf_lr_feat(monkeypatch):
    calls = []
    fake = _fake_kernels(calls)
    monkeypatch.setattr(optim, "_fused", lambda p: True)
    monkeypatch.setattr(adam_update, "finite_flag", fake[0])
    monkeypatch.setattr(adam_update, "update", fake[1])
    conf = _conf()
    params, state, grads = _model(conf, "cpu")
    _compare(params, state, grads, conf)
    feat = calls[1][2]
    paths = [path for path, _ in tree_leaves_with_path(params)]
    assert feat == [is_grid_feature_path(p) for p in paths]
    assert sum(feat) == 1 and feat[paths.index(TABLE)]


def test_clipping_takes_the_plain_path(monkeypatch):
    monkeypatch.setattr(optim, "_fused", lambda p: True)
    monkeypatch.setattr(adam_update, "finite_flag", _refuse)
    monkeypatch.setattr(adam_update, "update", _refuse)
    conf = _conf("train.clip_grad_norm=0.5")
    params, state, grads = _model(conf, "cpu")
    (_, s, flags), _ = _compare(params, state, grads, conf)
    assert flags == [True] * 3 and s["count"].item() == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_leaves_take_the_plain_path(monkeypatch, dtype):
    monkeypatch.setattr(adam_update, "finite_flag", _refuse)
    monkeypatch.setattr(adam_update, "update", _refuse)
    conf = _conf(f"precision.grid_dtype={dtype}")
    params, state, grads = _model(conf, "cpu")
    assert not any(optim._fused(p) for _, p in tree_leaves_with_path(params))
    (_, s, flags), _ = _compare(params, state, grads, conf)
    assert flags == [True] * 3 and s["count"].item() == 3


def test_kernel_is_registered_and_refuses_cpu_tensors():
    lib = kernels.LIBRARIES["adam_update"]
    assert (lib.source, lib.compiler) == ("adam_update.cu", "nvcc")
    assert {"adam_finite_reduce", "adam_update_elementwise"} \
        <= set(lib.functions)
    assert "adam_update" in kernels.LAUNCHES
    g = torch.zeros(4)
    with pytest.raises(ValueError):
        adam_update.finite_flag([g], [g], 0.0)
    with pytest.raises(ValueError):
        adam_update.update([g], [g], [g], [g], [False],
                           torch.ones((), dtype=torch.bool), g[0], g[0],
                           0.0, 0.9, 0.999, 1e-8)
    with pytest.raises(ValueError):
        adam_update.finite_flag([g], [], 0.0)
