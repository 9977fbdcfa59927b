"""The row gather (``csrc/gather_rows.cu``), the forward of ``GatherRows``,
against ``index_select``, which stays its plain version.

The tests marked ``cuda`` (skipped without an NVIDIA GPU) hold the kernel
to ``index_select`` bit for bit: f32 rows of 1, 2, 3, 4 and 8 values and
bf16 rows of 4 and 8 at 0, 1, 31, 33 and 2^20 + 7 ids (repeated ids, the
first and the last row), int32 ids, tables whose address or row width
takes a narrower vector; every row width through ``take_rows``; the
forward and table gradient of one 8-corner voxel query, one
differentiated Lanczos query, one hash query and one hash TV map at a
B=4, R=512 step's points, kernel against ``index_select`` in its place; and a captured ``train_steps`` whose replays add the capture's
gathers to ``LAUNCHES``.  The CPU tests check that a CPU table takes
``index_select`` and launches nothing, the wrapper's vector width and
lanes and the arguments it hands the kernel, and that the benchmark reads
the kernel's name as a gather.  The file imports no JAX:
``python3 -m pytest tests/test_torch_gather_rows.py -q``.
"""

import os
import re

import numpy as np
import pytest
import torch

from benchmark import trace
from ndjir_torch import kernels
from ndjir_torch.ops import grid, scatter, tv_loss

torch.set_num_threads(2)

M = 1000
# the hash preset's levels (configs/default.yaml's hash keys, D = 4)
HASH = (16, 1.5, 2 ** 15, 16, 4)
BOX = ((-1.0,) * 3, (1.0,) * 3)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the gather kernel has no CPU mode")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _table(rows, d, dtype, device, seed=0):
    """Random bytes as a (rows, d) table: NaNs and infinities included."""
    g = torch.Generator().manual_seed(seed)
    size = torch.tensor([], dtype=dtype).element_size()
    raw = torch.randint(0, 256, (rows, d * size), dtype=torch.uint8,
                        generator=g)
    return raw.view(dtype).to(device)


def _ids(n, rows, device, dtype=torch.int64, seed=1):
    """n ids in [0, rows): the first and the last row, and repeats."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, rows, n)
    ids[:n // 3] = rng.randint(0, 7, n // 3) * (rows // 7)   # repeats
    if n:
        ids[0] = 0
        ids[-1] = rows - 1
    if n > 2:
        ids[n // 2] = rows - 1
    return torch.from_numpy(rng.permutation(ids)).to(device, dtype)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 31, 33, 2 ** 20 + 7])
@pytest.mark.parametrize("dtype,d", [(torch.float32, 1), (torch.float32, 2),
                                     (torch.float32, 3), (torch.float32, 4),
                                     (torch.float32, 8),
                                     (torch.bfloat16, 4),
                                     (torch.bfloat16, 8)])
def test_kernel_is_index_select_bitwise(cuda, dtype, d, n):
    table = _table(M, d, dtype, cuda)
    ids = _ids(n, M, cuda)
    before = kernels.LAUNCHES["gather_rows"]
    got = scatter._gather_rows_cuda(table, ids)
    assert kernels.LAUNCHES["gather_rows"] - before == (1 if n else 0)
    want = table.index_select(0, ids)
    assert got.shape == want.shape == (n, d) and got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [
    (torch.float32, 1), (torch.float32, 2), (torch.float32, 3),
    (torch.float32, 4), (torch.float32, 8), (torch.float64, 1),
    (torch.bfloat16, 1), (torch.bfloat16, 4), (torch.bfloat16, 8)])
def test_take_rows_launches_the_kernel_by_row_width(cuda, dtype, d):
    """Every CUDA table takes the kernel, whatever its row width."""
    table = _table(M, d, dtype, cuda)
    ids = _ids(4097, M, cuda)
    before = kernels.LAUNCHES["gather_rows"]
    got = scatter.take_rows(table, ids)
    assert kernels.LAUNCHES["gather_rows"] - before == 1
    assert torch.equal(_bits(got), _bits(table.index_select(0, ids)))


@pytest.mark.cuda
def test_kernel_takes_int32_ids_and_narrower_vectors(cuda):
    """int32 ids; a table at an address 4 bytes past 16 (4-byte vectors);
    bf16 rows of one value (2 bytes) and byte rows of 3 (1 byte)."""
    n = 50_001
    flat = _table(M * 4 + 1, 1, torch.float32, cuda).reshape(-1)
    cases = [(_table(M, 4, torch.float32, cuda), torch.int32),
             (flat[1:].view(M, 4), torch.int64),
             (_table(M, 1, torch.bfloat16, cuda), torch.int64),
             (_table(M, 3, torch.uint8, cuda), torch.int32)]
    for table, id_dtype in cases:
        ids = _ids(n, M, cuda, id_dtype)
        before = kernels.LAUNCHES["gather_rows"]
        got = scatter.take_rows(table, ids)
        assert kernels.LAUNCHES["gather_rows"] - before == 1
        want = table.index_select(0, ids)
        assert torch.equal(_bits(got), _bits(want)), (table.dtype,
                                                      table.shape, id_dtype)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    table = _table(M, 4, torch.float32, cuda)
    with pytest.raises(TypeError):
        scatter.take_rows(table, torch.zeros(4, device=cuda))
    with pytest.raises(ValueError):
        scatter.take_rows(table, torch.zeros(4, dtype=torch.long))
    with pytest.raises(ValueError):
        scatter.take_rows(table.reshape(-1), torch.zeros(4, dtype=torch.long,
                                                         device=cuda))


def _ray_points(rays, samples, device, seed=0):
    """Points along rays from cameras outside the unit box towards its
    middle, sorted along each ray, some past the box: a step's samples."""
    rng = np.random.RandomState(seed)
    cam = rng.normal(size=(rays, 1, 3))
    cam *= rng.uniform(2.0, 3.5, (rays, 1, 1)) / np.linalg.norm(
        cam, axis=-1, keepdims=True)
    target = rng.uniform(-0.6, 0.6, (rays, 1, 3))
    d = (target - cam) / np.linalg.norm(target - cam, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0.5, 6.0, (rays, samples, 1)), axis=1)
    return torch.from_numpy((cam + t * d).astype(np.float32)).to(device)


_QUERIES = {
    "voxel": (lambda x, t: grid.query_voxel(x, t, *BOX), (512,) * 3 + (4,)),
    "lanczos": (lambda x, t: grid.query_voxel_lanczos(x, t, *BOX),
                (512,) * 3 + (4,)),
    "hash": (lambda x, t: grid.query_voxel_hash(x, t, *HASH, *BOX), None),
    "hash_tv": (lambda x, t: tv_loss.tv_loss_voxel_hash(x, t, *HASH, *BOX),
                None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("query", sorted(_QUERIES))
def test_grid_query_forward_and_table_gradient_bitwise(cuda, query,
                                                       monkeypatch):
    """One grid query of a training step (B=4 x R=512 rays x 128 samples),
    its output and its table gradient: one gather launch, bitwise the same
    query with ``index_select`` in the kernel's place."""
    fn, shape = _QUERIES[query]
    if shape is None:
        shape = (grid.hash_num_params(*HASH),)
    gen = torch.Generator(device=cuda).manual_seed(2)
    table = 1e-3 * torch.randn(shape, generator=gen, device=cuda)
    x = _ray_points(4 * 512, 128, cuda)

    def run():
        t = table.clone().requires_grad_(True)
        before = kernels.LAUNCHES["gather_rows"]
        out = fn(x, t)
        launches = kernels.LAUNCHES["gather_rows"] - before
        cot = torch.randn(out.shape, generator=torch.Generator(
            device=cuda).manual_seed(3), device=cuda)
        (g,) = torch.autograd.grad(out, t, cot)
        return out.detach(), g, launches

    out, g, launches = run()
    assert launches == 1
    monkeypatch.setattr(scatter, "_gather_rows_cuda",
                        scatter._gather_rows_plain)
    want_out, want_g, plain = run()
    assert plain == 0
    assert torch.equal(_bits(out), _bits(want_out))
    assert torch.equal(_bits(g), _bits(want_g))


def _tiny_conf():
    from ndjir_torch.config import load_config

    return load_config("default", overrides=[
        "valid.skip=true", "data_path=synthetic/sphere",
        "geometric_network.voxel.grid_size=16",
        "geometric_network.feature_size=64", "train.batch_size=2",
        "train.n_rays=8", "renderer.n_samples0=8", "renderer.n_samples1=4",
        "renderer.n_bg_samples=4", "renderer.n_thetas=2"])


@pytest.mark.cuda
def test_captured_step_replays_its_gathers(cuda, monkeypatch):
    """A captured default step holds 6 gathers (the sampler's four
    queries, x_fg with its TV map, x_ptb): each replay adds them to
    ``LAUNCHES``.  Its trained parameters and monitors equal, bitwise,
    those of the same captured training with ``index_select`` in the
    kernel's place; a first training warms the process up (``PERF.md``
    §7: a first captured training after an eikonal double backward lands
    ulps from later ones)."""
    from ndjir_torch.models.fields import init_model
    from ndjir_torch.render.renderer import make_mc_cdfs
    from ndjir_torch.train.graph import CapturedStep
    from ndjir_torch.train.optim import init_optimizer, tree_leaves_with_path
    from ndjir_torch.train.trainer import train_step, train_steps

    conf = _tiny_conf()
    B, R, K = conf.train.batch_size, conf.train.n_rays, 4
    rng = np.random.RandomState(3)
    camloc = np.tile(np.float32([0.1, -0.2, 2.5]), (K, B, 1))
    raydir = rng.randn(K, B, R, 3).astype(np.float32) * 0.5
    raydir[..., 2] -= 1.0
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    color = rng.rand(K, B, R, 3).astype(np.float32)
    mask = (rng.rand(K, B, R, 1) < 0.7).astype(np.float32)
    batches = [torch.from_numpy(a).to(cuda)
               for a in (camloc, raydir, color, mask)]
    cdfs = make_mc_cdfs(conf, B, R, device=cuda)
    sched = (0.5, 1.0, 1e-3, 1e-3)

    def train(per_step):
        p = init_model(conf, seed=0, device=cuda)
        o = init_optimizer(p)
        graph = CapturedStep(train_step, conf)
        kernels.reset_launches()
        mons = train_steps(p, o, *batches, *sched, 0, conf, cdfs=cdfs,
                           graph=graph)
        assert graph.captures == 1 and graph.replays == K - 1
        assert graph.tally["gather_rows"] == per_step
        assert kernels.LAUNCHES["gather_rows"] == per_step * K
        graph.release()
        return [t for _, t in tree_leaves_with_path(p)], mons

    train(6)
    fast, fast_mons = train(6)
    monkeypatch.setattr(scatter, "_gather_rows_cuda",
                        scatter._gather_rows_plain)
    plain, plain_mons = train(0)
    assert len(fast) == len(plain)
    assert all(torch.equal(a, b) for a, b in zip(fast, plain))
    assert fast_mons.keys() == plain_mons.keys()
    assert all(torch.equal(fast_mons[k], plain_mons[k]) for k in fast_mons)


# --------------------------------------------------------------------------
# on the CPU
# --------------------------------------------------------------------------

def _refuse(*args):
    raise AssertionError("a CPU table launched the gather kernel")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_cpu_table_takes_index_select_bitwise(monkeypatch, dtype, d):
    monkeypatch.setattr(kernels, "launch", _refuse)
    monkeypatch.setattr(kernels, "LAUNCHES",
                        dict.fromkeys(kernels.LAUNCHES, 0))
    table = _table(M, d, dtype, "cpu")
    ids = _ids(3000, M, "cpu")
    got = scatter.take_rows(table, ids)
    assert torch.equal(_bits(got), _bits(table.index_select(0, ids)))
    rows = scatter.gather_rows(table, ids.reshape(3, -1))
    assert rows.shape == (3, 1000, d)
    assert torch.equal(_bits(rows), _bits(table[ids.reshape(3, -1)]))
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("row_bytes,addresses,want", [
    (16, (0, 256), (16, 1)),          # D=4 f32
    (32, (512, 1024), (16, 2)),       # D=8 f32 (triplaneline)
    (4, (0, 0), (4, 1)),              # D=1 f32
    (8, (0, 0), (8, 1)),              # D=4 bf16, D=2 f32
    (12, (0, 0), (4, 3)),             # D=3 f32
    (256, (0, 0), (16, 16)),          # D=64 f32
    (16, (4, 0), (4, 4)),             # a table 4 bytes past 16
    (16, (8, 256), (8, 2)),
    (32, (0, 24), (8, 4)),            # an output 8 bytes past 16
    (2, (0, 0), (2, 1)),              # D=1 bf16
    (6, (0, 0), (2, 3)),              # D=3 bf16
    (3, (0, 0), (1, 3)),
    (16, (1, 0), (1, 16)),
    (16, (8, 0), (8, 2)),             # D=2 f64 at an address 8 past 16
    (24, (0, 0), (8, 3)),             # D=3 f64
    (12, (16, 4), (4, 3)),            # D=3 f32, an output 4 past 16
])
def test_width_and_lanes_follow_row_bytes_and_alignment(row_bytes, addresses,
                                                        want):
    assert scatter.gather_width(row_bytes, *addresses) == want


def test_width_refuses_an_empty_row():
    with pytest.raises(ValueError):
        scatter.gather_width(0, 0, 0)


@pytest.mark.parametrize("case", ["f32_d4", "f32_d8", "offset", "int32",
                                  "bf16_d1", "f32_d1", "f32_d2", "f32_d3",
                                  "f64_d1", "empty"])
def test_wrapper_hands_the_kernel_its_arguments(monkeypatch, case):
    """``_gather_rows_cuda`` on CPU tensors with a stand-in kernel: the
    table, ids, id width, output, counts, row bytes and vector width it
    passes, one count a launch and none for no ids."""
    d, dtype, id_dtype, n = {
        "f32_d4": (4, torch.float32, torch.int64, 77),
        "f32_d8": (8, torch.float32, torch.int64, 77),
        "offset": (4, torch.float32, torch.int64, 77),
        "int32": (4, torch.float32, torch.int32, 77),
        "bf16_d1": (1, torch.bfloat16, torch.int64, 77),
        "f32_d1": (1, torch.float32, torch.int64, 77),
        "f32_d2": (2, torch.float32, torch.int64, 77),
        "f32_d3": (3, torch.float32, torch.int64, 77),
        "f64_d1": (1, torch.float64, torch.int64, 77),
        "empty": (4, torch.float32, torch.int64, 0)}[case]
    table = _table(M + 1, d, dtype, "cpu")
    if case == "offset":
        table = table.reshape(-1)[1:1 + M * d].view(M, d)
    else:
        table = table[:M]
    ids = _ids(n, M, "cpu", id_dtype)
    calls = []

    def launch(name, symbol, device, *args):
        calls.append((name, symbol, device, args))
    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(kernels, "LAUNCHES",
                        dict.fromkeys(kernels.LAUNCHES, 0))
    out = scatter._gather_rows_cuda(table, ids)
    assert out.shape == (n, d) and out.dtype == dtype
    if case == "empty":
        assert calls == [] and kernels.LAUNCHES["gather_rows"] == 0
        return
    ((name, symbol, device, args),) = calls
    row_bytes = d * table.element_size()
    width, _ = scatter.gather_width(row_bytes, table.data_ptr(),
                                    out.data_ptr())
    assert (name, symbol, device) == ("gather_rows", "gather_rows",
                                      table.device)
    assert args == (table.data_ptr(), ids.data_ptr(),
                    int(id_dtype == torch.int64), out.data_ptr(), n, M,
                    row_bytes, width)
    assert width == {"f32_d4": 16, "f32_d8": 16, "offset": 4, "int32": 16,
                     "bf16_d1": 2, "f32_d1": 4, "f32_d2": 8, "f32_d3": 4,
                     "f64_d1": 8}[case]
    assert kernels.LAUNCHES["gather_rows"] == 1


def test_wrapper_refuses_ids_it_cannot_read():
    table = _table(M, 4, torch.float32, "cpu")
    with pytest.raises(TypeError):
        scatter._gather_rows_cuda(table, torch.zeros(4))
    with pytest.raises(TypeError):
        scatter._gather_rows_cuda(table, torch.zeros(4, dtype=torch.int16))
    with pytest.raises(ValueError):
        scatter.take_rows(table[None], torch.zeros(4, dtype=torch.long))
    with pytest.raises(ValueError):
        scatter.take_rows(table, torch.zeros(2, 2, dtype=torch.long))


def _kernel_names():
    path = os.path.join(os.path.dirname(kernels.BUILD_DIR), "gather_rows.cu")
    with open(path) as f:
        src = f.read()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                      r"(\w+)\s*\(", src)


def test_the_benchmark_reads_the_kernel_as_a_gather():
    """``gather_ms`` sums the kernels that ``trace.kind_of`` calls
    "gather": the kernel's name, as the source declares it and as the
    profiler prints an instance of it."""
    names = _kernel_names()
    assert names == ["gather_rows_kernel"]
    assert trace.kind_of(names[0]) == "gather"
    assert trace.kind_of(
        "void (anonymous namespace)::gather_rows_kernel<uint4, long long>"
        "(uint4 const*, long long const*, uint4*, long long, long long, "
        "long long, int)") == "gather"


def test_kernel_is_registered():
    lib = kernels.LIBRARIES["gather_rows"]
    assert (lib.source, lib.compiler) == ("gather_rows.cu", "nvcc")
    assert list(lib.functions) == ["gather_rows"]
    assert len(lib.functions["gather_rows"]) == 9
    assert "gather_rows" in kernels.LAUNCHES
