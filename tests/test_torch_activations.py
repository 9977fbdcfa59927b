"""The softplus second derivative of the eikonal double backward on the CPU
(``ndjir_torch/ops/activations.py``): its plain form is the expression the
one-pass kernel replaced, bitwise, over the edge values; it is still the
second derivative of ``F.softplus`` in f64; CPU tensors take it and launch
nothing; and the kernel's wrapper hands it operands in the layout it reads
and refuses any dtype it lacks.
The kernel itself is held against the plain form on the card
(``tests/test_torch_cuda.py``).  The file imports no JAX:
``python3 -m pytest tests/test_torch_activations.py -q``.
"""

import pytest
import torch
import torch.nn.functional as F

from ndjir_torch import kernels
from ndjir_torch.ops import activations

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
NEEDS = [(True, True), (True, False), (False, True)]


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _edge_operands(dtype, beta, g_rows=False):
    """gg, g and x of shape (300, 213): x across the threshold, at +-0,
    NaN, +-inf and subnormals, gg and g with NaNs; g a slice of wider rows
    with ``g_rows``."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(300 * 213, generator=gen) * 0.3 / beta * 10
    x[:64] = torch.linspace(19.5 / beta, 20.5 / beta, 64)
    x[64:76] = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                             -float("inf"), 1e-40, -1e-40, 1e-30, -1e-30,
                             3e-38, 1e-45, -1e-45])
    gg = torch.randn(x.shape, generator=gen)
    gg[100:104] = float("nan")
    gg[104:106] = torch.tensor([float("inf"), 0.0])
    wide = torch.randn(300, 256, generator=gen)
    wide.view(-1)[200:204] = float("nan")
    g = wide[:, :213] if g_rows else wide[:, :213].contiguous()
    x, gg = x.view(300, 213), gg.view(300, 213)
    return gg.to(dtype), g.to(dtype), x.to(dtype)


def _inline(gg, g, x, beta, need_dg, need_dx):
    """``_SoftplusGrad.backward``'s expression before the kernel."""
    dg = activations._softplus_grad(gg, x, beta) if need_dg else None
    dx = None
    if need_dx:
        bx = x * beta
        dx = torch.ops.aten.sigmoid_backward(gg * g, bx.sigmoid()) \
            * (bx < 20.0).to(gg.dtype) * beta
    return dg, dx


@pytest.mark.parametrize("needs", NEEDS, ids=["both", "dg", "dx"])
@pytest.mark.parametrize("beta", [1.0, 100.0])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_form_is_the_inline_expression(dtype, beta, needs):
    for g_rows in (False, True):
        gg, g, x = _edge_operands(dtype, beta, g_rows)
        got = activations._softplus_grad_grad_plain(gg, g, x, beta, *needs)
        want = _inline(gg, g, x, beta, *needs)
        for a, b, need in zip(got, want, needs):
            if not need:
                assert a is None and b is None
                continue
            assert a.dtype == dtype and a.shape == x.shape
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("beta", [1.0, 100.0])
def test_second_derivative_is_the_fused_softplus_one_in_f64(beta):
    """gradgradcheck of the port's softplus, and its second derivatives in
    g and x against ``torch.autograd`` of ``F.softplus``, away from 0
    (where the first derivatives differ by design) and the threshold."""
    gen = torch.Generator().manual_seed(2)
    x = (torch.rand(64, generator=gen, dtype=torch.float64) + 0.05) / beta
    x = (x * torch.where(torch.arange(64) % 2 == 0, 1.0, -1.0)
         .to(torch.float64)).requires_grad_()
    torch.autograd.gradgradcheck(lambda v: activations.softplus(v, beta),
                                 (x,))

    g = torch.randn(64, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    gg = torch.randn(64, generator=gen, dtype=torch.float64)

    def second(fn):
        (d,) = torch.autograd.grad(fn(x), x, g, create_graph=True)
        return torch.autograd.grad(d, (g, x), gg)
    ours = second(lambda v: activations.softplus(v, beta))
    fused = second(lambda v: F.softplus(v, beta=beta, threshold=20.0))
    for a, b in zip(ours, fused):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_cpu_tensors_take_the_plain_form_and_launch_nothing(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU tensor reached the kernel")
    monkeypatch.setattr(kernels, "launch", refuse)
    monkeypatch.setattr(kernels, "LAUNCHES",
                        dict.fromkeys(kernels.LAUNCHES, 0))
    for dtype in DTYPES:
        for needs in NEEDS:
            gg, g, x = _edge_operands(dtype, 100.0, g_rows=True)
            got = activations._softplus_grad_grad(gg, g, x, 100.0, *needs)
            want = activations._softplus_grad_grad_plain(gg, g, x, 100.0,
                                                         *needs)
            for a, b in zip(got, want):
                assert (a is None and b is None) \
                    or torch.equal(_bits(a), _bits(b))
    # a softplus MLP's eikonal double backward on the CPU
    gen = torch.Generator().manual_seed(0)
    ws = [torch.randn(16, 16, generator=gen, requires_grad=True) * 0.3
          for _ in range(3)]
    p = torch.randn(32, 16, generator=gen, requires_grad=True)
    h = p
    for w in ws:
        h = activations.softplus(h @ w, 100.0)
    (grad,) = torch.autograd.grad(h.sum(), p, create_graph=True)
    (grad.norm(dim=-1) - 1).square().mean().backward()
    assert not any(kernels.LAUNCHES.values())


def _operands(dtype=torch.float32, shape=(8, 16)):
    return [torch.randn(shape).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("case", [
    "contiguous", "g_rows", "dg_only", "gg_strided", "x_strided",
    "g_transposed", "g_every_other_column", "empty", "bfloat16"])
def test_kernel_operands_are_in_the_layout_it_reads(case):
    """The kernel reads gg and x contiguous and g (only for dx; None here
    without it) contiguous or as rows at one stride: operands in another
    layout are copied into that one, values unchanged, and those already
    in it are passed as they are."""
    gg, g, x = _operands(torch.bfloat16 if case == "bfloat16"
                         else torch.float32)
    ld = 16
    if case == "g_rows":
        g, ld = torch.randn(8, 20)[:, 2:18], 20
    elif case == "dg_only":
        g = None
    elif case == "gg_strided":
        gg = torch.randn(8, 20)[:, :16]
    elif case == "x_strided":
        x = torch.randn(16, 8).t()
    elif case == "g_transposed":
        g = torch.randn(16, 8).t()
    elif case == "g_every_other_column":
        g = torch.randn(8, 32)[:, ::2]
    elif case == "empty":
        gg, g, x = _operands(shape=(0, 16))
    got = activations._kernel_operands(gg, g, x)
    assert got[3] == ld
    for a, b in zip(got[:3], (gg, g, x)):
        if b is None:
            assert a is None
            continue
        assert torch.equal(a, b) and a.dtype == b.dtype
        assert (a.data_ptr() == b.data_ptr()) == (
            b.is_contiguous() or (b is g and case == "g_rows"))
    assert got[0].is_contiguous() and got[2].is_contiguous()


@pytest.mark.parametrize("case", ["float64", "float16", "two_dtypes",
                                  "two_shapes"])
def test_kernel_operands_refuse_what_it_lacks(case):
    """The kernel has f32 and bf16 instantiations: any other dtype, or
    operands of two dtypes or two shapes, raise, as the first
    derivative's kernel does for a dtype it lacks."""
    gg, g, x = _operands()
    if case in ("float64", "float16"):
        gg, g, x = _operands(getattr(torch, case))
    elif case == "two_dtypes":
        g = g.bfloat16()
    elif case == "two_shapes":
        g = torch.randn(1, 16)
    with pytest.raises(TypeError):
        activations._kernel_operands(gg, g, x)


@pytest.mark.parametrize("layout", ["contiguous", "slice", "slice_of_rows",
                                    "rows_apart", "transposed",
                                    "every_other"])
def test_row_stride_of_each_layout(layout):
    t = torch.randn(4, 6, 32)
    want = {"contiguous": (t, 32), "slice": (t[..., 3:20], 32),
            "slice_of_rows": (t[1:3, :, :17], 32),
            "rows_apart": (t[:, 1:5, :17], None),
            "transposed": (t.transpose(0, 1), None),
            "every_other": (t[..., ::2], None)}[layout]
    assert activations._row_stride(want[0]) == want[1]
