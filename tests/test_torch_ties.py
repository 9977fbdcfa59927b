"""Gradients at ties and at zero: the port against the JAX package.

``jnp.abs``'s cotangent is ``select(x >= 0, g, -g)`` (+g at +-0, -g at
NaN), ``jnp.clip`` and ``jnp.maximum`` give g/2 at a bound, and the JAX
softplus ``max(x, 0) + log1p(exp(-beta |x|)) / beta`` has derivative 0 at
x = 0.  ``torch.abs`` gives 0, ``torch.clamp`` g and ``F.softplus`` 1/2
there.  The port takes JAX's at every such site on a gradient path
(``ndjir_torch/ops/ties.py``, ``ndjir_torch/ops/activations.py``); these
tests hold each against the JAX function at the exact tie, bitwise unless
stated, and say for each clip whether a parameter's gradient can reach its
tie at all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import ndjir_tpu.render.loss as jloss
from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.models import brdf as jbrdf
from ndjir_tpu.models import fields as jfields
from ndjir_tpu.ops.activations import softplus as jax_softplus

import ndjir_torch.render.loss as tloss
from ndjir_torch.bridge import params_from_numpy, params_to_numpy
from ndjir_torch.config import load_config
from ndjir_torch.models import brdf, fields
from ndjir_torch.ops import activations
from ndjir_torch.ops.ties import absolute, clip

torch.set_num_threads(2)

DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
# the smallest normal float32: XLA on the CPU flushes results below it to 0
TINY = np.float32(2.0 ** -126)


def _jax_grads(fn, x):
    """First and second derivatives of an elementwise ``fn`` at ``x``."""
    g1 = jax.vmap(jax.grad(fn))(x)
    g2 = jax.vmap(jax.grad(jax.grad(fn)))(x)
    return np.asarray(g1, np.float32), np.asarray(g2, np.float32)


def _torch_grads(fn, x):
    x = x.clone().requires_grad_(True)
    (g1,) = torch.autograd.grad(fn(x).sum(), x, create_graph=True)
    (g2,) = torch.autograd.grad(g1.sum(), x)
    return g1.detach().float().numpy(), g2.float().numpy()


def _points(beta):
    """0, +-0, +-1e-30, +-1, NaN, and beta x = +-30 (beyond the fused op's
    threshold of 20)."""
    return [0.0, -0.0, 1e-30, -1e-30, 1.0, -1.0, float("nan"),
            30.0 / beta, -30.0 / beta]


@pytest.mark.parametrize("beta", [1.0, 100.0])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_softplus_derivatives_against_jax(beta, dtypes):
    """C2.  First derivative bitwise at every point in f32, but where the
    port's is subnormal (beta x = -100: z / (z + 1) with z = exp(-100))
    and XLA's flushed to 0; in bf16 the reference rounds after every op
    (``ROADMAP.md`` §C, known deviations), beta |x| included, so away
    from 0 and the saturated ends its derivatives lie within 2 bf16 ulps
    plus what rounding beta |x| to bf16 moves exp(-beta |x|) by (up to
    2^-8 beta |x| of itself).  The second
    derivative is the fused op's (beta sigmoid (1 - sigmoid)): beta / 4 at
    0 and +-1e-30 as the reference's; elsewhere within 2 ulps of it,
    except above beta x = 20, where the fused op returns x and its second
    derivative is 0 (the reference's < beta exp(-20))."""
    tdt, jdt = dtypes
    pts = _points(beta)
    j1, j2 = _jax_grads(lambda v: jax_softplus(v, beta),
                        jnp.asarray(pts, jdt))
    t1, t2 = _torch_grads(lambda v: activations.softplus(v, beta),
                          torch.tensor(pts, dtype=tdt))
    exact = [0, 1, 2, 3, 6]          # 0, -0, +-1e-30, NaN
    np.testing.assert_array_equal(t1[exact], j1[exact])
    np.testing.assert_array_equal(t2[exact], j2[exact])
    assert t1[0] == 0.0 and t2[0] == beta / 4
    assert t1[7] == j1[7] == 1.0                 # beta x = 30
    bf16 = tdt == torch.bfloat16
    ulp = 2.0 ** -8 if bf16 else 2.0 ** -24
    for i in (4, 5, 8):                          # +-1 and beta x = -30
        rel = 2 * ulp + (2.0 ** -8 * abs(pts[i]) * beta if bf16 else 0.0)
        if not bf16 and not (beta == 100.0 and i == 5):
            assert t1[i] == j1[i], (pts[i], t1[i], j1[i])
        elif j1[i] == 0.0:
            assert 0.0 <= t1[i] < (1e-30 if bf16 else TINY)
        else:
            assert abs(t1[i] - j1[i]) <= rel * abs(j1[i]), pts[i]
        if pts[i] * beta >= 20.0:
            assert t2[i] == 0.0 and 0.0 <= j2[i] < beta * np.exp(-20.0)
        else:
            assert abs(t2[i] - j2[i]) <= rel * abs(j2[i]) \
                + (TINY if j2[i] == 0.0 else 0.0), (pts[i], t2[i], j2[i])
    assert t1[7] == 1.0 and t2[7] == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("beta", [1.0, 100.0])
def test_softplus_equals_fused_op_but_at_zero(dtype, beta):
    """The port's softplus is PyTorch's fused op, bitwise, in value, first
    derivative (but at x = 0) and second derivative in both inputs of the
    first derivative (the eikonal double backward), across the threshold
    too."""
    gen = torch.Generator().manual_seed(5)
    x = (torch.randn(20000, generator=gen) * 0.3).to(dtype)
    x[:40] = torch.linspace(19.9 / beta, 20.1 / beta, 40).to(dtype)
    x[40:44] = 0.0
    g = torch.randn(x.shape, generator=gen).to(dtype)
    gg = torch.randn(x.shape, generator=gen).to(dtype)

    def run(fn):
        xr, gr = x.clone().requires_grad_(), g.clone().requires_grad_()
        y = fn(xr)
        (d,) = torch.autograd.grad(y, xr, gr, create_graph=True)
        dx, dg = torch.autograd.grad(d, (xr, gr), gg)
        return y.detach(), d.detach(), dx, dg
    ours = run(lambda v: activations.softplus(v, beta))
    fused = run(lambda v: F.softplus(v, beta=beta, threshold=20.0))
    nz = x != 0
    assert torch.equal(ours[0], fused[0])
    assert torch.equal(ours[1][nz], fused[1][nz])
    assert torch.equal(ours[1][~nz], torch.zeros(4, dtype=dtype))
    assert torch.equal(ours[2], fused[2])
    assert torch.equal(ours[3][nz], fused[3][nz])
    assert torch.equal(ours[3][~nz], torch.zeros(4, dtype=dtype))


def test_softplus_first_layer_zero_through_the_mlp(monkeypatch):
    """The geometric MLP (``tiny_test``, the JAX package's weights) with
    half of its first layer's units' weights and biases zero, so their
    pre-activations are exactly 0: sum(sdf) plus the eikonal term (through
    the double backward) differentiated by every parameter, against the
    JAX package's, each leaf within 1e-4 of its largest entry (f32 sums
    in another order).  Those units' weight gradients are 0 in the port
    and within 1e-5 of the largest in JAX (its 1/2 - 1/2 at 0 rounds
    (g / beta) beta); with the fused op's 1/2 at 0 they are not."""
    jconf = jax_load_config("tiny_test")
    conf = load_config("tiny_test")
    p = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: jfields.init_geometric(k, jconf))(
            jax.random.PRNGKey(3)))
    first = p["affine-00"]
    half = first["b"].shape[0] // 2
    first["W"] = first["W"].copy()
    first["W"][:, :half] = 0.0
    first["b"] = first["b"].copy()
    first["b"][:half] = 0.0
    rng = np.random.RandomState(2)
    x = (rng.rand(64, 3).astype(np.float32) - 0.5) * 1.2

    def jloss_fn(pp):
        sdf, vjp = jax.vjp(lambda xx: jfields.geometric_apply(pp, xx,
                                                              jconf)[0],
                           jnp.asarray(x))
        (gx,) = vjp(jnp.ones_like(sdf))
        return jnp.sum(sdf) + jnp.sum(
            (jnp.linalg.norm(gx, axis=-1) - 1.0) ** 2)
    want = params_to_numpy(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax.grad(jloss_fn)(p)),
        device="cpu"))

    def port_grads():
        tp = params_from_numpy(p, device="cpu")
        leaves = [t for _, t in _leaves(tp)]
        for t in leaves:
            t.requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        sdf = fields.geometric_apply(tp, xt, conf)[0]
        (gx,) = torch.autograd.grad(sdf, xt, torch.ones_like(sdf),
                                    create_graph=True)
        loss = sdf.sum() + ((torch.linalg.norm(gx, dim=-1) - 1.0) ** 2).sum()
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return {path: np.zeros(t.shape, np.float32) if g is None
                else g.numpy() for (path, t), g in zip(_leaves(tp), gs)}

    def worst(got):
        out = {}
        for path, g in got.items():
            w = _at(want, path)
            out[path] = float(np.abs(g - w).max()) \
                / max(float(np.abs(w).max()), 1e-30)
        return out
    got = port_grads()
    ours = worst(got)
    assert max(ours.values()) <= 1e-4, ours
    assert float(np.abs(got[("affine-00", "W")][:, :half]).max()) == 0.0
    w0 = _at(want, ("affine-00", "W"))
    assert float(np.abs(w0[:, :half]).max()) <= 1e-5 * float(
        np.abs(w0).max())
    monkeypatch.setattr(activations, "softplus",
                        lambda v, beta=1.0: F.softplus(v, beta=beta,
                                                       threshold=20.0))
    fused = port_grads()[("affine-00", "W")]
    assert float(np.abs(fused[:, :half]).max()) \
        > 1e-2 * float(np.abs(w0).max())


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# C1 and the loss's clips: total_loss of both packages on one rendered
# result, its gradient by every entry of that result

B, R, N = 2, 3, 4


def _rendered(conf):
    """A pb_render result with ties in it: the colour term's d = NaN
    (a NaN target), +0 and -0; the base-colour prior's likewise (its
    target the perturbed colour); the roughness and specular priors' d =
    +0 and NaN; the mask prediction at both clip bounds and NaN."""
    rng = np.random.RandomState(4)
    f32 = np.float32
    res = {
        "color_pixel": rng.rand(B, R, 3),
        "grad_x_fg": rng.randn(B, R, N, 3),
        "tv_map": rng.rand(B, R, N, 1),
        "obj_mask_pred": rng.rand(B, R, 1) * 0.8 + 0.1,
        "base_color": rng.rand(B, R, N, 3),
        "base_color_ptb": rng.rand(B, R, N, 3),
        "roughness": rng.rand(B, R, N, 1),
        "std_roughness": rng.rand(B, R, N, 1) + 0.5,
        "specular_reflectance": rng.rand(B, R, N, 1),
        "std_specular_reflectance": rng.rand(B, R, N, 1) + 0.5,
        "gain": rng.rand(1) + 1.0,
    }
    res = {k: v.astype(f32) for k, v in res.items()}
    color_gt = rng.rand(B, R, 3).astype(f32)
    color_gt[0, 0, 0] = np.nan
    res["color_pixel"][0, 0, 1] = color_gt[0, 0, 1]
    res["color_pixel"][0, 0, 2], color_gt[0, 0, 2] = -0.0, 0.0
    res["base_color_ptb"][0, 0, 0, 0] = np.nan
    res["base_color"][0, 0, 0, 1] = res["base_color_ptb"][0, 0, 0, 1]
    res["base_color"][0, 0, 0, 2], res["base_color_ptb"][0, 0, 0, 2] = \
        -0.0, 0.0
    res["roughness"][0, 0, 1, 0] = f32(conf.roughness_network.prior_value)
    res["roughness"][0, 1, 1, 0] = np.nan
    pv = conf.specular_reflectance_network.prior_value
    res["specular_reflectance"][0, 0, 1, 0] = f32(pv)
    res["specular_reflectance"][0, 1, 1, 0] = np.nan
    res["obj_mask_pred"][0, 0, 0] = f32(1e-3)
    res["obj_mask_pred"][0, 1, 0] = f32(1.0 - 1e-3)
    res["obj_mask_pred"][1, 0, 0] = np.nan
    obj_mask = (rng.rand(B, R, 1) > 0.2).astype(f32)
    obj_mask[0, :, 0] = 1.0
    mask = np.ones((B, R, N, 1), f32)
    mask[1, 2, 3, 0] = 0.0
    return res, color_gt, obj_mask, mask


LOSS_CASES = [[], ["train.mask_weight=0.0"],
              ["train.base_color_prior_sym_backward=false"]]


@pytest.mark.parametrize("over", LOSS_CASES,
                         ids=["mask", "no_mask", "asym_prior"])
def test_loss_gradient_at_ties_bitwise(monkeypatch, over):
    """C1: ``total_loss`` of both packages, their renderers replaced by one
    result with ties in it (``_rendered``), differentiated by every entry
    of that result: equal bitwise, NaN for NaN (the gradients by
    ``grad_x_fg`` and the two stds, whose paths pass no tie, within 8
    ulps: the norm's and the quotient's derivatives round in another
    order).  Under the default L1
    colour term a NaN target's cotangent is -g and a tie's +g in both;
    the mask prediction at a clip bound takes g/2."""
    over = ["train.mask_weight=0.1", *over]
    jconf = jax_load_config("default", overrides=over)
    conf = load_config("default", overrides=over)
    res, color_gt, obj_mask, mask = _rendered(conf)
    x_fg = np.zeros((B, R, N, 3), np.float32)

    def jax_sample(*a, **k):
        return (jnp.asarray(x_fg),) * 4 + (jnp.asarray(mask),)

    def torch_sample(*a, **k):
        return (torch.from_numpy(x_fg),) * 4 + (torch.from_numpy(mask),)
    monkeypatch.setattr(jloss, "sample_points", jax_sample)
    monkeypatch.setattr(jloss, "pb_render", lambda p, *a: p)
    monkeypatch.setattr(tloss, "sample_points", torch_sample)
    monkeypatch.setattr(tloss, "pb_render", lambda p, *a: p)
    cdfs = {"stratified": None, "background": None, "upsample": None}
    batch = (np.zeros((B, 3), np.float32), np.zeros((B, R, 3), np.float32),
             color_gt, obj_mask)

    def jfn(p):
        return jloss.total_loss(p, *map(jnp.asarray, batch), 0.5, 1.0,
                                jconf, cdfs=cdfs)[0]
    want = jax.tree_util.tree_map(np.asarray, jax.grad(jfn)(
        {k: jnp.asarray(v) for k, v in res.items()}))
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_(True)
              for k, v in res.items()}
    loss = tloss.total_loss(leaves, *map(torch.from_numpy, batch), 0.5, 1.0,
                            conf, cdfs=cdfs)[0]
    names = list(leaves)
    got = torch.autograd.grad(loss, [leaves[k] for k in names],
                              allow_unused=True)
    for k, g in zip(names, got):
        g = np.zeros_like(res[k]) if g is None else g.numpy()
        if k in ("grad_x_fg", "std_roughness",
                 "std_specular_reflectance"):    # no tie on their path
            np.testing.assert_allclose(g, want[k], rtol=2.0 ** -20,
                                       atol=0.0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, want[k], err_msg=k)
    # the ties themselves, spelled out
    c = got[names.index("color_pixel")].numpy()
    scale = 1.0 / (obj_mask.sum() + 1e-5) if "mask_weight=0.0" not in over[
        -1] else 1.0 / (B * R)
    np.testing.assert_allclose(c[0, 0, :], [-scale, scale, scale],
                               rtol=1e-6)
    if "mask_weight=0.0" not in over[-1]:
        m = got[names.index("obj_mask_pred")].numpy()
        full = -(obj_mask[0, 2, 0] / res["obj_mask_pred"][0, 2, 0]
                 - (1 - obj_mask[0, 2, 0])
                 / (1 - res["obj_mask_pred"][0, 2, 0]))
        assert m[0, 0, 0] != 0.0 and np.isnan(m[1, 0, 0])
        assert np.isfinite(full)


# ---------------------------------------------------------------------------
# the clip and maximum sites


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_clip_and_abs_match_jax_at_ties(dtypes):
    """``ties.clip`` against ``jnp.clip`` and ``jnp.maximum``, and
    ``ties.absolute`` against ``jnp.abs``: values and gradients bitwise at
    both bounds, inside, outside, at NaN, at +-0; a NaN cotangent stays
    NaN at a clipped entry, as JAX's product does."""
    tdt, jdt = dtypes
    lo, hi = 0.25, 0.75
    x = [lo, hi, 0.5, 0.1, 0.9, float("nan"), -0.0, 0.0]
    xt, xj = torch.tensor(x, dtype=tdt), jnp.asarray(x, jdt)
    g = np.linspace(-2.0, 2.0, len(x)).astype(np.float32)
    g[3] = np.nan
    gt, gj = torch.tensor(g, dtype=tdt), jnp.asarray(g, jdt)
    cases = [(lambda v: clip(v, lo, hi), lambda v: jnp.clip(v, lo, hi)),
             (lambda v: clip(v, lo), lambda v: jnp.maximum(v, lo)),
             (lambda v: clip(v, None, hi), lambda v: jnp.minimum(v, hi)),
             (absolute, jnp.abs)]
    for tfn, jfn in cases:
        xr = xt.clone().requires_grad_(True)
        y = tfn(xr)
        (gx,) = torch.autograd.grad(y, xr, gt)
        jy, vjp = jax.vjp(jfn, xj)
        (jg,) = vjp(gj)
        np.testing.assert_array_equal(np.abs(y.detach().float().numpy()),
                                      np.abs(np.asarray(jy, np.float32)))
        np.testing.assert_array_equal(gx.float().numpy(),
                                      np.asarray(jg, np.float32))
    xr = xt.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(clip(xr, lo, hi), xr, torch.ones_like(xt))
    assert gx[:2].tolist() == [0.5, 0.5]
    (ga,) = torch.autograd.grad(absolute(xr[5:]).sum(), xr)
    assert ga[5:].tolist() == [-1.0, 1.0, 1.0]


def test_alpha_clip_tie_reaches_the_sdf():
    """``render/renderer.py``'s alpha (JAX ``renderer.py:209``):
    (cdf0 - cdf1 + 1e-5) / (cdf0 + 1e-5) clipped to [0, 1].  With cdf1 =
    sigmoid(s) tiny but nonzero the ratio rounds to exactly 1, and the
    gradient by s is nonzero: JAX's takes half of it, torch.clamp all.
    The port's clip gives JAX's bitwise, so the site is repaired."""
    s = np.float32([-27.0, -30.0, 2.0])   # sigmoid 1.9e-12, 9.4e-14, .88
    c0 = np.float32([0.5, 0.25, 0.9])

    def jalpha(sv, c):
        c1 = jax.nn.sigmoid(sv)
        return jnp.sum(jnp.clip((c - c1 + 1e-5) / (c + 1e-5), 0.0, 1.0))

    def talpha(sv, c, fn):
        c1 = torch.sigmoid(sv)
        return fn((c - c1 + 1e-5) / (c + 1e-5), 0.0, 1.0).sum()
    jg = np.asarray(jax.grad(jalpha)(jnp.asarray(s), jnp.asarray(c0)))
    got = {}
    for name, fn in (("ties", clip), ("clamp", torch.clamp)):
        st = torch.from_numpy(s).requires_grad_(True)
        (got[name],) = torch.autograd.grad(talpha(st, torch.from_numpy(c0),
                                                  fn), st)
    ratio = (c0 - 1 / (1 + np.exp(-s.astype(np.float64))).astype(
        np.float32) + np.float32(1e-5)) / (c0 + np.float32(1e-5))
    assert ratio[0] == ratio[1] == 1.0
    np.testing.assert_array_equal(got["ties"].numpy(), jg)
    assert jg[0] != 0.0 and got["clamp"][0].item() == 2 * jg[0]


def test_masked_dot_tie_matches_jax():
    """``models/brdf.py: masked_dot`` (JAX ``brdf.py:25``) at u.v equal to
    the 1e-8 floor: gradients by u and v bitwise against JAX's (1/2 of
    the cotangent), reachable from the normal and hence the network."""
    u = np.float32([[1e-8, 0.0, 0.0], [0.3, 0.4, 0.5], [0.0, 1.0, 0.0]])
    v = np.float32([[1.0, 0.0, 0.0], [0.1, -0.2, 0.3], [0.0, -1.0, 0.0]])
    jg = jax.grad(lambda a, b: jnp.sum(jbrdf.masked_dot(a, b)),
                  argnums=(0, 1))(jnp.asarray(u), jnp.asarray(v))
    ut, vt = (torch.from_numpy(a).requires_grad_(True) for a in (u, v))
    tg = torch.autograd.grad(brdf.masked_dot(ut, vt).sum(), (ut, vt))
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tg[0][0, 0].item() == 0.5


def test_weight_norm_floor_tie_matches_jax():
    """``models/fields.py: _normalized_W`` (JAX ``fields.py:78``, and
    ``:65`` inside ``affine_apply``) with a column whose norm is exactly
    the 1e-12 floor: the gradients by W and g within 2 ulps of JAX's (the
    quotient's derivative rounds in another order), where
    torch.clamp_min's is off by more than 1% at the tie's column."""
    W = np.float32([[1e-12, 0.3], [0.0, -0.4], [0.0, 0.2]])
    gv = np.float32([1.5, 0.7])
    assert np.float32(np.linalg.norm(W[:, 0])) == np.float32(1e-12)
    jg = jax.grad(lambda p: jnp.sum(jfields._normalized_W(p) ** 2 * 0.5
                                    + jfields._normalized_W(p)))(
        {"W": jnp.asarray(W), "g": jnp.asarray(gv)})
    p = {"W": torch.from_numpy(W).requires_grad_(True),
         "g": torch.from_numpy(gv).requires_grad_(True)}
    Wn = fields._normalized_W(p)
    tg = torch.autograd.grad((Wn ** 2 * 0.5 + Wn).sum(), (p["W"], p["g"]))
    for t, j in zip(tg, (jg["W"], jg["g"])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   rtol=2.0 ** -22, atol=0.0)
    Wc = p["g"] * p["W"] / torch.clamp_min(
        torch.linalg.norm(p["W"], dim=0, keepdim=True), 1e-12)
    (gc,) = torch.autograd.grad((Wc ** 2 * 0.5 + Wc).sum(), p["W"])
    rel = np.abs(gc[:, 0].numpy() / np.asarray(jg["W"])[:, 0] - 1.0)
    assert rel.max() > 1e-2


def _bracket(center, fn, target, steps=16):
    """The float32 inputs within ``steps`` ulps of ``center``: whether
    ``fn`` of any of them is exactly ``target``, and whether ``fn`` rises
    from below the target to above it across them (so that, ``fn`` being
    monotone, no other input can reach it)."""
    c = np.float32(center)
    xs = [c]
    for _ in range(steps):
        xs.insert(0, np.nextafter(xs[0], np.float32(-np.inf)))
        xs.append(np.nextafter(xs[-1], np.float32(np.inf)))
    ys = fn(np.asarray(xs, np.float32))
    t = np.float32(target)
    return bool(np.any(ys == t)), bool(ys[0] < t < ys[-1])


def _both(tfn, jfn):
    return (lambda a: tfn(torch.from_numpy(a)).numpy(),
            lambda a: np.asarray(jfn(jnp.asarray(a))))


@pytest.mark.parametrize("site", ["log_std_floor", "gain_floor",
                                  "gain_ceiling", "roughness_floor"])
def test_unreachable_ties(site):
    """Sites whose tie no float32 parameter output reaches, in either
    package: ``render/loss.py``'s log-std clip (JAX ``loss.py:101`` and
    ``:113``) at 1e-5 (log's outputs near it are ~1.2e-7 apart, and its
    ceiling 1e5 needs std = e^100000); ``models/fields.py``'s gain clip
    (JAX ``:325``) at 1e-6 and 5e4 (exp(10 g) steps by ~1e-6 of itself);
    the roughness clip (JAX ``:548``) at its 0.089 floor under the
    default remap (sigmoid^2), and at its ceiling 1 sigmoid's derivative
    is 0.  They take JAX's tie all the same (``ties.clip``)."""
    conf = load_config("default")
    if site == "log_std_floor":
        center, target = np.exp(1e-5), 1e-5
        fns = _both(torch.log, jnp.log)
    elif site in ("gain_floor", "gain_ceiling"):
        target = 1e-6 if site == "gain_floor" else 5e4
        center = np.log(target) / 10.0
        fns = _both(lambda t: torch.exp(t * 10.0),
                    lambda t: jnp.exp(t * 10.0))
    else:
        assert conf.specular_brdf.remap
        target = conf.roughness_network.lower_bound
        r = np.sqrt(target)
        center = np.log(r / (1 - r))
        fns = _both(lambda t: torch.sigmoid(t) ** 2,
                    lambda t: jax.nn.sigmoid(t) ** 2)
    for fn in fns:
        hit, straddles = _bracket(center, fn, target)
        assert straddles and not hit, site
