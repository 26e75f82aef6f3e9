"""Gradients through the port's kernel modules, on the CPU.

* The plain backward formulas against the JAX package: the two-pass flash
  backward (``_premerged_flash_bwd``, interpret mode) and ``jax.vjp`` of the
  plain attention; the conv's input gradient through the flipped,
  I/O-swapped kernel and the GroupNorm split backward against the gradients
  of ``_conv3x3`` / ``_gn_silu_conv`` (interpret mode).  f32; tolerances as
  the JAX package's own tests of the same kernels, or stated.
* Each autograd Function's wiring: the Functions take their forward and
  backward callables as arguments, so ``torch.autograd.gradcheck`` (f64,
  tiny shapes) runs each with the plain versions in both places, with some
  inputs not requiring a gradient (``needs_input_grad``).
* The raw kernel wrappers refuse tensors that want a gradient.
* The fault the autograd Functions and the live fused QKV repair: every
  attention projection of the UNet gets the gradient ``jax.grad`` gives.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.ops import conv as jconv
from stable_diffusion_tpu.ops import flash_attention as jfa
from stable_diffusion_tpu_torch.models import unet as tunet
from stable_diffusion_tpu_torch.ops import conv as tconv
from stable_diffusion_tpu_torch.ops import ffn as tffn
from stable_diffusion_tpu_torch.ops import flash_attention as tfa
from stable_diffusion_tpu_torch.ops import groupnorm as tgn
from stable_diffusion_tpu_torch.ops._autograd import Recompute
from stable_diffusion_tpu_torch.utils.weights import from_jax_params
from tests.torch_threads import one_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _rel_close(got, want, tol, name=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: max|d| {err:.3e} vs scale {scale:.3e}"


# ---------------------------------------------------------------------------
# Plain backward formulas vs JAX
# ---------------------------------------------------------------------------


def test_attention_bwd_plain_matches_fused_flash_bwd(rng):
    """attention_bwd_plain == the Pallas two-pass backward (interpret mode),
    at the JAX test's shape; (B, S, H, D) <-> the premerged (B, S, H*D)."""
    b, s, heads, d = 1, 512, 2, 64
    scale = d ** -0.5
    q, k, v, g = (rng.standard_normal((b, s, heads, d)).astype(np.float32) * 0.3
                  for _ in range(4))
    flat = [jnp.asarray(a.reshape(b, s, heads * d)) for a in (q, k, v, g)]
    o = jfa._xla_ref_premerged(*flat[:3], scale, heads, d)
    with pltpu.force_tpu_interpret_mode():
        want = jfa._premerged_flash_bwd(*flat[:3], o, flat[3], scale, heads, d)
    got = tfa.attention_bwd_plain(_t(q), _t(k), _t(v), _t(np.asarray(o).reshape(b, s, heads, d)),
                                  _t(g), scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy().reshape(b, s, heads * d), np.asarray(w),
                                   atol=2e-4, rtol=1e-3, err_msg=name)


def test_attention_bwd_plain_matches_jax_vjp(rng):
    b, s, heads, d = 2, 96, 3, 40
    q, k, v, g = (rng.standard_normal((b, s, heads, d)).astype(np.float32) for _ in range(4))
    o, vjp = jax.vjp(lambda *a: jfa._xla_ref(*a, d ** -0.5), q, k, v)
    want = vjp(g)
    got = tfa.attention_bwd_plain(_t(q), _t(k), _t(v), _t(np.asarray(o)), _t(g))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4, err_msg=name)
    # the split into the two passes: K5's statistics are the natural-log LSE
    _, lse, delta = tfa.attention_bwd_dq_plain(_t(q), _t(k), _t(v), _t(np.asarray(o)), _t(g))
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
    np.testing.assert_allclose(lse.numpy(), jax.nn.logsumexp(logits, axis=-1), rtol=1e-5)
    np.testing.assert_allclose(delta.numpy(), np.einsum("bqhd,bqhd->bhq", g, np.asarray(o)),
                               rtol=1e-4, atol=1e-5)


def _conv_inputs(rng, c=64):
    x = rng.standard_normal((1, 16, 16, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)
    bias, gm, bt = (rng.standard_normal(c).astype(np.float32) for _ in range(3))
    return x, k, bias, gm, bt


def test_conv_dx_through_flipped_kernel_matches_jax(rng):
    """Conv3x3Fn (dx by the conv with flip_io(weight), dW/db plain) vs
    jax.grad of the Pallas-backed ``_conv3x3`` custom VJP (interpret)."""
    x, k, bias, _, _ = _conv_inputs(rng)

    def f_jax(x, k, b):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(jconv._conv3x3(x, k, b) ** 2)

    want = jax.grad(f_jax, argnums=(0, 1, 2))(x, k, bias)
    xs, ks, bs = (_t(a).requires_grad_() for a in (x, np.transpose(k, (3, 2, 0, 1)), bias))
    y = tconv.Conv3x3Fn.apply(tconv.PLAIN_OPS, xs, ks, bs)
    got = torch.autograd.grad((y ** 2).sum(), (xs, ks, bs))
    _rel_close(got[0], want[0], 2e-5, "dx")
    _rel_close(np.transpose(got[1].numpy(), (2, 3, 1, 0)), want[1], 2e-5, "dw")
    _rel_close(got[2], want[2], 2e-5, "db")


def test_gn_split_bwd_matches_jax(rng):
    """GnSiluConv3x3Fn (the split backward of ``_gn_split_bwd``) vs jax.grad
    of ``_gn_silu_conv`` (interpret)."""
    x, k, bias, gm, bt = _conv_inputs(rng)

    def f_jax(gm, bt, x, k, b):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(jconv._gn_silu_conv(gm, bt, x, k, b, 32, 1e-5) ** 2)

    want = jax.grad(f_jax, argnums=(0, 1, 2, 3, 4))(gm, bt, x, k, bias)
    ins = [_t(a).requires_grad_() for a in (gm, bt, x, np.transpose(k, (3, 2, 0, 1)), bias)]
    y = tconv.GnSiluConv3x3Fn.apply(tconv.PLAIN_OPS, ins[2], ins[0], ins[1], ins[3], ins[4],
                                    32, 1e-5)
    got = list(torch.autograd.grad((y ** 2).sum(), ins))
    got[3] = np.transpose(got[3].numpy(), (2, 3, 1, 0))
    for name, a, w in zip(("dgamma", "dbeta", "dx", "dw", "db"), got, want):
        _rel_close(a, w, 2e-5, name)


# ---------------------------------------------------------------------------
# Each Function's wiring, with the plain versions (gradcheck, f64)
# ---------------------------------------------------------------------------


def _r(*shape, grad=True, scale=1.0):
    g = torch.Generator().manual_seed(sum(shape) + len(shape))
    return (torch.randn(shape, generator=g, dtype=torch.float64) * scale).requires_grad_(grad)


@pytest.mark.parametrize("silu", [True, False])
def test_gradcheck_group_norm_function(silu):
    plain = functools.partial(tgn.group_norm_plain, num_groups=4, eps=1e-5, silu=silu)
    args = (_r(2, 3, 3, 8), _r(8), _r(8, grad=False))
    assert torch.autograd.gradcheck(lambda *a: Recompute.apply(plain, plain, *a), args)
    ss = functools.partial(tgn.gn_scale_shift_plain, num_groups=4, eps=1e-5)
    assert torch.autograd.gradcheck(lambda *a: Recompute.apply(ss, ss, *a),
                                    (_r(2, 3, 3, 8), _r(8, grad=False), _r(8)))


def test_gradcheck_conv_functions():
    x, w, b = _r(1, 4, 5, 8), _r(8, 8, 3, 3, scale=0.3), _r(8)
    assert torch.autograd.gradcheck(
        lambda *a: tconv.Conv3x3Fn.apply(tconv.PLAIN_OPS, *a), (x, w, b))
    # a frozen weight and no bias: dx alone, through the flipped-kernel conv
    assert torch.autograd.gradcheck(
        lambda x: tconv.Conv3x3Fn.apply(tconv.PLAIN_OPS, x, w.detach(), None), (x,))
    gw, gb = _r(8), _r(8, grad=False)
    assert torch.autograd.gradcheck(
        lambda x, gw, w, b: tconv.GnSiluConv3x3Fn.apply(tconv.PLAIN_OPS, x, gw, gb, w, b, 4, 1e-5),
        (x, gw, w, b))
    assert torch.autograd.gradcheck(
        lambda x: tconv.GnSiluConv3x3Fn.apply(tconv.PLAIN_OPS, x, gw.detach(), gb, w.detach(),
                                              b.detach(), 4, 1e-5), (x,))


def test_gradcheck_ffn_function():
    m, c = 6, 8
    args = (_r(m, c), _r(c), _r(c, grad=False), _r(8 * c, c, scale=0.3), _r(8 * c),
            _r(c, 4 * c, scale=0.3), _r(c, grad=False), _r(m, c))
    plain = functools.partial(tffn.geglu_ffn_plain, eps=1e-5)
    assert torch.autograd.gradcheck(lambda *a: Recompute.apply(plain, plain, *a), args,
                                    fast_mode=True)


def test_gradcheck_attention_functions():
    q, k, v = _r(1, 6, 2, 8), _r(1, 6, 2, 8), _r(1, 6, 2, 8)
    assert torch.autograd.gradcheck(
        lambda *a: tfa.SelfAttentionFn.apply(tfa.PLAIN_OPS, *a, 8 ** -0.5), (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q: tfa.SelfAttentionFn.apply(tfa.PLAIN_OPS, q, k.detach(), v.detach(), 0.3), (q,))
    # the cross-attention's recompute backward, keys past kv_len masked
    kc, vc = _r(1, 5, 2, 8), _r(1, 5, 2, 8, grad=False)
    plain = functools.partial(tfa.attention_plain, scale=None, kv_len=4)
    assert torch.autograd.gradcheck(lambda *a: Recompute.apply(plain, plain, *a), (q, kc, vc))


def test_raw_kernels_refuse_tensors_that_want_a_gradient():
    x = torch.randn(1, 4, 4, 8, requires_grad=True)
    w = torch.randn(8, 8, 3, 3)
    q = torch.randn(1, 8, 1, 8, requires_grad=True)
    calls = [
        lambda: tgn.group_norm_silu_kernel(x, torch.ones(8), torch.zeros(8), num_groups=4),
        lambda: tgn.gn_scale_shift_kernel(x, torch.ones(8), torch.zeros(8), num_groups=4),
        lambda: tconv.conv3x3_kernel(x, w),
        lambda: tffn.geglu_ffn_kernel(x.reshape(16, 8), *[torch.ones(8)] * 2,
                                      torch.ones(64, 8), torch.ones(64), torch.ones(8, 32),
                                      torch.ones(8)),
        lambda: tfa.attention_kernel(q, q, q),
        lambda: tfa.attention_bwd_dq_kernel(q, q, q, q, torch.zeros(1, 1, 8), q),
        lambda: tfa.attention_bwd_dkv_kernel(q, q, q, torch.zeros(1, 1, 8), torch.zeros(1, 1, 8), q),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="carries no gradient"):
            call()
    with torch.no_grad():  # no graph is recorded: the wrappers go on to their device check
        with pytest.raises(ValueError, match="CUDA"):
            tconv.conv3x3_kernel(x, w)


# ---------------------------------------------------------------------------
# The UNet's attention projections get their gradients (the repaired fault)
# ---------------------------------------------------------------------------


def test_unet_attention_projection_grads_match_jax():
    """Before the repair the fused QKV weight was a detached, cached copy:
    attn1.{q,k,v}_proj got no gradient.  Every projection's gradient must
    equal jax.grad's (f32, atol 1e-5, rtol 1e-4)."""
    kw = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
              cross_attention_dim=24, t_embed_dim=16)
    cfg = junet.UNetConfig(**kw)
    params = junet.init_unet(jax.random.key(0), cfg)
    model = tunet.UNet(tunet.UNetConfig(**kw))
    model.load_state_dict(from_jax_params(params), strict=True)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4), dtype=np.float32)
    ctx = rng.standard_normal((2, 7, 24), dtype=np.float32)
    w = rng.standard_normal((2, 16, 16, 4), dtype=np.float32)
    t = np.array([321, 17], np.int32)
    want = jax.jit(jax.grad(lambda p: jnp.mean(
        junet.unet_apply(p, x, t, ctx, cfg, impl="xla") * w)))(params)
    # a no-grad call first fills the serving cache, which must not leak into the graph
    with torch.no_grad():
        model(_t(x), _t(t).long(), _t(ctx), impl="torch")
    named = dict(model.named_parameters())
    keys = sorted(k for k in named if k.endswith(("q_proj.weight", "k_proj.weight",
                                                  "v_proj.weight", "out_proj.weight")))
    assert any(".attn1.q_proj" in k for k in keys) and len(keys) == 16 * 8  # 16 transformers
    out = model(_t(x), _t(t).long(), _t(ctx), impl="torch")
    grads = torch.autograd.grad((out * _t(w)).mean(), [named[k] for k in keys], allow_unused=True)
    for key, g in zip(keys, grads):
        assert g is not None, key
        node = want
        for part in key.split(".")[:-1]:
            node = node[part]
        np.testing.assert_allclose(g.numpy().T, np.asarray(node["kernel"]), atol=1e-5, rtol=1e-4,
                                   err_msg=key)
