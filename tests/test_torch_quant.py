"""The port's static-W8A8 modules against the JAX package, on the CPU in f32.

Each module that holds a W8A8 kernel (K7 ``ops/conv``, K8 ``ops/linear``,
K9 ``ops/ffn``) in its plain version against the JAX XLA reference and the
Pallas kernel run as the JAX tests run it (``force_tpu_interpret_mode``);
the quantization primitives, the int8 holders and the W8A8 attention forms.
Inputs come from numpy seeds.  tests/test_torch_quant_unet.py holds the
tiny UNet: calibration, the weight bridge, the forward and txt2img.

Tolerances: codes and scales exactly; the XLA-form comparisons at 1e-5
(the same f32 arithmetic, summed in another order).  Against the Pallas
kernels at 1e-4 on the dequantized output (K8) and 5e-3 relative (K9), as
the JAX tests: the TPU kernels pre-divide gamma/beta by s_x and multiply by
1/s_x where the XLA form divides, which can flip a code by one at an exact
half step.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stable_diffusion_tpu.models import attention as jattn
from stable_diffusion_tpu.models import layers as jlayers
from stable_diffusion_tpu.ops import conv as jconv
from stable_diffusion_tpu.ops import ffn as jffn
from stable_diffusion_tpu.ops import groupnorm as jgn
from stable_diffusion_tpu.ops import linear as jlin
from stable_diffusion_tpu.ops import quantize as jquant
from stable_diffusion_tpu.utils import quantize_model as JQ
from stable_diffusion_tpu_torch.models import attention as tattn
from stable_diffusion_tpu_torch.models import layers as tlayers
from stable_diffusion_tpu_torch.ops import conv as tconv
from stable_diffusion_tpu_torch.ops import ffn as tffn
from stable_diffusion_tpu_torch.ops import linear as tlin
from stable_diffusion_tpu_torch.ops import quantize as tquant
from stable_diffusion_tpu_torch.utils import quantize_model as TQ
from stable_diffusion_tpu_torch.utils import weights as W
from tests.torch_threads import one_thread  # noqa: F401

def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(320, 640), (3, 3, 64, 32)])
def test_quantize_tensor_matches_jax(rng, shape):
    w = rng.standard_normal(shape, dtype=np.float32) * 0.05
    w[..., 3] = 0.0  # an all-zero channel takes the 1e-12 floor
    jq, js = jquant.quantize_tensor(w.reshape(-1, shape[-1]), axis=0)
    tw = _t(w.reshape(-1, shape[-1]).T)  # PyTorch's (out, in) layout
    q, s = tquant.quantize_tensor(tw, axis=1)
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js).T)
    np.testing.assert_allclose(tquant.dequantize_tensor(q, s).numpy(),
                               np.asarray(jquant.dequantize_tensor(jq, js)).T, atol=0)


def _jax_linear(rng, k, n, act=3.0, bias=True):
    p = {"kernel": rng.standard_normal((k, n), dtype=np.float32) * k ** -0.5}
    if bias:
        p["bias"] = rng.standard_normal(n, dtype=np.float32) * 0.1
    q = JQ.quantize_params({"l": p})["l"]
    return p, q, dict(q, act_scale=jnp.asarray(act, jnp.float32))


def _holder(jp):
    """A port QLinear loaded from a JAX linear subtree through the bridge."""
    w = jp["kernel_q"]
    lin = torch.nn.Linear(w.shape[0], w.shape[1], bias="bias" in jp)
    holder = tlayers.QLinear.from_float(lin)
    holder.load_state_dict(W.from_jax_params(jp))
    return holder


@pytest.mark.parametrize("form", ["w8a8", "weight_only"])
def test_layers_linear_matches_jax(rng, form):
    _, wo, w8 = _jax_linear(rng, 64, 48)
    jp = w8 if form == "w8a8" else wo
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    want = np.asarray(jlayers.linear(jp, jnp.asarray(x)))
    holder = _holder(jp)
    assert holder.w8a8 == (form == "w8a8")
    got = tlayers.linear(holder, _t(x), impl="torch").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_holder_scales_stay_f32_under_a_cast(rng):
    _, _, w8 = _jax_linear(rng, 64, 32)
    h = _holder(w8).to(torch.bfloat16)
    assert h.bias.dtype == torch.bfloat16 and h.weight_q.dtype == torch.int8
    assert h.weight_scale.dtype == h.act_scale.dtype == torch.float32
    np.testing.assert_array_equal(h.weight_scale.numpy(), np.asarray(w8["kernel_scale"])[0])


def test_derived_tensor_cache_follows_and_frees_its_tensors():
    """``utils.device.cached`` (folded scales, dequantized weights, K2's HWIO
    weight): recomputed after an in-place change, and never the reason a
    weight stays alive (the LoRA merge makes new weights every step)."""
    import gc
    import weakref

    ws, act = torch.rand(16) + 0.5, torch.tensor(3.0)
    s_x, out = tquant.folded_scales(ws, act)
    assert tquant.folded_scales(ws, act)[1] is out
    act.mul_(2.0)
    s_x2, out2 = tquant.folded_scales(ws, act)
    torch.testing.assert_close(s_x2, s_x * 2)
    torch.testing.assert_close(out2, out * 2)
    w = torch.randn(8, 4, 3, 3)
    alive = weakref.ref(w)
    gc.disable()
    try:
        tconv.k2_taps(w)
        del w
        assert alive() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# K8: the W8A8 matmul
# ---------------------------------------------------------------------------


def test_k8_plain_matches_jax_xla_and_pallas(rng):
    m, k, n = 128, 320, 384  # tests/test_fused_linear.py::test_w8a8_fused_interpret
    x = rng.standard_normal((1, m, k), dtype=np.float32)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = rng.uniform(0.01, 0.02, (1, n)).astype(np.float32)
    act = np.float32(3.0)
    b = rng.standard_normal(n, dtype=np.float32)
    res = rng.standard_normal((1, m, n), dtype=np.float32)
    gamma = rng.standard_normal(k, dtype=np.float32)
    beta = rng.standard_normal(k, dtype=np.float32)
    ln = {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    with pltpu.force_tpu_interpret_mode():
        pal_ln = np.asarray(jlin.ln_matmul_w8a8(ln, x, wq, ws, act, b, impl="pallas"))
        pal_nl = np.asarray(jlin.matmul_w8a8(x, wq, ws, act, b, residual=res, impl="pallas"))
    xla_ln = np.asarray(jlin._q_mm_xla(x, gamma, beta, jnp.asarray(act), wq, ws.reshape(-1), b,
                                       None, 1e-5))
    xla_nl = np.asarray(jlin._q_mm_xla(x, None, None, jnp.asarray(act), wq, ws.reshape(-1), b,
                                       res, 1e-5))
    args = (_t(wq.T), _t(ws.reshape(-1)), torch.tensor(act), _t(b))
    got_ln = tlin.ln_matmul_w8a8(_t(gamma), _t(beta), _t(x), *args, impl="torch").numpy()
    got_nl = tlin.matmul_w8a8(_t(x), *args, residual=_t(res), impl="torch").numpy()
    np.testing.assert_allclose(got_ln, xla_ln, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_nl, xla_nl, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_ln, pal_ln, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_nl, pal_nl, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# K9: the W8A8 LN-GeGLU-FFN
# ---------------------------------------------------------------------------


def test_k9_plain_matches_jax_xla_and_pallas(rng):
    b, s, c, hidden = 1, 128, 128, 512  # tests/test_ffn.py::test_w8a8_ffn_kernel_matches_xla_int8
    p0 = {"kernel": rng.standard_normal((c, 2 * hidden), dtype=np.float32) * c ** -0.5,
          "bias": rng.standard_normal(2 * hidden, dtype=np.float32) * 0.1}
    p1 = {"kernel": rng.standard_normal((hidden, c), dtype=np.float32) * hidden ** -0.5,
          "bias": rng.standard_normal(c, dtype=np.float32) * 0.1}
    q = JQ.quantize_params({"0": {"proj": p0}, "1": p1})
    q["0"]["proj"]["act_scale"] = jnp.asarray(4.0, jnp.float32)
    q["1"]["act_scale"] = jnp.asarray(6.0, jnp.float32)
    x = rng.standard_normal((b, s, c), dtype=np.float32) * 0.5
    res = rng.standard_normal((b, s, c), dtype=np.float32)
    gamma = np.full(c, 1.1, np.float32)
    beta = np.zeros(c, np.float32)
    ln = {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    xla = np.asarray(jffn._ffn_q_xla(jnp.asarray(x), ln["scale"], ln["bias"], q["0"]["proj"],
                                     q["1"], jnp.asarray(res), 1e-5))
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(jffn.geglu_ffn(q, jnp.asarray(x), ln_params=ln, residual=jnp.asarray(res),
                                        impl="pallas"))
    q0, q1 = q["0"]["proj"], q["1"]
    got = tffn.geglu_ffn_w8a8(
        _t(x), _t(gamma), _t(beta), _t(np.asarray(q0["kernel_q"]).T),
        _t(np.asarray(q0["kernel_scale"])[0]), _t(q0["bias"]), torch.tensor(4.0),
        _t(np.asarray(q1["kernel_q"]).T), _t(np.asarray(q1["kernel_scale"])[0]), _t(q1["bias"]),
        torch.tensor(6.0), _t(res), impl="torch").numpy()
    np.testing.assert_allclose(got, xla, atol=1e-5, rtol=1e-5)
    rel = np.abs(got - pal).max() / (np.abs(pal).max() + 1e-9)
    assert rel < 5e-3, rel


# ---------------------------------------------------------------------------
# K7: the W8A8 conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 16, 32, 320, 320), (2, 16, 16, 64, 64), (1, 8, 32, 32, 64)])
def test_k7_plain_matches_jax_conv3x3_q(rng, shape):
    b, h, w, cin, cout = shape
    xn = rng.standard_normal((b, h, w, cin), dtype=np.float32)  # the normalized input
    k = rng.standard_normal((3, 3, cin, cout), dtype=np.float32) * (9 * cin) ** -0.5
    bias = rng.standard_normal(cout, dtype=np.float32) * 0.1
    cp = JQ.quantize_convs({"c": {"kernel": k, "bias": bias}})["c"]
    kq, ks = np.asarray(cp["kernel_q"]), np.asarray(cp["kernel_scale"])
    act = np.float32(3.5)
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(jconv._conv3x3_q(jnp.asarray(xn), kq, ks, jnp.asarray(act), bias))
    # the same function as an int32 XLA conv
    s_x = max(act / np.float32(127.0), np.float32(1e-12))
    xq = jnp.round(jnp.clip(jnp.asarray(xn) / s_x, -127, 127)).astype(jnp.int8)
    acc = jax.lax.conv_general_dilated(xq, jnp.asarray(kq), (1, 1), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       preferred_element_type=jnp.int32)
    sim = np.asarray(acc.astype(jnp.float32) * (s_x * ks.reshape(-1)) + bias)
    got = tconv.conv3x3_w8a8_plain(_t(xn), _t(np.transpose(kq, (3, 2, 0, 1))), _t(ks.reshape(-1)),
                                   torch.tensor(act), _t(bias)).numpy()
    np.testing.assert_allclose(got, sim, atol=2e-6, rtol=1e-6)
    np.testing.assert_allclose(got, pal, atol=2e-6, rtol=1e-6)


def test_k7_entry_quantizes_the_gn_silu_activation(rng):
    """gn_silu_conv3x3_w8a8 on the CPU = JAX's W8A8 branch written out:
    gn_scale_shift -> x * scale + shift -> SiLU -> _conv3x3_q."""
    x = rng.standard_normal((2, 16, 16, 64), dtype=np.float32) + 0.3
    gw = 1 + 0.1 * rng.standard_normal(64, dtype=np.float32)
    gb = 0.1 * rng.standard_normal(64, dtype=np.float32)
    k = rng.standard_normal((3, 3, 64, 64), dtype=np.float32) * 0.05
    bias = rng.standard_normal(64, dtype=np.float32) * 0.1
    cp = JQ.quantize_convs({"c": {"kernel": k, "bias": bias}})["c"]
    ss = jgn.gn_scale_shift({"scale": jnp.asarray(gw), "bias": jnp.asarray(gb)}, jnp.asarray(x),
                        num_groups=32, eps=1e-5)
    xn = x * ss[:, 0][:, None, None, :] + ss[:, 1][:, None, None, :]
    xn = xn * jax.nn.sigmoid(xn)
    act = np.float32(2.0)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jconv._conv3x3_q(xn, cp["kernel_q"], cp["kernel_scale"],
                                           jnp.asarray(act), bias))
    got = tconv.gn_silu_conv3x3_w8a8(
        _t(x), _t(gw), _t(gb), _t(np.transpose(np.asarray(cp["kernel_q"]), (3, 2, 0, 1))),
        _t(np.asarray(cp["kernel_scale"]).reshape(-1)), torch.tensor(act), _t(bias),
        impl="torch").numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cross", [False, True])
def test_w8a8_attention_matches_jax(rng, cross):
    e, heads, cd = 64, 4, 24
    p = jattn.init_multihead_attention(jax.random.key(3), e, cond_dim=cd if cross else None,
                                       qkv_bias=False)
    q = JQ.quantize_params(p)
    for name, a in zip(("q_proj", "k_proj", "v_proj", "out_proj"), (3.0, 2.5, 2.0, 1.5)):
        q[name]["act_scale"] = jnp.asarray(a, jnp.float32)
    ln = {"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(e, dtype=np.float32)),
          "bias": jnp.asarray(0.1 * rng.standard_normal(e, dtype=np.float32))}
    x = rng.standard_normal((2, 16, e), dtype=np.float32)
    cond = rng.standard_normal((2, 77, cd), dtype=np.float32) if cross else None
    want = np.asarray(jattn.multihead_attention(
        q, jnp.asarray(x), num_heads=heads, cond=None if cond is None else jnp.asarray(cond),
        impl="xla", ln_params=ln, residual=jnp.asarray(x)))
    mod = tattn.MultiheadAttention(e, cond_dim=cd if cross else None, qkv_bias=False)
    mod.load_state_dict(W.from_jax_params(p))
    TQ.quantize_params(mod)
    mod.load_state_dict(W.from_jax_params(q))
    ln_mod = torch.nn.LayerNorm(e)
    ln_mod.load_state_dict(W.from_jax_params(ln))
    with torch.no_grad():
        got = tattn.multihead_attention(mod, _t(x), num_heads=heads,
                                        cond=None if cond is None else _t(cond), impl="torch",
                                        ln=ln_mod, residual=_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Inference only
# ---------------------------------------------------------------------------


def test_gradients_through_w8a8_entry_points_raise():
    x = torch.randn(2, 8, 64, requires_grad=True)
    wq, ws = tquant.quantize_tensor(torch.randn(96, 64), axis=1)
    ws = ws.reshape(-1)
    one = torch.tensor(1.0)
    lw, lb = torch.ones(64), torch.zeros(64)
    calls = [
        lambda: tlin.matmul_w8a8(x, wq, ws, one),
        lambda: tlin.ln_matmul_w8a8(lw, lb, x, wq, ws, one),
        lambda: tffn.geglu_ffn_w8a8(x, lw, lb, tquant.quantize_tensor(torch.randn(512, 64), axis=1)[0],
                                    torch.ones(512), torch.zeros(512), one,
                                    tquant.quantize_tensor(torch.randn(64, 256), axis=1)[0],
                                    torch.ones(64), torch.zeros(64), one),
        lambda: tconv.gn_silu_conv3x3_w8a8(torch.randn(1, 4, 4, 64, requires_grad=True),
                                           lw, lb, torch.zeros(32, 64, 3, 3, dtype=torch.int8),
                                           torch.ones(32), one),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="inference-only"):
            call()
