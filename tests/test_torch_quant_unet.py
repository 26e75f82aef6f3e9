"""The port's static-W8A8 tiny UNet against the JAX package, on the CPU in
f32: calibration, the weight bridge of a quantized tree, the UNet forward
and a 2-step txt2img on the same quantized parameters.

The parameters are the JAX-initialised ones of tests/test_torch_pipeline.py
(``jax.random.key(42)``), the calibration batches numpy draws.  A whole-model
comparison at 1e-4 rests on the two packages quantizing every activation to
the same code: their f32 sums differ by ~1e-6, and an activation within that
of a half step flips a code, which this random tiny UNet carries to ~1e-2 of
its output.  At these parameters and inputs no code flips (at other seeds of
the same init one or two do); tests/test_torch_quant.py holds each W8A8 form
on its own.  The JAX XLA path runs W8A8 linears and weight-only convs
(impl="xla" never quantizes a conv's activation), so the port with
weight-only convs matches it at 1e-4; the full-W8A8 port, conv activations
quantized as well, as the port runs every calibrated resblock conv, matches
at 1e-4 the JAX UNet taking its W8A8 conv branch at those convs.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.ops import conv as jconv
from stable_diffusion_tpu.ops import groupnorm as jgn
from stable_diffusion_tpu.utils import quantize_model as JQ
from stable_diffusion_tpu.utils.torch_interop import flatten_tree
from stable_diffusion_tpu_torch.models import layers as tlayers
from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
from stable_diffusion_tpu_torch.utils import quantize_model as TQ
from stable_diffusion_tpu_torch.utils import weights as W

UNET = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
            cross_attention_dim=24, t_embed_dim=16)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _port(cls, cfg, tree):
    mod = cls(cfg)
    mod.load_state_dict(W.from_jax_params(tree))
    return mod


@pytest.fixture(scope="module")
def tiny():
    """The tiny UNet in both packages, JAX's calibration of it and the
    port's own on the same batches.  The batches are 16x16 latents: at 8x8
    the 1x1 bottleneck's GroupNorm normalises groups of two values, which
    turns the packages' f32 rounding differences into 1e-4 differences of
    the ranges recorded after it."""
    ucfg = junet.UNetConfig(**UNET)
    params = junet.init_unet(jax.random.split(jax.random.key(42), 3)[0], ucfg)
    unet = _port(UNet, UNetConfig(**UNET), params)
    r = np.random.default_rng(7)
    batches = [(r.standard_normal((2, 16, 16, 4), dtype=np.float32), np.array([t], np.int32),
                r.standard_normal((2, 77, 24), dtype=np.float32)) for t in (999, 499)]
    apply = lambda p, b: junet.unet_apply(p, *map(jnp.asarray, b), ucfg, impl="xla")  # noqa: E731
    jcal_lin = JQ.calibrate_static_activations(apply, params, batches)
    jcal = JQ.calibrate_static_conv_activations(apply, jcal_lin, batches)

    tb = [(_t(x), _t(t.astype(np.int64)), _t(c)) for x, t, c in batches]

    def tapply(m, bt):
        with torch.no_grad():
            m(*bt, impl="torch")

    tcal = TQ.calibrate_static_activations(tapply, copy.deepcopy(unet), tb)
    tcal = TQ.calibrate_static_conv_activations(tapply, tcal, tb)
    # W8A8 linears and weight-only convs; and the same with the convs' scales
    jlin_only = JQ.quantize_convs(JQ.quantize_params(jcal_lin))
    jq = JQ.quantize_convs(JQ.quantize_params(jcal))
    return dict(ucfg=ucfg, params=params, batches=batches, tb=tb, jcal_lin=jcal_lin, jcal=jcal,
                unet=unet, tcal=tcal, jlin_only=jlin_only, jq=jq)


def _act_scales(flat):
    return {k: float(np.asarray(v)) for k, v in flat.items() if k.endswith("act_scale")}


def test_calibration_matches_jax(tiny):
    want = _act_scales(flatten_tree(tiny["jcal"]))
    got = _act_scales(tiny["tcal"].state_dict())
    n_lin = len(_act_scales(flatten_tree(tiny["jcal_lin"])))
    assert set(got) == set(want) and n_lin > 0 and len(want) > n_lin
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_calibration_raises_when_nothing_is_recorded(tiny):
    with pytest.raises(RuntimeError, match="recorded no"):
        TQ.calibrate_static_activations(lambda m, b: None, copy.deepcopy(tiny["unet"]), [0])
    other = copy.deepcopy(tiny["unet"])
    with pytest.raises(RuntimeError, match="re-attached"):
        TQ.calibrate_static_activations(
            lambda m, b: tlayers.linear(other.time_embedding.ffn["0"], torch.zeros(1, 16)),
            copy.deepcopy(tiny["unet"]), [0])


def _port_quantized(tiny, jtree):
    """The port's tiny UNet holding the JAX quantized tree ``jtree``."""
    unet = copy.deepcopy(tiny["unet"])
    TQ.quantize_convs(TQ.quantize_params(unet))
    unet.load_state_dict(W.from_jax_params(jtree))
    return unet


def test_bridge_round_trips_a_quantized_tree(tiny):
    jq = tiny["jq"]
    unet = _port_quantized(tiny, jq)
    back = flatten_tree(W.to_jax_params(unet))
    want = flatten_tree(jq)
    assert set(back) == set(want)
    assert W.jax_param_shapes(unet) == {k: tuple(np.shape(v)) for k, v in want.items()}
    for k, v in want.items():
        v = np.asarray(v)
        assert back[k].dtype == (np.int8 if v.dtype == np.int8 else np.float32), k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # the port quantizes the same float weights to the same codes and scales
    own = W.to_jax_params(TQ.quantize_convs(TQ.quantize_params(copy.deepcopy(tiny["tcal"]))))
    own = flatten_tree(own)
    for k, v in want.items():
        if "act_scale" not in k:
            np.testing.assert_array_equal(own[k], np.asarray(v), err_msg=k)
    errs = TQ.quantization_error(tiny["unet"], unet)
    jerrs = JQ.quantization_error(tiny["params"], jq)
    assert set(errs) == set(jerrs)
    for k in jerrs:
        np.testing.assert_allclose(errs[k], jerrs[k], rtol=1e-4, err_msg=k)


def _jax_w8a8_conv_branch(orig):
    """JAX ``gn_silu_conv3x3``, but taking its W8A8 branch (ops/conv.py:
    673-683) at every conv that carries an ``act_scale``, as the port does:
    gn_scale_shift -> normalize -> SiLU -> cast -> ``_conv3x3_q``.  The
    Pallas ``_conv3x3_q`` runs here as the int32 XLA conv that
    tests/test_torch_quant.py::test_k7_plain_matches_jax_conv3x3_q holds
    equal to it in interpret mode (interpret mode at every conv of the UNet
    would take minutes)."""
    def gn_silu_conv3x3(gn_params, conv_params, x, *, num_groups=32, eps=1e-5, impl="auto"):
        if "act_scale" not in conv_params:
            return orig(gn_params, conv_params, x, num_groups=num_groups, eps=eps, impl=impl)
        ss = jgn.gn_scale_shift(gn_params, x, num_groups=num_groups, eps=eps)
        xn = x.astype(jnp.float32) * ss[:, 0][:, None, None, :] + ss[:, 1][:, None, None, :]
        xn = (xn * jax.nn.sigmoid(xn)).astype(x.dtype)
        s_x = jnp.maximum(conv_params["act_scale"].astype(jnp.float32) / 127.0, 1e-12)
        xq = jnp.round(jnp.clip(xn.astype(jnp.float32) / s_x, -127.0, 127.0)).astype(jnp.int8)
        acc = jax.lax.conv_general_dilated(xq, conv_params["kernel_q"], (1, 1), "SAME",
                                           dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                           preferred_element_type=jnp.int32)
        y = acc.astype(jnp.float32) * (s_x * conv_params["kernel_scale"].reshape(-1))
        return (y + conv_params["bias"].astype(jnp.float32)).astype(x.dtype)
    return gn_silu_conv3x3


# The full-W8A8 tiny UNet moves this far at least from the one with
# weight-only convs (relative L2 of the eps prediction): its resblock convs
# quantize their activations to 8 bits, about 1e-2 each, where skipping
# them would leave only the two packages' f32 differences, ~1e-6.
CONV_QUANT_MIN_REL_L2 = 1e-3


def test_tiny_unet_matches_jax(tiny, monkeypatch):
    """At the 4x4 latents of the tiny txt2img (at 16x16 a code or two lands
    within the packages' f32 differences of a half step; with the conv
    activations quantized too, one flips at 4x4 for the rng seeds 3 and 4,
    moving one batch element by ~4e-2, and none for 5), at 1e-4: the port
    with W8A8 linears and weight-only convs against JAX ``impl="xla"``, and
    the full-W8A8 port against JAX taking its W8A8 conv branch at every
    calibrated resblock conv."""
    apply = jax.jit(lambda p, *a: junet.unet_apply(p, *a, tiny["ucfg"], impl="xla"))
    lin_only = _port_quantized(tiny, tiny["jlin_only"])
    full = _port_quantized(tiny, tiny["jq"])
    x4 = np.random.default_rng(5).standard_normal((2, 4, 4, 4), dtype=np.float32)
    _, t, ctx = tiny["batches"][0]
    args = (_t(x4), _t(t.astype(np.int64)), _t(ctx))
    with torch.no_grad():
        got = lin_only(*args, impl="torch").numpy()
        got_full = full(*args, impl="torch").numpy()
    np.testing.assert_allclose(got, np.asarray(apply(tiny["jlin_only"], x4, t, ctx)), atol=1e-4)
    monkeypatch.setattr(jconv, "gn_silu_conv3x3", _jax_w8a8_conv_branch(jconv.gn_silu_conv3x3))
    want_full = np.asarray(jax.jit(
        lambda p, *a: junet.unet_apply(p, *a, tiny["ucfg"], impl="xla"))(tiny["jq"], x4, t, ctx))
    np.testing.assert_allclose(got_full, want_full, atol=1e-4)
    rel = np.linalg.norm(got_full - got) / np.linalg.norm(got)
    assert rel > CONV_QUANT_MIN_REL_L2, rel


def test_tiny_unet_cached_matches_jax(tiny, monkeypatch):
    """DeepCache on the calibrated full-W8A8 tiny UNet: ``forward_split``
    (output and deep feature) at t = 999, then ``forward_cached`` on another
    latent at t = 499 on that feature, against JAX's ``unet_apply_split`` /
    ``unet_apply_cached`` taking its W8A8 conv branch at every calibrated
    resblock conv; at the 4x4 latents of test_tiny_unet_matches_jax and
    1e-4 (the code-flip caveat of this file's docstring: no code flips
    here)."""
    full = _port_quantized(tiny, tiny["jq"])
    x4, x4b = np.random.default_rng(5).standard_normal((2, 2, 4, 4, 4), dtype=np.float32)
    (_, t, ctx), (_, t2, _) = tiny["batches"]
    monkeypatch.setattr(jconv, "gn_silu_conv3x3", _jax_w8a8_conv_branch(jconv.gn_silu_conv3x3))

    def split_then_cached(p, x, xb, t, t2, c):
        out, deep = junet.unet_apply_split(p, x, t, c, tiny["ucfg"], impl="xla")
        return out, deep, junet.unet_apply_cached(p, xb, t2, c, deep, tiny["ucfg"], impl="xla")

    want = jax.jit(split_then_cached)(tiny["jq"], x4, x4b, t, t2, ctx)
    with torch.no_grad():
        out, deep = full.forward_split(_t(x4), _t(t.astype(np.int64)), _t(ctx), impl="torch")
        cached = full.forward_cached(_t(x4b), _t(t2.astype(np.int64)), _t(ctx), deep,
                                     impl="torch")
    for got, w in zip((out, deep, cached), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-4)
    assert np.abs(cached.numpy() - out.numpy()).max() > 1e-2  # another step's input


def test_tiny_txt2img_matches_jax(tiny):
    """2 DDIM steps, CFG 5, 32x32: the port's pipeline with the W8A8-linear
    UNet against the JAX pipeline on the same trees and JAX's noise."""
    from test_torch_pipeline import TEXT, VAE, _jax_noise

    from stable_diffusion_tpu.models import clip as jclip
    from stable_diffusion_tpu.models import vae as jvae
    from stable_diffusion_tpu.pipeline import StableDiffusion as JSD
    from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
    from stable_diffusion_tpu_torch.models.vae import VAEConfig, VAEDecoder
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion

    ks = jax.random.split(jax.random.key(42), 3)
    tcfg, vcfg = jclip.CLIPTextConfig(**TEXT), jvae.VAEConfig(**VAE)
    text = jclip.init_text_model(ks[1], tcfg)
    vae = {k: v for k, v in jvae.init_vae(ks[2], vcfg).items()
           if k in ("decoder", "post_quant_conv")}
    pipe = StableDiffusion(_port_quantized(tiny, tiny["jlin_only"]),
                           _port(CLIPTextModel, CLIPTextConfig(**TEXT), text),
                           _port(VAEDecoder, VAEConfig(**VAE), vae), impl="torch")
    jpipe = JSD(params={"unet": tiny["jlin_only"], "text_encoder": text, "vae": vae},
                unet_config=tiny["ucfg"], text_config=tcfg, vae_config=vcfg, impl="xla")
    ids, unc = np.arange(77)[None] % 64, np.zeros((1, 77), np.int64)
    want = jpipe.generate(prompt="", do_cfg=True, cfg_scale=5.0, inference_steps=2,
                          sampler="ddim", img_size=(32, 32), seed=123, cond_ids=ids,
                          uncond_ids=unc)
    got = pipe.generate(ids, unc, img_size=(32, 32), cfg_scale=5.0, inference_steps=2,
                        initial_latents=_jax_noise(123, (1, 4, 4, 4)))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_gradients_through_the_w8a8_unet_raise(tiny):
    unet = _port_quantized(tiny, tiny["jq"])
    xb, tb, cb = tiny["tb"][0]
    with pytest.raises(NotImplementedError, match="inference-only"):
        unet(xb.clone().requires_grad_(), tb, cb, impl="torch")
