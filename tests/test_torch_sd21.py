"""The SD2.1 slice of the port against the JAX package on the CPU (f32):
a tiny SD2.1-shaped txt2img (GELU text tower, as OpenCLIP ViT-H; its
parameters carried across from the ``text_model`` root; v-prediction DDIM
with CFG) against JAX ``StableDiffusion.generate`` on the JAX noise, the
tiny UNet with both kernel switches on against JAX's UNet, and the SD1.5
golden through the repaired schedule."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu.pipeline import StableDiffusion as JaxSD
from stable_diffusion_tpu_torch.models import clip as tclip
from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
from stable_diffusion_tpu_torch.models.vae import VAEConfig
from stable_diffusion_tpu_torch.ops import linear, winograd
from stable_diffusion_tpu_torch.pipeline import StableDiffusion, scheduler_config_for
from stable_diffusion_tpu_torch.utils.weights import build, from_jax_params, to_jax_params

UNET = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
            cross_attention_dim=24, t_embed_dim=16)
TEXT = dict(hidden_size=24, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=77, vocab_size=64, hidden_act="gelu")
VAE = dict(ch_mult=(1, 1, 1, 1), base_channels=32)
V_PRED = {"prediction_type": "v_prediction"}
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_txt2img.npz")


def _jax_params(text_act="gelu"):
    ks = jax.random.split(jax.random.key(42), 3)
    return {
        "unet": junet.init_unet(ks[0], junet.UNetConfig(**UNET)),
        "text_encoder": jclip.init_text_model(ks[1], jclip.CLIPTextConfig(
            **dict(TEXT, hidden_act=text_act))),
        "vae": jvae.init_vae(ks[2], jvae.VAEConfig(**VAE)),
    }


def _port(params, text_act="gelu", scheduler_config=None):
    pipe = StableDiffusion.build(UNetConfig(**UNET), tclip.CLIPTextConfig(
        **dict(TEXT, hidden_act=text_act)), VAEConfig(**VAE), device="cpu", impl="torch",
        scheduler_config=scheduler_config)
    pipe.unet.load_state_dict(from_jax_params(params["unet"]))
    # the OpenCLIP checkpoint's form: the tower under "text_model"
    pipe.text_encoder.load_state_dict(from_jax_params({"text_model": params["text_encoder"]},
                                                      root="text_model"))
    pipe.vae.load_state_dict(from_jax_params(params["vae"]), strict=True)
    return pipe


def _jax_noise(seed, shape):
    _, key_lat, _ = jax.random.split(jax.random.key(seed), 3)
    return np.asarray(jax.random.normal(key_lat, shape, jnp.float32))


def test_tiny_sd21_pipeline_matches_jax_v_prediction():
    params = _jax_params()
    ids, unc = np.arange(77)[None] % 64, np.zeros((1, 77), np.int64)
    want = JaxSD(params=params, unet_config=junet.UNetConfig(**UNET),
                 text_config=jclip.CLIPTextConfig(**TEXT), vae_config=jvae.VAEConfig(**VAE),
                 scheduler_config=V_PRED, impl="xla").generate(
        prompt="", do_cfg=True, cfg_scale=5.0, inference_steps=4, sampler="ddim",
        img_size=(32, 32), seed=123, cond_ids=ids, uncond_ids=unc)
    pipe = _port(params, scheduler_config=V_PRED)
    assert pipe.make_schedule().prediction_type == "v_prediction"
    got = pipe.generate(ids, unc, img_size=(32, 32), cfg_scale=5.0, inference_steps=4,
                        initial_latents=_jax_noise(123, (1, 4, 4, 4)))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    # the epsilon schedule on the same weights gives another image
    eps = _port(params).generate(ids, unc, img_size=(32, 32), cfg_scale=5.0, inference_steps=4,
                                 initial_latents=_jax_noise(123, (1, 4, 4, 4)))
    assert np.abs(eps - got).max() > 1e-2


def test_openclip_tower_matches_jax():
    p = _jax_params()["text_encoder"]
    cfg = tclip.CLIPTextConfig(**TEXT)
    ids = np.random.default_rng(0).integers(0, 64, (2, 77))
    want = jclip.openclip_apply({"text_model": p}, jnp.asarray(ids),
                                jclip.CLIPTextConfig(**TEXT), impl="xla")
    oc = build(tclip.OpenCLIP, cfg, device="cpu")
    oc.load_state_dict(from_jax_params({"text_model": p}))
    got = tclip.openclip_apply(oc, torch.as_tensor(ids), impl="torch")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    # and the bridge back, under the same root
    back = to_jax_params(oc.text_model, root="text_model")
    np.testing.assert_array_equal(back["text_model"]["final_layer_norm"]["scale"],
                                  np.asarray(p["final_layer_norm"]["scale"]))


def test_version_constructors_and_configs():
    for version, unet_cfg, text_cfg, pred in (
            ("1.5", UNetConfig.sd15(), tclip.CLIPTextConfig.vit_l(), "epsilon"),
            ("2.1", UNetConfig.sd21(), tclip.CLIPTextConfig.vit_h(), "v_prediction")):
        pipe = StableDiffusion.for_version(version, device="meta")
        assert pipe.unet.cfg == unet_cfg and pipe.text_encoder.cfg == text_cfg
        assert pipe.make_schedule().prediction_type == pred
        assert scheduler_config_for(version)["prediction_type"] == pred
    j = junet.UNetConfig.sd21()
    assert UNetConfig.sd21().heads_per_stage == j.heads_per_stage
    assert UNetConfig.sd21().cross_dim_per_stage == j.cross_dim_per_stage
    assert UNetConfig.from_dict({"block_out_channels": [320, 640, 1280, 1280],
                                 "attention_head_dim": [5, 10, 20, 20],
                                 "cross_attention_dim": 1024, "sample_size": 96}) == UNetConfig.sd21()
    jt = jclip.CLIPTextConfig.vit_h()
    assert tclip.CLIPTextConfig.from_dict(dataclasses.asdict(jt)) == tclip.CLIPTextConfig.vit_h()
    assert StableDiffusion.build(UNetConfig(**UNET), tclip.CLIPTextConfig(**TEXT),
                                 VAEConfig(**VAE), device="meta").make_schedule().prediction_type \
        == "epsilon"


def test_tiny_unet_with_both_switches_on_matches_jax(monkeypatch):
    """SD_TPU_FUSED_MM=all and SD_TPU_WINOGRAD=1: every switched site takes
    its switched entry (on the CPU, the kernels' plain versions: the
    Winograd form for the convs at W >= 16: the 32^2 and 16^2 stages here)
    and the UNet still equals JAX's (XLA) UNet."""
    hw = 32
    monkeypatch.setenv("SD_TPU_FUSED_MM", "all")
    monkeypatch.setenv("SD_TPU_WINOGRAD", "1")
    jparams = _jax_params()["unet"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, hw, hw, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 24)).astype(np.float32)
    t = np.array([501])
    want = junet.unet_apply(jparams, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                            junet.UNetConfig(**UNET), impl="xla")
    unet = build(UNet, UNetConfig(**UNET), device="cpu")
    unet.load_state_dict(from_jax_params(jparams))
    calls = []
    real = winograd.conv3x3_winograd_plain
    monkeypatch.setattr(winograd, "conv3x3_winograd_plain",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), impl="auto")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert {shape[1] for shape in calls} == {32, 16} and linear.fused_mm_enabled()


def test_sd15_pipeline_still_gives_the_tiny_golden():
    # the golden's tiny tower keeps the config's default GELU (tests/test_golden.py)
    pipe = _port(_jax_params(), scheduler_config=scheduler_config_for("1.5"))
    got = pipe.generate(np.arange(77)[None] % 64, np.zeros((1, 77), np.int64), img_size=(32, 32),
                        cfg_scale=5.0, inference_steps=4,
                        initial_latents=_jax_noise(123, (1, 4, 4, 4)))
    np.testing.assert_allclose(got, np.load(GOLDEN)["images"], atol=1e-4)
