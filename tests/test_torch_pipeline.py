"""The PyTorch port's txt2img pipeline reproduces the JAX golden
tests/golden/tiny_txt2img.npz (atol 1e-4, f32 on the CPU).

The parameters are the JAX-initialised ones of tests/test_golden.py, carried
over by the port's weight bridge, and the starting noise is the one the JAX
pipeline draws for seed 123 (pipeline.py ``_txt2img_jit``: the second of
three keys split from ``jax.random.key(seed)``), handed to the port as
``initial_latents``."""

import os

import numpy as np
import jax
import torch

from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig
from stable_diffusion_tpu_torch.models.unet import UNetConfig
from stable_diffusion_tpu_torch.models.vae import VAEConfig
from stable_diffusion_tpu_torch.pipeline import StableDiffusion, cfg_combine
from stable_diffusion_tpu_torch.utils.weights import from_jax_params

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_txt2img.npz")
UNET = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
            cross_attention_dim=24, t_embed_dim=16)
TEXT = dict(hidden_size=24, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=77, vocab_size=64)
VAE = dict(ch_mult=(1, 1, 1, 1), base_channels=32)


def _pipe(impl="torch"):
    ks = jax.random.split(jax.random.key(42), 3)
    params = {
        "unet": junet.init_unet(ks[0], junet.UNetConfig(**UNET)),
        "text_encoder": jclip.init_text_model(ks[1], jclip.CLIPTextConfig(**TEXT)),
        "vae": jvae.init_vae(ks[2], jvae.VAEConfig(**VAE)),
    }
    pipe = StableDiffusion.build(UNetConfig(**UNET), CLIPTextConfig(**TEXT), VAEConfig(**VAE),
                                 device="cpu", impl=impl)
    pipe.unet.load_state_dict(from_jax_params(params["unet"]))
    pipe.text_encoder.load_state_dict(from_jax_params(params["text_encoder"]))
    pipe.vae.load_state_dict(from_jax_params(params["vae"]), strict=True)
    return pipe


def _jax_noise(seed, shape):
    _, key_lat, _ = jax.random.split(jax.random.key(seed), 3)
    return np.asarray(jax.random.normal(key_lat, shape, jax.numpy.float32))


def test_generate_reproduces_jax_golden():
    want = np.load(GOLDEN)["images"]
    got = _pipe().generate(
        np.arange(77)[None] % 64, np.zeros((1, 77), np.int64), img_size=(32, 32),
        cfg_scale=5.0, inference_steps=4, initial_latents=_jax_noise(123, (1, 4, 4, 4)))
    assert got.shape == want.shape == (1, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_generate_uint8_and_seeded_noise():
    pipe = _pipe()
    ids, unc = np.arange(77)[None] % 64, np.zeros((1, 77), np.int64)
    a = pipe.generate(ids, unc, img_size=(32, 32), inference_steps=2, seed=5, output_dtype="uint8")
    b = pipe.generate(ids, unc, img_size=(32, 32), inference_steps=2, seed=5, output_dtype="uint8")
    c = pipe.generate(ids, unc, img_size=(32, 32), inference_steps=2, seed=6, output_dtype="uint8")
    assert a.dtype == np.uint8 and a.shape == (1, 32, 32, 3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_cfg_combine_is_uncond_first():
    pred = torch.tensor([[1.0], [3.0]])
    assert cfg_combine(pred, 7.5).item() == 1.0 + 7.5 * 2.0
