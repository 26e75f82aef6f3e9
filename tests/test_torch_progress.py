"""The pipeline's progress mode and prompt strings (the surface the Gradio
demo calls) against the JAX package's, on the CPU in f32.

Progress mode: ``generate`` / ``inpaint`` with a ``progress_callback`` run
the loop in segments of ``progress_every`` steps.  Held to JAX's progress
mode at DDIM within 1e-4 (tests/test_torch_img2img.py's bound): ``generate``
with DeepCache k = 2 in segments of 3, where each segment restarts the held
feature and the step index (step 3 runs the full UNet, which the one call
runs cached, so the segmented image must also lie away from the one
call's); ``inpaint`` on JAX's own draws (its four-way key split), its
[-1, 1] decode read from JAX's ``_decode_jit``.  The port draws from one
generator in one order, so its segmented call equals its one call exactly
without DeepCache, DDPM and DDIM at eta > 0 included.

Prompt strings: ids from ``tokenize`` by JAX's rules (a string over
``batch_size`` lanes, a list one a lane, ``uncond_prompt`` "" by default),
equal to the ids path exactly; JAX's ``ValueError``s, raised by both; and
``encode_text`` against JAX's within 1e-5.
"""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stable_diffusion_tpu import pipeline as JP
from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu_torch import pipeline as TP
from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig
from stable_diffusion_tpu_torch.models.unet import UNetConfig
from stable_diffusion_tpu_torch.models.vae import VAEConfig
from stable_diffusion_tpu_torch.utils.weights import from_jax_params
from tests.torch_threads import one_thread  # noqa: F401

ATOL = 1e-4
UNET = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
            cross_attention_dim=24, t_embed_dim=16)
TEXT = dict(hidden_size=24, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=77, vocab_size=64)
VAE = dict(ch_mult=(1, 1, 1, 1), base_channels=32)


class FakeTokenizer:
    """Deterministic ids below the tiny vocabulary (64), one row a prompt."""

    def batch_encode_plus(self, prompts, padding=None, max_length=77, truncation=True, **kw):
        return SimpleNamespace(input_ids=[
            [(sum(map(ord, p)) * 31 + j) % 64 for j in range(max_length)] for p in prompts])


@pytest.fixture(scope="module")
def params():
    ks = jax.random.split(jax.random.key(21), 3)
    return {"unet": junet.init_unet(ks[0], junet.UNetConfig(**UNET)),
            "text_encoder": jclip.init_text_model(ks[1], jclip.CLIPTextConfig(**TEXT)),
            "vae": jvae.init_vae(ks[2], jvae.VAEConfig(**VAE))}


@pytest.fixture(scope="module")
def pipes(params):
    jpipe = JP.StableDiffusion(params=params, unet_config=junet.UNetConfig(**UNET),
                               text_config=jclip.CLIPTextConfig(**TEXT),
                               vae_config=jvae.VAEConfig(**VAE), tokenizer=FakeTokenizer(),
                               impl="xla")
    pipe = TP.StableDiffusion.build(UNetConfig(**UNET), CLIPTextConfig(**TEXT), VAEConfig(**VAE),
                                    device="cpu", impl="torch")
    for name in ("unet", "text_encoder", "vae"):
        getattr(pipe, name).load_state_dict(from_jax_params(params[name]), strict=True)
    pipe.tokenizer = FakeTokenizer()
    return jpipe, pipe


def _ids(b):
    return (np.arange(77)[None] + 5 * np.arange(b)[:, None]) % 64, np.zeros((b, 77), np.int64)


def _recorder():
    calls = []
    return calls, lambda done, total: calls.append((done, total))


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def test_segmented_generate_with_deepcache_matches_jax(pipes):
    """DDIM b2, 6 steps, k = 2 in segments of 3: segments (0, 1, 2) and (3,
    4, 5), each full, cached, full."""
    jpipe, pipe = pipes
    ids, unc = _ids(2)
    lat = np.random.default_rng(0).standard_normal((2, 4, 4, 4)).astype(np.float32)
    kw = dict(img_size=(32, 32), cfg_scale=5.0, inference_steps=6, deepcache_interval=2,
              initial_latents=lat)
    jcalls, jcb = _recorder()
    want = jpipe.generate("", batch_size=2, cond_ids=ids, uncond_ids=unc, progress_callback=jcb,
                          progress_every=3, **kw)
    calls, cb = _recorder()
    got = pipe.generate(ids, unc, progress_callback=cb, progress_every=3, **kw)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert calls == jcalls == [(0, 6), (3, 6), (6, 6)]
    one = pipe.generate(ids, unc, **kw)
    assert np.abs(one - got).max() > 1e-3  # the restart at step 3 is seen


def test_segmented_inpaint_matches_jax(pipes, monkeypatch):
    """DDIM inpaint, 4 of 5 steps at strength 0.8, in segments of 2, on
    JAX's draws: the [-1, 1] decode within 1e-4, the uint8 within 1."""
    jpipe, pipe = pipes
    ids, unc = _ids(1)
    img = np.random.default_rng(5).integers(0, 256, (32, 32, 3)).astype(np.uint8)
    mask = np.zeros((32, 32), np.uint8)
    mask[:12, :20] = 255
    kw = dict(img_size=(32, 32), cfg_scale=5.0, strength=0.8, inference_steps=5, sampler="ddim",
              seed=13, progress_every=2)
    decoded = []
    decode = JP._decode_jit

    def record(*a):
        decoded.append(np.asarray(decode(*a)))
        return decoded[-1]

    monkeypatch.setattr(JP, "_decode_jit", record)
    jcalls, jcb = _recorder()
    want_u8 = jpipe.inpaint("", img, mask, cond_ids=ids, uncond_ids=unc, progress_callback=jcb, **kw)
    k_enc, k_lat, k_mask, _ = jax.random.split(jax.random.key(13), 4)
    shape = (1, 4, 4, 4)
    draws = dict(encode_noise=_normal(k_enc, shape), latent_noise=_normal(k_lat, shape),
                 mask_noise=_normal(k_mask, shape))
    calls, cb = _recorder()
    lat = pipe.inpaint(ids, unc, img, mask, progress_callback=cb, return_latents=True, **draws,
                       **kw)
    with torch.no_grad():
        got = pipe.vae.decode(torch.from_numpy(lat), impl="torch").numpy()
    np.testing.assert_allclose(got, decoded[-1], atol=ATOL)
    assert calls == jcalls == [(0, 4), (2, 4), (4, 4)]
    got_u8 = pipe.inpaint(ids, unc, img, mask, **draws, **kw)
    assert np.abs(got_u8.astype(np.int32) - want_u8.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("case", ["ddpm", "ddim_eta", "inpaint_ddpm"])
def test_segmented_call_is_the_one_call(pipes, case):
    """Without DeepCache the segments change nothing: one generator, one
    order of draws."""
    _, pipe = pipes
    ids, unc = _ids(1 if case == "inpaint_ddpm" else 2)
    calls, cb = _recorder()
    if case == "inpaint_ddpm":
        img = np.random.default_rng(2).integers(0, 256, (32, 32, 3)).astype(np.uint8)
        mask = np.zeros((32, 32), np.uint8)
        mask[8:, 8:] = 255
        kw = dict(img_size=(32, 32), inference_steps=7, strength=1.0, seed=3, return_latents=True)
        one = pipe.inpaint(ids, unc, img, mask, **kw)
        seg = pipe.inpaint(ids, unc, img, mask, progress_callback=cb, progress_every=3, **kw)
    else:
        kw = dict(img_size=(32, 32), inference_steps=7, seed=3, sampler=case[:4],
                  eta=0.5 if case == "ddim_eta" else 0.0, return_latents=True)
        one = pipe.generate(ids, unc, **kw)
        seg = pipe.generate(ids, unc, progress_callback=cb, progress_every=3, **kw)
    np.testing.assert_array_equal(seg, one)
    assert calls == [(0, 7), (3, 7), (6, 7), (7, 7)]


def test_prompts_are_the_ids(pipes):
    """A prompt list (one a lane), a string over ``batch_size`` lanes and
    the default "" unconditional prompt give the ids path's images; the
    ids are JAX ``tokenize``'s."""
    jpipe, pipe = pipes
    kw = dict(img_size=(32, 32), inference_steps=2, seed=1)
    tok = pipe.tokenize
    np.testing.assert_array_equal(tok(["a cat", "a dog"]), jpipe.tokenize(["a cat", "a dog"]))
    got = pipe.generate(prompt=["a cat", "a dog"], uncond_prompt=["x", "y"], **kw)
    np.testing.assert_array_equal(got, pipe.generate(tok(["a cat", "a dog"]), tok(["x", "y"]), **kw))
    got = pipe.generate(prompt="a cat", batch_size=2, **kw)
    np.testing.assert_array_equal(got, pipe.generate(tok(["a cat"] * 2), tok(["", ""]), **kw))
    got = pipe.generate(tok(["a cat"]), **kw)  # CFG's ids from the default "" prompt
    np.testing.assert_array_equal(got, pipe.generate(tok(["a cat"]), tok([""]), **kw))


def test_inpaint_and_one_step_take_prompts(pipes):
    _, pipe = pipes
    tok = pipe.tokenize
    img = np.random.default_rng(4).integers(0, 256, (32, 32, 3)).astype(np.uint8)
    mask = np.zeros((32, 32), np.uint8)
    mask[4:20, 4:20] = 255
    kw = dict(img_size=(32, 32), inference_steps=3, seed=2)
    got = pipe.inpaint(prompt="a cat", uncond_prompt="blur", input_image=img, mask=mask, **kw)
    np.testing.assert_array_equal(got, pipe.inpaint(tok(["a cat"]), tok(["blur"]), img, mask, **kw))
    one = dict(img_size=(32, 32), seed=6)
    np.testing.assert_array_equal(pipe.generate_in_one_step(prompt=["a", "b"], **one),
                                  pipe.generate_in_one_step(tok(["a", "b"]), **one))
    np.testing.assert_array_equal(pipe.generate_in_one_step(prompt="a", batch_size=3, **one),
                                  pipe.generate_in_one_step(tok(["a"]), batch_size=3, **one))


@pytest.mark.parametrize("kw,match", [
    (dict(prompt=["a", "b", "c"], batch_size=2), "batch_size=2 conflicts with a 3-prompt list"),
    (dict(prompt=["a", "b"], uncond_prompt=["x"]), "uncond_prompt list has 1 entries for "
                                                   "batch_size=2"),
    (dict(prompt="a", batch_size=3, uncond_prompt=["x", "y"]), "uncond_prompt list has 2 entries"),
])
def test_prompt_refusals_are_jax_s(pipes, kw, match):
    jpipe, pipe = pipes
    with pytest.raises(ValueError, match=match):
        jpipe.generate(**kw, img_size=(32, 32), inference_steps=1)
    with pytest.raises(ValueError, match=match):
        pipe.generate(**kw, img_size=(32, 32), inference_steps=1)
    with pytest.raises(ValueError, match="needs a prompt, cond_ids or a context"):
        pipe.generate(img_size=(32, 32), inference_steps=1)


def test_encode_text_matches_jax(pipes):
    jpipe, pipe = pipes
    ids, _ = _ids(3)
    want = np.asarray(jpipe.encode_text(ids))
    got = pipe.encode_text(ids)
    assert got.shape == (3, 77, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
