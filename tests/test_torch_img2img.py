"""The port's img2img and inpaint against the JAX package's, on the CPU in f32.

The tiny models of tests/test_torch_pipeline.py (the VAE at ch_mult (1, 1,
1, 1), base 32: the pipeline needs its 8x downsampling), JAX-initialised and
carried across whole by the weight bridge.  The port cannot replay
``jax.random``, so each test rebuilds JAX's own draws (the key splits of
``_img2img_jit`` / ``_inpaint_jit`` and the per-step split of their scans)
and hands them to the port.  Tolerances: images within 1e-4 (f32 through a
few hundred layers in another summation order), except DDIM at eta 0.5
within 2e-4: its unscaled latents reach |12| (x 5.5 into the decoder), and
JAX's own f32 image there lies 1.4e-4 from the same function evaluated in
f64 by the port, while the port's f32 image lies within 1e-5 of it (checked
below, so the wider bound cannot hide a port error); inpaint's uint8 output,
truncated from [0, 255], within 1.  ``preprocess_mask``'s boolean mask
equals JAX's exactly, and ``preprocess_image`` equals JAX's on arrays at
``img_size``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stable_diffusion_tpu import pipeline as JP
from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu.schedulers import schedule as JS
from stable_diffusion_tpu_torch import pipeline as TP
from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig
from stable_diffusion_tpu_torch.models.unet import UNetConfig
from stable_diffusion_tpu_torch.models.vae import VAEConfig
from stable_diffusion_tpu_torch.utils.weights import from_jax_params

ATOL = 1e-4
DDIM_ATOL = 2e-4
UNET = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
            cross_attention_dim=24, t_embed_dim=16)
TEXT = dict(hidden_size=24, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=77, vocab_size=64)
VAE = dict(ch_mult=(1, 1, 1, 1), base_channels=32)
V_PRED = {"prediction_type": "v_prediction"}
STEPS, STRENGTH = 5, 0.8  # 4 steps run


@pytest.fixture(scope="module")
def params():
    ks = jax.random.split(jax.random.key(42), 3)
    return {"unet": junet.init_unet(ks[0], junet.UNetConfig(**UNET)),
            "text_encoder": jclip.init_text_model(ks[1], jclip.CLIPTextConfig(**TEXT)),
            "vae": jvae.init_vae(ks[2], jvae.VAEConfig(**VAE))}


def _jax(params, scheduler_config=None):
    return JP.StableDiffusion(params=params, unet_config=junet.UNetConfig(**UNET),
                              text_config=jclip.CLIPTextConfig(**TEXT),
                              vae_config=jvae.VAEConfig(**VAE),
                              scheduler_config=scheduler_config, impl="xla")


def _port(params, scheduler_config=None, impl="torch"):
    pipe = TP.StableDiffusion.build(UNetConfig(**UNET), CLIPTextConfig(**TEXT), VAEConfig(**VAE),
                                    device="cpu", impl=impl, scheduler_config=scheduler_config)
    pipe.unet.load_state_dict(from_jax_params(params["unet"]), strict=True)
    pipe.text_encoder.load_state_dict(from_jax_params(params["text_encoder"]), strict=True)
    pipe.vae.load_state_dict(from_jax_params(params["vae"]), strict=True)
    return pipe


def _ids(b):
    return (np.arange(77)[None] + 5 * np.arange(b)[:, None]) % 64, np.zeros((b, 77), np.int64)


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _step_draws(key, n, shape):
    """The scan's draws: ``key, sub = split(key)`` each step, noise from sub."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(_normal(sub, shape))
    return np.stack(out)


def _img2img_draws(seed, b, h, n):
    """``_img2img_jit``'s three-way split: encode noise (1, ...), the
    q-sample noise (b, ...), and the scan's per-step noise."""
    key_img, key_lat, key_steps = jax.random.split(jax.random.key(seed), 3)
    shape = (b, h, h, 4)
    return dict(encode_noise=_normal(key_img, (1, h, h, 4)), latent_noise=_normal(key_lat, shape),
                step_noise=_step_draws(key_steps, n, shape))


def _image(seed, hw):
    return np.random.default_rng(seed).integers(0, 256, (hw, hw, 3)).astype(np.uint8)


@pytest.mark.parametrize("case", ["ddpm_cosine", "input_latents", "ddim_eta", "ddpm_v_prediction"])
def test_img2img_matches_jax(params, case):
    """generate(input_image=...) at batch 2, strength 0.8: DDPM on the cosine
    schedule; the same from ``input_latents``; DDIM at eta 0.5; DDPM on a
    v-prediction schedule (which JAX's DDPM takes as eps)."""
    ids, unc = _ids(2)
    sched_cfg = V_PRED if case == "ddpm_v_prediction" else None
    kw = dict(img_size=(32, 32), cfg_scale=5.0, strength=STRENGTH, inference_steps=STEPS,
              seed=11, sampler="ddim" if case == "ddim_eta" else "ddpm",
              eta=0.5 if case == "ddim_eta" else 0.0,
              use_cosine_schedule=case in ("ddpm_cosine", "input_latents"))
    src = {"input_image": _image(0, 32)}
    if case == "input_latents":
        src = {"input_latents": np.random.default_rng(1).standard_normal((1, 4, 4, 4))
               .astype(np.float32)}
    want = _jax(params, sched_cfg).generate("", batch_size=2, cond_ids=ids, uncond_ids=unc,
                                            **src, **kw)
    draws = _img2img_draws(11, 2, 4, int(STEPS * STRENGTH))
    if case == "input_latents":
        del draws["encode_noise"]
    pipe = _port(params, sched_cfg)
    got = pipe.generate(ids, unc, **src, **draws, **kw)
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=DDIM_ATOL if case == "ddim_eta" else ATOL)
    if case == "ddim_eta":  # the port in f32 against itself in f64
        for m in (pipe.unet, pipe.text_encoder, pipe.vae):
            m.double()
        np.testing.assert_allclose(got, pipe.generate(ids, unc, **src, **draws, **kw), atol=1e-5)
    if case == "ddpm_v_prediction":  # the quirk: DDPM ignores the prediction type
        eps = _port(params).generate(ids, unc, **src, **draws, **kw)
        np.testing.assert_array_equal(eps, got)


def test_img2img_seeded_draws_and_strength(params):
    """Without injected noise: one seed, one image; another seed, another;
    ``return_latents`` gives the final latents; a draw of the wrong shape
    and an unknown sampler are refused."""
    pipe = _port(params)
    ids, unc = _ids(1)
    kw = dict(input_image=_image(2, 32), img_size=(32, 32), inference_steps=4, sampler="ddpm",
              output_dtype="uint8")
    a = pipe.generate(ids, unc, seed=3, **kw)
    b = pipe.generate(ids, unc, seed=3, **kw)
    c = pipe.generate(ids, unc, seed=4, **kw)
    assert a.dtype == np.uint8 and a.shape == (1, 32, 32, 3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    lat = pipe.generate(ids, unc, seed=3, strength=0.5, return_latents=True, **{
        k: v for k, v in kw.items() if k != "output_dtype"})
    assert lat.shape == (1, 4, 4, 4) and lat.dtype == np.float32
    with pytest.raises(ValueError, match="latent_noise"):
        pipe.generate(ids, unc, latent_noise=np.zeros((2, 4, 4, 4), np.float32), **kw)
    with pytest.raises(ValueError, match="sampler"):
        pipe.generate(ids, unc, **dict(kw, sampler="euler"))


def _inpaint_case():
    img = _image(5, 64)
    mask = np.zeros((64, 64), np.uint8)
    mask[:20, :24] = 255
    return img, mask


def test_inpaint_matches_jax(params):
    """``_inpaint_jit``'s [-1, 1] images within 1e-4 over its four-way key
    split; ``inpaint``'s uint8 within 1 of JAX's."""
    img, mask = _inpaint_case()
    ids, unc = _ids(1)
    kw = dict(img_size=(64, 64), cfg_scale=5.0, strength=STRENGTH, inference_steps=STEPS, seed=13)
    j = _jax(params)
    want_u8 = j.inpaint("", img, mask, cond_ids=ids, uncond_ids=unc, **kw)
    sched = j.make_schedule()
    ts = JS.apply_strength(JS.inference_timesteps(sched, STEPS, kind="ddpm"), STRENGTH)
    prev = JS.prev_timesteps(sched, ts, STEPS)
    small = JP.preprocess_mask(mask, (64, 64))
    assert small.any() and not small.all()  # both regions are exercised
    want = np.asarray(JP._inpaint_jit(
        j.params, jnp.asarray(JP.preprocess_image(img, (64, 64))), jnp.asarray(small),
        j.encode_text(np.concatenate([ids, unc])), jnp.asarray(ts), jnp.asarray(prev),
        jnp.asarray(sched.alphas_hat), jnp.asarray(5.0, jnp.float32), jax.random.key(13),
        (1, 8, 8, 4), j.unet_config, j.vae_config, jnp.float32, True, "ddpm", "epsilon",
        "xla")).reshape(1, 64, 64, 3)
    k_enc, k_lat, k_mask, k_steps = jax.random.split(jax.random.key(13), 4)
    shape = (1, 8, 8, 4)
    draws = dict(encode_noise=_normal(k_enc, shape), latent_noise=_normal(k_lat, shape),
                 mask_noise=_normal(k_mask, shape), step_noise=_step_draws(k_steps, len(ts), shape))
    pipe = _port(params)
    lat = pipe.inpaint(ids, unc, img, mask, return_latents=True, **draws, **kw)
    with torch.no_grad():
        got = pipe.vae.decode(torch.from_numpy(lat), impl="torch").numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    got_u8 = pipe.inpaint(ids, unc, img, mask, **draws, **kw)
    assert got_u8.shape == want_u8.shape == (64, 64, 3) and got_u8.dtype == np.uint8
    assert np.abs(got_u8.astype(np.int32) - want_u8.astype(np.int32)).max() <= 1
    # truncation, not rounding, from the clamped [0, 255] scale
    np.testing.assert_array_equal(
        got_u8, np.clip((got[0] + 1.0) * 127.5, 0.0, 255.0).astype(np.uint8))


def test_inpaint_and_img2img_refuse_cuda_on_the_cpu(params):
    pipe = _port(params, impl="cuda")
    ids, unc = _ids(1)
    img, mask = _inpaint_case()
    with pytest.raises(ValueError, match="CUDA device"):
        pipe.inpaint(ids, unc, img, mask, img_size=(64, 64))
    with pytest.raises(ValueError, match="CUDA device"):
        pipe.generate(ids, unc, input_image=img, img_size=(64, 64))


def _masks(size):
    h, w = size
    rng = np.random.default_rng(h + w)
    rect = np.zeros(size, np.uint8)
    rect[h // 5:h // 5 + h * 200 // 512, w // 3:w // 3 + w * 250 // 512] = 255
    grad = np.tile(np.linspace(0, 255, w), (h, 1)).astype(np.uint8)
    grad[:, : w // 4] = 0
    yy, xx = np.mgrid[:h, :w]
    blobs = np.zeros(size, np.float32)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(8, 40)
        blobs += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
    blobs = np.where(blobs > 0.5, 255, 0).astype(np.uint8)
    speck = np.zeros(size, np.uint8)
    speck[h // 2, w // 2] = 1
    return {"zeros": np.zeros(size, np.uint8), "full": np.full(size, 255, np.uint8),
            "rectangle": rect, "gradient": grad, "blobs": blobs, "speck": speck}


@pytest.mark.parametrize("size", [(512, 512), (256, 384)])
@pytest.mark.parametrize("name", ["zeros", "full", "rectangle", "gradient", "blobs", "speck"])
def test_preprocess_mask_equals_jax(size, name):
    mask = _masks(size)[name]
    want = JP.preprocess_mask(mask, size)
    got = TP.preprocess_mask(mask, size)
    assert got.dtype == np.bool_ and got.shape == want.shape == (1, size[0] // 8, size[1] // 8, 1)
    np.testing.assert_array_equal(got, want)
    if name == "rectangle" and size == (512, 512):
        # the ringing outside the hard edge counts: more cells than it covers
        assert int(got.sum()) > (200 // 8) * (250 // 8)


def test_preprocess_mask_needs_antialiasing():
    """The plain (not antialiased) bicubic downsample gives another mask."""
    mask = _masks((512, 512))["rectangle"]
    x = torch.from_numpy(mask.astype(np.float32))[None, None]
    plain = torch.nn.functional.interpolate(x, size=(64, 64), mode="bicubic", align_corners=False)
    assert not np.array_equal(plain[0, 0].numpy() != 0, JP.preprocess_mask(mask, (512, 512))[0, :, :, 0])


@pytest.mark.parametrize("kind", ["uint8", "float", "grey", "resized"])
def test_preprocess_image_equals_jax(kind):
    rng = np.random.default_rng(8)
    size = (48, 64)
    img = rng.integers(0, 256, (*size, 3)).astype(np.uint8)
    if kind == "float":  # cast to uint8 by truncation, as JAX
        img = img.astype(np.float32) + 0.7
    elif kind == "grey":
        img = img[:, :, 0]
    elif kind == "resized":
        img = rng.integers(0, 256, (40, 50, 3)).astype(np.uint8)
    want = JP.preprocess_image(img, size)
    got = TP.preprocess_image(img, size)
    assert got.dtype == np.float32 and got.shape == want.shape == (1, *size, 3)
    np.testing.assert_array_equal(got, want)


def test_scale_img_and_cfg_order():
    x = np.array([-2.0, -1.0, 0.0, 1.0, 2.0], np.float32)
    np.testing.assert_array_equal(TP.scale_img(x, (-1, 1), (0, 255), clamp=True),
                                  JP.scale_img(x, (-1, 1), (0, 255), clamp=True))
    pred = torch.tensor([[1.0], [3.0]])
    assert TP.cfg_combine(pred, 7.5, "cond_first").item() == 1.0 + 7.5 * (1.0 - 3.0)
    assert TP.cfg_combine(pred, 7.5).item() == 1.0 + 7.5 * 2.0
