"""The port's DeepCache (the split UNet and ``generate(deepcache_interval=k)``)
against the JAX package's, on the CPU in f32.

The models are initialised by the port (``init_random_``, then every bias
and norm parameter moved off 0 and 1) and carried to JAX by the weight
bridge (``to_jax_params``), which spares the suite JAX's eager inits; JAX
runs ``impl="xla"``, each comparison one ``jax.jit``.  Two tiny configurations: an
SD1.5-shaped one (one head count for every stage, so the head width grows
with the channels) and an SD2.1-shaped one (a head count a stage, the head
width fixed, another cross-attention width).  Tolerances: the split parts
within 1e-5 of the tensor's largest magnitude (f32 through ~60 layers
summed in another order: the deep feature reaches |13| and lies ~2e-5 from
JAX's, the outputs ~3e-6); the pipelines' images within 1e-4, as
tests/test_torch_img2img.py holds them; the port's ``forward`` equals its
own composition exactly.
"""

import numpy as np
import jax
import pytest
import torch

from stable_diffusion_tpu import pipeline as JP
from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig
from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
from stable_diffusion_tpu_torch.models.vae import VAEConfig
from stable_diffusion_tpu_torch.pipeline import StableDiffusion
from stable_diffusion_tpu_torch.utils.weights import init_random_, to_jax_params
from test_torch_img2img import TEXT, UNET, VAE, _ids, _image, _img2img_draws
from tests.torch_threads import one_thread  # noqa: F401

CONFIGS = {
    "sd15": dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=2,
                 cross_attention_dim=24, t_embed_dim=16),
    "sd21": dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
                 cross_attention_dim=32, t_embed_dim=16),
}
SPLIT_TOL = 1e-5
PIPE_ATOL = 1e-4
STEPS = 4  # k = 3 runs full, cached, cached, full


def _init(module, seed):
    """``init_random_``, then biases and norm parameters drawn too (zero
    biases and unit norms would hide a bias or affine dropped by the port)."""
    init_random_(module, seed)
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return module


def _close(got, want, tol):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (err, float(np.abs(want).max()))


@pytest.fixture(scope="module")
def unets():
    return {name: _init(UNet(UNetConfig(**kw)), 1) for name, kw in CONFIGS.items()}


def _inputs(seed, cross, hw=8):
    r = np.random.default_rng(seed)
    return (r.standard_normal((2, hw, hw, 4), dtype=np.float32),
            r.standard_normal((2, 77, cross), dtype=np.float32))


@pytest.mark.parametrize("name", CONFIGS)
def test_split_and_cached_match_jax(unets, name):
    """``forward_split`` (output and deep feature) against ``unet_apply_split``,
    and a cached step at another latent and timestep on that feature
    against ``unet_apply_cached``."""
    unet, jcfg = unets[name], junet.UNetConfig(**CONFIGS[name])
    x, cond = _inputs(0, jcfg.cross_attention_dim)
    x2, _ = _inputs(1, jcfg.cross_attention_dim)
    t, t2 = np.array([500], np.int32), np.array([480], np.int32)

    def split_then_cached(p, x, x2, t, t2, cond):
        out, deep = junet.unet_apply_split(p, x, t, cond, jcfg, impl="xla")
        return out, deep, junet.unet_apply_cached(p, x2, t2, cond, deep, jcfg, impl="xla")

    want, jdeep, want_cached = jax.jit(split_then_cached)(to_jax_params(unet), x, x2, t, t2, cond)
    tt = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    with torch.no_grad():
        got, deep = unet.forward_split(tt(x), tt(t).long(), tt(cond), impl="torch")
        got_cached = unet.forward_cached(tt(x2), tt(t2).long(), tt(cond), deep, impl="torch")
    assert deep.shape == (2, 8, 8, jcfg.block_out_channels[1])
    _close(deep, jdeep, SPLIT_TOL)
    _close(got, want, SPLIT_TOL)
    _close(got_cached, want_cached, SPLIT_TOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_is_the_composition(unets, name):
    """``forward`` is shallow_encoder -> deep -> shallow_decoder, bit for bit;
    a cached step on its own latent's deep feature is the full pass; and
    gradient checkpointing reaches the split parts (the same gradients)."""
    unet, cfg = unets[name], UNetConfig(**CONFIGS[name])
    x, cond = (torch.from_numpy(a) for a in _inputs(2, cfg.cross_attention_dim))
    t = torch.tensor([700])
    with torch.no_grad():
        full = unet(x, t, cond, impl="torch")
        t_embed = unet.time_embedding_apply(t, x.dtype, "torch")
        skips, down0 = unet.shallow_encoder(x, t_embed, cond, impl="torch")
        deep = unet.deep(down0, t_embed, cond, impl="torch")
        parts = unet.shallow_decoder(deep, skips, t_embed, cond, impl="torch")
        cached = unet.forward_cached(x, t, cond, deep, impl="torch")
    assert len(skips) == cfg.layers_per_block + 1
    assert torch.equal(full, parts) and torch.equal(full, cached)
    grads = []
    for remat in (False, True):
        unet.zero_grad()
        unet(x, t, cond, impl="torch", gradient_checkpointing=remat).square().mean().backward()
        grads.append([p.grad.clone() for p in unet.parameters()])
    unet.zero_grad()
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def pipes():
    pipe = StableDiffusion.build(UNetConfig(**UNET), CLIPTextConfig(**TEXT), VAEConfig(**VAE),
                                 device="cpu", impl="torch")
    for i, m in enumerate((pipe.unet, pipe.text_encoder, pipe.vae)):
        _init(m, 10 + i)
    params = {"unet": to_jax_params(pipe.unet), "text_encoder": to_jax_params(pipe.text_encoder),
              "vae": to_jax_params(pipe.vae)}
    jpipe = JP.StableDiffusion(params=params, unet_config=junet.UNetConfig(**UNET),
                               text_config=jclip.CLIPTextConfig(**TEXT),
                               vae_config=jvae.VAEConfig(**VAE), impl="xla")
    return jpipe, pipe


@pytest.mark.parametrize("k", [1, 2, 3])
def test_generate_deepcache_matches_jax(pipes, k):
    """txt2img DDIM 4 steps (eta 0) with CFG at batch 2 on the same starting
    latents: the images against JAX's ``generate``; k = 1 is the exact loop
    (the same code as no argument), k = 2 and 3 move away from it, so the
    interval is not ignored."""
    jpipe, pipe = pipes
    ids, unc = _ids(2)
    lat = np.random.default_rng(3).standard_normal((2, 4, 4, 4)).astype(np.float32)
    kw = dict(img_size=(32, 32), cfg_scale=5.0, inference_steps=STEPS, sampler="ddim",
              initial_latents=lat)
    want = jpipe.generate("", batch_size=2, cond_ids=ids, uncond_ids=unc, deepcache_interval=k,
                          **kw)
    got = pipe.generate(ids, unc, deepcache_interval=k, **kw)
    np.testing.assert_allclose(got, np.asarray(want), atol=PIPE_ATOL)
    exact = pipe.generate(ids, unc, **kw)
    if k == 1:
        np.testing.assert_array_equal(got, exact)
    else:
        assert np.abs(got - exact).max() > 1e-2


def test_img2img_ddpm_deepcache_matches_jax(pipes):
    """img2img at batch 2, DDPM on the cosine schedule, strength 0.8 of 5
    steps (4 run), k = 2, on JAX's own draws (its encode, q-sample and
    per-step noise, rebuilt from the key splits)."""
    jpipe, pipe = pipes
    ids, unc = _ids(2)
    kw = dict(input_image=_image(0, 32), img_size=(32, 32), cfg_scale=5.0, strength=0.8,
              inference_steps=5, sampler="ddpm", use_cosine_schedule=True, seed=11,
              deepcache_interval=2)
    want = jpipe.generate("", batch_size=2, cond_ids=ids, uncond_ids=unc, **kw)
    got = pipe.generate(ids, unc, **_img2img_draws(11, 2, 4, 4), **kw)
    np.testing.assert_allclose(got, np.asarray(want), atol=PIPE_ATOL)


def test_inpaint_and_one_step_take_no_interval(pipes):
    """As in JAX: ``inpaint`` and ``generate_in_one_step`` have no DeepCache."""
    _, pipe = pipes
    with pytest.raises(TypeError):
        pipe.generate_in_one_step(_ids(1)[0], img_size=(32, 32), deepcache_interval=2)
    with pytest.raises(TypeError):
        pipe.inpaint(*_ids(1), _image(0, 32), np.zeros((32, 32), np.uint8), img_size=(32, 32),
                     deepcache_interval=2)
