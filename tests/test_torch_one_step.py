"""SwiftBrush one-step generation of the port (``generate_in_one_step``)
against JAX ``_one_step_jit`` on the same parameters, latents and text
context (CPU, f32), and the port's batch rules: one lane a row of ids by
default, a larger batch cycles the rows (JAX ``_one_step_full_jit``'s
ceil-tile then slice), a smaller one raises."""

import numpy as np
import pytest
import jax
import torch

from stable_diffusion_tpu import pipeline as jpipe
from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig
from stable_diffusion_tpu_torch.models.unet import UNetConfig
from stable_diffusion_tpu_torch.models.vae import VAEConfig
from stable_diffusion_tpu_torch.pipeline import StableDiffusion
from stable_diffusion_tpu_torch.utils.weights import from_jax_params
from tests import torch_checkpoints as C
from tests.torch_threads import one_thread  # noqa: F401

TEXT = dict(C.TINY_TEXT, vocab_size=64)
IDS = (np.arange(2 * 77).reshape(2, 77) * 7) % 64


@pytest.fixture(scope="module")
def setup():
    ks = jax.random.split(jax.random.key(3), 3)
    ucfg, tcfg, vcfg = (junet.UNetConfig(**C.TINY_UNET), jclip.CLIPTextConfig(**TEXT),
                        jvae.VAEConfig(**C.TINY_VAE))
    params = {"unet": junet.init_unet(ks[0], ucfg), "text_encoder": jclip.init_text_model(ks[1], tcfg),
              "vae": jvae.init_vae(ks[2], vcfg)}
    pipe = StableDiffusion.build(UNetConfig(**C.TINY_UNET), CLIPTextConfig(**TEXT),
                                 VAEConfig(**C.TINY_VAE), device="cpu", impl="torch")
    for name in ("unet", "text_encoder", "vae"):
        getattr(pipe, name).load_state_dict(from_jax_params(params[name]), strict=True)
    return pipe, params, ucfg, vcfg


def _latents(b, seed=0):
    return np.random.default_rng(seed).standard_normal((b, 4, 4, 4), dtype=np.float32)


def test_one_step_equals_jax(setup):
    pipe, params, ucfg, vcfg = setup
    lat = _latents(2)
    with torch.no_grad():
        context = pipe.text_encoder(torch.as_tensor(IDS), impl="torch").numpy()
    want = jpipe._one_step_jit(params["unet"], params["vae"], lat, context, ucfg, vcfg, "xla")
    want = (np.asarray(want, np.float32) + 1.0) / 2.0
    got = pipe.generate_in_one_step(IDS, img_size=(32, 32), initial_latents=lat)
    assert got.shape == (2, 32, 32, 3) and got.dtype == np.float32
    assert float(np.abs(want - 0.5).max()) > 0.05  # not a flat image
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_uint8_and_seeded_latents(setup):
    pipe = setup[0]
    a = pipe.generate_in_one_step(IDS[:1], img_size=(32, 32), seed=4, output_dtype="uint8")
    b = pipe.generate_in_one_step(IDS[:1], img_size=(32, 32), seed=4, output_dtype="uint8")
    c = pipe.generate_in_one_step(IDS[:1], img_size=(32, 32), seed=5, output_dtype="uint8")
    assert a.dtype == np.uint8 and a.shape == (1, 32, 32, 3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    f = pipe.generate_in_one_step(IDS[:1], img_size=(32, 32), seed=4)
    np.testing.assert_array_equal(a, np.round(np.clip(f, 0, 1) * 255).astype(np.uint8))


@pytest.mark.parametrize("batch", [None, 2, 3, 5])
def test_a_larger_batch_cycles_the_rows(setup, batch):
    """Lane i takes row i % rows: each lane equals the one-row call on its
    row and its own latents (to f32 summation order, which moves with the
    batch and is amplified by 1 / alpha_T ~ 14.6)."""
    pipe = setup[0]
    b = 2 if batch is None else batch
    lat = _latents(b, seed=1)
    got = pipe.generate_in_one_step(IDS, img_size=(32, 32), batch_size=batch, initial_latents=lat)
    assert got.shape == (b, 32, 32, 3)
    for i in range(b):
        one = pipe.generate_in_one_step(IDS[i % 2:i % 2 + 1], img_size=(32, 32),
                                        initial_latents=lat[i:i + 1])
        np.testing.assert_allclose(got[i], one[0], atol=1e-4)


@pytest.mark.parametrize("batch", [1, 0])
def test_a_smaller_batch_raises(setup, batch):
    """An explicit batch below the rows raises, 1 included (no silent drop
    and no silent growth)."""
    with pytest.raises(ValueError, match="smaller than the 2 rows"):
        setup[0].generate_in_one_step(IDS, img_size=(32, 32), batch_size=batch)


def test_latents_of_another_shape_raise(setup):
    with pytest.raises(ValueError, match="initial_latents"):
        setup[0].generate_in_one_step(IDS, img_size=(32, 32), initial_latents=_latents(1))
