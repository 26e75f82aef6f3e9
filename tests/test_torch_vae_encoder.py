"""The port's VAE encoder against the JAX package's (impl="xla"), on the CPU
in f32, at ch_mult=(1, 2), base_channels=32, with the whole ``init_vae``
tree carried across strictly by the weight bridge.  Tolerance: 1e-4
absolute (f32 summed in another order through a few dozen layers)."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu.utils.torch_interop import flatten_tree
from stable_diffusion_tpu_torch.models import layers
from stable_diffusion_tpu_torch.models import vae as tvae
from stable_diffusion_tpu_torch.utils import weights as W

ATOL = 1e-4
KW = dict(ch_mult=(1, 2), base_channels=32)


@pytest.fixture(scope="module")
def tiny():
    params = jvae.init_vae(jax.random.key(2), jvae.VAEConfig(**KW))
    model = tvae.VAE(tvae.VAEConfig(**KW))
    model.load_state_dict(W.from_jax_params(params), strict=True)
    return params, model.eval()


def _image(seed, hw):
    return np.random.default_rng(seed).uniform(-1, 1, (2, hw, hw, 3)).astype(np.float32)


def test_vae_keys_and_shapes_are_jax_init_vae():
    tree = jax.eval_shape(lambda k: jvae.init_vae(k, jvae.VAEConfig()), jax.random.key(0))
    want = {k: tuple(v.shape) for k, v in flatten_tree(tree).items()}
    with torch.device("meta"):
        module = tvae.VAE(tvae.VAEConfig())
    assert W.jax_param_shapes(module) == want


def test_round_trip_tiny(tiny):
    params, model = tiny
    back, want = flatten_tree(W.to_jax_params(model)), flatten_tree(params)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("hw", [32, 64])
def test_encoder_apply_and_moments_match_jax(tiny, hw):
    params, model = tiny
    x = _image(hw, hw)
    cfg = jvae.VAEConfig(**KW)
    want = np.asarray(jax.jit(lambda p, x: jvae.encoder_apply(p["encoder"], x, cfg, impl="xla"))(
        params, x))
    want_m, want_s = jax.jit(lambda p, x: jvae.encode_moments(p, x, cfg, impl="xla"))(params, x)
    with torch.no_grad():
        got = model.encoder_apply(torch.from_numpy(x), impl="torch").numpy()
        got_m, got_s = model.encode_moments(torch.from_numpy(x), impl="torch")
    assert got.shape == want.shape == (2, hw // 2, hw // 2, 8)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=ATOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=ATOL)


def test_encode_with_noise_is_unscaled_and_matches_jax(tiny):
    params, model = tiny
    x = _image(3, 32)
    noise = np.random.default_rng(4).standard_normal((2, 16, 16, 4)).astype(np.float32)
    want = jax.jit(lambda p, x, n: jvae.encode(p, x, jvae.VAEConfig(**KW), noise=n, impl="xla"))(
        params, x, noise)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(x), noise=torch.from_numpy(noise), impl="torch")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    lat, mean, std = (t.numpy() for t in got)
    np.testing.assert_allclose(lat, mean + std * noise, rtol=1e-6, atol=1e-6)


def test_encode_without_noise_draws_and_scales(tiny):
    _, model = tiny
    x = torch.from_numpy(_image(5, 32))
    with torch.no_grad():
        lat, mean, std = model.encode(x, generator=torch.Generator().manual_seed(9), impl="torch")
    draw = torch.randn(std.shape, generator=torch.Generator().manual_seed(9))
    torch.testing.assert_close(lat, (mean + std * draw) * tvae.SD_LATENT_SCALE)
    assert tvae.SD_LATENT_SCALE == jvae.SD_LATENT_SCALE == 0.18215


def test_log_variance_is_clipped(tiny):
    model = copy.deepcopy(tiny[1])
    x = torch.from_numpy(_image(6, 32))
    with torch.no_grad():
        model.quant_conv.bias[4:] = 100.0  # the log-variance half
        _, std = model.encode_moments(x, impl="torch")
        model.quant_conv.bias[4:] = -100.0
        _, std_low = model.encode_moments(x, impl="torch")
    torch.testing.assert_close(std, torch.full_like(std, float(np.exp(10.0))))
    torch.testing.assert_close(std_low, torch.full_like(std_low, float(np.exp(-15.0))))


def test_downsampler_pads_bottom_and_right_only():
    """((0, 1), (0, 1)) then a stride-2 VALID conv, as JAX ``conv2d``."""
    from stable_diffusion_tpu.models import layers as jlayers

    conv = torch.nn.Conv2d(4, 6, 3)
    x = np.random.default_rng(7).standard_normal((1, 9, 8, 4)).astype(np.float32)
    jparams = {"kernel": conv.weight.detach().numpy().transpose(2, 3, 1, 0),
               "bias": conv.bias.detach().numpy()}
    want = np.asarray(jlayers.conv2d(jparams, jnp.asarray(x), stride=2, padding=((0, 1), (0, 1))))
    with torch.no_grad():
        got = layers.conv2d(conv, torch.from_numpy(x), stride=2, padding=((0, 1), (0, 1)))
        sym = layers.conv2d(conv, torch.from_numpy(x), stride=2, padding=1)
    assert got.shape == want.shape == (1, 4, 4, 6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.abs(sym.numpy()[:, :4, :4] - want).max() > 1e-2
