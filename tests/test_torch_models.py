"""The PyTorch port's models against the JAX package (impl="xla"), on the CPU
in f32, at tiny widths, with the JAX-initialised parameters carried over by
the port's weight bridge.  Tolerance: 1e-4 absolute (f32; the two frameworks
sum in different orders through a few dozen layers)."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu_torch.models import clip as tclip
from stable_diffusion_tpu_torch.models import unet as tunet
from stable_diffusion_tpu_torch.models import vae as tvae
from stable_diffusion_tpu_torch.utils.weights import from_jax_params
from tests.torch_threads import one_thread  # noqa: F401

ATOL = 1e-4


def _load(module, jax_tree):
    module.load_state_dict(from_jax_params(jax_tree), strict=True)
    return module.eval()


def test_unet_matches_jax():
    kw = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
              cross_attention_dim=24, t_embed_dim=16)
    params = junet.init_unet(jax.random.key(0), junet.UNetConfig(**kw))
    model = _load(tunet.UNet(tunet.UNetConfig(**kw)), params)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4), dtype=np.float32)
    ctx = rng.standard_normal((2, 7, 24), dtype=np.float32)
    t = np.array([321], np.int32)
    want = np.asarray(jax.jit(
        lambda p, x, t, c: junet.unet_apply(p, x, t, c, junet.UNetConfig(**kw), impl="xla")
    )(params, x, t, ctx))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(ctx),
                    impl="torch").numpy()
    assert got.shape == want.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_text_model_matches_jax():
    kw = dict(hidden_size=24, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=8, vocab_size=64)
    for act in ("quick_gelu", "gelu"):
        params = jclip.init_text_model(jax.random.key(1), jclip.CLIPTextConfig(hidden_act=act, **kw))
        model = _load(tclip.CLIPTextModel(tclip.CLIPTextConfig(hidden_act=act, **kw)), params)
        ids = np.random.default_rng(1).integers(0, 64, (2, 8))
        want = np.asarray(jclip.text_model_apply(
            params, jnp.asarray(ids), jclip.CLIPTextConfig(hidden_act=act, **kw), impl="xla"))
        with torch.no_grad():
            got = model(torch.from_numpy(ids), impl="torch").numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_vae_decode_matches_jax():
    kw = dict(ch_mult=(1, 2), base_channels=32)
    params = jvae.init_vae(jax.random.key(2), jvae.VAEConfig(**kw))
    decode_half = {k: params[k] for k in ("decoder", "post_quant_conv")}
    model = _load(tvae.VAEDecoder(tvae.VAEConfig(**kw)), decode_half)
    z = np.random.default_rng(2).standard_normal((1, 8, 8, 4), dtype=np.float32) * 0.2
    want = np.asarray(jax.jit(
        lambda p, z: jvae.decode(p, z, jvae.VAEConfig(**kw), impl="xla"))(params, z))
    with torch.no_grad():
        got = model.decode(torch.from_numpy(z), impl="torch").numpy()
    assert got.shape == want.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)
