"""The port's weight bridge against the JAX package's parameter trees.

``jax_param_shapes`` (computed without JAX, on meta-device modules) must list
exactly the keys and shapes of ``flatten_tree(jax.eval_shape(init_*))`` at
full SD1.5 width, and a tiny tree must survive JAX -> torch -> JAX exactly.
"""

import numpy as np
import jax
import pytest
import torch

from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu.utils.torch_interop import flatten_tree
from stable_diffusion_tpu_torch.models import clip as tclip
from stable_diffusion_tpu_torch.models import unet as tunet
from stable_diffusion_tpu_torch.models import vae as tvae
from stable_diffusion_tpu_torch.utils import weights as W
from tests.torch_threads import one_thread  # noqa: F401

_DECODE_HALF = ("decoder", "post_quant_conv")


def _meta(cls, cfg):
    with torch.device("meta"):
        return cls(cfg)


def _jax_shapes(init, cfg, keep=None):
    tree = jax.eval_shape(lambda k: init(k, cfg), jax.random.key(0))
    if keep is not None:
        tree = {k: tree[k] for k in keep}
    return {k: tuple(v.shape) for k, v in flatten_tree(tree).items()}


@pytest.mark.parametrize("which", ["unet_sd15", "clip_vit_l", "vae"])
def test_jax_param_shapes_full_size(which):
    if which == "unet_sd15":
        want = _jax_shapes(junet.init_unet, junet.UNetConfig.sd15())
        got = W.jax_param_shapes(_meta(tunet.UNet, tunet.UNetConfig.sd15()))
    elif which == "clip_vit_l":
        want = _jax_shapes(jclip.init_text_model, jclip.CLIPTextConfig.vit_l())
        got = W.jax_param_shapes(_meta(tclip.CLIPTextModel, tclip.CLIPTextConfig.vit_l()))
    else:  # the port has the decode half of the VAE
        want = _jax_shapes(jvae.init_vae, jvae.VAEConfig(), keep=_DECODE_HALF)
        got = W.jax_param_shapes(_meta(tvae.VAEDecoder, tvae.VAEConfig()))
    assert got == want


@pytest.mark.parametrize("which", ["unet", "clip", "vae"])
def test_round_trip_tiny(which):
    if which == "unet":
        kw = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
                  cross_attention_dim=24, t_embed_dim=16)
        tree = junet.init_unet(jax.random.key(3), junet.UNetConfig(**kw))
        module = tunet.UNet(tunet.UNetConfig(**kw))
    elif which == "clip":
        kw = dict(hidden_size=24, intermediate_size=48, num_hidden_layers=2,
                  num_attention_heads=4, max_position_embeddings=8, vocab_size=64)
        tree = jclip.init_text_model(jax.random.key(4), jclip.CLIPTextConfig(**kw))
        module = tclip.CLIPTextModel(tclip.CLIPTextConfig(**kw))
    else:
        kw = dict(ch_mult=(1, 2), base_channels=32)
        full = jvae.init_vae(jax.random.key(5), jvae.VAEConfig(**kw))
        tree = {k: full[k] for k in _DECODE_HALF}
        module = tvae.VAEDecoder(tvae.VAEConfig(**kw))
    module.load_state_dict(W.from_jax_params(tree), strict=True)
    back = flatten_tree(W.to_jax_params(module))
    want = flatten_tree(tree)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], np.asarray(want[k]), err_msg=k)


def test_layout_rules():
    sd = W.from_jax_params({
        "conv": {"kernel": np.zeros((3, 3, 2, 5), np.float32), "bias": np.zeros(5, np.float32)},
        "lin": {"kernel": np.zeros((2, 7), np.float32)},
        "norm": {"scale": np.zeros(4, np.float32)},
        "token_embedding": {"embedding": np.zeros((9, 4), np.float32)},
    })
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        "conv.weight": (5, 2, 3, 3), "conv.bias": (5,), "lin.weight": (7, 2),
        "norm.weight": (4,), "token_embedding.weight": (9, 4)}


def test_philox_params_follow_sorted_jax_keys():
    module = _meta(tvae.VAEDecoder, tvae.VAEConfig(ch_mult=(1,), base_channels=32))
    got = W.philox_jax_params(module, seed=7)
    keys = sorted(W.jax_param_shapes(module))
    assert list(got) == keys
    rng = np.random.Generator(np.random.Philox(7))
    first = rng.standard_normal(got[keys[0]].shape, dtype=np.float32) * 0.02
    np.testing.assert_array_equal(got[keys[0]], first)
