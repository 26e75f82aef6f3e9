"""The port's checkpoint converter (stable_diffusion_tpu_torch/utils/
model_converter.py) equals the JAX package's value for value, in f32, on
synthesized diffusers and LDM files whose every tensor has distinct elements
(tests/torch_checkpoints.py): a swapped pairing of two same-shaped tensors,
a transpose or a wrong third of a fused in_proj shows in the values.

The synthesized files are written by hand-made inverse maps; the JAX
package's strict converters judge them first: they must consume every key
and give exactly the key set and shapes of ``init_unet`` / ``init_vae`` /
``init_text_model``.  Then ``to_jax_params`` of the port's loaded module
must equal the JAX loader's tree exactly."""

import numpy as np
import pytest
import jax
import torch

from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu.utils import model_converter as jmc
from stable_diffusion_tpu.utils.torch_interop import flatten_tree, from_torch_state_dict
from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
from stable_diffusion_tpu_torch.models.vae import VAE, VAEConfig
from stable_diffusion_tpu_torch.utils import model_converter as mc
from stable_diffusion_tpu_torch.utils import safetensors_io
from stable_diffusion_tpu_torch.utils.weights import build, to_jax_params
from tests import torch_checkpoints as C
from tests.torch_threads import one_thread  # noqa: F401

MODELS = {
    "unet": (UNet, UNetConfig(**C.TINY_UNET), lambda k: junet.init_unet(k, junet.UNetConfig(**C.TINY_UNET))),
    "vae": (VAE, VAEConfig(**C.TINY_VAE), lambda k: jvae.init_vae(k, jvae.VAEConfig(**C.TINY_VAE))),
    "text_encoder": (CLIPTextModel, CLIPTextConfig(**C.TINY_TEXT),
                     lambda k: jclip.init_text_model(k, jclip.CLIPTextConfig(**C.TINY_TEXT))),
}


def _module(name, dtype=torch.float32):
    cls, cfg, _ = MODELS[name]
    return build(cls, cfg, device="cpu", dtype=dtype)


@pytest.fixture(scope="module")
def states():
    """Distinct-element state dicts of the three tiny port modules."""
    return {name: C.distinct(_module(name).state_dict()) for name in MODELS}


@pytest.fixture(scope="module")
def init_shapes():
    """{model: {flat JAX key: shape}} of the JAX package's own init trees."""
    out = {}
    for name, (_, _, init) in MODELS.items():
        tree = jax.eval_shape(init, jax.random.key(0))
        out[name] = {k: tuple(v.shape) for k, v in flatten_tree(tree).items()}
    return out


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _assert_trees_equal(got, want):
    got, want = _flat_np(got), _flat_np(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _judge(tree, shapes):
    """The JAX converter's output has the init tree's keys and shapes."""
    assert {k: tuple(np.shape(v)) for k, v in flatten_tree(tree).items()} == shapes


def _save(flat, path):
    """Through the ``safetensors`` package (the JAX loaders' reader)."""
    from safetensors.torch import save_file

    save_file({k: v.contiguous() for k, v in flat.items()}, str(path))
    return str(path)


def _port(name, state):
    return to_jax_params(mc.load_into(_module(name), state))


@pytest.mark.parametrize("linear_proj", [False, True], ids=["sd15_conv_proj", "sd21_linear_proj"])
def test_diffusers_unet_equals_jax(states, init_shapes, tmp_path, linear_proj):
    src = C.to_diffusers_unet(states["unet"], linear_proj=linear_proj)
    assert any(v.dim() == (2 if linear_proj else 4) for k, v in src.items() if "proj_in.weight" in k)
    path = _save(src, tmp_path / "unet.safetensors")
    want = jmc.load_unet_diffusers(path)
    _judge(want, init_shapes["unet"])
    _assert_trees_equal(_port("unet", mc.load_unet_diffusers(path)), want)


@pytest.mark.parametrize("swiftbrush", [False, True], ids=["stock_naming", "to_qkv_naming"])
def test_diffusers_vae_equals_jax(states, init_shapes, tmp_path, swiftbrush):
    path = _save(C.to_diffusers_vae(states["vae"], swiftbrush=swiftbrush), tmp_path / "vae.safetensors")
    want = jmc.load_vae_diffusers(path)
    _judge(want, init_shapes["vae"])
    _assert_trees_equal(_port("vae", mc.load_vae_diffusers(path)), want)


def test_diffusers_text_encoder_equals_jax(states, init_shapes, tmp_path):
    src = C.to_diffusers_text(states["text_encoder"])
    assert "text_model.embeddings.position_ids" in src
    path = _save(src, tmp_path / "model.safetensors")
    want = jmc.load_text_encoder_diffusers(path)
    _judge(want, init_shapes["text_encoder"])
    _assert_trees_equal(_port("text_encoder", mc.load_text_encoder_diffusers(path)), want)


@pytest.mark.parametrize("version", ["1.5", "2.1"])
def test_ldm_checkpoint_equals_jax(states, init_shapes, tmp_path, version):
    flat = C.to_ldm(states["unet"], states["vae"], states["text_encoder"], version=version)
    if version == "2.1":
        assert any("in_proj_weight" in k for k in flat)
    path = str(tmp_path / "model.ckpt")
    torch.save({"state_dict": flat}, path)
    want = jmc.load_ldm_checkpoint(path, sd_version=version)
    got = mc.load_ldm_checkpoint(path)
    for name in MODELS:
        _judge(want[name], init_shapes[name])
        _assert_trees_equal(_port(name, got[name]), want[name])


def test_ldm_safetensors_file_equals_the_ckpt(states, tmp_path):
    """read_checkpoint takes an LDM .safetensors through the port's reader."""
    flat = C.to_ldm(states["unet"], states["vae"], states["text_encoder"], version="1.5")
    path = _save(flat, tmp_path / "model.safetensors")
    want = jmc.convert_ldm_checkpoint(jmc.read_checkpoint(path))
    got = mc.load_ldm_checkpoint(path)
    for name in MODELS:
        _assert_trees_equal(_port(name, got[name]), from_torch_state_dict(want[name]))


def test_unmatched_keys_raise_in_both(states, tmp_path):
    src = C.to_diffusers_unet(states["unet"])
    src["down_blocks.0.mystery.weight"] = torch.zeros(2)
    path = _save(src, tmp_path / "unet.safetensors")
    with pytest.raises(KeyError, match="unmatched"):
        jmc.load_unet_diffusers(path)
    with pytest.raises(KeyError, match="unmatched"):
        mc.load_unet_diffusers(path)
    flat = C.to_ldm(states["unet"], states["vae"], states["text_encoder"], version="1.5")
    flat["model.diffusion_model.extra_block.weight"] = torch.zeros(2)
    with pytest.raises(KeyError, match="unmatched LDM"):
        jmc.convert_ldm_checkpoint({k: v.numpy() for k, v in flat.items()})
    with pytest.raises(KeyError, match="unmatched LDM"):
        mc.convert_ldm_checkpoint(flat)


@pytest.mark.parametrize("name", list(MODELS))
def test_port_load_refuses_extra_and_missing_keys(states, name):
    """The VAE and text loaders rename by a catch-all, so their strictness
    is the module's: ``load_into`` raises on a key too many or too few."""
    state = dict(states[name])
    with pytest.raises(RuntimeError, match="Unexpected"):
        mc.load_into(_module(name), {**state, "extra.weight": torch.zeros(1)})
    state.pop(next(iter(state)))
    with pytest.raises(RuntimeError, match="Missing"):
        mc.load_into(_module(name), state)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_files_load_bit_for_bit_into_bf16(states, tmp_path, dtype):
    """An f16 (or bf16) file loads into a bf16 module as ``tensor.to(bf16)``
    of the file's tensors, bit for bit; the port's reader hands BF16 on as
    bfloat16, never through f16."""
    src = {k: v.to(dtype) for k, v in C.to_diffusers_text(states["text_encoder"]).items()
           if v.is_floating_point()}
    path = str(tmp_path / "half.safetensors")
    safetensors_io.save_file(src, path)
    read = safetensors_io.load_file(path)
    assert all(read[k].dtype == dtype and torch.equal(read[k], src[k]) for k in src)
    mod = mc.load_into(_module("text_encoder", torch.bfloat16), mc.convert_text_encoder_diffusers(read))
    got = mod.state_dict()
    for k, v in src.items():
        assert torch.equal(got[k.removeprefix("text_model.")], v.to(torch.bfloat16)), k


def test_reshape_helpers():
    w2 = torch.arange(6.0).reshape(2, 3)
    assert mc._as_conv1x1(w2).shape == (2, 3, 1, 1) and mc._as_conv1x1(w2[:, :, None, None]).dim() == 4
    assert torch.equal(mc._squeeze_conv(w2[:, :, None, None]), w2)
    fused = torch.arange(12.0).reshape(6, 2)
    assert [mc._chunk3(i)(fused).tolist() for i in range(3)] == [
        np.split(fused.numpy(), 3)[i].tolist() for i in range(3)]
