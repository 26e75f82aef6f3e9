"""``StableDiffusion.from_pretrained`` of the port against the JAX package's,
on one tiny diffusers directory and one LDM file (CPU, f32): equal
parameters and configs, and ``generate`` on the loaded pipeline reproduces
JAX's golden txt2img image (tests/golden/tiny_txt2img.npz, atol 1e-4, as
tests/test_torch_pipeline.py holds it).

The parameters are the golden's own (JAX ``init_*`` from key 42), written
out in diffusers and LDM naming by tests/torch_checkpoints.py."""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import torch

from stable_diffusion_tpu import pipeline as jpipe
from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu.utils.torch_interop import flatten_tree
from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig
from stable_diffusion_tpu_torch.models.unet import UNetConfig
from stable_diffusion_tpu_torch.models.vae import VAEConfig
from stable_diffusion_tpu_torch.pipeline import StableDiffusion, scheduler_config_for
from stable_diffusion_tpu_torch.tokenizer import load_tokenizer
from stable_diffusion_tpu_torch.utils.weights import from_jax_params, to_jax_params
from tests import torch_checkpoints as C
from tests.torch_threads import one_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_txt2img.npz")
TEXT = dict(C.TINY_TEXT, vocab_size=64)  # the golden's text tower
SCHED = {"_class_name": "PNDMScheduler", "num_train_timesteps": 1000, "beta_start": 0.00085,
         "beta_end": 0.012, "beta_schedule": "scaled_linear", "prediction_type": "epsilon"}
# config.json files as diffusers writes them: lists, and keys neither port reads
UNET_JSON = {"_class_name": "UNet2DConditionModel", "_diffusers_version": "0.21.0",
             "block_out_channels": [32, 64, 64, 64], "attention_head_dim": [2, 4, 4, 4],
             "cross_attention_dim": 24, "t_embed_dim": 16, "in_channels": 4, "out_channels": 4,
             "flip_sin_to_cos": True, "freq_shift": 0, "sample_size": 4,
             "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
             "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3}
TEXT_JSON = dict(TEXT, _name_or_path="tiny", architectures=["CLIPTextModel"], hidden_act="gelu",
                 model_type="clip_text_model", projection_dim=24)
VAE_JSON = {"_class_name": "AutoencoderKL", "_diffusers_version": "0.21.0", "in_channels": 3,
            "out_channels": 3, "latent_channels": 4, "block_out_channels": [32, 32, 32, 32],
            "layers_per_block": 2, "norm_num_groups": 32, "sample_size": 32}
SD15_UNET = {"_class_name": "UNet2DConditionModel", "attention_head_dim": 8, "cross_attention_dim": 768,
             "block_out_channels": [320, 640, 1280, 1280], "layers_per_block": 2,
             "norm_num_groups": 32, "norm_eps": 1e-05, "sample_size": 64, "flip_sin_to_cos": True}
SD21_UNET = {"_class_name": "UNet2DConditionModel", "_diffusers_version": "0.10.0.dev0",
             "attention_head_dim": [5, 10, 20, 20], "cross_attention_dim": 1024,
             "use_linear_projection": True, "block_out_channels": [320, 640, 1280, 1280],
             "sample_size": 96, "upcast_attention": True}
SD21_TEXT = {"_name_or_path": "hf-models/stable-diffusion-v2-768x768/text_encoder",
             "architectures": ["CLIPTextModel"], "hidden_act": "gelu", "hidden_size": 1024,
             "intermediate_size": 4096, "num_attention_heads": 16, "num_hidden_layers": 23,
             "vocab_size": 49408, "projection_dim": 512, "torch_dtype": "float32"}


@pytest.fixture(scope="module")
def jax_params():
    """The golden's parameters (tests/test_torch_pipeline.py ``_pipe``)."""
    ks = jax.random.split(jax.random.key(42), 3)
    return {"unet": junet.init_unet(ks[0], junet.UNetConfig(**C.TINY_UNET)),
            "text_encoder": jclip.init_text_model(ks[1], jclip.CLIPTextConfig(**TEXT)),
            "vae": jvae.init_vae(ks[2], jvae.VAEConfig(**C.TINY_VAE))}


@pytest.fixture(scope="module")
def states(jax_params):
    return {k: from_jax_params(v) for k, v in jax_params.items()}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, states):
    root = tmp_path_factory.mktemp("tiny_sd")
    C.write_diffusers_dir(str(root), states["unet"], states["text_encoder"], states["vae"],
                          unet_config=UNET_JSON, text_config=TEXT_JSON, vae_config=VAE_JSON,
                          scheduler_config=SCHED)
    C.write_vocab(str(root / "tokenizer"))
    return root


@pytest.fixture(scope="module")
def ldm_file(tmp_path_factory, states):
    path = tmp_path_factory.mktemp("ldm") / "v1-tiny.ckpt"
    torch.save({"state_dict": C.to_ldm(states["unet"], states["vae"], states["text_encoder"],
                                       version="1.5")}, str(path))
    return str(path)


def _same_fields(port_cfg, jax_cfg):
    """Every field of the port's config equals JAX's field of that name; the
    fields JAX lacks (SDXL's, which the JAX package does not build) hold
    their defaults, SD's."""
    for f in dataclasses.fields(port_cfg):
        want = getattr(jax_cfg, f.name) if hasattr(jax_cfg, f.name) else f.default
        assert getattr(port_cfg, f.name) == want, f.name


def _assert_params_equal(pipe, jax_tree):
    want = {k: np.asarray(v) for k, v in flatten_tree(jax_tree).items()}
    got = flatten_tree(to_jax_params(pipe))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_diffusers_dir_params_and_configs_equal_jax(model_dir, jax_params):
    jp = jpipe.StableDiffusion.from_pretrained(str(model_dir))
    pp = StableDiffusion.from_pretrained(str(model_dir), dtype=torch.float32, impl="torch",
                                         device="cpu")
    for name in ("unet", "text_encoder", "vae"):
        _assert_params_equal(getattr(pp, name), jp.params[name])
        _assert_params_equal(getattr(pp, name), jax_params[name])  # and the source's
    _same_fields(pp.unet.cfg, jp.unet_config)
    _same_fields(pp.text_encoder.cfg, jp.text_config)
    assert pp.vae.cfg == VAEConfig(**C.TINY_VAE)
    _same_fields(pp.vae.cfg, jp.vae_config)
    assert pp.scheduler_config == jp.scheduler_config == SCHED
    assert pp.device.type == "cpu" and pp.dtype == torch.float32


def test_generate_after_from_pretrained_reproduces_jax_golden(model_dir):
    """JAX's generate on these parameters is the golden: seed 123's starting
    noise (the second of three keys), CFG 5, DDIM 4 steps, 32^2."""
    pipe = StableDiffusion.from_pretrained(str(model_dir), dtype=torch.float32, impl="torch",
                                           device="cpu")
    _, key_lat, _ = jax.random.split(jax.random.key(123), 3)
    noise = np.asarray(jax.random.normal(key_lat, (1, 4, 4, 4), jax.numpy.float32))
    got = pipe.generate(np.arange(77)[None] % 64, np.zeros((1, 77), np.int64), img_size=(32, 32),
                        cfg_scale=5.0, inference_steps=4, initial_latents=noise)
    np.testing.assert_allclose(got, np.load(GOLDEN)["images"], atol=1e-4)


def test_ldm_file_params_and_configs_equal_jax(ldm_file, jax_params, monkeypatch):
    """A single file takes its configs from sd_version (full SD1.5 here, in
    both packages); the port's modules are built tiny for the load, the
    configs compared as the full-size ones it would build."""
    jp = jpipe.StableDiffusion.from_pretrained(ldm_file, sd_version="1.5")
    built = []

    def tiny(cls, sd_version="1.5", *, device="cuda", dtype=torch.float32, impl="auto"):
        built.append(sd_version)
        return cls.build(UNetConfig(**C.TINY_UNET), CLIPTextConfig(**TEXT), VAEConfig(**C.TINY_VAE),
                         device=device, dtype=dtype, impl=impl,
                         scheduler_config=scheduler_config_for(sd_version))

    monkeypatch.setattr(StableDiffusion, "for_version", classmethod(tiny))
    pp = StableDiffusion.from_pretrained(ldm_file, sd_version="1.5", dtype=torch.float32,
                                         impl="torch", device="cpu")
    assert built == ["1.5"]
    for name in ("unet", "text_encoder", "vae"):
        _assert_params_equal(getattr(pp, name), jp.params[name])
        _assert_params_equal(getattr(pp, name), jax_params[name])
    monkeypatch.undo()
    _same_fields(UNetConfig.sd15(), jp.unet_config)
    _same_fields(CLIPTextConfig.vit_l(), jp.text_config)
    _same_fields(VAEConfig(), jp.vae_config)
    assert pp.scheduler_config == jp.scheduler_config


@pytest.mark.parametrize("data", [SD15_UNET, SD21_UNET, UNET_JSON], ids=["sd15", "sd21", "tiny"])
def test_unet_config_from_dict_equals_jax(data):
    _same_fields(UNetConfig.from_dict(dict(data)), junet.UNetConfig.from_dict(dict(data)))


@pytest.mark.parametrize("data", [SD21_TEXT, TEXT_JSON], ids=["sd21", "tiny"])
def test_text_config_from_dict_equals_jax(data):
    _same_fields(CLIPTextConfig.from_dict(dict(data)), jclip.CLIPTextConfig.from_dict(dict(data)))


@pytest.mark.parametrize("data", [VAE_JSON, {"block_out_channels": [128, 256, 512, 512]}, {}],
                         ids=["tiny", "sd", "defaults"])
def test_vae_config_from_dict_equals_jax(data):
    _same_fields(VAEConfig.from_dict(data), jvae.VAEConfig.from_dict(data))


@pytest.mark.parametrize("bad", [{"layers_per_block": 1}, {"norm_num_groups": 16},
                                 {"block_out_channels": [32, 48]}],
                         ids=["layers_per_block", "norm_num_groups", "block_out_channels"])
def test_vae_config_from_dict_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        jvae.VAEConfig.from_dict(bad)
    with pytest.raises(ValueError, match=next(iter(bad))):
        VAEConfig.from_dict(bad)


def test_tokenize_pads_and_needs_a_tokenizer(model_dir):
    pipe = StableDiffusion.from_pretrained(str(model_dir), dtype=torch.float32, impl="torch",
                                           device="cpu",
                                           tokenizer=load_tokenizer(str(model_dir / "tokenizer")))
    ids = pipe.tokenize(["a photo of a cat", ""])
    tok = pipe.tokenizer
    assert ids.shape == (2, 77) and ids.dtype == np.int64
    assert ids[1, 0] == tok.bos_token_id and ids[1, 1] == tok.eos_token_id
    assert (ids[1, 2:] == tok.pad_token_id).all()
    pipe.tokenizer = None
    with pytest.raises(ValueError, match="no tokenizer"):
        pipe.tokenize(["a cat"])


def test_scheduler_config_is_optional(tmp_path, states):
    C.write_diffusers_dir(str(tmp_path), states["unet"], states["text_encoder"], states["vae"],
                          unet_config=UNET_JSON, text_config=TEXT_JSON, vae_config=VAE_JSON)
    assert not os.path.exists(tmp_path / "scheduler")
    pipe = StableDiffusion.from_pretrained(str(tmp_path), dtype=torch.float32, device="cpu")
    assert pipe.scheduler_config is None and pipe.make_schedule().prediction_type == "epsilon"
    json.loads((tmp_path / "unet" / "config.json").read_text())  # written as JSON
