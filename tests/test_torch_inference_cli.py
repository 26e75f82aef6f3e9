"""The port's inference CLI (inference_torch.py) on the CPU, on a tiny
diffusers directory with a synthesized CLIP vocabulary: txt2img (DDPM and
DDIM with CFG), img2img, one-step and a kohya --lora_ckpt, each writing
img_{i}_{j}.jpg for ceil(n_samples / batch_size) requests of batch_size
lanes as inference.py does; the merged weights equal the JAX package's
``merge_lora`` of its own kohya loader; the flags are inference.py's; and
the card's refusals come before any load."""

import json
import os

import numpy as np
import pytest
import jax
import torch

import inference as jax_cli
import inference_torch as cli
from stable_diffusion_tpu import pipeline as jpipe
from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.models import lora as jlora
from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu.utils import model_converter as jmc
from stable_diffusion_tpu.utils.torch_interop import flatten_tree
from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
from stable_diffusion_tpu_torch.utils import safetensors_io
from stable_diffusion_tpu_torch.utils.device import SPANS
from stable_diffusion_tpu_torch.utils.weights import build, from_jax_params, to_jax_params
from tests import torch_checkpoints as C
from tests.torch_threads import one_thread  # noqa: F401

UNET_JSON = dict(C.TINY_UNET, block_out_channels=[32, 64, 64, 64], attention_head_dim=[2, 4, 4, 4])
VAE_JSON = {"block_out_channels": [32, 32, 32, 32], "latent_channels": 4}
LORA_PATHS = {
    "unet": ["encoder.down.0.block.0.1.transformer_block.attn1.q_proj",
             "encoder.down.1.block.1.1.transformer_block.ffn.0.proj",
             "bottleneck.1.conv_input", "decoder.up.1.block.2.1.transformer_block.attn2.out_proj",
             "decoder.up.3.block.0.1.conv_output"],
    "text_encoder": ["encoder.layers.0.self_attn.k_proj", "encoder.layers.1.mlp.fc2"],
}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_cli")
    ks = jax.random.split(jax.random.key(0), 3)
    params = {"unet": junet.init_unet(ks[0], junet.UNetConfig(**C.TINY_UNET)),
              "text_encoder": jclip.init_text_model(ks[1], jclip.CLIPTextConfig(**C.TINY_TEXT)),
              "vae": jvae.init_vae(ks[2], jvae.VAEConfig(**C.TINY_VAE))}
    states = {k: from_jax_params(v) for k, v in params.items()}
    C.write_diffusers_dir(str(root), states["unet"], states["text_encoder"], states["vae"],
                          unet_config=UNET_JSON, text_config=C.TINY_TEXT, vae_config=VAE_JSON,
                          scheduler_config={"prediction_type": "epsilon"})
    C.write_vocab(str(root / "tokenizer"))
    modules = {"unet": build(UNet, UNetConfig(**C.TINY_UNET), device="meta"),
               "text_encoder": build(CLIPTextModel, CLIPTextConfig(**C.TINY_TEXT), device="meta")}
    kohya = C.kohya_state(modules, LORA_PATHS, rank=4, alpha=2.0, seed=9)
    safetensors_io.save_file(kohya, str(root / "lora.safetensors"))
    # SD2.1's files hold proj_in / proj_out as rank-2 linears
    safetensors_io.save_file({k: (v[:, :, 0, 0] if v.dim() == 4 else v) for k, v in kohya.items()},
                             str(root / "lora_linear_proj.safetensors"))
    return root


def _argv(model_dir, out, *extra):
    return ["--model_path", str(model_dir), "--tokenizer_dir", str(model_dir / "tokenizer"),
            "--prompt", "a photo of a cat", "--device", "cpu", "--dtype", "float32",
            "--img_size", "32", "--num_inference_steps", "2", "--output_dir", str(out), *extra]


def _files(out, arrays, requests, batch):
    from PIL import Image

    names = sorted(os.listdir(out))
    assert names == sorted(f"img_{i}_{j}.jpg" for i in range(requests) for j in range(batch))
    assert len(arrays) == requests * batch
    for a in arrays:
        assert a.shape == (32, 32, 3) and a.dtype == np.uint8 and a.max() > a.min()
    for n in names:
        assert np.asarray(Image.open(out / n)).shape == (32, 32, 3)


@pytest.mark.parametrize("extra,requests,batch", [
    ((), 3, 1),                                                         # the defaults: DDPM, no CFG
    (("--sampler", "ddim", "--do_cfg", "--cfg_scale", "7.5", "--batch_size", "2"), 2, 2),
    (("--one_step",), 3, 1),
    (("--one_step", "--batch_size", "2", "--n_samples", "4"), 2, 2),
], ids=["ddpm_default", "ddim_cfg_b2", "one_step", "one_step_b2"])
def test_cli_writes_n_samples_images(model_dir, tmp_path, extra, requests, batch):
    out = tmp_path / "out"
    arrays = cli.main(_argv(model_dir, out, "--seed", "3", *extra))
    _files(out, arrays, requests, batch)
    assert not all(np.array_equal(arrays[0], a) for a in arrays[1:])  # seeds (seed or 0) + i


def test_cli_img2img(model_dir, tmp_path):
    from PIL import Image

    img = (np.random.default_rng(0).random((40, 48, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "in.png")
    out = tmp_path / "out"
    arrays = cli.main(_argv(model_dir, out, "--img_path", str(tmp_path / "in.png"), "--strength",
                            "0.5", "--n_samples", "1", "--num_inference_steps", "4"))
    _files(out, arrays, 1, 1)


@pytest.mark.parametrize("name", ["lora", "lora_linear_proj"])
def test_kohya_lora_merges_to_jax_weights(model_dir, tmp_path, name):
    lora_file = str(model_dir / f"{name}.safetensors")
    args = cli.parse_args(_argv(model_dir, tmp_path, "--lora_ckpt", lora_file))
    merged = cli.load_model(args)
    base = cli.load_model(cli.parse_args(_argv(model_dir, tmp_path)))
    jp = jpipe.StableDiffusion.from_pretrained(str(model_dir))
    jl = jmc.load_lora_kohya(lora_file)
    for target in ("unet", "text_encoder"):
        want = flatten_tree(jlora.merge_lora(jp.params[target], jl[target]))
        got = flatten_tree(to_jax_params(getattr(merged, target)))
        unchanged = flatten_tree(to_jax_params(getattr(base, target)))
        assert sorted(got) == sorted(want)
        moved = [k for k in want if not np.array_equal(got[k], unchanged[k])]
        assert sorted(moved) == sorted(f"{p}.kernel" for p in LORA_PATHS[target])
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    out = tmp_path / "out"
    _files(out, cli.main(_argv(model_dir, out, "--lora_ckpt", lora_file, "--n_samples", "1")), 1, 1)


def test_training_checkpoint_lora_waits_for_the_trainer(model_dir, tmp_path):
    """The trainer is ported (train_lora_dreambooth_torch.py; its .ckpt
    checkpoints load, tests/test_torch_train_cli.py): a .ckpt is read as one
    (a missing file raises FileNotFoundError, not NotImplementedError), and
    the JAX trainer's msgpack and orbax checkpoints raise ValueError naming
    their format, before the model loads."""
    with pytest.raises(FileNotFoundError):
        cli.load_model(cli.parse_args(_argv(model_dir, tmp_path, "--lora_ckpt", "run/step.ckpt")))
    for path, kind in (("run/epoch-0.msgpack", "msgpack"), ("run/epoch-0.orbax", "orbax")):
        with pytest.raises(ValueError, match=kind):
            cli.load_model(cli.parse_args(["--model_path", str(tmp_path / "absent"), "--device",
                                           "cpu", "--lora_ckpt", path]))


def test_unknown_inputs_raise(model_dir, tmp_path):
    """Where inference.py goes on without them, the port refuses: a missing
    --img_path, a --lora_ckpt of no known kind."""
    with pytest.raises(FileNotFoundError, match="img_path"):
        cli.main(_argv(model_dir, tmp_path, "--img_path", str(tmp_path / "absent.png")))
    with pytest.raises(ValueError, match="kohya .safetensors"):
        cli.load_model(cli.parse_args(_argv(model_dir, tmp_path, "--lora_ckpt", "lora.bin")))


def test_f32_on_the_card_is_refused_before_any_load(tmp_path):
    with pytest.raises(ValueError, match="bfloat16"):
        cli.main(["--model_path", str(tmp_path / "absent"), "--device", "cuda", "--dtype", "float32",
                  "--img_path", str(tmp_path / "absent.png")])


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--model_path", str(tmp_path / "absent")])


def test_a_prompt_needs_a_tokenizer(model_dir, tmp_path):
    argv = [a for a in _argv(model_dir, tmp_path) if a not in ("--tokenizer_dir",
                                                               str(model_dir / "tokenizer"))]
    with pytest.raises(ValueError, match="no tokenizer"):
        cli.main(argv)


def test_profile_dir_writes_a_trace(model_dir, tmp_path):
    """The trace holds the port's spans, recorded only while it is taken."""
    cli.main(_argv(model_dir, tmp_path / "out", "--one_step", "--n_samples", "1",
                   "--profile_dir", str(tmp_path / "prof")))
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"sd.text", "sd.denoise_step", "sd.unet", "sd.vae_decode", "sd.to_host"} <= names
    assert SPANS.calls is None


def test_flags_and_defaults_are_inference_py_s():
    ours, theirs = cli.build_parser(), jax_cli.build_parser()
    opts = lambda p: {a.dest: (tuple(a.option_strings), a.default, a.choices)  # noqa: E731
                      for a in p._actions if a.dest != "help"}
    want = opts(theirs)
    want["device"] = (("--device",), "cuda", None)  # honoured here; the JAX CLI ignores it
    assert opts(ours) == want
