"""The port's Gradio demo (demo/app_torch.py) on the CPU, through the
recording stand-in for gradio (tests/gradio_stub.py), as
tests/test_demo_app.py drives the JAX demo.

The graph, handlers, signatures, control defaults and ``IMG_SIZE`` must be
demo/app.py's.  The handlers run through the recorded click events with a
gr.Progress on a tiny diffusers directory (JAX-initialised weights, a
synthesized CLIP vocabulary and a kohya LoRA, tests/torch_checkpoints.py)
loaded by ``initialize_model(..., device="cpu")`` in f32, at 64x64: the
progress bar ends at 1.0 and the txt2img image is the one-call request's
(no DeepCache: the segments change nothing).  ``--device cuda`` on a
machine without a card raises before any load.
"""

import importlib
import inspect
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
from stable_diffusion_tpu_torch.utils import safetensors_io
from stable_diffusion_tpu_torch.utils.weights import build, from_jax_params
from tests import gradio_stub
from tests import torch_checkpoints as C
from tests.torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET_JSON = dict(C.TINY_UNET, block_out_channels=[32, 64, 64, 64], attention_head_dim=[2, 4, 4, 4])
VAE_JSON = {"block_out_channels": [32, 32, 32, 32], "latent_channels": 4}
HANDLERS = ("txt2img", "img2img", "inpaint")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_demo")
    ks = jax.random.split(jax.random.key(3), 3)
    params = {"unet": junet.init_unet(ks[0], junet.UNetConfig(**C.TINY_UNET)),
              "text_encoder": jclip.init_text_model(ks[1], jclip.CLIPTextConfig(**C.TINY_TEXT)),
              "vae": jvae.init_vae(ks[2], jvae.VAEConfig(**C.TINY_VAE))}
    states = {k: from_jax_params(v) for k, v in params.items()}
    C.write_diffusers_dir(str(root), states["unet"], states["text_encoder"], states["vae"],
                          unet_config=UNET_JSON, text_config=C.TINY_TEXT, vae_config=VAE_JSON)
    C.write_vocab(str(root / "tokenizer"))
    modules = {"unet": build(UNet, UNetConfig(**C.TINY_UNET), device="meta"),
               "text_encoder": build(CLIPTextModel, CLIPTextConfig(**C.TINY_TEXT), device="meta")}
    paths = {"unet": ["encoder.down.0.block.0.1.transformer_block.attn1.q_proj"],
             "text_encoder": ["encoder.layers.0.mlp.fc1"]}
    safetensors_io.save_file(C.kohya_state(modules, paths, rank=4, alpha=2.0, seed=1),
                             str(root / "lora.safetensors"))
    return root


def _apps():
    return importlib.import_module("demo.app"), importlib.import_module("demo.app_torch")


@pytest.fixture
def demo(monkeypatch, model_dir):
    """The port's demo built on the stub, its model the tiny directory at 64x64."""
    monkeypatch.setitem(sys.modules, "gradio", gradio_stub)
    app = importlib.import_module("demo.app_torch")
    monkeypatch.setitem(app.MODEL, "pipe", None)
    pipe, _ = app.initialize_model(str(model_dir), str(model_dir / "tokenizer"), device="cpu")
    monkeypatch.setattr(app, "IMG_SIZE", (64, 64))
    return app, pipe, {e["tab"]: e for e in app.build_demo().events}


def test_demo_imports_neither_jax_torch_nor_gradio():
    code = ("import sys; import demo.app_torch as a; "
            "bad = [m for m in ('jax', 'torch', 'gradio', 'transformers', 'stable_diffusion_tpu') "
            "if m in sys.modules]; assert not bad, bad; "
            "assert all(callable(getattr(a, f)) for f in "
            "('txt2img', 'img2img', 'inpaint', 'initialize_model', 'build_demo'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_handlers_and_defaults_are_the_jax_demo_s():
    jax_app, app = _apps()
    for name in (*HANDLERS, "_progress_cb"):
        assert inspect.signature(getattr(app, name)) == inspect.signature(getattr(jax_app, name))
    assert app.IMG_SIZE == jax_app.IMG_SIZE
    params = inspect.signature(app.initialize_model).parameters
    assert list(params)[:4] == list(inspect.signature(jax_app.initialize_model).parameters)
    assert params["device"].default == "cuda"


def test_blocks_graph_is_the_jax_demo_s(monkeypatch):
    """The same tabs, components (types, labels and arguments, the title
    aside) and click wiring as demo/app.py."""
    monkeypatch.setitem(sys.modules, "gradio", gradio_stub)
    apps = _apps()
    graphs = [a.build_demo() for a in apps]

    def comps(d):
        return [(type(c).__name__, c.tab, c.label, c.args, c.kwargs) for c in d.components
                if type(c).__name__ != "Markdown"]

    def events(d):
        return [(e["tab"], [type(c).__name__ for c in e["inputs"]],
                 [type(c).__name__ for c in e["outputs"]]) for e in d.events]

    assert graphs[1].queued and graphs[1].tabs == ["txt2img", "img2img", "inpaint"]
    assert comps(graphs[1]) == comps(graphs[0])
    assert events(graphs[1]) == events(graphs[0])
    for e in graphs[1].events:
        params = [p for p in inspect.signature(getattr(apps[1], e["tab"])).parameters
                  if p != "progress"]
        assert len(e["inputs"]) == len(params)


def test_txt2img_handler_through_event(demo):
    """b2 DDIM with gr.Progress in segments: the bar ends at 1.0, and the
    images are the one-call request's."""
    app, pipe, events = demo
    progress = gradio_stub.Progress()
    out = events["txt2img"]["fn"]("a photo of a cat", "", 2, False, 7.5, 0.8, 7, "ddim",
                                  progress=progress)
    assert len(out) == 2 and all(o.size == (64, 64) and o.mode == "RGB" for o in out)
    fracs = [f for f, _ in progress.calls]
    assert fracs[0] == 0.0 and fracs[-1] == pytest.approx(1.0) and len(fracs) == 3
    want = pipe.generate(prompt="a photo of a cat", batch_size=2, inference_steps=7,
                         sampler="ddim", img_size=(64, 64), cfg_scale=7.5)
    np.testing.assert_array_equal(np.stack([np.asarray(o) for o in out]),
                                  (np.clip(want, 0, 1) * 255).round().astype(np.uint8))


def test_img2img_handler_through_event(demo):
    from PIL import Image

    _, _, events = demo
    src = Image.fromarray(np.random.default_rng(0).integers(0, 256, (64, 64, 3)).astype(np.uint8))
    progress = gradio_stub.Progress()
    out = events["img2img"]["fn"](src, "a photo", "blurry", 1, True, 7.5, 0.8, 5, "ddpm",
                                  progress=progress)
    assert len(out) == 1 and out[0].size == (64, 64)
    assert progress.calls[-1][0] == pytest.approx(1.0)


def test_inpaint_handler_through_event(demo):
    """gr.ImageMask's {background, layers} payload; one request a sample."""
    from PIL import Image

    _, _, events = demo
    base = Image.fromarray(np.full((64, 64, 3), 100, np.uint8))
    mask_rgba = np.zeros((64, 64, 4), np.uint8)
    mask_rgba[16:48, 16:48, 3] = 255
    payload = {"background": base, "layers": [Image.fromarray(mask_rgba, "RGBA")]}
    progress = gradio_stub.Progress()
    out = events["inpaint"]["fn"](payload, "a photo", "", 2, False, 7.5, 0.8, 5, "ddim",
                                  progress=progress)
    assert len(out) == 2 and out[0].size == (64, 64)
    assert [f for f, _ in progress.calls].count(pytest.approx(1.0)) == 2


def test_initialize_model_on_the_cpu_and_refusals(model_dir):
    """f32 plain versions on ``cpu`` with the LoRA merged at load; ``cuda``
    without a card raises before anything loads."""
    app = importlib.import_module("demo.app_torch")
    base, tok = app.initialize_model(str(model_dir), str(model_dir / "tokenizer"), device="cpu")
    assert base.dtype == torch.float32 and base.device.type == "cpu" and base.impl == "torch"
    assert tok is base.tokenizer and app.MODEL["pipe"] is base
    merged, _ = app.initialize_model(str(model_dir), str(model_dir / "tokenizer"),
                                     lora_ckpt=str(model_dir / "lora.safetensors"), device="cpu")
    q = "encoder.down.0.block.0.1.transformer_block.attn1.q_proj.weight"
    assert not torch.equal(merged.unet.state_dict()[q], base.unet.state_dict()[q])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            app.initialize_model(str(model_dir / "missing"), "", device="cuda")
