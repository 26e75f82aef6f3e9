"""Gradio demo on the PyTorch port: txt2img / img2img / inpaint tabs.

    python demo/app_torch.py --model_path DIR_OR_FILE --tokenizer_dir DIR [--device cuda]

The same demo as ``demo/app.py`` (the same handlers, signatures, tabs,
controls and defaults, ``IMG_SIZE``, and gr.Progress wired to the denoise
loop through the pipeline's ``progress_callback``), on
``stable_diffusion_tpu_torch``.  It differs in three ways:

  * ``initialize_model`` loads through ``inference_torch.load_model``:
    ``StableDiffusion.from_pretrained`` (a diffusers directory or a single
    LDM file), the port's tokenizer (``tokenizer.load_tokenizer``; no
    ``transformers``), and a kohya LoRA (or a training checkpoint of
    ``train_lora_dreambooth_torch.py``) merged at load;
  * ``--device``: ``cuda`` (the default) runs the hand-written kernels in
    bf16 and raises on a machine without a card; ``cpu`` runs the plain
    versions in f32;
  * nothing of JAX: importing this module imports numpy alone; torch, the
    port and gradio are imported where they are used (gradio lazily in
    ``build_demo``, with a clear error where it is absent).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

MODEL = {"pipe": None}

# Output resolution for all three tabs (the reference demo is fixed 512x512).
# Module-level so tests can drive the real handlers on a tiny model at low
# resolution.
IMG_SIZE = (512, 512)


def initialize_model(model_path: str, tokenizer_dir: str, sd_version: str = "1.5",
                     lora_ckpt: str = "", device: str = "cuda"):
    """Load the pipeline (bf16 on ``cuda``, f32 on ``cpu``) and its tokenizer
    into ``MODEL``; returns (pipe, tokenizer)."""
    import inference_torch

    args = inference_torch.parse_args([
        "--model_path", model_path, "--tokenizer_dir", tokenizer_dir, "--sd_version", sd_version,
        "--lora_ckpt", lora_ckpt, "--device", device,
        "--dtype", "float32" if device == "cpu" else "bfloat16"])
    pipe = inference_torch.load_model(args)
    MODEL["pipe"] = pipe
    return pipe, pipe.tokenizer


def _progress_cb(progress):
    """gr.Progress (or None) -> pipeline progress_callback."""
    if progress is None:
        return None
    return lambda done, total: progress(done / total, desc=f"denoising {done}/{total}")


def _to_pil(imgs01):
    from PIL import Image

    return [
        Image.fromarray((np.clip(img, 0, 1) * 255).round().astype(np.uint8)) for img in imgs01
    ]


def txt2img(prompt, uncond_prompt, n_samples, use_cosine, cfg_scale, strength,
            inference_steps, sampler, progress=None):
    pipe = MODEL["pipe"]
    imgs = pipe.generate(
        prompt=prompt, uncond_prompt=uncond_prompt, do_cfg=True,
        cfg_scale=float(cfg_scale), strength=float(strength),
        inference_steps=int(inference_steps), sampler=sampler,
        use_cosine_schedule=bool(use_cosine), batch_size=int(n_samples),
        img_size=IMG_SIZE, progress_callback=_progress_cb(progress),
    )
    return _to_pil(imgs)


def img2img(input_image, prompt, uncond_prompt, n_samples, use_cosine, cfg_scale,
            strength, inference_steps, sampler, progress=None):
    pipe = MODEL["pipe"]
    imgs = pipe.generate(
        prompt=prompt, uncond_prompt=uncond_prompt, input_image=input_image,
        do_cfg=True, cfg_scale=float(cfg_scale), strength=float(strength),
        inference_steps=int(inference_steps), sampler=sampler,
        use_cosine_schedule=bool(use_cosine), batch_size=int(n_samples),
        img_size=IMG_SIZE, progress_callback=_progress_cb(progress),
    )
    return _to_pil(imgs)


def inpaint(input_images, prompt, uncond_prompt, n_samples, use_cosine, cfg_scale,
            strength, inference_steps, sampler, progress=None):
    from PIL import Image

    pipe = MODEL["pipe"]
    # gr.ImageMask delivers {"background": PIL, "layers": [PIL mask]}
    base = input_images["background"]
    layer = input_images["layers"][0] if input_images.get("layers") else None
    mask = (
        layer.split()[-1] if layer is not None else Image.new("L", base.size, 0)
    )
    outs = []
    for i in range(int(n_samples)):
        out = pipe.inpaint(
            prompt=prompt, input_image=base, mask=mask, uncond_prompt=uncond_prompt,
            do_cfg=True, cfg_scale=float(cfg_scale), strength=float(strength),
            inference_steps=int(inference_steps), sampler=sampler,
            use_cosine_schedule=bool(use_cosine), img_size=IMG_SIZE, seed=i,
            progress_callback=_progress_cb(progress),
        )
        outs.append(Image.fromarray(out))
    return outs


def build_demo():
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError("gradio is not installed; `pip install gradio` to run the demo") from e

    sampler_choices = [("DDPM", "ddpm"), ("DDIM", "ddim")]

    def with_progress(fn):
        # gradio injects a live gr.Progress for any param defaulting to one
        def wrapped(*a, progress=gr.Progress()):
            return fn(*a, progress=progress)
        return wrapped

    txt2img_h, img2img_h, inpaint_h = map(with_progress, (txt2img, img2img, inpaint))

    def controls(open_accordion):
        with gr.Accordion(label="Advanced settings", open=open_accordion):
            cfg_scale = gr.Slider(minimum=0, maximum=10, label="CFG Scale", step=0.1, value=7.5)
            strength = gr.Slider(label="Strength", minimum=0, maximum=1.0, step=0.01, value=0.8)
            steps = gr.Slider(label="Generation Steps", minimum=0, maximum=1000, step=1, value=50)
            sampler = gr.Dropdown(label="Sampling method", choices=sampler_choices, value="ddpm")
            cosine = gr.Checkbox(value=False, label="Use cosine-based beta schedule")
        return cfg_scale, strength, steps, sampler, cosine

    demo = gr.Blocks().queue()
    with demo:
        with gr.Row():
            gr.Markdown("## Stable Diffusion (PyTorch, H100)")
        with gr.Tab(label="txt2img"):
            with gr.Row():
                with gr.Column():
                    prompt = gr.Textbox(label="Prompt")
                    uncond = gr.Textbox(label="Uncondition prompt")
                    n = gr.Slider(label="Number of generated images", minimum=1, maximum=5, step=1, value=1)
                    cfg_s, stren, steps, samp, cos = controls(False)
            with gr.Row():
                btn = gr.Button(value="Generate")
            with gr.Row():
                gallery = gr.Gallery(label="Generated images", show_label=False)
            btn.click(fn=txt2img_h, inputs=[prompt, uncond, n, cos, cfg_s, stren, steps, samp],
                      outputs=[gallery])
        with gr.Tab("img2img"):
            with gr.Row(equal_height=True):
                img_in = gr.Image(sources="upload", type="pil")
                with gr.Column():
                    prompt = gr.Textbox(label="Prompt")
                    uncond = gr.Textbox(label="Uncondition prompt")
                    n = gr.Slider(label="Number of generated images", minimum=1, maximum=5, step=1, value=1)
            with gr.Row():
                cfg_s, stren, steps, samp, cos = controls(True)
            with gr.Row():
                btn = gr.Button(value="Generate")
            with gr.Row():
                gallery = gr.Gallery(label="Generated images", show_label=False)
            btn.click(fn=img2img_h, inputs=[img_in, prompt, uncond, n, cos, cfg_s, stren, steps, samp],
                      outputs=[gallery])
        with gr.Tab("inpaint"):
            with gr.Row():
                img_mask = gr.ImageMask(sources="upload", type="pil", crop_size=(512, 512), scale=2)
                with gr.Column(scale=1):
                    prompt = gr.Textbox(label="Prompt")
                    uncond = gr.Textbox(label="Unconditional prompt")
                    n = gr.Slider(label="Number of generated images", minimum=1, maximum=5, step=1, value=1)
                    cfg_s, stren, steps, samp, cos = controls(False)
            with gr.Row():
                btn = gr.Button(value="Generate")
            with gr.Row():
                gallery = gr.Gallery(label="Generated images", show_label=False)
            btn.click(fn=inpaint_h, inputs=[img_mask, prompt, uncond, n, cos, cfg_s, stren, steps, samp],
                      outputs=[gallery])
    return demo


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--tokenizer_dir", required=True)
    parser.add_argument("--sd_version", default="1.5")
    parser.add_argument("--lora_ckpt", default="")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda: the kernels in bf16 (needs a card); cpu: the plain versions in f32")
    args = parser.parse_args()
    initialize_model(args.model_path, args.tokenizer_dir, args.sd_version, args.lora_ckpt,
                     args.device)
    build_demo().launch()
