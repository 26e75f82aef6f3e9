"""txt2img / img2img / one-step inference CLI of the PyTorch port
(stable_diffusion_tpu_torch): ``inference.py``'s flags and defaults, on the
port's pipeline.

    python inference_torch.py --model_path DIR_OR_FILE --tokenizer_dir DIR \\
        --prompt "a photo of a cat" [--device cuda] [--one_step] [--do_cfg] ...

``--model_path`` is a diffusers directory or a single CompVis/LDM
``.ckpt`` / ``.safetensors`` file (``--sd_version`` picks its configs).  A
``.ckpt`` is unpickled, which runs code from the file: use trusted files
only.  ``--device cuda`` (the default) runs the hand-written kernels, which
take bf16, so ``--dtype float32`` is refused there; ``--device cpu`` runs the
plain PyTorch versions in either dtype.  Nothing moves to the CPU by itself:
``--device cuda`` without a card raises.  ``--lora_ckpt`` is merged into the
weights at load: a kohya ``.safetensors`` file, or a ``.ckpt`` training
checkpoint of ``train_lora_dreambooth_torch.py`` (its LoRA tree; the JAX
trainer's ``.msgpack`` / orbax checkpoints raise ``ValueError``).  Images go to
``--output_dir`` as ``img_{i}_{j}.jpg`` (request i, lane j), written with
PIL.
"""

import argparse
import contextlib
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def build_parser():
    parser = argparse.ArgumentParser(description="Inference Arguments")
    parser.add_argument("--model_path", metavar="", default="",
                        help="Model path: a diffusers directory or a single LDM .ckpt/.safetensors "
                             "file (a .ckpt runs code when unpickled: trusted files only)")
    parser.add_argument("--tokenizer_dir", metavar="", default="",
                        help="Tokenizer dir (vocab.json, merges.txt)")
    parser.add_argument("--device", metavar="", default="cuda", type=str,
                        help="cuda (the kernels, bfloat16) or cpu (the plain versions)")
    parser.add_argument("--img_size", metavar="", default=512, type=int, help="Image size")
    parser.add_argument("--img_path", metavar="", default="", type=str, help="Image path")
    parser.add_argument("--prompt", metavar="", default="", type=str, help="Input prompt")
    parser.add_argument("--uncond_prompt", metavar="", default="", type=str, help="Unconditional prompt")
    parser.add_argument("--n_samples", metavar="", default=3, type=int, help="Number of generated images")
    parser.add_argument("--lora_ckpt", metavar="", default="", type=str,
                        help="kohya LoRA .safetensors, or a training checkpoint (.ckpt) of "
                             "train_lora_dreambooth_torch.py, to merge into the weights")
    parser.add_argument("--do_cfg", action=argparse.BooleanOptionalAction, help="Activate CFG")
    parser.add_argument("--cfg_scale", metavar="", default=7.5, type=float, help="CFG scale")
    parser.add_argument("--strength", metavar="", default=1.0, type=float, help="img2img strength")
    parser.add_argument("--num_inference_steps", help="Step to generate image", default=50,
                        choices=range(1, 1001), metavar="Value: [1-1000]", type=int)
    parser.add_argument("--sampler", metavar="", default="ddpm", choices=["ddpm", "ddim"], type=str)
    parser.add_argument("--use_cosine_schedule", action=argparse.BooleanOptionalAction)
    parser.add_argument("--batch_size", metavar="", default=1, type=int, help="Batch size")
    parser.add_argument("--seed", default=None, type=int, help="Seed value")
    parser.add_argument("--one_step", action=argparse.BooleanOptionalAction, help="One step generation")
    parser.add_argument("--sd_version", default="1.5", type=str, help="Stable Diffusion Model Version")
    parser.add_argument("--output_dir", default="./output", type=str, help="Where to save images")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"], type=str)
    parser.add_argument("--profile_dir", default="", type=str,
                        help="Write a torch.profiler trace (Chrome JSON) of generation here")
    return parser


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    args.do_cfg = bool(args.do_cfg)
    args.use_cosine_schedule = bool(args.use_cosine_schedule)
    args.one_step = bool(args.one_step)
    return args


def check_device(args):
    """(device, dtype, impl) of the flags, refused before anything loads:
    the kernels take bf16, and a missing card is not replaced by the CPU."""
    import torch

    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if device.type == "cuda":
        if dtype != torch.bfloat16:
            raise ValueError("--dtype float32 with --device cuda: the kernels take bfloat16; "
                             "use --dtype bfloat16, or --device cpu for the plain versions")
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but torch.cuda.is_available() is false; "
                               "pass --device cpu to run the plain versions")
        return device, dtype, "cuda"
    if device.type != "cpu":
        raise ValueError(f"--device must be cuda or cpu, got {args.device!r}")
    return device, dtype, "torch"


def load_model(args):
    """The pipeline of ``--model_path`` on ``--device`` in ``--dtype``, with
    the tokenizer of ``--tokenizer_dir`` and ``--lora_ckpt`` merged (a kohya
    file, or a training checkpoint's LoRA tree; the LoRA is read first, so a
    bad file fails before the model loads)."""
    from stable_diffusion_tpu_torch.models.lora import merge_lora_
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion
    from stable_diffusion_tpu_torch.tokenizer import load_tokenizer
    from stable_diffusion_tpu_torch.utils import model_converter as mc
    from stable_diffusion_tpu_torch.utils.checkpoint import load_train_checkpoint

    device, dtype, impl = check_device(args)
    lora = None
    if args.lora_ckpt.endswith(".safetensors"):
        lora = mc.load_lora_kohya(args.lora_ckpt)
    elif args.lora_ckpt.endswith((".ckpt", ".msgpack", ".orbax")):
        # a training checkpoint of train_lora_dreambooth_torch.py: its LoRA
        # tree (not the EMA), as JAX's inference.py merges it
        lora = load_train_checkpoint(args.lora_ckpt)["state"]["lora"]
    elif args.lora_ckpt:
        raise ValueError(f"--lora_ckpt {args.lora_ckpt}: expected a kohya .safetensors file or a "
                         "training checkpoint (.ckpt)")
    tokenizer = load_tokenizer(args.tokenizer_dir) if args.tokenizer_dir else None
    model = StableDiffusion.from_pretrained(args.model_path, sd_version=args.sd_version, dtype=dtype,
                                            tokenizer=tokenizer, impl=impl, device=device)
    if lora is not None:
        merge_lora_(model.unet, lora["unet"])
        if "text_encoder" in lora:
            merge_lora_(model.text_encoder, lora["text_encoder"])
    return model


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading --img_path and writing the images need PIL (Pillow)") from e
    return Image


def inference(args, model, input_image=None, *, save: bool = True):
    """``ceil(n_samples / batch_size)`` requests of ``batch_size`` lanes,
    request i seeded ``(seed or 0) + i``; returns the uint8 (H, W, 3) images
    and, with ``save``, writes each as ``img_{i}_{j}.jpg`` in
    ``output_dir``."""
    image_mod = _pil() if save else None
    cond = model.tokenize([args.prompt] * (1 if args.one_step else args.batch_size))
    uncond = (model.tokenize([args.uncond_prompt] * args.batch_size)
              if args.do_cfg and not args.one_step else None)
    if save:
        os.makedirs(args.output_dir, exist_ok=True)
    outputs = []
    for i in range(math.ceil(args.n_samples / args.batch_size)):
        seed = (args.seed or 0) + i
        size = (args.img_size, args.img_size)
        if args.one_step:
            imgs = model.generate_in_one_step(cond, img_size=size, batch_size=args.batch_size,
                                              seed=seed, output_dtype="uint8")
        else:
            imgs = model.generate(cond, uncond, input_image=input_image, img_size=size,
                                  do_cfg=args.do_cfg, cfg_scale=args.cfg_scale,
                                  inference_steps=args.num_inference_steps, strength=args.strength,
                                  sampler=args.sampler, use_cosine_schedule=args.use_cosine_schedule,
                                  seed=seed, output_dtype="uint8")
        for j, arr in enumerate(np.asarray(imgs)):
            if save:
                image_mod.fromarray(arr).save(os.path.join(args.output_dir, f"img_{i}_{j}.jpg"))
            outputs.append(arr)
    return outputs


@contextlib.contextmanager
def profile(directory: str, device_type: str):
    """A ``torch.profiler`` trace of the block written to ``directory``
    (``trace.json``, Chrome format), the card's activity included on CUDA
    and the port's ``sd.*`` spans recorded (``utils/device.span``); nothing
    when ``directory`` is empty."""
    if not directory:
        yield
        return
    import torch
    from stable_diffusion_tpu_torch.utils.device import SPANS

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    SPANS.record()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield
    finally:
        SPANS.stop_recording()
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))


def main(argv=None):
    args = parse_args(argv)
    device, _, _ = check_device(args)
    input_image = None
    if args.img_path:
        if not os.path.exists(args.img_path):
            raise FileNotFoundError(f"--img_path {args.img_path} does not exist")
        input_image = _pil().open(args.img_path)
    model = load_model(args)
    with profile(args.profile_dir, device.type):
        return inference(args, model, input_image)


if __name__ == "__main__":
    main()
