"""Evaluation harness of the PyTorch port (stable_diffusion_tpu_torch):
``evaluation.py``'s flags, sweep and results keys, on the port's pipeline.

    python evaluation_torch.py --model_path DIR_OR_FILE --tokenizer_dir DIR \\
        --original_imgs_dir val2017 --label_file captions_val2017.json \\
        --clip_model_dir CLIP_DIR --fid_backbone clip [--device cuda] ...

It samples ``--num_samples`` captions of a COCO-format annotation file,
generates an image for each with every config of {ddpm, ddim} x {linear,
cosine} x ``CFG_SCALES``, saves the real and fake pairs under
``--save_dir``, and returns (and logs to TensorBoard where it is installed)
each config's mean CLIP score (``results[tag]``, with ``--clip_model_dir``,
an HF ``CLIPModel`` directory) and FID (``results[tag + "/fid"]``, with
``--fid_backbone inception`` and ``--inception_weights``, a local
torchvision / pytorch-fid state dict, or ``--fid_backbone clip``).

``--device cuda`` (the default) generates and scores on the card, on the
hand-written kernels, in bf16; ``--device cpu`` runs the plain versions.
A missing card is not replaced by the CPU.  ``--lora_ckpt`` is merged at
load, as ``inference_torch.py`` does (JAX's evaluation.py takes the flag and
ignores it).
"""

import argparse
import json
import os
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

TEST_CONFIGS = [
    {"sampler": "ddpm", "use_cosine_schedule": False},
    {"sampler": "ddpm", "use_cosine_schedule": True},
    {"sampler": "ddim", "use_cosine_schedule": False},
    {"sampler": "ddim", "use_cosine_schedule": True},
]
CFG_SCALES = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.5, 9.0]


def load_clip_scorer(clip_model_dir: str, *, device="cuda", impl: str = "auto"):
    """An HF ``CLIPModel`` directory -> ``score(pixel_values, input_ids)``:
    (B, H, W, 3) raw [0, 255] images and (B, S) ids (numpy) -> (B,) numpy
    CLIP scores, computed on ``device``."""
    import torch

    from stable_diffusion_tpu_torch.fid import load_clip_model
    from stable_diffusion_tpu_torch.models.clip import clip_score

    model = load_clip_model(clip_model_dir, device=device)

    @torch.no_grad()
    def score(pixel_values, input_ids):
        px = torch.as_tensor(np.asarray(pixel_values, np.float32), device=device)
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=device)
        return clip_score(model, px, ids, impl=impl).cpu().numpy()

    return score


def generate_fake_imgs(args, model, original_imgs_dir, label_file, save_dir,
                       num_samples, test_configs, cfg_scales, scorer=None,
                       writer_fn=None, feature_fn=None):
    from PIL import Image

    from stable_diffusion_tpu_torch import fid as fid_m

    with open(label_file) as f:
        annotation_dict = json.load(f)
    id2filename = {img["id"]: img["file_name"] for img in annotation_dict["images"]}
    prompts_dict = {
        anno["caption"]: {
            "image_id": anno["image_id"],
            "file_name": id2filename[anno["image_id"]],
            "id": anno["id"],
        }
        for anno in annotation_dict["annotations"]
    }
    rng = random.Random(args.seed)
    random_prompts = rng.sample(list(prompts_dict.keys()), k=num_samples)
    os.makedirs(f"{save_dir}/original", exist_ok=True)
    uncond_ids = model.tokenize([""]) if args.do_cfg else None

    results = {}
    real_feats = None
    for config in test_configs:
        sampler = config["sampler"]
        cosine = config["use_cosine_schedule"]
        writer = writer_fn(sampler, cosine) if writer_fn else None
        for cfg_scale in cfg_scales:
            tag = f"{cfg_scale}_{sampler}_{'cosine' if cosine else 'linear'}Schedule"
            os.makedirs(f"{save_dir}/fake/{tag}", exist_ok=True)
            scores = []
            fake_feats = []
            real_batch = []
            for prompt in random_prompts:
                meta = prompts_dict[prompt]
                pil_img = Image.open(
                    os.path.join(original_imgs_dir, meta["file_name"])
                ).convert("RGB").resize((512, 512))
                ids = model.tokenize([prompt])
                fake = model.generate(
                    ids, uncond_ids,
                    img_size=(512, 512),
                    do_cfg=args.do_cfg,
                    cfg_scale=cfg_scale,
                    strength=args.strength,
                    inference_steps=args.num_inference_steps,
                    sampler=sampler,
                    use_cosine_schedule=cosine,
                    seed=args.seed or 0,
                )[0]
                fake_u8 = (np.clip(fake, 0, 1) * 255).round().astype(np.uint8)
                stem = f"{meta['image_id']}_{meta['id']}"
                pil_img.save(os.path.join(save_dir, "original", f"{stem}.jpg"))
                Image.fromarray(fake_u8).save(os.path.join(save_dir, "fake", tag, f"{stem}.jpg"))
                with open(os.path.join(save_dir, f"{stem}.txt"), "w") as f:
                    f.write(prompt)
                if scorer is not None:
                    img224 = np.asarray(
                        Image.fromarray(fake_u8).resize((224, 224), Image.BICUBIC),
                        dtype=np.float32,
                    )[None]
                    scores.append(float(scorer(img224, ids)[0]))
                if feature_fn is not None:
                    fake_feats.append(np.asarray(
                        feature_fn(fake_u8[None].astype(np.float32) / 255.0)
                    ))
                    if real_feats is None:
                        real_batch.append(np.asarray(
                            feature_fn(np.asarray(pil_img, np.float32)[None] / 255.0)
                        ))
            if feature_fn is not None:
                if real_feats is None:
                    real_feats = np.concatenate(real_batch, axis=0)
                fid_val = fid_m.fid_from_features(real_feats, np.concatenate(fake_feats, axis=0))
                results[f"{tag}/fid"] = fid_val
                print(f"{tag}: FID={fid_val:.4f}", flush=True)
                if writer:
                    writer.add_scalars("FID", {"fid": fid_val}, int(cfg_scale))
            if scores:
                avg = float(np.mean(scores))
                results[tag] = avg
                print(f"{tag}: CLIP-score={avg:.4f}", flush=True)
                if writer:
                    writer.add_scalars("CLIP Score", {"clip_score": avg}, int(cfg_scale))
        if writer:
            writer.close()
    return results


def build_parser():
    parser = argparse.ArgumentParser(description="Evaluation Arguments")
    parser.add_argument("--model_path", help="Model path", metavar="", default="")
    parser.add_argument("--tokenizer_dir", metavar="", default="")
    parser.add_argument("--device", metavar="", default="cuda", type=str,
                        help="cuda (the kernels, bfloat16) or cpu (the plain versions)")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"], type=str)
    parser.add_argument("--lora_ckpt", metavar="", default="", type=str)
    parser.add_argument("--do_cfg", action=argparse.BooleanOptionalAction)
    parser.add_argument("--cfg_scale", metavar="", default=7.5, type=float)
    parser.add_argument("--strength", metavar="", default=1.0, type=float)
    parser.add_argument("--num_inference_steps", default=50, choices=range(1, 1001),
                        metavar="Value: [1-1000]", type=int)
    parser.add_argument("--sampler", metavar="", default="ddpm", choices=["ddpm", "ddim"], type=str)
    parser.add_argument("--use_cosine_schedule", action=argparse.BooleanOptionalAction)
    parser.add_argument("--original_imgs_dir", default="./val2017", type=str)
    parser.add_argument("--label_file", default="./annotations/captions_val2017.json", type=str)
    parser.add_argument("--save_dir", default="./eval_output", type=str)
    parser.add_argument("--num_samples", default=1000, type=int)
    parser.add_argument("--clip_model_dir", default="", type=str,
                        help="HF CLIPModel dir for the CLIP score (optional)")
    parser.add_argument("--fid_backbone", default="none",
                        choices=["none", "inception", "clip"],
                        help="FID feature tower; 'clip' = CLIP-FID from --clip_model_dir")
    parser.add_argument("--inception_weights", default="", type=str,
                        help="Local torchvision/pytorch-fid InceptionV3 state dict")
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument("--sd_version", default="1.5", type=str)
    return parser


def main(argv=None):
    import inference_torch
    from stable_diffusion_tpu_torch import fid as fid_m

    args = build_parser().parse_args(argv)
    args.do_cfg = bool(args.do_cfg) if args.do_cfg is not None else True
    device, _, impl = inference_torch.check_device(args)
    model = inference_torch.load_model(args)
    scorer = (load_clip_scorer(args.clip_model_dir, device=device, impl=impl)
              if args.clip_model_dir else None)
    feature_fn = None
    if args.fid_backbone != "none":
        feature_fn = fid_m.make_feature_fn(
            args.fid_backbone, weights_path=args.inception_weights,
            clip_model_dir=args.clip_model_dir, device=device, impl=impl,
        )

    def writer_fn(sampler, cosine):
        try:
            from torch.utils.tensorboard import SummaryWriter

            name = f"{sampler}_{'cosine' if cosine else 'linear'}"
            return SummaryWriter(log_dir=os.path.join("./runs/", name))
        except Exception:
            return None

    return generate_fake_imgs(
        args, model, args.original_imgs_dir, args.label_file, args.save_dir,
        args.num_samples, TEST_CONFIGS, CFG_SCALES, scorer=scorer,
        writer_fn=writer_fn, feature_fn=feature_fn,
    )


if __name__ == "__main__":
    main()
