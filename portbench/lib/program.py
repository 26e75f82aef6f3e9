"""The system under test, built from a configuration file: the port's
``StableDiffusion`` or its UNet alone, with the benchmark's seeded weights
loaded into it.  The only module of the benchmark that imports the port
(with the drivers)."""

from __future__ import annotations

from typing import Mapping

import torch

from portbench.lib import inputs
from portbench.reference import nets


def scheduler_config(cfg: Mapping) -> dict:
    return {"num_train_timesteps": 1000, "beta_start": 0.00085, "beta_end": 0.012,
            "prediction_type": cfg["prediction_type"]}


def unet_config(cfg: Mapping):
    from stable_diffusion_tpu_torch.models.unet import UNetConfig

    return UNetConfig.from_dict(dict(cfg["unet"]))


@torch.no_grad()
def load(module: torch.nn.Module, tensors: Mapping[str, torch.Tensor], *,
         unused_prefixes=()) -> None:
    """Copy ``tensors`` into ``module`` by name.  Every parameter must be
    given except those under ``unused_prefixes`` (parts the served path
    never runs, as the VAE's encoder in txt2img), which are zeroed."""
    missing, unexpected = module.load_state_dict(dict(tensors), strict=False)
    left = [k for k in missing if not k.startswith(tuple(unused_prefixes))]
    if left or unexpected:
        raise ValueError(f"weights do not fit {type(module).__name__}: missing {left[:5]}, "
                         f"unexpected {list(unexpected)[:5]}")
    params = dict(module.named_parameters())
    for k in missing:
        params[k].zero_()


def build_pipeline(cfg: Mapping, seed: int, *, device, dtype, impl: str):
    """The port's pipeline of ``cfg`` with the weights of ``seed``."""
    from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig
    from stable_diffusion_tpu_torch.models.vae import VAEConfig
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion

    pipe = StableDiffusion.build(unet_config(cfg), CLIPTextConfig.from_dict(dict(cfg["text"])),
                                 VAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                                              for k, v in cfg["vae"].items()}),
                                 device=device, dtype=dtype, impl=impl,
                                 scheduler_config=scheduler_config(cfg))
    load_pipeline_weights(pipe, cfg, seed)
    return pipe


def load_pipeline_weights(pipe, cfg: Mapping, seed: int) -> None:
    w = inputs.make_weights(nets.param_shapes(cfg), seed, pipe.device, pipe.dtype)
    load(pipe.unet, w["unet"])
    load(pipe.text_encoder, w["text_encoder"])
    load(pipe.vae, w["vae"], unused_prefixes=("encoder.", "quant_conv."))


def build_unet(cfg: Mapping, seed: int, *, device, dtype):
    """The port's UNet of ``cfg`` with the weights of ``seed``."""
    from stable_diffusion_tpu_torch.models.unet import UNet
    from stable_diffusion_tpu_torch.utils.weights import build

    unet = build(UNet, unet_config(cfg), device=device, dtype=dtype)
    shapes = {"unet": nets.param_shapes(cfg)["unet"]}
    load(unet, inputs.make_weights(shapes, seed, device, dtype)["unet"])
    return unet


def reference_weights(cfg: Mapping, seed: int, device, served_dtype,
                      nets_wanted=("unet", "text_encoder", "vae")):
    """The weights of ``seed`` as the program holds them (rounded to the
    served dtype), in f32, for the reference."""
    shapes = {k: v for k, v in nets.param_shapes(cfg).items() if k in nets_wanted}
    w = inputs.make_weights(shapes, seed, device, served_dtype)
    return {n: {k: v.float() for k, v in t.items()} for n, t in w.items()}
