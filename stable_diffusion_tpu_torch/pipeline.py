"""txt2img pipeline (port of stable_diffusion_tpu/pipeline.py
``StableDiffusion.generate`` on its main path: CLIP text tower -> DDIM
denoise loop with classifier-free guidance -> VAE decode).

Numerical contract, as in JAX: context = [uncond, cond] and
eps = uncond + s * (cond - uncond).  The port cannot replay ``jax.random``,
so the starting noise is either drawn from a ``torch.Generator`` seeded with
``seed`` on the pipeline's device or passed in as ``initial_latents`` (the
tests pass the noise JAX drew).  Images come back NHWC, float in [0, 1] or
uint8; the TPU's lane-packed (b, h, w*3) transfer layout is not ported.

The pipeline never moves work to the CPU: it runs on ``device``, and with
``impl="cuda"`` it refuses a device that is not CUDA.  The tokenizer,
checkpoint loading and the CLI wait until their files are in the repository;
``generate`` takes token ids.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
from stable_diffusion_tpu_torch.models.vae import VAEConfig, VAEDecoder
from stable_diffusion_tpu_torch.schedulers import schedule as S


def cfg_combine(pred: torch.Tensor, cfg_scale: float) -> torch.Tensor:
    """(uncond, cond) halves of the batch -> uncond + s * (cond - uncond)."""
    uncond, cond = pred.chunk(2, dim=0)
    return uncond + torch.tensor(cfg_scale, dtype=pred.dtype) * (cond - uncond)


@dataclasses.dataclass
class StableDiffusion:
    """The three models on one device, in one dtype, and the ``impl`` switch."""

    unet: UNet
    text_encoder: CLIPTextModel
    vae: VAEDecoder
    impl: str = "auto"

    @classmethod
    def build(cls, unet_config: UNetConfig, text_config: CLIPTextConfig,
              vae_config: VAEConfig = VAEConfig(), *, device, dtype=torch.float32,
              impl: str = "auto") -> "StableDiffusion":
        """Uninitialised models on ``device``: load a state_dict into each
        (``utils.weights.from_jax_params``) or initialise them
        (``utils.weights.init_random_``) before generating.  On a CUDA device
        the kernels take bf16: build with ``dtype=torch.bfloat16``, or use
        ``impl="torch"`` for f32 (the kernels raise on f32 rather than fall
        back)."""
        from stable_diffusion_tpu_torch.utils.weights import build

        return cls(unet=build(UNet, unet_config, device=device, dtype=dtype),
                   text_encoder=build(CLIPTextModel, text_config, device=device, dtype=dtype),
                   vae=build(VAEDecoder, vae_config, device=device, dtype=dtype), impl=impl)

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.unet.parameters()).dtype

    @torch.no_grad()
    def generate(self, cond_ids, uncond_ids=None, *, img_size: Tuple[int, int] = (512, 512),
                 do_cfg: bool = True, cfg_scale: float = 7.5, inference_steps: int = 50,
                 seed: int = 0, initial_latents=None, output_dtype: str = "float32") -> np.ndarray:
        """txt2img with DDIM (eta = 0).

        cond_ids / uncond_ids: (B, 77) token ids (uncond needed with CFG).
        initial_latents: (B, H/8, W/8, 4) starting noise; drawn from
        ``torch.Generator().manual_seed(seed)`` on the device when None.
        Returns (B, H, W, 3) images: float32 in [0, 1], or uint8 when
        ``output_dtype="uint8"`` (which raises FloatingPointError rather
        than cast a non-finite value).
        """
        dev, dtype, impl = self.device, self.dtype, self.impl
        if impl == "cuda" and dev.type != "cuda":
            raise ValueError(f"impl='cuda' needs the models on a CUDA device, they are on {dev}")
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"output_dtype must be 'float32' or 'uint8', got {output_dtype!r}")
        cond = torch.as_tensor(np.asarray(cond_ids), dtype=torch.long, device=dev)
        b = cond.shape[0]
        if do_cfg:
            if uncond_ids is None:
                raise ValueError("classifier-free guidance needs uncond_ids")
            uncond = torch.as_tensor(np.asarray(uncond_ids), dtype=torch.long, device=dev)
            ids = torch.cat([uncond, cond], dim=0)
        else:
            ids = cond
        context = self.text_encoder(ids, impl=impl)

        h, w = img_size
        lat_shape = (b, h // 8, w // 8, 4)
        if initial_latents is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            latents = torch.randn(lat_shape, generator=gen, device=dev).to(dtype)
        else:
            latents = torch.tensor(np.asarray(initial_latents), device=dev, dtype=dtype)
            if tuple(latents.shape) != lat_shape:
                raise ValueError(f"initial_latents {tuple(latents.shape)}, expected {lat_shape}")

        sched = S.make_schedule()  # SD1.5's: linear 0.00085..0.012, epsilon
        ts = S.inference_timesteps(sched, inference_steps, kind="ddim")
        prev_ts = ts - sched.num_train_timesteps // inference_steps
        table = torch.as_tensor(sched.alphas_hat, device=dev)
        for t, pt in zip(ts.tolist(), prev_ts.tolist()):
            model_in = torch.cat([latents, latents], dim=0) if do_cfg else latents
            t_in = torch.full((1,), t, dtype=torch.long, device=dev)
            pred = self.unet(model_in, t_in, context, impl=impl)
            eps = cfg_combine(pred, cfg_scale) if do_cfg else pred
            latents = S.ddim_step(table, latents, t, pt, eps, prediction_type=sched.prediction_type)

        imgs = (self.vae.decode(latents, impl=impl).float() + 1.0) / 2.0
        if output_dtype == "uint8":
            # a uint8 image cannot show a NaN, so refuse to hide one
            if not bool(torch.isfinite(imgs).all()):
                raise FloatingPointError("generate produced non-finite image values")
            imgs = torch.round(imgs.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        return imgs.cpu().numpy()
