"""The plain reference of the served paths: the scaled-linear schedule,
txt2img by DDIM (eta 0) under classifier-free guidance with epsilon or v
prediction, SwiftBrush's one step at t = 999, and the decode to uint8
images.  Float32, NHWC at the edges (the program's layout), NCHW inside."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from portbench.reference import nets

ONE_STEP_T = 999
ONE_STEP_ALPHA2 = 0.0047  # SwiftBrush's alpha_T^2 at t = 999


def alphas_hat(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
               beta_end: float = 0.012) -> np.ndarray:
    """The cumulative product of 1 - beta over the scaled-linear betas, in f32."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                        dtype=np.float32) ** 2
    return np.cumprod(1.0 - betas, dtype=np.float32)


def ddim_timesteps(steps: int, num_train_timesteps: int = 1000):
    """(t, previous t) of each DDIM step, descending, with the +1 offset; a
    previous t below 0 means alphas_hat = 1."""
    stride = num_train_timesteps // steps
    ts = (np.arange(steps) * stride + 1)[::-1]
    return ts.tolist(), (ts - stride).tolist()


def _ah(table: np.ndarray, t: int) -> float:
    return 1.0 if t < 0 else float(table[t])


def ddim_step(x, out, t: int, prev: int, table: np.ndarray, prediction_type: str):
    a, ap = _ah(table, t), _ah(table, prev)
    if prediction_type == "epsilon":
        x0, eps = (x - (1 - a) ** 0.5 * out) / a ** 0.5, out
    else:  # v prediction
        x0, eps = a ** 0.5 * x - (1 - a) ** 0.5 * out, a ** 0.5 * out + (1 - a) ** 0.5 * x
    return ap ** 0.5 * x0 + (1 - ap) ** 0.5 * eps


def to_uint8(decoded: torch.Tensor) -> np.ndarray:
    """(B, 3, H, W) decode in [-1, 1] -> (B, H, W, 3) uint8, rounded."""
    img = ((decoded.float() + 1.0) / 2.0).clamp(0.0, 1.0).permute(0, 2, 3, 1)
    return torch.round(img * 255.0).to(torch.uint8).cpu().numpy()


def to_unit(decoded: torch.Tensor) -> np.ndarray:
    """(B, 3, H, W) decode in [-1, 1] -> (B, H, W, 3) float32 in [0, 1], unrounded."""
    img = ((decoded.float() + 1.0) / 2.0).clamp(0.0, 1.0).permute(0, 2, 3, 1)
    return img.cpu().numpy()


@torch.no_grad()
def txt2img(weights: Mapping[str, Mapping], cfg: Mapping, cond_ids, uncond_ids, latents, *,
            steps: int, cfg_scale: float, ops: nets.Ops) -> torch.Tensor:
    """The decode (B, 3, H, W) of a DDIM txt2img request: ``latents`` (B, h,
    w, 4) NHWC start; context [uncond; cond]; eps = uncond + s (cond - uncond)."""
    P = {k: nets.Params(v) for k, v in weights.items()}
    dev = latents.device
    ids = torch.cat([torch.as_tensor(uncond_ids), torch.as_tensor(cond_ids)]).to(dev)
    ctx = nets.text_encoder(P["text_encoder"], cfg["text"], ids, ops)
    table = alphas_hat()
    x = latents.to(ctx.dtype).permute(0, 3, 1, 2)
    b = x.shape[0]
    ts, prevs = ddim_timesteps(steps)
    for t, prev in zip(ts, prevs):
        tt = torch.full((2 * b,), t, dtype=torch.long, device=dev)
        out = nets.unet(P["unet"], cfg["unet"], torch.cat([x, x]), tt, ctx, ops)
        uncond, cond = out.chunk(2)
        x = ddim_step(x, uncond + cfg_scale * (cond - uncond), t, prev, table,
                      cfg["prediction_type"])
    return nets.vae_decode(P["vae"], cfg["vae"], x, ops)


@torch.no_grad()
def one_step(weights: Mapping[str, Mapping], cfg: Mapping, cond_ids, latents, *,
             ops: nets.Ops) -> torch.Tensor:
    """The decode of SwiftBrush's one step: x0 = (z - sigma_T eps) / alpha_T."""
    P = {k: nets.Params(v) for k, v in weights.items()}
    dev = latents.device
    ctx = nets.text_encoder(P["text_encoder"], cfg["text"], torch.as_tensor(cond_ids).to(dev),
                            ops)
    z = latents.to(ctx.dtype).permute(0, 3, 1, 2)
    tt = torch.full((z.shape[0],), ONE_STEP_T, dtype=torch.long, device=dev)
    eps = nets.unet(P["unet"], cfg["unet"], z, tt, ctx, ops)
    x0 = (z - (1.0 - ONE_STEP_ALPHA2) ** 0.5 * eps) / ONE_STEP_ALPHA2 ** 0.5
    return nets.vae_decode(P["vae"], cfg["vae"], x0, ops)
