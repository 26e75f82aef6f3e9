"""Schedule tables, the DDPM and DDIM steps, and the training-time noising
(port of stable_diffusion_tpu/schedulers/schedule.py: ``make_schedule``
(linear or cosine), ``schedule_from_config``, ``inference_timesteps``,
``apply_strength``, ``prev_timesteps``, ``ddpm_step``, ``ddim_step``,
``forward_process``, ``v_prediction_targets``).

The tables are host numpy, built once; the step gathers from them on the
device in f32.  Kept deviation from the original PyTorch code (COMPONENTS.md,
"Known intentional deviations"): the DDIM variance uses ``alphas_hat[t]``
where the original used ``alphas[t]``; at the default eta = 0 both agree.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    betas: np.ndarray
    alphas: np.ndarray
    alphas_hat: np.ndarray
    num_train_timesteps: int
    prediction_type: str = "epsilon"


def make_schedule(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                  beta_end: float = 0.012, use_cosine_schedule: bool = False,
                  prediction_type: str = "epsilon") -> DiffusionSchedule:
    """Linear-in-sqrt beta schedule, or the Nichol-Dhariwal cosine one in f32
    with every table clipped to 0.999 (as JAX's)."""
    T = num_train_timesteps
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, T, dtype=np.float32) ** 2
    alphas = 1.0 - betas
    alphas_hat = np.cumprod(alphas, dtype=np.float32)
    if use_cosine_schedule:
        s = np.float32(0.008)
        t = np.arange(0, T + 1, dtype=np.float32)
        f = np.cos((t / np.float32(T) + s) / (1 + s) * np.float32(np.pi) / 2) ** 2
        ah = (f / f[0]).astype(np.float32)
        betas = np.clip(1.0 - ah[1:] / ah[:-1], 0.0, 0.999).astype(np.float32)
        alphas = np.clip(1.0 - betas, 0.0, 0.999).astype(np.float32)
        alphas_hat = np.clip(ah[1:], 0.0, 0.999).astype(np.float32)
    return DiffusionSchedule(betas, alphas, alphas_hat, T, prediction_type)


def schedule_from_config(cfg_dir: str, use_cosine_schedule: bool = False) -> DiffusionSchedule:
    """The schedule of ``cfg_dir/scheduler_config.json`` (a diffusers config)."""
    with open(os.path.join(cfg_dir, "scheduler_config.json")) as f:
        cfg = json.load(f)
    return make_schedule(num_train_timesteps=cfg["num_train_timesteps"],
                         beta_start=cfg["beta_start"], beta_end=cfg["beta_end"],
                         use_cosine_schedule=use_cosine_schedule,
                         prediction_type=cfg.get("prediction_type", "epsilon"))


def inference_timesteps(schedule: DiffusionSchedule, steps: int, *, kind: str = "ddpm") -> np.ndarray:
    """Descending int64 timesteps; DDIM carries the +1 offset.  The default
    ``kind`` is the JAX package's ("ddpm")."""
    ts = np.arange(0, steps) * (schedule.num_train_timesteps // steps)
    if kind == "ddim":
        ts = ts + 1
    return np.asarray(np.round(ts)[::-1].copy(), dtype=np.int64)


def apply_strength(timesteps: np.ndarray, strength: float) -> np.ndarray:
    """img2img's truncation: drop the first ``len - int(len * strength)`` steps."""
    steps = len(timesteps)
    return timesteps[steps - int(steps * strength):]


def prev_timesteps(schedule: DiffusionSchedule, timesteps: np.ndarray, steps: int) -> np.ndarray:
    """t - T // steps for each step; may go negative (alphas_hat := 1 there)."""
    return timesteps - schedule.num_train_timesteps // steps


def _gather_ah(alphas_hat: torch.Tensor, t) -> torch.Tensor:
    """alphas_hat[t] with alphas_hat[t < 0] := 1."""
    t = torch.as_tensor(t, device=alphas_hat.device)
    safe = t.clamp(0, alphas_hat.shape[0] - 1)
    return torch.where(t < 0, torch.ones((), device=alphas_hat.device), alphas_hat[safe])


def ddpm_step(alphas_hat: torch.Tensor, x_t: torch.Tensor, t, prev_t, eps_hat: torch.Tensor,
              noise: torch.Tensor) -> torch.Tensor:
    """Ancestral DDPM reverse step in f32.  ``noise`` is drawn by the caller
    (fresh each step) and added only where t > 0.  The model output is taken
    as eps whatever the schedule's prediction type, as in JAX."""
    ah_t = _gather_ah(alphas_hat, t).float()
    ah_prev = _gather_ah(alphas_hat, prev_t).float()
    cur_alpha = torch.clamp(ah_t / ah_prev, 0.0, 0.999)
    cur_beta = 1.0 - cur_alpha
    xf = x_t.float()
    mu = torch.rsqrt(cur_alpha) * (xf - (1.0 - cur_alpha) * torch.rsqrt(1.0 - ah_t)
                                   * eps_hat.float())
    variance = torch.clamp((1.0 - ah_prev) / (1.0 - ah_t) * cur_beta, min=1e-20)
    t = torch.as_tensor(t, device=alphas_hat.device)
    stdev = torch.where(t > 0, torch.sqrt(variance), torch.zeros((), device=alphas_hat.device))
    return (mu + stdev * noise.float()).to(x_t.dtype)


def ddim_step(alphas_hat: torch.Tensor, x_t: torch.Tensor, t, prev_t, model_output: torch.Tensor,
              *, prediction_type: str = "epsilon", eta: float = 0.0,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DDIM reverse step in f32, epsilon- or v-prediction."""
    ah_t = _gather_ah(alphas_hat, t).float()
    ah_prev = _gather_ah(alphas_hat, prev_t).float()
    beta_hat_t = 1.0 - ah_t
    xf = x_t.float()
    mo = model_output.float()
    if prediction_type == "epsilon":
        pred_x0 = (xf - torch.sqrt(beta_hat_t) * mo) * torch.rsqrt(ah_t)
        pred_eps = mo
    elif prediction_type == "v_prediction":
        pred_x0 = torch.sqrt(ah_t) * xf - torch.sqrt(beta_hat_t) * mo
        pred_eps = torch.sqrt(ah_t) * mo + torch.sqrt(beta_hat_t) * xf
    else:
        raise ValueError(f"unknown prediction_type {prediction_type!r}")
    variance_t = (1.0 - ah_prev) / (1.0 - ah_t) * (1.0 - ah_t / ah_prev)
    std_dev_t = torch.sqrt(torch.clamp(eta * variance_t, min=0.0))
    direction = torch.sqrt(torch.clamp(1.0 - ah_prev - std_dev_t ** 2, min=0.0)) * pred_eps
    prev_x = torch.sqrt(ah_prev) * pred_x0 + direction
    if eta > 0:
        if noise is None:
            raise ValueError("eta > 0 needs per-step noise")
        prev_x = prev_x + std_dev_t * noise.float()
    return prev_x.to(x_t.dtype)


def _per_sample(alphas_hat: torch.Tensor, t, like: torch.Tensor) -> torch.Tensor:
    """alphas_hat[t] in ``like``'s dtype, broadcast over its trailing dims;
    t is (B,) (one timestep per sample) or a scalar."""
    ah = alphas_hat[torch.as_tensor(t, device=alphas_hat.device).long()].to(like.dtype)
    return ah.reshape(ah.shape + (1,) * (like.dim() - ah.dim()))


def forward_process(alphas_hat: torch.Tensor, x0: torch.Tensor, t, noise: torch.Tensor):
    """q(x_t | x_0) sample: sqrt(ah) x0 + sqrt(1 - ah) noise, in x0's dtype."""
    ah = _per_sample(alphas_hat, t, x0)
    return torch.sqrt(ah) * x0 + torch.sqrt(1.0 - ah) * noise


def v_prediction_targets(alphas_hat: torch.Tensor, x0: torch.Tensor, noise: torch.Tensor, t):
    """v = sqrt(ah) noise - sqrt(1 - ah) x0, the v-prediction training target."""
    ah = _per_sample(alphas_hat, t, x0)
    return torch.sqrt(ah) * noise - torch.sqrt(1.0 - ah) * x0
