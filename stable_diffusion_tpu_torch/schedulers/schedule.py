"""DDIM schedule tables and step, and the training-time noising (port of
stable_diffusion_tpu/schedulers/schedule.py: ``make_schedule`` (linear),
``inference_timesteps``, ``ddim_step``, ``forward_process``,
``v_prediction_targets``).

The tables are host numpy, built once; the step gathers from them on the
device in f32.  Kept deviation from the original PyTorch code (COMPONENTS.md,
"Known intentional deviations"): the DDIM variance uses ``alphas_hat[t]``
where the original used ``alphas[t]``; at the default eta = 0 both agree.
"""

from __future__ import annotations

import dataclasses
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
                  beta_end: float = 0.012, prediction_type: str = "epsilon") -> DiffusionSchedule:
    """Linear-in-sqrt beta schedule."""
    T = num_train_timesteps
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, T, dtype=np.float32) ** 2
    alphas = 1.0 - betas
    alphas_hat = np.cumprod(alphas, dtype=np.float32)
    return DiffusionSchedule(betas, alphas, alphas_hat, T, prediction_type)


def inference_timesteps(schedule: DiffusionSchedule, steps: int, *, kind: str = "ddpm") -> np.ndarray:
    """Descending int64 timesteps; DDIM carries the +1 offset.  The default
    ``kind`` is the JAX package's ("ddpm")."""
    ts = np.arange(0, steps) * (schedule.num_train_timesteps // steps)
    if kind == "ddim":
        ts = ts + 1
    return np.asarray(np.round(ts)[::-1].copy(), dtype=np.int64)


def _gather_ah(alphas_hat: torch.Tensor, t) -> torch.Tensor:
    """alphas_hat[t] with alphas_hat[t < 0] := 1."""
    t = torch.as_tensor(t, device=alphas_hat.device)
    safe = t.clamp(0, alphas_hat.shape[0] - 1)
    return torch.where(t < 0, torch.ones((), device=alphas_hat.device), alphas_hat[safe])


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
