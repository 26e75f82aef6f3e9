"""Int8 quantization primitives (port of stable_diffusion_tpu/ops/quantize.py)
and the scale folding the static-W8A8 kernels read.

Weights are quantized symmetric per output channel; a static-W8A8 layer
also carries ``act_scale``, the calibrated absmax of its input, so the
activation quantizes as ``clip(round(x / s_x), -127, 127)`` with
``s_x = act_scale / 127`` (``max(act_scale / 127, 1e-12)`` for the convs,
as JAX ``_conv3x3_q``).  ``torch.round`` rounds half to even, as
``jnp.round``; the codes never take -128.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stable_diffusion_tpu_torch.utils.device import cached


def quantize_tensor(w: torch.Tensor, *, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over ``axis``: (q int8, scale f32 broadcastable), with
    scale = max(absmax / 127, 1e-12) and q = clip(round(w / scale), +-127)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(absmax / 127.0, 1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_tensor(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def act_step(act_scale: torch.Tensor, *, floor: bool = False) -> torch.Tensor:
    """s_x, the activation's quantization step, f32 on act_scale's device."""
    s = act_scale.float() / 127.0
    return torch.clamp_min(s, 1e-12) if floor else s


def quantize_act(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """clip(round(x / s_x), +-127) as int8: the division, not a multiply by
    1/s_x, so every form of the quantizer gives the same codes."""
    return torch.clamp(torch.round(x.float() / s_x), -127, 127).to(torch.int8)


def int_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq (..., K) int8 @ wq (N, K)^T as exact integers in f64 (CUDA has no
    integer matmul outside ``torch._int_mm``; every such sum is far below
    2^53), returned as f32 rounded once, as JAX's int32 -> f32 convert."""
    return torch.matmul(xq.double(), wq.double().t()).float()


def folded_scales(weight_scale: torch.Tensor, act_scale: torch.Tensor, *,
                  floor: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s_x (1,), s_x * weight_scale (N,)), both f32 and contiguous on the
    weight's device: the two scales a W8A8 kernel reads from device memory.

    Cached on ``weight_scale`` until either tensor is replaced or changed in
    place, so a denoise loop folds each layer's scales once and never syncs
    with the host for them."""
    def fold():
        s_x = act_step(act_scale.detach(), floor=floor).reshape(1).contiguous()
        return s_x, (s_x * weight_scale.detach().float().reshape(-1)).contiguous()

    return cached(weight_scale, f"_sdtk_folded_{floor}", [weight_scale, act_scale], fold)
