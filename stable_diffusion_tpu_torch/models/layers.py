"""Functional layers over PyTorch parameter modules (port of
stable_diffusion_tpu/models/layers.py).

Activations are NHWC and norm statistics are f32, as in JAX.  The modules
(``nn.Linear``, ``nn.Conv2d``, ``nn.GroupNorm``, ``nn.LayerNorm``,
``nn.Embedding``) only hold parameters in PyTorch's layout; the maths is
here.  ``use_im2col_conv`` is not ported: it chose an XLA lowering.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from stable_diffusion_tpu_torch.ops.groupnorm import group_norm_plain


def linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ W^T + b."""
    return F.linear(x, mod.weight, mod.bias)


def conv2d(mod: nn.Conv2d, x: torch.Tensor, *, stride: int = 1, padding=None) -> torch.Tensor:
    """NHWC conv.  ``padding`` None means SAME for odd kernels (k // 2); an
    int pads every side.  A 1x1 stride-1 conv is a per-pixel matmul."""
    k = mod.weight.shape[-1]
    if k == 1 and stride == 1 and not padding:
        return F.linear(x, mod.weight[:, :, 0, 0], mod.bias)
    pad = k // 2 if padding is None else padding
    y = F.conv2d(x.permute(0, 3, 1, 2), mod.weight, mod.bias, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()


def embedding(mod: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    return mod.weight[ids]


def layer_norm(mod: nn.LayerNorm, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * mod.weight.float() + mod.bias.float()).to(x.dtype)


def group_norm(mod: nn.GroupNorm, x: torch.Tensor, *, num_groups: int = 32,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel (last) dim; channel c is in group c // (C/G)."""
    return group_norm_plain(x, mod.weight, mod.bias, num_groups, eps)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def geglu(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """proj to 2*out, split, value * gelu(gate); parameter path "proj"."""
    value, gate = linear(mod.proj, x).chunk(2, dim=-1)
    return value * gelu(gate)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


class GEGLU(nn.Module):
    """Parameter holder for :func:`geglu` (key path ``proj``)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * hidden)
