"""The plain forms of stable_diffusion_tpu/ops/linear.py that the UNet calls.

With its default ``SD_TPU_FUSED_MM=0`` the JAX package runs
``matmul_residual`` and ``gn_matmul`` as XLA; here they are matmuls, and
``gn_matmul`` takes its GroupNorm from K1.  The fused-matmul Pallas kernels
behind that switch are still to be ported.
"""

from __future__ import annotations

import torch.nn.functional as F

from stable_diffusion_tpu_torch.ops.groupnorm import group_norm_silu


def matmul_residual(x, weight, bias, res):
    """x @ W^T + b + res; weight in PyTorch's (out, in) layout."""
    return F.linear(x, weight, bias) + res


def gn_matmul(x, gn_weight, gn_bias, weight, bias=None, *, num_groups: int = 32,
              eps: float = 1e-5, impl: str = "auto"):
    """GroupNorm(x) @ W^T + b over NHWC x (the 1x1-conv-as-matmul case)."""
    xn = group_norm_silu(x, gn_weight, gn_bias, num_groups=num_groups, eps=eps,
                         silu=False, impl=impl)
    return F.linear(xn, weight, bias)
