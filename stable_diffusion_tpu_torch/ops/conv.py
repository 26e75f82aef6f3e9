"""3x3 SAME stride-1 conv over NHWC: kernel K2 (CUDA) beside its plain version.

K2 (csrc/conv3x3.cu) replaces stable_diffusion_tpu/ops/conv.py
``_conv3x3_kernel``; the note at the top of the source says what bounds it
and how it is built.  :func:`gn_silu_conv3x3` takes the GroupNorm statistics
from K1 and hands the folded (B, 2, C) scale/shift to K2's prologue, so the
normalised activation never reaches device memory; :func:`conv3x3` runs K2
without a prologue (the upsamplers).

Weights arrive in PyTorch's OIHW layout; the kernel reads HWIO, re-laid once
per weight and cached on the weight tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stable_diffusion_tpu_torch.ops import _cuda
from stable_diffusion_tpu_torch.ops.groupnorm import gn_scale_shift, group_norm_plain
from stable_diffusion_tpu_torch.utils.device import LaunchCounter, require, use_kernel

K2 = LaunchCounter()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def conv3x3_plain(x, weight, bias=None):
    """NHWC x, OIHW weight -> NHWC, zero padding 1 (F.conv2d)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def gn_silu_conv3x3_plain(x, gn_weight, gn_bias, weight, bias=None, *,
                          num_groups: int = 32, eps: float = 1e-5):
    """GroupNorm -> SiLU -> zero-padded 3x3 conv, as the JAX XLA path."""
    h = group_norm_plain(x, gn_weight, gn_bias, num_groups, eps, silu=True)
    return conv3x3_plain(h, weight, bias)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def hwio(weight: torch.Tensor) -> torch.Tensor:
    """The weight in HWIO layout, contiguous, cached on the weight tensor."""
    key = (weight.data_ptr(), weight._version, weight.dtype, weight.device)
    cached = getattr(weight, "_sdtk_hwio", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    w = weight.detach().permute(2, 3, 1, 0).contiguous()
    weight._sdtk_hwio = (key, w)
    return w


def conv3x3_kernel(x, weight, bias=None, scale_shift=None):
    """Launch K2.  x (B,H,W,Cin) bf16 contiguous; weight OIHW (Cout,Cin,3,3);
    scale_shift (B, 2, Cin) f32 applies GroupNorm+SiLU to x first."""
    require(x.is_cuda, f"K2 needs a CUDA tensor, got {x.device}")
    require(x.dtype == torch.bfloat16, f"K2 takes bf16, got {x.dtype}")
    require(x.dim() == 4 and x.is_contiguous(), "K2 needs a contiguous NHWC tensor")
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    require(tuple(weight.shape) == (cout, cin, 3, 3), f"K2: weight {tuple(weight.shape)} for Cin={cin}")
    require(weight.dtype == torch.bfloat16, f"K2: weight dtype {weight.dtype}")
    require(cin % 8 == 0 and cout % 8 == 0, f"K2 takes Cin % 8 == 0 and Cout % 8 == 0, got {cin}->{cout}")
    wk = hwio(weight)
    if bias is not None:
        require(bias.shape == (cout,) and bias.dtype == torch.bfloat16 and bias.is_contiguous(),
                "K2: bias must be contiguous bf16 (Cout,)")
    if scale_shift is not None:
        require(scale_shift.shape == (b, 2, cin) and scale_shift.dtype == torch.float32
                and scale_shift.is_contiguous(), "K2: scale_shift must be contiguous f32 (B, 2, Cin)")
    require(x.data_ptr() % 16 == 0 and wk.data_ptr() % 16 == 0, "K2 needs 16-byte aligned tensors")
    lib = _cuda.library()
    ksplit = lib.sdtk_conv3x3_ksplit(b, h, w, cin, cout)
    ws = (torch.empty((ksplit, b * h * w, cout), device=x.device, dtype=torch.float32)
          if ksplit > 1 else None)
    y = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
    code = lib.sdtk_conv3x3(
        x.data_ptr(), wk.data_ptr(), None if bias is None else bias.data_ptr(),
        None if scale_shift is None else scale_shift.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), b, h, w, cin, cout, ksplit,
        _cuda.stream_handle(x))
    _cuda.check(code, "K2 conv3x3")
    K2.launched((b, h, w, cin, cout, scale_shift is not None))
    return y


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def conv3x3(x, weight, bias=None, *, impl: str = "auto"):
    """3x3 SAME stride-1 conv (the upsamplers' conv)."""
    if not use_kernel(impl, x):
        return conv3x3_plain(x, weight, bias)
    return conv3x3_kernel(x, weight, bias)


def gn_silu_conv3x3(x, gn_weight, gn_bias, weight, bias=None, *, num_groups: int = 32,
                    eps: float = 1e-5, impl: str = "auto"):
    """GroupNorm -> SiLU -> conv3x3, the resblock pattern: K1 stats, then K2
    with the normalize+SiLU folded into its input reads."""
    if not use_kernel(impl, x):
        return gn_silu_conv3x3_plain(x, gn_weight, gn_bias, weight, bias,
                                     num_groups=num_groups, eps=eps)
    ss = gn_scale_shift(x, gn_weight, gn_bias, num_groups=num_groups, eps=eps, impl=impl)
    return conv3x3_kernel(x, weight, bias, ss)
