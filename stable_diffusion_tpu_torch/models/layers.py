"""Functional layers over PyTorch parameter modules (port of
stable_diffusion_tpu/models/layers.py).

Activations are NHWC and norm statistics are f32, as in JAX.  The modules
(``nn.Linear``, ``nn.Conv2d``, ``nn.GroupNorm``, ``nn.LayerNorm``,
``nn.Embedding``, and the int8 holders :class:`QLinear` / :class:`QConv2d`)
only hold parameters in PyTorch's layout; the maths is here.
``use_im2col_conv`` is not ported: it chose an XLA lowering.

Quantized holders (utils/quantize_model.py makes them): a :class:`QLinear`
with an ``act_scale`` is static W8A8 and runs the int8 matmul (K8 on the
card); without one it is weight-only int8 and runs on its dequantized
weight, as the JAX ``kernel_q`` forms.  A :class:`QConv2d` with an
``act_scale`` runs the int8 conv (K7) where :func:`gn_silu_conv3x3` calls
it; elsewhere it is dequantized.

Calibration (utils/quantize_model.py) sets :data:`CAPTURE`: while it is set,
:func:`linear` and :func:`gn_silu_conv3x3` record the absmax of their
layer's input on the device, keyed by the holder module (JAX patches
``layers.linear`` and sets ``ops/conv._CAPTURE``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from stable_diffusion_tpu_torch.ops import conv as conv_ops
from stable_diffusion_tpu_torch.ops.groupnorm import group_norm_plain
from stable_diffusion_tpu_torch.ops.linear import layer_norm_plain, matmul_w8a8
from stable_diffusion_tpu_torch.ops.quantize import dequantize_tensor, quantize_tensor
from stable_diffusion_tpu_torch.parallel.mesh import reduce_add, row_parallel
from stable_diffusion_tpu_torch.utils.device import cached


# ---------------------------------------------------------------------------
# Calibration capture
# ---------------------------------------------------------------------------


class Capture:
    """Running input absmax per holder module, kept on the device (f32 0-dim
    tensors), for the linears or the GN+SiLU+3x3 convs."""

    def __init__(self, kind: str):
        if kind not in ("linear", "conv"):
            raise ValueError(f"capture kind must be 'linear' or 'conv', got {kind!r}")
        self.kind = kind
        self.records = {}

    def record(self, mod: nn.Module, x: torch.Tensor) -> None:
        a = x.detach().abs().amax().float()
        prev = self.records.get(mod)
        self.records[mod] = a if prev is None else torch.maximum(prev, a)


CAPTURE: Optional[Capture] = None


def capturing(kind: str) -> bool:
    return CAPTURE is not None and CAPTURE.kind == kind


# ---------------------------------------------------------------------------
# Int8 holders
# ---------------------------------------------------------------------------


class _QuantHolder(nn.Module):
    """Buffers ``weight_q`` int8 (out, ...), ``weight_scale`` f32 (out,),
    ``bias`` (out,) or None and ``act_scale`` f32 () or None.

    The two scales stay f32 when the module is cast to another dtype, and a
    ``state_dict`` that carries ``act_scale`` loads into a holder without
    one (the holder becomes W8A8)."""

    _F32 = ("weight_scale", "act_scale")

    def __init__(self, weight_q, weight_scale, bias=None, act_scale=None):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("weight_scale", weight_scale)
        self.register_buffer("bias", bias)
        self.register_buffer("act_scale", act_scale)

    @classmethod
    def from_float(cls, mod: nn.Module) -> "_QuantHolder":
        """Quantize ``mod``'s weight per output channel (JAX
        ``quantize_tensor`` over every axis but the output's), keeping its
        bias and any ``act_scale`` calibration attached to it."""
        w = mod.weight.detach()
        q, s = quantize_tensor(w.reshape(w.shape[0], -1), axis=1)
        act = getattr(mod, "act_scale", None)
        return cls(q.reshape(w.shape), s.reshape(-1),
                   None if mod.bias is None else mod.bias.detach().clone(),
                   None if act is None else act.detach().float().clone())

    @property
    def w8a8(self) -> bool:
        return self.act_scale is not None

    def dequantized(self, dtype) -> torch.Tensor:
        """The weight as ``dtype`` (JAX's weight-only forms), cached."""
        shape = (-1,) + (1,) * (self.weight_q.dim() - 1)
        return cached(self, f"_sdtk_dequant_{dtype}", [self.weight_q, self.weight_scale],
                      lambda: dequantize_tensor(self.weight_q, self.weight_scale.reshape(shape),
                                                dtype))

    def _apply(self, fn, recurse=True):
        keep = {n: getattr(self, n) for n in self._F32 if getattr(self, n) is not None}
        super()._apply(fn, recurse)
        for n, t in keep.items():
            now = getattr(self, n)
            if now.dtype != torch.float32:
                setattr(self, n, t.to(now.device))
        return self

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if prefix + "act_scale" in state_dict and self.act_scale is None:
            self.act_scale = torch.zeros((), dtype=torch.float32, device=self.weight_q.device)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class QLinear(_QuantHolder):
    """Int8 linear: ``weight_q`` (out, in)."""


class QConv2d(_QuantHolder):
    """Int8 conv: ``weight_q`` OIHW."""


def _conv_weight(mod: nn.Module, dtype) -> torch.Tensor:
    return mod.dequantized(dtype) if isinstance(mod, QConv2d) else mod.weight


# ---------------------------------------------------------------------------
# Dense / conv
# ---------------------------------------------------------------------------


def linear(mod: nn.Module, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """x @ W^T + b; a W8A8 :class:`QLinear` runs the int8 matmul, a
    weight-only one its dequantized weight.  A row-parallel shard
    (parallel/mesh.py) sums its partial product over "model" before the
    bias is added, once."""
    if capturing("linear"):
        CAPTURE.record(mod, x)
    if isinstance(mod, QLinear):
        if mod.w8a8:
            return matmul_w8a8(x, mod.weight_q, mod.weight_scale, mod.act_scale,
                               mod.bias, impl=impl)
        return F.linear(x, mod.dequantized(x.dtype), mod.bias)
    if row_parallel(mod) is not None:
        return reduce_add(mod, F.linear(x, mod.weight))
    return F.linear(x, mod.weight, mod.bias)


def conv2d(mod: nn.Module, x: torch.Tensor, *, stride: int = 1, padding=None) -> torch.Tensor:
    """NHWC conv.  ``padding`` None means SAME for odd kernels (k // 2); an
    int pads every side; ((top, bottom), (left, right)) pads as given (the
    VAE downsampler's ((0, 1), (0, 1))).  A 1x1 stride-1 conv is a
    per-pixel matmul.  A :class:`QConv2d` runs on its dequantized weight
    (JAX ``conv2d``)."""
    weight, bias = _conv_weight(mod, x.dtype), mod.bias
    k = weight.shape[-1]
    if k == 1 and stride == 1 and not padding:
        return F.linear(x, weight[:, :, 0, 0], bias)
    xc = x.permute(0, 3, 1, 2)
    if isinstance(padding, (tuple, list)):
        (top, bottom), (left, right) = padding
        xc, pad = F.pad(xc, (left, right, top, bottom)), 0
    else:
        pad = k // 2 if padding is None else padding
    y = F.conv2d(xc, weight, bias, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3x3(mod: nn.Module, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """3x3 SAME stride-1 conv through K2 (the upsamplers); a :class:`QConv2d`
    is dequantized to x's dtype first (JAX ``_materialize_kernel``)."""
    return conv_ops.conv3x3(x, _conv_weight(mod, x.dtype), mod.bias, impl=impl)


def gn_silu_conv3x3(gn: nn.GroupNorm, conv: nn.Module, x: torch.Tensor, *, num_groups: int = 32,
                    eps: float = 1e-5, impl: str = "auto") -> torch.Tensor:
    """GroupNorm -> SiLU -> 3x3 conv, the resblock pattern (JAX
    ``ops/conv.gn_silu_conv3x3`` on parameter dicts): the int8 conv for a
    W8A8 :class:`QConv2d`, else the bf16 one (dequantized weight for a
    weight-only holder)."""
    if capturing("conv"):
        CAPTURE.record(conv, group_norm_plain(x, gn.weight, gn.bias, num_groups, eps, silu=True))
    if isinstance(conv, QConv2d) and conv.w8a8:
        return conv_ops.gn_silu_conv3x3_w8a8(
            x, gn.weight, gn.bias, conv.weight_q, conv.weight_scale, conv.act_scale,
            conv.bias, num_groups=num_groups, eps=eps, impl=impl)
    return conv_ops.gn_silu_conv3x3(x, gn.weight, gn.bias, _conv_weight(conv, x.dtype),
                                    conv.bias, num_groups=num_groups, eps=eps,
                                    impl=impl)


def embedding(mod: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    return mod.weight[ids]


def layer_norm(mod: nn.LayerNorm, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    return layer_norm_plain(x, mod.weight, mod.bias, eps)


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


def geglu(mod: nn.Module, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """proj to 2*out, split, value * gelu(gate); parameter path "proj"."""
    value, gate = linear(mod.proj, x, impl=impl).chunk(2, dim=-1)
    return value * gelu(gate)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC (from a 1x1 image ``reshape`` alone would return a
    stride-0 view, which K2 refuses)."""
    b, h, w, c = x.shape
    return (x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
            .contiguous())


class GEGLU(nn.Module):
    """Parameter holder for :func:`geglu` (key path ``proj``)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * hidden)
