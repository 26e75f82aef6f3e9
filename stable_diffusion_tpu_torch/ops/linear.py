"""The matmuls of stable_diffusion_tpu/ops/linear.py that the UNet calls:
the static-W8A8 matmul, kernel K8 (CUDA), beside its plain version, and the
plain forms of the bf16 fused matmuls.

K8 (csrc/linear_q.cu) replaces ``_make_q_kernel`` (``_q_mm_call``, entries
``ln_matmul_w8a8`` / ``matmul_w8a8``): (LayerNorm ->) quantize the
activation to int8 with the layer's static scale -> int8 x int8 -> int32
product -> dequantize, +bias (+residual).  The int8 activation never reaches
device memory.  One kernel serves every W8A8 linear of the UNet (fused QKV,
cross q/k/v, the out projections, ``t_embed`` and the time embedding) at any
M; the note at the top of the source says what bounds it.  Inference only:
every W8A8 entry point raises NotImplementedError when an input wants a
gradient (JAX ``_q_raise_bwd``).

Weights are in PyTorch's (out, in) layout: ``weight_q`` (N, K) int8,
``weight_scale`` (N,).  The plain version follows JAX ``_q_mm_xla``: the
LayerNorm output cast to the input dtype, then divided by s_x, rounded and
clipped.  K8 follows the TPU kernel: the f32 LN output goes to the
quantizer unrounded, and the dequantize, bias and residual run in f32 with
one rounding.  In f32 the two are one function; both divide by s_x (not
multiply by its inverse), so the same f32 input gives the same codes.

With its default ``SD_TPU_FUSED_MM=0`` the JAX package runs
``matmul_residual`` and ``gn_matmul`` as XLA; here they are matmuls, and
``gn_matmul`` takes its GroupNorm from K1.  The bf16 fused-matmul Pallas
kernels behind that switch are still to be ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stable_diffusion_tpu_torch.ops import _cuda
from stable_diffusion_tpu_torch.ops.groupnorm import group_norm_silu
from stable_diffusion_tpu_torch.ops.quantize import act_step, folded_scales, int_matmul, quantize_act
from stable_diffusion_tpu_torch.utils.device import (LaunchCounter, at_least_f32, require,
                                                     require_inference, require_no_grad, use_kernel)

K8 = LaunchCounter()


def matmul_residual(x, weight, bias, res):
    """x @ W^T + b + res; weight in PyTorch's (out, in) layout."""
    return F.linear(x, weight, bias) + res


def gn_matmul(x, gn_weight, gn_bias, weight, bias=None, *, num_groups: int = 32,
              eps: float = 1e-5, impl: str = "auto"):
    """GroupNorm(x) @ W^T + b over NHWC x (the 1x1-conv-as-matmul case)."""
    xn = group_norm_silu(x, gn_weight, gn_bias, num_groups=num_groups, eps=eps,
                         silu=False, impl=impl)
    return F.linear(xn, weight, bias)


# ---------------------------------------------------------------------------
# Static W8A8: plain version, kernel wrapper, entry points
# ---------------------------------------------------------------------------


def layer_norm_plain(x, weight, bias, eps: float = 1e-5):
    """models/layers.layer_norm: f32 statistics, cast back to x's dtype."""
    xf = at_least_f32(x)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * at_least_f32(weight) + at_least_f32(bias)).to(x.dtype)


def matmul_w8a8_plain(x, weight_q, weight_scale, act_scale, bias=None, residual=None,
                      ln_weight=None, ln_bias=None, *, eps: float = 1e-5):
    """(LN ->) quantize -> int8 product -> dequant (+b) (+res): JAX ``_q_mm_xla``."""
    h = x if ln_weight is None else layer_norm_plain(x, ln_weight, ln_bias, eps)
    s_x = act_step(act_scale)
    acc = int_matmul(quantize_act(h, s_x), weight_q)
    y = (acc * (s_x * weight_scale.float().reshape(-1))).to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y if residual is None else y + residual


def matmul_w8a8_kernel(x, weight_q, s_x, out_scale, bias=None, residual=None,
                       ln_weight=None, ln_bias=None, *, eps: float = 1e-5):
    """Launch K8.  x (..., K) bf16 contiguous on CUDA; weight_q (N, K) int8;
    s_x (1,) and out_scale = s_x * weight_scale (N,) f32 (``folded_scales``);
    bias (N,), residual (..., N) and the LN affine (K,) bf16."""
    require_no_grad("K8", x, bias, residual, ln_weight, ln_bias)
    require(x.is_cuda, f"K8 needs a CUDA tensor, got {x.device}")
    k = x.shape[-1]
    m = x.numel() // k
    n = weight_q.shape[0]
    require(k % 32 == 0 and n % 8 == 0, f"K8 takes K % 32 == 0 and N % 8 == 0, got K={k}, N={n}")
    require(weight_q.shape == (n, k) and weight_q.dtype == torch.int8 and weight_q.is_contiguous(),
            f"K8: weight_q must be contiguous int8 (N, K={k}), got {tuple(weight_q.shape)}")
    require(s_x.shape == (1,) and out_scale.shape == (n,)
            and all(t.dtype == torch.float32 and t.is_contiguous() for t in (s_x, out_scale)),
            "K8: s_x (1,) and out_scale (N,) must be contiguous f32")
    bf = [x] + [t for t in (bias, residual, ln_weight, ln_bias) if t is not None]
    require(all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in bf),
            "K8 takes contiguous bf16 activations, bias, residual and LN affine")
    require(x.data_ptr() % 16 == 0 and weight_q.data_ptr() % 16 == 0, "K8 needs 16-byte alignment")
    require(bias is None or bias.shape == (n,), "K8: bias must be (N,)")
    require(residual is None or residual.shape == (*x.shape[:-1], n), "K8: residual shape")
    require((ln_weight is None) == (ln_bias is None)
            and (ln_weight is None or ln_weight.shape == ln_bias.shape == (k,)),
            "K8: LN weight and bias must both be (K,) or both None")
    out = torch.empty((*x.shape[:-1], n), device=x.device, dtype=x.dtype)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    code = _cuda.library().sdtk_linear_q(
        x.data_ptr(), ptr(ln_weight), ptr(ln_bias), weight_q.data_ptr(), s_x.data_ptr(),
        out_scale.data_ptr(), ptr(bias), ptr(residual), out.data_ptr(), m, n, k, float(eps),
        _cuda.stream_handle(x))
    _cuda.check(code, "K8 linear_q")
    K8.launched((m, k, n, ln_weight is not None, residual is not None))
    return out


def _w8a8(x, ln_weight, ln_bias, weight_q, weight_scale, act_scale, bias, residual, eps, impl):
    require_inference("W8A8 matmul", x, ln_weight, ln_bias, weight_scale, act_scale, bias, residual)
    if not use_kernel(impl, x):
        return matmul_w8a8_plain(x, weight_q, weight_scale, act_scale, bias, residual,
                                 ln_weight, ln_bias, eps=eps)
    s_x, out_scale = folded_scales(weight_scale, act_scale)
    return matmul_w8a8_kernel(x, weight_q, s_x, out_scale, bias, residual, ln_weight, ln_bias,
                              eps=eps)


def ln_matmul_w8a8(ln_weight, ln_bias, x, weight_q, weight_scale, act_scale, bias=None, *,
                   eps: float = 1e-5, residual=None, impl: str = "auto"):
    """LayerNorm -> static-W8A8 matmul (+bias) (+residual): K8 on the card."""
    return _w8a8(x, ln_weight, ln_bias, weight_q, weight_scale, act_scale, bias, residual, eps,
                 impl)


def matmul_w8a8(x, weight_q, weight_scale, act_scale, bias=None, *, residual=None,
                impl: str = "auto"):
    """Static-W8A8 matmul (+bias) (+residual), the quantize fused in: K8 on the card."""
    return _w8a8(x, None, None, weight_q, weight_scale, act_scale, bias, residual, 1e-5, impl)
