"""The transformer's GeGLU feed-forward block: kernel K4 (CUDA) beside its
plain version.

K4 (csrc/ffn.cu) replaces stable_diffusion_tpu/ops/ffn.py's bf16
``_make_kernel`` (``_ffn_call`` via ``geglu_ffn`` -> ``_ln_ffn_res``): LN ->
x W1 split into value and gate halves -> (hv + bv) * gelu_erf(hg + bg) ->
W2 -> +b2 -> +residual, with the (M, 8C) intermediate kept out of device
memory.  The note at the top of the source says what bounds it and how it
is built.

Weights are in PyTorch's layout: W1 (8C, C) with the value rows first and
the gate rows second, W2 (C, 4C).  The gradient is the VJP of the plain
version, recomputed (JAX ``_ln_ffn_res_bwd``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from stable_diffusion_tpu_torch.ops import _cuda
from stable_diffusion_tpu_torch.ops._autograd import Recompute
from stable_diffusion_tpu_torch.utils.device import (LaunchCounter, at_least_f32, require,
                                                     require_no_grad, use_kernel, wants_grad)

K4 = LaunchCounter()


def geglu_ffn_plain(x, ln_weight, ln_bias, w1, b1, w2, b2, residual=None, *, eps: float = 1e-5):
    """LN -> GeGLU -> W2 (+residual), as the JAX layer path: f32 LN stats, the
    gelu taken in f32 and cast back (``_ffn_xla``)."""
    xf = at_least_f32(x)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    h = ((xf - mean) * torch.rsqrt(var + eps) * at_least_f32(ln_weight) + at_least_f32(ln_bias)).to(x.dtype)
    h = F.linear(h, w1, b1)
    value, gate = h.chunk(2, dim=-1)
    h = value * F.gelu(at_least_f32(gate)).to(x.dtype)
    out = F.linear(h, w2, b2)
    return out if residual is None else out + residual


def geglu_ffn_kernel(x, ln_weight, ln_bias, w1, b1, w2, b2, residual=None, *, eps: float = 1e-5):
    """Launch K4.  x (..., C) bf16 on CUDA; every parameter bf16 and contiguous."""
    require_no_grad("K4", x, ln_weight, ln_bias, w1, b1, w2, b2, residual)
    require(x.is_cuda, f"K4 needs a CUDA tensor, got {x.device}")
    c = x.shape[-1]
    m = x.numel() // c
    require(c % 16 == 0, f"K4 takes C % 16 == 0, got C={c}")
    shapes = ((ln_weight, (c,)), (ln_bias, (c,)), (w1, (8 * c, c)), (b1, (8 * c,)),
              (w2, (c, 4 * c)), (b2, (c,)))
    for t, want in shapes:
        require(tuple(t.shape) == want, f"K4: parameter {tuple(t.shape)}, expected {want}")
    tensors = [x, *(t for t, _ in shapes)] + ([] if residual is None else [residual])
    for t in tensors:
        require(t.dtype == torch.bfloat16 and t.is_contiguous() and t.data_ptr() % 32 == 0,
                "K4 takes contiguous, 32-byte aligned bf16 tensors")
    if residual is not None:
        require(residual.shape == x.shape, "K4: residual shape differs from x")
    lib = _cuda.library()
    bm, rb, nsplit = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _cuda.check(lib.sdtk_ffn_plan(m, c, ctypes.byref(bm), ctypes.byref(rb), ctypes.byref(nsplit)),
                f"K4 has no launch plan for C={c}")
    mpad = (m + bm.value - 1) // bm.value * bm.value
    ws = torch.empty((nsplit.value, mpad, c), device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    code = lib.sdtk_ffn(
        x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), None if residual is None else residual.data_ptr(),
        ws.data_ptr(), out.data_ptr(), m, c, bm, rb, nsplit, float(eps), _cuda.stream_handle(x))
    _cuda.check(code, "K4 ffn")
    K4.launched((m, c))
    return out


def geglu_ffn(x, ln_weight, ln_bias, w1, b1, w2, b2, residual=None, *, eps: float = 1e-5,
              impl: str = "auto"):
    """LN -> GeGLU FFN (-> +residual): K4 on the card, the plain version on the CPU."""
    args = (x, ln_weight, ln_bias, w1, b1, w2, b2, residual)
    plain = functools.partial(geglu_ffn_plain, eps=eps)
    if not use_kernel(impl, x):
        return plain(*args)
    fwd = functools.partial(geglu_ffn_kernel, eps=eps)
    if wants_grad(*args):
        return Recompute.apply(fwd, plain, *args)
    return fwd(*args)
