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

K9 (csrc/ffn_q.cu) is the static-W8A8 form, replacing ffn.py's int8
``_make_q_kernel`` (``_ffn_q``): LN -> quantize with the first linear's
act_scale -> int8 value and gate products -> dequantize -> GeGLU in f32 ->
requantize with the second linear's act_scale -> int8 W2 product, its int32
partial sums added over the hidden blocks -> dequantize, +b2, +residual.
The plain version follows JAX ``_ffn_q_xla`` (the layer path: the LN and
each linear's output cast to the input dtype); K9 keeps the LN output and
the GeGLU intermediate in f32 as the TPU kernel does, so in f32 the two are
one function.  Inference only.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from stable_diffusion_tpu_torch.ops import _cuda
from stable_diffusion_tpu_torch.ops._autograd import Recompute
from stable_diffusion_tpu_torch.ops.linear import layer_norm_plain, matmul_w8a8_plain
from stable_diffusion_tpu_torch.ops.quantize import folded_scales
from stable_diffusion_tpu_torch.utils.device import (LaunchCounter, at_least_f32, require,
                                                     require_inference, require_no_grad, use_kernel,
                                                     wants_grad)

K4 = LaunchCounter()
K9 = LaunchCounter()


def geglu_ffn_plain(x, ln_weight, ln_bias, w1, b1, w2, b2, residual=None, *, eps: float = 1e-5):
    """LN -> GeGLU -> W2 (+residual), as the JAX layer path: f32 LN stats, the
    gelu taken in f32 and cast back (``_ffn_xla``)."""
    h = F.linear(layer_norm_plain(x, ln_weight, ln_bias, eps), w1, b1)
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


# ---------------------------------------------------------------------------
# Static W8A8: K9
# ---------------------------------------------------------------------------


def geglu_ffn_w8a8_plain(x, ln_weight, ln_bias, w1_q, w1_scale, b1, act1, w2_q, w2_scale, b2, act2,
                         residual=None, *, eps: float = 1e-5):
    """(LN ->) W8A8 GeGLU FFN (-> +residual), JAX ``_ffn_q_xla``: W1 (2H, C)
    int8 value rows then gate rows, W2 (C, H) int8; act1 / act2 the two
    linears' calibrated input absmax."""
    h = x if ln_weight is None else layer_norm_plain(x, ln_weight, ln_bias, eps)
    h = matmul_w8a8_plain(h, w1_q, w1_scale, act1, b1)
    value, gate = h.chunk(2, dim=-1)
    h = value * F.gelu(at_least_f32(gate)).to(x.dtype)
    out = matmul_w8a8_plain(h, w2_q, w2_scale, act2, b2)
    return out if residual is None else out + residual


def geglu_ffn_w8a8_kernel(x, ln_weight, ln_bias, w1_q, s1, out_scale1, b1, w2_q, s2, out_scale2, b2,
                          residual=None, *, eps: float = 1e-5):
    """Launch K9.  x (..., C) bf16 contiguous on CUDA; w1_q (2H, C) and w2_q
    (C, H) int8; (s1, out_scale1) and (s2, out_scale2) the two linears'
    ``folded_scales``; b1 (2H,), b2 (C,), the LN affine (C,) and the
    residual bf16."""
    require_no_grad("K9", x, ln_weight, ln_bias, b1, b2, residual)
    require(x.is_cuda, f"K9 needs a CUDA tensor, got {x.device}")
    c = x.shape[-1]
    m = x.numel() // c
    hidden = w2_q.shape[-1]
    require(c % 32 == 0 and hidden % 64 == 0,
            f"K9 takes C % 32 == 0 and a hidden width % 64 == 0, got C={c}, H={hidden}")
    require(w1_q.shape == (2 * hidden, c) and w2_q.shape == (c, hidden)
            and all(t.dtype == torch.int8 and t.is_contiguous() for t in (w1_q, w2_q)),
            f"K9: w1_q {tuple(w1_q.shape)} / w2_q {tuple(w2_q.shape)} for C={c}, H={hidden}")
    for t, n in ((s1, 1), (out_scale1, 2 * hidden), (s2, 1), (out_scale2, c)):
        require(t.shape == (n,) and t.dtype == torch.float32 and t.is_contiguous(),
                "K9: the folded scales must be contiguous f32")
    bf = [x, b1, b2] + [t for t in (ln_weight, ln_bias, residual) if t is not None]
    require(all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in bf),
            "K9 takes contiguous bf16 activations, biases, residual and LN affine")
    require(b1.shape == (2 * hidden,) and b2.shape == (c,), "K9: bias shapes")
    require((ln_weight is None) == (ln_bias is None)
            and (ln_weight is None or ln_weight.shape == ln_bias.shape == (c,)),
            "K9: LN weight and bias must both be (C,) or both None")
    require(residual is None or residual.shape == x.shape, "K9: residual shape differs from x")
    require(x.data_ptr() % 16 == 0 and w1_q.data_ptr() % 16 == 0 and w2_q.data_ptr() % 16 == 0,
            "K9 needs 16-byte aligned tensors")
    lib = _cuda.library()
    rb, nsplit = ctypes.c_int(), ctypes.c_int()
    _cuda.check(lib.sdtk_ffn_q_plan(m, c, hidden, ctypes.byref(rb), ctypes.byref(nsplit)),
                f"K9 has no launch plan for C={c}, H={hidden}")
    bm = lib.sdtk_ffn_q_rows()
    ws = torch.empty((nsplit.value, (m + bm - 1) // bm * bm, c), device=x.device,
                     dtype=torch.int32)
    out = torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    code = lib.sdtk_ffn_q(
        x.data_ptr(), ptr(ln_weight), ptr(ln_bias), w1_q.data_ptr(), s1.data_ptr(),
        out_scale1.data_ptr(), b1.data_ptr(), w2_q.data_ptr(), s2.data_ptr(),
        out_scale2.data_ptr(), b2.data_ptr(), ptr(residual), ws.data_ptr(), out.data_ptr(),
        m, c, hidden, rb, nsplit, float(eps), _cuda.stream_handle(x))
    _cuda.check(code, "K9 ffn_q")
    K9.launched((m, c, hidden, ln_weight is not None, residual is not None))
    return out


def geglu_ffn_w8a8(x, ln_weight, ln_bias, w1_q, w1_scale, b1, act1, w2_q, w2_scale, b2, act2,
                   residual=None, *, eps: float = 1e-5, impl: str = "auto"):
    """(LN ->) static-W8A8 GeGLU FFN (-> +residual): K9 on the card, the
    plain version on the CPU.  Inference only."""
    require_inference("W8A8 GeGLU FFN", x, ln_weight, ln_bias, w1_scale, b1, act1, w2_scale, b2,
                      act2, residual)
    if not use_kernel(impl, x):
        return geglu_ffn_w8a8_plain(x, ln_weight, ln_bias, w1_q, w1_scale, b1, act1, w2_q,
                                    w2_scale, b2, act2, residual, eps=eps)
    s1, os1 = folded_scales(w1_scale, act1)
    s2, os2 = folded_scales(w2_scale, act2)
    return geglu_ffn_w8a8_kernel(x, ln_weight, ln_bias, w1_q, s1, os1, b1, w2_q, s2, os2, b2,
                                 residual, eps=eps)
