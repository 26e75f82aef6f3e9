"""GroupNorm(+SiLU) over NHWC: kernel K1 (Triton) beside its plain version.

K1 replaces two TPU kernels of stable_diffusion_tpu/ops/groupnorm.py:
``_stats_kernel`` (per-channel sums -> group mean/rstd -> folded (B, 2, C)
scale/shift; ``_stats_call``, ``_run_kernels``) and ``_norm_kernel``
(``y = x * scale + shift`` (+SiLU); ``_run_kernels``).

What bounds it on Hopper: device-memory bandwidth.  It reads the activation
twice (stats, normalize) and writes it once, with a handful of FLOPs per
byte and no tensor-core work, which is why it is a Triton kernel.

Design: the TPU kernel carried sum(x) and sum(x^2) across a sequential HW
grid axis in VMEM scratch and took the one-pass E[x^2] - E[x]^2.  Hopper
runs blocks in parallel and in no order, and the VAE's 512^2 activations
make the one-pass variance lose digits, so the stats are a split reduction
with a safe merge: (1) each program takes a chunk of rows and a block of
channels and writes per-channel (mean, M2) of its chunk, two passes over
the chunk; (2) one program per (batch, group) merges those partials with
Chan's formula (M2 = sum M2_i + sum n_i (mean_i - mean)^2) and folds gamma
and beta into a (B, 2, C) f32 scale/shift; (3) an elementwise pass applies
it (+SiLU).  The scale/shift is also exposed on its own
(:func:`gn_scale_shift`), since K2 applies it in its prologue.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

import torch

from stable_diffusion_tpu_torch.ops._autograd import Recompute
from stable_diffusion_tpu_torch.utils.device import (LaunchCounter, at_least_f32, require,
                                                     require_no_grad, use_kernel, wants_grad)

K1 = LaunchCounter()

_CHUNK = 256  # rows per stats program
_BR = 32      # rows per load inside a program
_BC = 64      # channels per program

tl = None  # triton.language, bound by _kernels() on first launch
_TRITON = None


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and the card's reference)
# ---------------------------------------------------------------------------


def _hw_view(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1, x.shape[-1])


def gn_scale_shift_plain(x, weight, bias, num_groups: int = 32, eps: float = 1e-5):
    """(B, 2, C) f32 folded affine with ``y = x * out[:, 0] + out[:, 1]``;
    two-pass f32 statistics as models/layers.group_norm."""
    b, c = x.shape[0], x.shape[-1]
    g = num_groups
    xf = at_least_f32(x).reshape(b, -1, g, c // g)
    mean = xf.mean(dim=(1, 3))
    var = (xf - mean[:, None, :, None]).square().mean(dim=(1, 3))
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(c // g, dim=-1)
    inv_c = inv.repeat_interleave(c // g, dim=-1)
    scale = at_least_f32(weight)[None, :] * inv_c
    shift = at_least_f32(bias)[None, :] - mean_c * scale
    return torch.stack([scale, shift], dim=1)


def group_norm_plain(x, weight, bias, num_groups: int = 32, eps: float = 1e-5, silu: bool = False):
    """models/layers.group_norm (+SiLU): f32 statistics, cast back."""
    b, c = x.shape[0], x.shape[-1]
    g = num_groups
    xf = at_least_f32(x).reshape(b, -1, g, c // g)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = (y * at_least_f32(weight) + at_least_f32(bias)).to(x.dtype)
    return torch.nn.functional.silu(y) if silu else y


def gn_silu_prologue(x, scale_shift):
    """``silu(x * scale + shift)`` in f32, cast to x's dtype: the activation
    the convs K2, K7 and K12 take in their prologue, from a (B, 2, C) f32
    ``scale_shift``."""
    xf = at_least_f32(x) * scale_shift[:, None, None, 0] + scale_shift[:, None, None, 1]
    return torch.nn.functional.silu(xf).to(x.dtype)


# ---------------------------------------------------------------------------
# The Triton kernels, defined on first launch
# ---------------------------------------------------------------------------


def _kernels():
    global tl, _TRITON
    if _TRITON is not None:
        return _TRITON
    os.environ.setdefault(
        "TRITON_CACHE_DIR",
        str(Path(__file__).resolve().parents[2] / "build" / "triton_cache"))
    import triton
    import triton.language as language

    tl = language

    @triton.jit
    def partial_stats(x_ptr, part_ptr, HW, C, NCH,
                      CHUNK: tl.constexpr, BR: tl.constexpr, BC: tl.constexpr):
        b = tl.program_id(0).to(tl.int64)
        ch = tl.program_id(1)
        cols = tl.program_id(2) * BC + tl.arange(0, BC)
        cmask = cols < C
        r0 = ch * CHUNK
        n = tl.minimum(CHUNK, HW - r0).to(tl.float32)
        base = x_ptr + b * HW * C
        s = tl.zeros([BC], tl.float32)
        for i in range(0, CHUNK, BR):
            rows = r0 + i + tl.arange(0, BR)
            m = (rows < HW)[:, None] & cmask[None, :]
            v = tl.load(base + rows[:, None] * C + cols[None, :], mask=m, other=0.0)
            s += tl.sum(v.to(tl.float32), axis=0)
        mean = s / n
        q = tl.zeros([BC], tl.float32)
        for i in range(0, CHUNK, BR):
            rows = r0 + i + tl.arange(0, BR)
            m = (rows < HW)[:, None] & cmask[None, :]
            v = tl.load(base + rows[:, None] * C + cols[None, :], mask=m, other=0.0)
            d = tl.where(m, v.to(tl.float32) - mean[None, :], 0.0)
            q += tl.sum(d * d, axis=0)
        pbase = part_ptr + (b * NCH + ch) * 2 * C
        tl.store(pbase + cols, mean, mask=cmask)
        tl.store(pbase + C + cols, q, mask=cmask)

    @triton.jit
    def finalize(part_ptr, w_ptr, b_ptr, ss_ptr, HW, C, NCH, CPG, eps,
                 CHUNK: tl.constexpr, BN: tl.constexpr, BG: tl.constexpr):
        b = tl.program_id(0).to(tl.int64)
        g = tl.program_id(1)
        j = tl.arange(0, BG)
        jmask = j < CPG
        ch = g * CPG + j
        total = (HW * CPG).to(tl.float32)
        acc = tl.zeros([BN, BG], tl.float32)
        for i0 in range(0, NCH, BN):
            idx = i0 + tl.arange(0, BN)
            imask = idx < NCH
            cnt = tl.minimum(CHUNK, HW - idx * CHUNK).to(tl.float32)
            m = imask[:, None] & jmask[None, :]
            ptr = part_ptr + ((b * NCH + idx) * 2 * C)[:, None] + ch[None, :]
            mu = tl.load(ptr, mask=m, other=0.0)
            acc += tl.where(m, cnt[:, None] * mu, 0.0)
        mean = tl.sum(tl.sum(acc, axis=1), axis=0) / total
        acc2 = tl.zeros([BN, BG], tl.float32)
        for i0 in range(0, NCH, BN):
            idx = i0 + tl.arange(0, BN)
            imask = idx < NCH
            cnt = tl.minimum(CHUNK, HW - idx * CHUNK).to(tl.float32)
            m = imask[:, None] & jmask[None, :]
            ptr = part_ptr + ((b * NCH + idx) * 2 * C)[:, None] + ch[None, :]
            mu = tl.load(ptr, mask=m, other=0.0)
            m2 = tl.load(ptr + C, mask=m, other=0.0)
            d = mu - mean
            acc2 += tl.where(m, m2 + cnt[:, None] * d * d, 0.0)
        var = tl.sum(tl.sum(acc2, axis=1), axis=0) / total
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(w_ptr + ch, mask=jmask, other=0.0).to(tl.float32)
        bb = tl.load(b_ptr + ch, mask=jmask, other=0.0).to(tl.float32)
        scale = w * rstd
        shift = bb - mean * scale
        tl.store(ss_ptr + b * 2 * C + ch, scale, mask=jmask)
        tl.store(ss_ptr + b * 2 * C + C + ch, shift, mask=jmask)

    @triton.jit
    def apply(x_ptr, ss_ptr, y_ptr, HW, C,
              SILU: tl.constexpr, BR: tl.constexpr, BC: tl.constexpr):
        b = tl.program_id(0).to(tl.int64)
        rows = tl.program_id(1) * BR + tl.arange(0, BR)
        cols = tl.program_id(2) * BC + tl.arange(0, BC)
        cmask = cols < C
        m = (rows < HW)[:, None] & cmask[None, :]
        off = b * HW * C + rows[:, None] * C + cols[None, :]
        x = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
        sc = tl.load(ss_ptr + b * 2 * C + cols, mask=cmask, other=0.0)
        sh = tl.load(ss_ptr + b * 2 * C + C + cols, mask=cmask, other=0.0)
        y = x * sc[None, :] + sh[None, :]
        if SILU:
            y = y / (1.0 + tl.exp(-y))
        tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=m)

    _TRITON = (triton, partial_stats, finalize, apply)
    return _TRITON


def _check(x, weight, num_groups):
    require(x.is_cuda, f"K1 needs a CUDA tensor, got {x.device}")
    require(x.dtype in (torch.bfloat16, torch.float32), f"K1 takes bf16/f32, got {x.dtype}")
    require(x.is_contiguous(), "K1 needs a contiguous NHWC tensor")
    c = x.shape[-1]
    require(c % num_groups == 0, f"K1: C={c} not divisible by {num_groups} groups")
    require(weight.shape == (c,), f"K1: GroupNorm weight {tuple(weight.shape)} for C={c}")


def _stats_launch(x3, weight, bias, num_groups, eps):
    triton, partial_stats, finalize, _ = _kernels()
    b, hw, c = x3.shape
    nch = triton.cdiv(hw, _CHUNK)
    part = torch.empty((b, nch, 2, c), device=x3.device, dtype=torch.float32)
    ss = torch.empty((b, 2, c), device=x3.device, dtype=torch.float32)
    partial_stats[(b, nch, triton.cdiv(c, _BC))](
        x3, part, hw, c, nch, CHUNK=_CHUNK, BR=_BR, BC=_BC)
    cpg = c // num_groups
    finalize[(b, num_groups)](
        part, weight.contiguous(), bias.contiguous(), ss, hw, c, nch, cpg, float(eps),
        CHUNK=_CHUNK, BN=64, BG=max(triton.next_power_of_2(cpg), 2))
    return ss


def gn_scale_shift_kernel(x, weight, bias, *, num_groups: int = 32,
                          eps: float = 1e-5) -> torch.Tensor:
    """Launch K1's statistics kernels: the folded (B, 2, C) f32 affine."""
    require_no_grad("K1", x, weight, bias)
    _check(x, weight, num_groups)
    x3 = _hw_view(x)
    ss = _stats_launch(x3, weight, bias, num_groups, eps)
    K1.launched(("stats", *x3.shape, x.dtype, eps))
    return ss


def group_norm_silu_kernel(x, weight, bias, *, num_groups: int = 32, eps: float = 1e-5,
                           silu: bool = True) -> torch.Tensor:
    """Launch K1: statistics, then the normalize (+SiLU) pass."""
    require_no_grad("K1", x, weight, bias)
    _check(x, weight, num_groups)
    triton, _, _, apply = _kernels()
    x3 = _hw_view(x)
    b, hw, c = x3.shape
    ss = _stats_launch(x3, weight, bias, num_groups, eps)
    y = torch.empty_like(x)
    apply[(b, triton.cdiv(hw, 64), triton.cdiv(c, _BC))](
        x3, ss, y, hw, c, SILU=silu, BR=64, BC=_BC)
    K1.launched(("norm", b, hw, c, x.dtype, eps, silu))
    return y


# ---------------------------------------------------------------------------
# Entry points: the kernel on the card (in its autograd Function when a
# gradient is wanted), the plain version on the CPU
# ---------------------------------------------------------------------------


def gn_scale_shift(x, weight, bias, *, num_groups: int = 32, eps: float = 1e-5,
                   impl: str = "auto") -> torch.Tensor:
    """Folded GroupNorm affine (B, 2, C) f32: ``y = x * out[:, 0] + out[:, 1]``."""
    plain = functools.partial(gn_scale_shift_plain, num_groups=num_groups, eps=eps)
    if not use_kernel(impl, x):
        return plain(x, weight, bias)
    fwd = functools.partial(gn_scale_shift_kernel, num_groups=num_groups, eps=eps)
    if wants_grad(x, weight, bias):
        return Recompute.apply(fwd, plain, x, weight, bias)
    return fwd(x, weight, bias)


def group_norm_silu(x, weight, bias, *, num_groups: int = 32, eps: float = 1e-5,
                    silu: bool = True, impl: str = "auto") -> torch.Tensor:
    """GroupNorm over the channel (last) dim of an NHWC tensor (+SiLU).  Its
    gradient is the VJP of the plain version, recomputed (JAX ``_gn_bwd``)."""
    plain = functools.partial(group_norm_plain, num_groups=num_groups, eps=eps, silu=silu)
    if not use_kernel(impl, x):
        return plain(x, weight, bias)
    fwd = functools.partial(group_norm_silu_kernel, num_groups=num_groups, eps=eps, silu=silu)
    if wants_grad(x, weight, bias):
        return Recompute.apply(fwd, plain, x, weight, bias)
    return fwd(x, weight, bias)
