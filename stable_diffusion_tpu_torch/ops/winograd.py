"""3x3 SAME stride-1 conv as Winograd F(2x2, 3x3): kernel K12 (CUDA) beside
its plain version.

K12 (csrc/winograd.cu) replaces stable_diffusion_tpu/ops/winograd.py
``_wino_kernel``: per 4x4 input patch (stride 2) V = B^T d B, per weight
U = G w G^T, 16 (tiles x Cin) x (Cin x Cout) position products, and
Y = A^T M A + bias; 4 multiplies per output where a direct conv takes 9.
The note at the top of the source says what bounds it and how it is built.
Like K2 it takes an optional (B, 2, Cin) f32 GroupNorm+SiLU
``scale_shift``, applied as the patch is loaded, with the zero halo after
the activation, so it drops in wherever K2 is called (ops/conv.py's
``conv3x3`` and ``gn_silu_conv3x3`` send it the routed shapes) and the
normalized activation never reaches device memory.

The JAX package routes a conv here under SD_TPU_WINOGRAD=1 (read at call
time) for stride 1, SAME padding, even H and W and W >= 16 (``route``).
Its TPU VMEM plan (``_plan``), the host-side ``xw`` patch slab and the batch
chunking that kept that slab under ``_XW_MAX_BYTES`` are TPU artifacts the
port drops: K12 reads the NHWC input directly and writes NHWC, so every
shape the rule admits runs (the 768^2 VAE stages too, which JAX's plan
refused).

K12's launch comes from :func:`winograd_plan` (the region of 64 tiles a
block, the channel blocks, the shared bytes), as the C entry takes it.

Numerics: the transforms are exact in f32 (B and A hold 0 and +-1); V and U
are rounded to the input dtype once before the products, as on the TPU, so
in bf16 K12 carries more rounding than K2 (the transforms grow magnitudes
up to 4x).  The plain version (:func:`conv3x3_winograd_plain`) does the
same arithmetic in torch and equals ops/conv.py's ``conv3x3_plain`` in
f32.  Under autograd the entries run the kernel inside ``Recompute``, whose
backward is the VJP of the plain direct conv (JAX ``_conv_bwd`` recomputes
through XLA).
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from stable_diffusion_tpu_torch.ops import _cuda
from stable_diffusion_tpu_torch.ops.groupnorm import gn_silu_prologue
from stable_diffusion_tpu_torch.utils.device import (LaunchCounter, at_least_f32, cached, require,
                                                     require_no_grad)

K12 = LaunchCounter("K12")

# B^T (4x4), G (4x3), A^T (2x4): the F(2, 3) Winograd matrices (JAX's _BT, _G, _AT)
_BT = ((1, 0, -1, 0), (0, 1, 1, 0), (0, -1, 1, 0), (0, 1, 0, -1))
_AT = ((1, 1, 1, 0), (0, 1, -1, -1))
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))


def _mat(rows, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(rows, dtype=like.dtype, device=like.device)


def route(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, padding="SAME") -> bool:
    """JAX ``route``'s shape rule under SD_TPU_WINOGRAD=1: a 3x3 kernel
    (OIHW here), stride 1, SAME padding, NHWC x with even H and W, W >= 16.
    The TPU VMEM plan is not part of it."""
    if os.environ.get("SD_TPU_WINOGRAD", "0") != "1":
        return False
    if x.dim() != 4 or tuple(weight.shape[2:]) != (3, 3) or stride != 1:
        return False
    if padding not in ("SAME", 1, ((1, 1), (1, 1))):
        return False
    _, h, w, _ = x.shape
    return h % 2 == 0 and w % 2 == 0 and w >= 16


def supported(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, padding="SAME") -> bool:
    """JAX ``supported``: the route, with no slab size to bound here."""
    return route(x, weight, stride, padding)


def transform_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """JAX ``transform_kernel`` without the lane padding: HWIO (3, 3, Cin,
    Cout) -> U = G w G^T as (16, Cin, Cout), computed in f32 (or wider) and
    returned in the kernel's dtype."""
    w = at_least_f32(kernel)
    g = _mat(_G, w)
    u = torch.einsum("ai,bj,ijco->abco", g, g, w)
    return u.reshape(16, w.shape[2], w.shape[3]).to(kernel.dtype)


def conv3x3_winograd_plain(x, weight, bias=None, scale_shift=None):
    """The function K12 computes, in torch: NHWC x, OIHW weight; with a
    (B, 2, Cin) f32 ``scale_shift`` ``silu(x * scale + shift)`` (cast to
    x's dtype) is convolved.  Transforms, the 16 products and the inverse
    transform run in f32 (or wider); V and U are rounded to x's dtype
    first, as K12 rounds them (a no-op in f32)."""
    if scale_shift is not None:
        x = gn_silu_prologue(x, scale_shift)
    b, h, w, c = x.shape
    dt = x.dtype
    u = at_least_f32(transform_kernel(weight.to(dt).permute(2, 3, 1, 0)))  # (16, Cin, Cout)
    xp = F.pad(at_least_f32(x), (0, 0, 1, 1, 1, 1))                        # (B, H+2, W+2, C)
    d = xp.unfold(1, 4, 2).unfold(2, 4, 2)                                # (B, H/2, W/2, C, 4, 4)
    bt = _mat(_BT, xp)
    v = at_least_f32(torch.einsum("ka,ntscab,lb->klntsc", bt, d, bt).reshape(16, -1, c).to(dt))
    m = torch.bmm(v, u).reshape(4, 4, b, h // 2, w // 2, -1)               # M[k1, k2]
    at = _mat(_AT, xp)
    y = torch.einsum("pk,klntso,ql->ntpsqo", at, m, at).reshape(b, h, w, -1)
    if bias is not None:
        y = y + at_least_f32(bias)
    return y.to(dt)


def u_tiles(weight: torch.Tensor) -> torch.Tensor:
    """U for K12: (16, Cout, Cin) contiguous in the weight's dtype, each
    position's (Cout, Cin) slab K-contiguous for the B operand; computed
    once per weight from the OIHW weight and cached on it."""
    def make():
        # a detached copy: the raw kernel refuses tensors that want a gradient
        w = weight.detach()
        return transform_kernel(w.permute(2, 3, 1, 0)).transpose(1, 2).contiguous()

    return cached(weight, "_sdtk_wino_u", [weight], make)


# csrc/winograd.cu: 64 tiles and 64 output channels a block (warpgroup o1
# folds F[o1][k2]), Cin 64 a chunk, U through a three-slab ring.
WINO_TILES, WINO_BN, WINO_KC, WINO_STAGES = 64, 64, 64, 3
# (tile rows, tile columns) of a block's region, in the planner's order on a
# tie: on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py --k12-sweep) 4 x 16
# regions ran the UNet's shapes ~20% faster than 8 x 8 at equal padding.  The
# path's images are square, so no shape of it would pick a 16 x 4 region.
WINO_REGIONS = ((4, 16), (8, 8))
WINO_SMEM = (1024 + WINO_STAGES * 4 * WINO_BN * 128 + 4 * WINO_TILES * 128 + 2 * 340 * 128
             + 2 * 2 * WINO_KC * 4)


class WinogradPlan(NamedTuple):
    """K12's launch at (b, h, w, cin, cout): a block takes a ``region`` of
    (tile rows, tile columns) = 64 tiles of one image and 64 output
    channels (the F-fold: F[o1][k2] sets, A^T's signs in A); ``grid`` =
    (regions, channel blocks); ``chunks`` of 64 input channels; ``smem``
    the dynamic shared bytes."""
    region: tuple
    grid: tuple
    chunks: int
    smem: int


def winograd_plan(b: int, h: int, w: int, cin: int, cout: int, sms: int = 132) -> WinogradPlan:
    """K12's launch, as csrc/winograd.cu's entry takes it: the region of
    64 tiles (4 x 16 or 8 x 8) that pads the (H/2) x (W/2) tiles
    least, in WINO_REGIONS' order on a tie.  ``sms`` does not change it:
    every shape of the path gives at least one wave."""
    require(h % 2 == 0 and w % 2 == 0 and cin % 8 == 0 and cout % 8 == 0,
            f"K12 takes even H and W, Cin % 8 == 0 and Cout % 8 == 0, got {h}x{w}, {cin}->{cout}")
    th_, tw_ = h // 2, w // 2

    def padded(r):
        return -(-th_ // r[0]) * r[0] * -(-tw_ // r[1]) * r[1]

    region = min(WINO_REGIONS, key=lambda r: (padded(r), WINO_REGIONS.index(r)))
    regions = b * -(-th_ // region[0]) * -(-tw_ // region[1])
    return WinogradPlan(region, (regions, -(-cout // WINO_BN)), -(-cin // WINO_KC), WINO_SMEM)


def winograd_occupancy() -> dict:
    """K12's kernel on the current card: registers a thread, spill (local)
    bytes a thread, shared bytes a block and resident blocks an SM."""
    got = (ctypes.c_int * 4)()
    _cuda.check(_cuda.library().sdtk_winograd_attrs(got), "K12 attributes")
    return dict(zip(("registers", "spill_bytes", "smem_bytes", "blocks_per_sm"), got))


def conv3x3_winograd_kernel(x, weight, bias=None, scale_shift=None, *, _plan: WinogradPlan = None):
    """Launch K12.  x (B,H,W,Cin) bf16 contiguous, H and W even; weight
    OIHW (Cout,Cin,3,3) bf16; bias (Cout,) bf16; scale_shift (B, 2, Cin)
    f32 applies GroupNorm+SiLU to x first.  ``_plan`` runs another plan
    (for measuring)."""
    with K12.span():
        require_no_grad("K12", x, weight, bias, scale_shift)
        require(x.is_cuda, f"K12 needs a CUDA tensor, got {x.device}")
        require(x.dtype == torch.bfloat16, f"K12 takes bf16, got {x.dtype}")
        require(x.dim() == 4 and x.is_contiguous(), "K12 needs a contiguous NHWC tensor")
        b, h, w, cin = x.shape
        cout = weight.shape[0]
        require(h % 2 == 0 and w % 2 == 0, f"K12 takes even H and W, got {h}x{w}")
        require(tuple(weight.shape) == (cout, cin, 3, 3) and weight.dtype == torch.bfloat16,
                f"K12: weight {tuple(weight.shape)} {weight.dtype} for Cin={cin}")
        require(cin % 8 == 0 and cout % 8 == 0,
                f"K12 takes Cin % 8 == 0 and Cout % 8 == 0, got {cin}->{cout}")
        if bias is not None:
            require(bias.shape == (cout,) and bias.dtype == torch.bfloat16 and bias.is_contiguous(),
                    "K12: bias must be contiguous bf16 (Cout,)")
        if scale_shift is not None:
            require(scale_shift.shape == (b, 2, cin) and scale_shift.dtype == torch.float32
                    and scale_shift.is_contiguous(),
                    "K12: scale_shift must be contiguous f32 (B, 2, Cin)")
        u = u_tiles(weight)
        require(x.data_ptr() % 16 == 0 and u.data_ptr() % 16 == 0,
                "K12 needs 16-byte aligned tensors")
        plan = _plan or winograd_plan(b, h, w, cin, cout)
        y = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
        _cuda.check(_cuda.call_packed(
            _cuda.library().sdtk_winograd, x.data_ptr(), u.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if scale_shift is None else scale_shift.data_ptr(), y.data_ptr(), b, h, w, cin, cout,
            *plan.region, _cuda.stream_handle(x)), "K12 winograd")
        K12.launched((b, h, w, cin, cout, scale_shift is not None))
        return y
