"""3x3 SAME stride-1 conv over NHWC: kernel K2 (CUDA) beside its plain version.

K2 (csrc/conv3x3.cu) replaces stable_diffusion_tpu/ops/conv.py
``_conv3x3_kernel``; the note at the top of the source says what bounds it
and how it is built.  :func:`gn_silu_conv3x3` takes the GroupNorm statistics
from K1 and hands the folded (B, 2, C) scale/shift to K2's prologue, so the
normalised activation never reaches device memory; :func:`conv3x3` runs K2
without a prologue (the upsamplers).  Under SD_TPU_WINOGRAD=1 both send the
shapes ``winograd.route`` admits to K12 (ops/winograd.py) instead, as JAX's
``_conv3x3`` does; the W8A8 form (K7) is not affected.

Weights arrive in PyTorch's OIHW layout; K2 reads them as (3, 3, Cout, Cin),
re-laid once per weight and cached on the weight tensor (:func:`k2_taps`).
:func:`conv3x3_plan` picks K2's tiles, ring depth and K split from the
shape; the CPU tests hold it and an emulation of the kernel's schedule.

Gradients follow the JAX package's ``jax.custom_vjp`` rules (``_conv_bwd``,
``_gn_split_bwd``): the input gradient of a SAME 3x3 stride-1 conv is such a
conv with the spatially flipped, I/O-swapped kernel, so it runs on K2 too
(``transposed=True``); the weight and bias gradients come from the plain
conv's VJP; the GroupNorm+SiLU chain is differentiated through its plain
version, recomputed.

K7 (csrc/conv3x3_q.cu) is the static-W8A8 form (JAX ``_conv3x3_q_kernel``,
reached through ``gn_silu_conv3x3``'s W8A8 branch): the GroupNorm+SiLU
prologue, then the activation quantized to int8 with the layer's calibrated
scale, an int8 x int8 -> int32 implicit GEMM, and the epilogue
``acc * (s_x * weight_scale) + bias`` in f32.  The activation is cast to
its own dtype (bf16 on the card) before the quantizer, as JAX's W8A8
branch casts it (``ops/conv.py`` ``xn.astype(x.dtype)``); K7 and its plain
version both do.  It runs as two launches: the codes, once a value, into a
per-device int8 scratch; then K2's halo-tile GEMM on them with s8 ``wgmma``
(split K merged by atomics and a ticket in a per-device workspace left
zero).  :func:`conv3x3_q_plan` mirrors the C dispatch (K2's tiles, 128-channel
chunks); the CPU tests hold it and an emulation of both launches.
Inference only: the W8A8 entry raises NotImplementedError when an input
wants a gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from stable_diffusion_tpu_torch.ops import _cuda, groupnorm, winograd
from stable_diffusion_tpu_torch.ops._autograd import Recompute
from stable_diffusion_tpu_torch.ops.groupnorm import (GnOps, gn_scale_shift_kernel,
                                                      gn_scale_shift_plain, gn_silu_prologue,
                                                      group_norm_plain)
from stable_diffusion_tpu_torch.ops.quantize import act_step, folded_scales, quantize_act
from stable_diffusion_tpu_torch.utils.device import (LaunchCounter, cached, require,
                                                     require_inference, require_no_grad, use_kernel,
                                                     wants_grad)

K2 = LaunchCounter("K2")
K7 = LaunchCounter("K7")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def conv3x3_plain(x, weight, bias=None):
    """NHWC x, OIHW weight -> NHWC, zero padding 1 (F.conv2d)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3x3_scale_shift_plain(x, weight, bias=None, scale_shift=None):
    """The function K2 computes: with a (B, 2, Cin) f32 ``scale_shift``,
    ``silu(x * scale + shift)`` is convolved instead of x."""
    if scale_shift is not None:
        x = gn_silu_prologue(x, scale_shift)
    return conv3x3_plain(x, weight, bias)


def conv3x3_w8a8_plain(x, weight_q, weight_scale, act_scale, bias=None, scale_shift=None):
    """The function K7 computes (JAX ``_conv3x3_q``): with a (B, 2, Cin) f32
    ``scale_shift``, ``silu(x * scale + shift)`` cast to x's dtype is the
    conv's input; it is quantized with s_x = max(act_scale / 127, 1e-12),
    convolved in exact integers (f64, zero padding 1) with the OIHW int8
    weight, and dequantized ``acc * (s_x * weight_scale) + bias`` in f32."""
    if scale_shift is not None:
        x = gn_silu_prologue(x, scale_shift)
    s_x = act_step(act_scale, floor=True)
    xq = quantize_act(x, s_x)
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), weight_q.double(), padding=1).float()
    y = acc.permute(0, 2, 3, 1) * (s_x * weight_scale.float().reshape(-1))
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).contiguous()


def flip_io(weight):
    """OIHW (Cout, Cin, 3, 3) -> (Cin, Cout, 3, 3) spatially flipped: the
    kernel whose conv is the input gradient of ``weight``'s (JAX ``_dx_conv``)."""
    return weight.flip(2, 3).transpose(0, 1)


def gn_silu_conv3x3_plain(x, gn_weight, gn_bias, weight, bias=None, *,
                          num_groups: int = 32, eps: float = 1e-5):
    """GroupNorm -> SiLU -> zero-padded 3x3 conv, as the JAX XLA path."""
    h = group_norm_plain(x, gn_weight, gn_bias, num_groups, eps, silu=True)
    return conv3x3_plain(h, weight, bias)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


# The compiled variants of K2, (BM, BN) -> ring stages (csrc/conv3x3.cu
# SDTK_CONV3X3_VARIANTS): a 64-row tile for small images, 160 or 64
# columns where Cout % 128 != 0; the ring is as deep as two blocks an SM
# leave room for.
K2_VARIANTS = {(128, 128): 4, (128, 160): 3, (128, 64): 6, (64, 128): 4, (64, 64): 6}
K2_CHUNK = 64  # input channels per halo tile and weight slab
K2_MAX_KSPLIT = 16


class Conv3x3Plan(NamedTuple):
    """K2's launch: each block computes a ``th`` x ``tw`` rectangle of one
    image (th * tw <= ``bm`` GEMM rows) by ``bn`` output channels, with a
    ring of ``stages`` weight slabs, its input channels split over
    ``ksplit`` blocks."""
    th: int
    tw: int
    bm: int
    bn: int
    stages: int
    ksplit: int

    def grid(self, b: int, h: int, w: int, cout: int):
        """(output tiles, column blocks, splits): the launch grid."""
        return b * -(-h // self.th) * -(-w // self.tw), -(-cout // self.bn), self.ksplit

    @property
    def smem(self) -> int:
        """Dynamic shared memory a block takes: 1024 bytes to align the
        weight ring to the 128-byte swizzle's atoms, the ring, and two halo
        buffers of (th + 2) x (tw + 2) pixels x 64 channels, bf16."""
        return 1024 + (self.stages * self.bn + 2 * (self.th + 2) * (self.tw + 2)) * K2_CHUNK * 2


@functools.lru_cache(maxsize=None)
def conv3x3_plan(b: int, h: int, w: int, cin: int, cout: int, sms: int = 132) -> Conv3x3Plan:
    """K2's tiles for a (b, h, w, cin) -> cout conv on a card of ``sms`` SMs.

    For each ``bm`` the output rectangle is the one that computes the fewest
    GEMM rows over the image (rows past it are masked), then loads the
    fewest halo pixels, then is the wider: 8 x 16 at most shapes, 5 x 24 at
    24^2.  A 64-row tile streams the same weight slabs for half the
    products, so it is taken only where it computes at most 3/4 of the
    128-row tile's rows: small images (8 x 8 at 8^2, 5 x 12 at 12^2).  No
    tile straddles images.  ``bn`` is 128 where Cout is a multiple of it,
    else 160 where Cout is a multiple of that (320, 960) and the tile has
    128 rows, else 64.  ``ksplit``: enough blocks for two per SM when the
    output tiles alone are fewer, whole 64-channel chunks per split, at
    most 16."""
    th, tw, bm = _halo_tile(h, w)
    bn = 128 if cout % 128 == 0 else 160 if cout % 160 == 0 and bm == 128 else 64
    plan = Conv3x3Plan(th, tw, bm, bn, K2_VARIANTS[(bm, bn)], 1)
    tiles, cols, _ = plan.grid(b, h, w, cout)
    nchunks = -(-cin // K2_CHUNK)
    ksplit = max(1, min(-(-2 * sms // (tiles * cols)), nchunks, K2_MAX_KSPLIT))
    return plan._replace(ksplit=ksplit)


@functools.lru_cache(maxsize=None)
def _halo_tile(h: int, w: int):
    """(th, tw, bm): the output rectangle and GEMM rows of K2's and K7's
    halo tiles for an h x w image (see :func:`conv3x3_plan`)."""
    best = {}
    for bm in (128, 64):
        for tw in sorted({min(t, w, bm) for t in (8, 16, 24, 32, w)}):
            th = min(bm // tw, h)
            tiles = -(-h // th) * -(-w // tw)
            score = (tiles * bm, tiles * (th + 2) * (tw + 2), -tw)
            if bm not in best or score < best[bm][0]:
                best[bm] = (score, th, tw)
    bm = 64 if 4 * best[64][0][0] <= 3 * best[128][0][0] else 128
    _, th, tw = best[bm]
    return th, tw, bm


def k2_taps(weight: torch.Tensor, *, transposed: bool = False) -> torch.Tensor:
    """The OIHW weight as K2 reads it, (3, 3, Cout, Cin) contiguous: each
    tap's (Cout, Cin) slab K-contiguous; cached on the weight tensor.
    ``transposed`` gives that of :func:`flip_io` (weight)."""
    def relay():
        # a detached copy: the raw kernel refuses tensors that want a gradient,
        # so this copy never stands in for a weight in a recorded graph
        w = weight.detach()
        return (w.flip(2, 3).permute(2, 3, 1, 0) if transposed
                else w.permute(2, 3, 0, 1)).contiguous()

    return cached(weight, "_sdtk_k2_taps_t" if transposed else "_sdtk_k2_taps", [weight], relay)


def conv3x3_kernel(x, weight, bias=None, scale_shift=None, *, transposed: bool = False):
    """Launch K2.  x (B,H,W,Cin) bf16 contiguous; weight OIHW (Cout,Cin,3,3);
    scale_shift (B, 2, Cin) f32 applies GroupNorm+SiLU to x first.  With
    ``transposed`` the conv runs with :func:`flip_io` (weight): the input
    gradient of ``weight``'s conv, for x of Cout channels."""
    with K2.span():
        require_no_grad("K2", x, weight, bias, scale_shift)
        require(x.is_cuda, f"K2 needs a CUDA tensor, got {x.device}")
        require(x.dtype == torch.bfloat16, f"K2 takes bf16, got {x.dtype}")
        require(x.dim() == 4 and x.is_contiguous(), "K2 needs a contiguous NHWC tensor")
        b, h, w, cin = x.shape
        cout = weight.shape[1] if transposed else weight.shape[0]
        want = (cin, cout, 3, 3) if transposed else (cout, cin, 3, 3)
        require(tuple(weight.shape) == want, f"K2: weight {tuple(weight.shape)} for Cin={cin}")
        require(weight.dtype == torch.bfloat16, f"K2: weight dtype {weight.dtype}")
        require(cin % 8 == 0 and cout % 8 == 0,
                f"K2 takes Cin % 8 == 0 and Cout % 8 == 0, got {cin}->{cout}")
        wk = k2_taps(weight, transposed=transposed)
        if bias is not None:
            require(bias.shape == (cout,) and bias.dtype == torch.bfloat16 and bias.is_contiguous(),
                    "K2: bias must be contiguous bf16 (Cout,)")
        if scale_shift is not None:
            require(scale_shift.shape == (b, 2, cin) and scale_shift.dtype == torch.float32
                    and scale_shift.is_contiguous(),
                    "K2: scale_shift must be contiguous f32 (B, 2, Cin)")
        require(x.data_ptr() % 16 == 0 and wk.data_ptr() % 16 == 0,
                "K2 needs 16-byte aligned tensors")
        lib = _cuda.library()
        plan = conv3x3_plan(b, h, w, cin, cout, _cuda.sm_count(x.device.index or 0))
        ws = (torch.empty((plan.ksplit, b * h * w, cout), device=x.device, dtype=torch.float32)
              if plan.ksplit > 1 else None)
        y = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
        code = lib.sdtk_conv3x3(
            x.data_ptr(), wk.data_ptr(), None if bias is None else bias.data_ptr(),
            None if scale_shift is None else scale_shift.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), b, h, w, cin, cout, plan.th, plan.tw, plan.bm,
            plan.bn, plan.stages, plan.ksplit, _cuda.stream_handle(x))
        _cuda.check(code, "K2 conv3x3")
        K2.launched((b, h, w, cin, cout, scale_shift is not None))
        return y


def conv3x3_occupancy() -> dict:
    """Each compiled K2 variant on the current card, at the largest tile
    its plans take (8 x 16 for 128 rows, 8 x 8 for 64): ``{(bm, bn):
    {...}}`` with registers a thread, spill (local) bytes a thread, shared
    bytes a block and resident blocks an SM, from the runtime."""
    keys = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm")
    out = {}
    for (bm, bn), stages in K2_VARIANTS.items():
        plan = Conv3x3Plan(8, 16 if bm == 128 else 8, bm, bn, stages, 1)
        got = (ctypes.c_int * 4)()
        _cuda.check(_cuda.library().sdtk_conv3x3_attrs(bm, bn, stages, plan.smem, got),
                    "K2 attributes")
        out[(bm, bn)] = dict(zip(keys, got))
    return out


# The compiled variants of K7, (BM, BN) -> ring stages (csrc/conv3x3_q.cu
# SDTK_CONV3X3_Q_VARIANTS): K2's tiles, a chunk 128 int8 channels (a
# pixel's halo row 128 bytes, as K2's 64 bf16).
K7_VARIANTS = {(128, 128): 4, (128, 160): 3, (128, 64): 6, (64, 128): 4, (64, 64): 6}
K7_CHUNK = 128  # input channels per halo tile and weight slab
K7_MAX_KSPLIT = 16


class Conv3x3QPlan(NamedTuple):
    """K7's launch: K2's halo tile (``th`` x ``tw`` outputs of one image,
    ``bm`` GEMM rows) by ``bn`` output channels, a ring of ``stages`` weight
    slabs, the input channels split over ``ksplit`` blocks (int32 partials
    merged by atomics and a ticket)."""
    th: int
    tw: int
    bm: int
    bn: int
    stages: int
    ksplit: int

    def grid(self, b: int, h: int, w: int, cout: int):
        """(output tiles, column blocks, splits): the GEMM's launch grid."""
        return b * -(-h // self.th) * -(-w // self.tw), -(-cout // self.bn), self.ksplit

    @property
    def smem(self) -> int:
        """Dynamic shared bytes of the GEMM: 1024 to align the ring, the ring
        of 128-byte weight rows, two int8 halo buffers of (th + 2) x (tw +
        2) rows of 128 bytes, 16 for the ticket's flag."""
        halo = (self.th + 2) * (self.tw + 2) * K7_CHUNK
        return 1024 + self.stages * self.bn * K7_CHUNK + 2 * halo + 16


@functools.lru_cache(maxsize=None)
def conv3x3_q_plan(b: int, h: int, w: int, cin: int, cout: int, sms: int = 132,
                   bn: int = None, ksplit: int = None) -> Conv3x3QPlan:
    """K7's launch for a (b, h, w, cin) -> cout conv on a card of ``sms``
    SMs, as csrc/conv3x3_q.cu's entry takes it (``bn`` and ``ksplit`` name
    another variant, for measuring).

    K2's tile (:func:`conv3x3_plan`: 8 x 16 outputs at most shapes, 8 x 8
    in 64 rows at 8^2); the column width, of 128 and 160 those that divide
    Cout (else 64; 128 rows only take 160), that finishes in the fewest
    waves of two blocks an SM x columns a block, 128 on a tie: 160 at Cout
    = 320 and at 32^2 x 640 (one wave of 256 blocks where 128 columns give
    320), 128 at 16^2 x 1280 and in 64 rows; ``ksplit``: only where the
    output tiles give fewer blocks
    than the card has SMs (the 8^2 stage), the most parts that still fit in
    one wave of two blocks an SM, whole 128-channel chunks a part, at most
    16.  The int32 atomic merge
    costs more than idle SMs elsewhere: on an NVIDIA H100 80GB HBM3 at 700
    W, two parts took 1.25-2.35x one part's time at 16^2 and 1.4-5.7x at
    32^2 and 64^2, three parts 0.77x at (8, 8, 8, 2560) (PERF.md,
    chip_smoke.py --w8a8-sweep)."""
    require(cin % 32 == 0 and cout % 8 == 0,
            f"K7 takes Cin % 32 == 0 and Cout % 8 == 0, got {cin}->{cout}")
    th, tw, bm = _halo_tile(h, w)
    if bn is None:
        tiles = b * -(-h // th) * -(-w // tw)
        widths = [n for n in (128, 160) if cout % n == 0 and (bm, n) in K7_VARIANTS] or [64]
        bn = min(widths, key=lambda n: (-(-tiles * -(-cout // n) // (2 * sms)) * n, n))
    require((bm, bn) in K7_VARIANTS, f"K7: no variant ({bm}, {bn})")
    plan = Conv3x3QPlan(th, tw, bm, bn, K7_VARIANTS[(bm, bn)], 1)
    tiles, cols, _ = plan.grid(b, h, w, cout)
    nchunks = -(-cin // K7_CHUNK)
    if ksplit is None:
        ksplit = 1
        if tiles * cols < sms:
            ksplit = max(1, min(2 * sms // (tiles * cols), nchunks, K7_MAX_KSPLIT))
    require(1 <= ksplit <= min(nchunks, K7_MAX_KSPLIT), f"K7: no split {ksplit} of {nchunks} chunks")
    return plan._replace(ksplit=ksplit)


def taps_q(weight_q: torch.Tensor) -> torch.Tensor:
    """The int8 OIHW weight as (3, 3, Cout, Cin) contiguous, each tap's
    (Cout, Cin) slab K-contiguous for the int8 products; cached on the tensor."""
    return cached(weight_q, "_sdtk_taps", [weight_q],
                  lambda: weight_q.permute(2, 3, 0, 1).contiguous())


_Q_CODES = {}  # device index -> int8 scratch: launch 1's codes
_Q_WS = {}     # device index -> zero int32: split-K sums, then tickets; left zero


def _q_scratch(x: torch.Tensor, nbytes: int) -> int:
    """The pointer of at least ``nbytes`` of scratch on ``x``'s device for
    K7's codes, reused call after call (calls on one stream are ordered, so
    two streams must not run K7 on one device at once)."""
    buf = _Q_CODES.get(x.get_device())
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1 << 20), device=x.device, dtype=torch.uint8)
        _Q_CODES[x.get_device()] = buf
    return buf.data_ptr()


def _q_workspace(x: torch.Tensor, ints: int) -> int:
    """The pointer of at least ``ints`` zero int32 on ``x``'s device (K7
    leaves what it used zero)."""
    buf = _Q_WS.get(x.get_device())
    if buf is None or buf.numel() < ints:
        buf = torch.zeros(max(ints, 1 << 18), device=x.device, dtype=torch.int32)
        _Q_WS[x.get_device()] = buf
    return buf.data_ptr()


def k7_codes(x: torch.Tensor) -> torch.Tensor:
    """The int8 codes K7's first launch wrote for ``x`` (B, H, W, Cin), as a
    view of the scratch (for tests: valid until the next K7 call)."""
    return _Q_CODES[x.get_device()][:x.numel()].view(torch.int8).view(x.shape)


def _k7_refuse(x, weight_q, s_x, out_scale, bias, scale_shift):
    """Raise the ValueError that names what K7 does not take (its shape
    rules, checked in one expression on the launch path)."""
    require(x.is_cuda, f"K7 needs a CUDA tensor, got {x.device}")
    require(x.dtype == torch.bfloat16, f"K7 takes bf16, got {x.dtype}")
    require(x.dim() == 4 and x.is_contiguous(), "K7 needs a contiguous NHWC tensor")
    b, h, w, cin = x.shape
    cout = weight_q.shape[0]
    require(tuple(weight_q.shape) == (cout, cin, 3, 3) and weight_q.dtype == torch.int8,
            f"K7: weight_q {tuple(weight_q.shape)} {weight_q.dtype} for Cin={cin}")
    require(cin % 32 == 0 and cout % 8 == 0,
            f"K7 takes Cin % 32 == 0 and Cout % 8 == 0, got {cin}->{cout}")
    require(s_x.shape == (1,) and out_scale.shape == (cout,)
            and all(t.dtype == torch.float32 and t.is_contiguous() for t in (s_x, out_scale)),
            "K7: s_x (1,) and out_scale (Cout,) must be contiguous f32")
    require(bias is None or (bias.shape == (cout,) and bias.dtype == torch.bfloat16
                             and bias.is_contiguous()), "K7: bias must be contiguous bf16 (Cout,)")
    require(scale_shift is None or (scale_shift.shape == (b, 2, cin)
                                    and scale_shift.dtype == torch.float32
                                    and scale_shift.is_contiguous()),
            "K7: scale_shift must be contiguous f32 (B, 2, Cin)")
    raise ValueError("K7 needs 16-byte aligned tensors")


def conv3x3_w8a8_kernel(x, weight_q, s_x, out_scale, bias=None, scale_shift=None, *,
                        _plan: Conv3x3QPlan = None, _parts: int = 3):
    """Launch K7.  x (B,H,W,Cin) bf16 contiguous; weight_q OIHW (Cout,Cin,3,3)
    int8; s_x (1,) and out_scale = s_x * weight_scale (Cout,) f32
    (``folded_scales(..., floor=True)``); scale_shift (B, 2, Cin) f32
    applies GroupNorm+SiLU to x first.  For measuring: ``_plan`` runs
    another plan; ``_parts`` 1 launches the codes alone, 2 the GEMM alone
    (on whatever codes the scratch holds)."""
    with K7.span():
        require_no_grad("K7", x, bias, scale_shift)
        cout = weight_q.shape[0]
        wk = taps_q(weight_q) if weight_q.dim() == 4 else weight_q
        if not (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4 and x.is_contiguous()
                and weight_q.dtype == torch.int8 and weight_q.shape[1:] == (x.shape[3], 3, 3)
                and x.shape[3] % 32 == 0 and cout % 8 == 0
                and s_x.shape == (1,) and out_scale.shape == (cout,)
                and s_x.dtype == out_scale.dtype == torch.float32
                and s_x.is_contiguous() and out_scale.is_contiguous()
                and (bias is None or (bias.shape == (cout,) and bias.dtype == torch.bfloat16
                                      and bias.is_contiguous()))
                and (scale_shift is None or (scale_shift.shape == (x.shape[0], 2, x.shape[3])
                                             and scale_shift.dtype == torch.float32
                                             and scale_shift.is_contiguous()))
                and x.data_ptr() % 16 == 0 and wk.data_ptr() % 16 == 0):
            _k7_refuse(x, weight_q, s_x, out_scale, bias, scale_shift)
        b, h, w, cin = x.shape
        plan = _plan or conv3x3_q_plan(b, h, w, cin, cout, _cuda.sm_count(x.get_device()))
        ws = tickets = None
        if plan.ksplit > 1:
            tiles, cols, _ = plan.grid(b, h, w, cout)
            ws = _q_workspace(x, b * h * w * cout + tiles * cols)
            tickets = ws + 4 * b * h * w * cout
        xq = _q_scratch(x, x.numel())
        y = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
        _cuda.check(_cuda.call_packed(
            _cuda.library().sdtk_conv3x3_q, x.data_ptr(), xq, wk.data_ptr(), s_x.data_ptr(),
            out_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            None if scale_shift is None else scale_shift.data_ptr(), y.data_ptr(), ws, tickets,
            b, h, w, cin, cout, plan.th, plan.tw, plan.bm, plan.bn, plan.stages, plan.ksplit, _parts,
            _cuda.stream_handle(x)), "K7 conv3x3_q")
        K7.launched((b, h, w, cin, cout, scale_shift is not None))
        return y


def conv3x3_q_occupancy() -> dict:
    """Each compiled K7 variant on the current card, at the largest tile
    its plans take (8 x 16 for 128 rows, 8 x 8 for 64): ``{(bm, bn): {...}}``
    with registers a thread, spill (local) bytes a thread, shared bytes a
    block and resident blocks an SM, from the runtime."""
    keys = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm")
    out = {}
    for (bm, bn), stages in K7_VARIANTS.items():
        plan = Conv3x3QPlan(8, 16 if bm == 128 else 8, bm, bn, stages, 1)
        got = (ctypes.c_int * 4)()
        _cuda.check(_cuda.library().sdtk_conv3x3_q_attrs(bm, bn, stages, plan.smem, got),
                    "K7 attributes")
        out[(bm, bn)] = dict(zip(keys, got))
    return out


# ---------------------------------------------------------------------------
# Autograd: the forward and the input-gradient conv are arguments, so the
# CPU tests run the same Functions on the plain versions
# ---------------------------------------------------------------------------


class ConvOps(NamedTuple):
    conv: Callable     # (x, weight, bias, scale_shift) -> y
    conv_dx: Callable  # (g, weight) -> the conv of g with flip_io(weight)
    gn: GnOps          # the GroupNorm's statistics, normalize and backward


KERNEL_OPS = ConvOps(
    conv3x3_kernel,
    lambda g, weight: conv3x3_kernel(g, weight, transposed=True),
    groupnorm.KERNEL_OPS)
PLAIN_OPS = ConvOps(
    conv3x3_scale_shift_plain,
    lambda g, weight: conv3x3_plain(g, flip_io(weight)),
    groupnorm.PLAIN_OPS)


def _weight_grads(x, weight, bias, g, need_w: bool, need_b: bool):
    """dW and db of ``conv3x3_plain(x, weight, bias)`` against g (plain VJP)."""
    dw = (torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), weight.shape, g.permute(0, 3, 1, 2),
                                      padding=1) if need_w else None)
    db = g.float().sum(dim=(0, 1, 2)).to(bias.dtype) if need_b else None
    return dw, db


class Conv3x3Fn(torch.autograd.Function):
    """3x3 conv: dx by the conv with the flipped, I/O-swapped weight (JAX
    ``_conv_bwd``), dW and db from the plain VJP."""

    @staticmethod
    def forward(ctx, ops: ConvOps, x, weight, bias):
        ctx.ops = ops
        ctx.save_for_backward(x, weight, bias)
        return ops.conv(x, weight, bias, None)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        _, nx, nw, nb = ctx.needs_input_grad
        g = g.contiguous()
        dx = ctx.ops.conv_dx(g, weight) if nx else None
        dw, db = _weight_grads(x, weight, bias, g, nw, nb and bias is not None)
        return None, dx, dw, db


class GnSiluConv3x3Fn(torch.autograd.Function):
    """GroupNorm -> SiLU -> 3x3 conv with the split backward of JAX
    ``_gn_split_bwd``: the conv's input gradient by the flipped-weight conv
    (no prologue), then the GroupNorm+SiLU's backward (K1's on the card) on
    the forward's statistics; dW and db from the plain conv VJP on the
    activation, normalized again (K1's forward on the card)."""

    @staticmethod
    def forward(ctx, ops: ConvOps, x, gn_weight, gn_bias, weight, bias, num_groups, eps):
        ctx.ops, ctx.num_groups, ctx.eps = ops, num_groups, eps
        ss, stats = ops.gn.scale_shift(x, gn_weight, gn_bias, num_groups, eps)
        ctx.save_for_backward(x, gn_weight, gn_bias, weight, bias, stats)
        return ops.conv(x, weight, bias, ss)

    @staticmethod
    def backward(ctx, g):
        x, gw, gb, weight, bias, stats = ctx.saved_tensors
        _, nx, ngw, ngb, nw, nb, _, _ = ctx.needs_input_grad
        nb = nb and bias is not None
        g = g.contiguous()
        dx = dgw = dgb = dw = db = None
        if nw or nb:
            xn, _ = ctx.ops.gn.norm(x, gw, gb, ctx.num_groups, ctx.eps, True)
            dw, db = _weight_grads(xn, weight, bias, g, nw, nb)
        if nx or ngw or ngb:
            dxn = ctx.ops.conv_dx(g, weight).to(x.dtype)
            dx, dgw, dgb = ctx.ops.gn.backward(x, dxn, gw, gb, stats, ctx.num_groups, True,
                                               ngw or ngb)
        return (None, dx if nx else None, dgw if ngw else None, dgb if ngb else None, dw, db,
                None, None)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def conv3x3(x, weight, bias=None, *, impl: str = "auto"):
    """3x3 SAME stride-1 conv (the upsamplers' conv); K12 where
    SD_TPU_WINOGRAD=1 routes the shape (JAX ``_conv3x3``)."""
    if winograd.route(x, weight):
        if not use_kernel(impl, x):
            return winograd.conv3x3_winograd_plain(x, weight, bias)
        if wants_grad(x, weight, bias):
            return Recompute.apply(winograd.conv3x3_winograd_kernel, conv3x3_plain, x, weight, bias)
        return winograd.conv3x3_winograd_kernel(x, weight, bias)
    if not use_kernel(impl, x):
        return conv3x3_plain(x, weight, bias)
    if wants_grad(x, weight, bias):
        return Conv3x3Fn.apply(KERNEL_OPS, x, weight, bias)
    return conv3x3_kernel(x, weight, bias)


def gn_silu_conv3x3(x, gn_weight, gn_bias, weight, bias=None, *, num_groups: int = 32,
                    eps: float = 1e-5, impl: str = "auto"):
    """GroupNorm -> SiLU -> conv3x3, the resblock pattern: K1 stats, then K2
    (K12 where SD_TPU_WINOGRAD=1 routes the shape) with the normalize+SiLU
    folded into its input reads."""
    if winograd.route(x, weight):
        return _gn_silu_winograd(x, gn_weight, gn_bias, weight, bias, num_groups, eps, impl)
    if not use_kernel(impl, x):
        return gn_silu_conv3x3_plain(x, gn_weight, gn_bias, weight, bias,
                                     num_groups=num_groups, eps=eps)
    if wants_grad(x, gn_weight, gn_bias, weight, bias):
        return GnSiluConv3x3Fn.apply(KERNEL_OPS, x, gn_weight, gn_bias, weight, bias,
                                     num_groups, eps)
    ss = gn_scale_shift_kernel(x, gn_weight, gn_bias, num_groups=num_groups, eps=eps)
    return conv3x3_kernel(x, weight, bias, ss)


def _gn_silu_winograd(x, gn_weight, gn_bias, weight, bias, num_groups, eps, impl):
    """A routed GroupNorm -> SiLU -> conv3x3 (JAX ``_gn_silu_conv`` under
    SD_TPU_WINOGRAD=1): K1 stats, then K12 with the normalize+SiLU in its
    prologue; on the CPU the plain stats and the plain Winograd form."""
    if not use_kernel(impl, x):
        ss = gn_scale_shift_plain(x, gn_weight, gn_bias, num_groups, eps)
        return winograd.conv3x3_winograd_plain(x, weight, bias, ss)

    def fwd(x, gn_weight, gn_bias, weight, bias):
        ss = gn_scale_shift_kernel(x, gn_weight, gn_bias, num_groups=num_groups, eps=eps)
        return winograd.conv3x3_winograd_kernel(x, weight, bias, ss)

    args = (x, gn_weight, gn_bias, weight, bias)
    if wants_grad(*args):
        plain = functools.partial(gn_silu_conv3x3_plain, num_groups=num_groups, eps=eps)
        return Recompute.apply(fwd, plain, *args)
    return fwd(*args)


def gn_silu_conv3x3_w8a8(x, gn_weight, gn_bias, weight_q, weight_scale, act_scale, bias=None, *,
                         num_groups: int = 32, eps: float = 1e-5, impl: str = "auto"):
    """GroupNorm -> SiLU -> static-W8A8 conv3x3 (JAX ``gn_silu_conv3x3`` with
    ``kernel_q`` and ``act_scale``): K1 stats, then K7 with the normalize,
    SiLU and int8 quantize in its prologue.  Inference only."""
    require_inference("W8A8 conv3x3", x, gn_weight, gn_bias, weight_scale, act_scale, bias)
    if not use_kernel(impl, x):
        ss = gn_scale_shift_plain(x, gn_weight, gn_bias, num_groups, eps)
        return conv3x3_w8a8_plain(x, weight_q, weight_scale, act_scale, bias, ss)
    ss = gn_scale_shift_kernel(x, gn_weight, gn_bias, num_groups=num_groups, eps=eps)
    s_x, out_scale = folded_scales(weight_scale, act_scale, floor=True)
    return conv3x3_w8a8_kernel(x, weight_q, s_x, out_scale, bias, ss)
