"""The matmuls of stable_diffusion_tpu/ops/linear.py that the UNet calls:
the bf16 fused matmuls, kernels K10 and K11 (CUDA), and the static-W8A8
matmul, kernel K8 (CUDA), each beside its plain version.

K10 (csrc/linear.cu) replaces ``_make_kernel`` (``_mm_call``, entries
``ln_matmul`` / ``matmul_residual``): (LayerNorm, f32 statistics ->) x @ W^T
+ b (+ residual), f32 accumulation, one bf16 rounding.  K11 (the same
source) replaces ``_gn_mm_kernel`` (``_gn_mm_call``, entry ``gn_matmul``):
the GroupNorm normalize, from K1's folded (B, 2, K) scale/shift, then the
same product and bias.  Both are one ``wgmma`` GEMM with three prologues;
:func:`linear_plan` chooses its launch as the C entry takes it: schedule R
(the LN and GN sites: a block's rows resident in shared memory, normalized
there once, for all its N tiles) or S (the plain and residual sites: x and
W streamed through one ring, split K where the tiles leave most SMs idle,
the f32 partials reduced in split order).  The note at the top of the
source says what bounds it and why.  The JAX package keeps
both behind ``SD_TPU_FUSED_MM`` (read at call time): "0" (the default) runs
every site unfused, "envelope" only the sites ``site_wins`` names (its
thresholds were measured on a TPU, not here), "all"/"1" every site.  As in
JAX the site rule applies under ``impl="auto"`` only; an explicit kernel
``impl`` takes every site.  Unfused, ``ln_matmul`` is the LayerNorm then
``F.linear``, ``matmul_residual`` ``F.linear`` + residual, and
``gn_matmul`` K1's normalize then ``F.linear``.  JAX's TPU geometry gates
(M % 128, the VMEM plan, row blocks inside one image) do not apply: K10 and
K11 take any M, K % 8 == 0 and N % 8 == 0.  The plain versions follow JAX
``_mm_xla`` / ``_gn_mm_xla`` (the normalized activation cast to the input
dtype, the product rounded, then bias and residual); the kernels follow the
TPU kernels (bias and residual added to the f32 sum, one rounding); in f32
the two are one function.  Under autograd the kernels run inside
``Recompute``, whose backward is the VJP of the plain version (JAX
``_ln_mm_bwd``, ``_mm_res_bwd``, ``_gn_mm_bwd``).

K8 (csrc/linear_q.cu) replaces ``_make_q_kernel`` (``_q_mm_call``, entries
``ln_matmul_w8a8`` / ``matmul_w8a8``): (LayerNorm ->) quantize the
activation to int8 with the layer's static scale -> int8 x int8 -> int32
product -> dequantize, +bias (+residual).  One kernel serves every W8A8 linear of the UNet (fused QKV,
cross q/k/v, the out projections, ``t_embed`` and the time embedding) at any
M; the note at the top of the source says what bounds it and how it is
built: a first launch LayerNorms and quantizes each row once into an int8
scratch, the second multiplies.  :func:`linear_q_plan` chooses the
product's launch (the variant, the N split and the K split), as the C
entry takes it; split-K partials meet in a per-device int32 workspace that
the kernel leaves zero.  Inference only:
every W8A8 entry point raises NotImplementedError when an input wants a
gradient (JAX ``_q_raise_bwd``).

Weights are in PyTorch's (out, in) layout: ``weight`` (N, K), ``weight_q``
(N, K) int8, ``weight_scale`` (N,).  The W8A8 plain version follows JAX
``_q_mm_xla``: the LayerNorm output cast to the input dtype, then divided
by s_x, rounded and clipped.  K8 follows the TPU kernel: the f32 LN output
goes to the quantizer unrounded, and the dequantize, bias and residual run
in f32 with one rounding.  In f32 the two are one function; both divide by
s_x (not multiply by its inverse), so the same f32 input gives the same
codes.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from stable_diffusion_tpu_torch.ops import _cuda
from stable_diffusion_tpu_torch.ops._autograd import Recompute
from stable_diffusion_tpu_torch.ops.groupnorm import (gn_scale_shift_kernel, group_norm_plain,
                                                      group_norm_silu)
from stable_diffusion_tpu_torch.ops.quantize import act_step, folded_scales, int_matmul, quantize_act
from stable_diffusion_tpu_torch.utils.device import (LaunchCounter, at_least_f32, require,
                                                     require_inference, require_no_grad, use_kernel,
                                                     wants_grad)

K8 = LaunchCounter("K8")
K10 = LaunchCounter("K10")
K11 = LaunchCounter("K11")
SMEM_BLOCK = 232448        # shared bytes a block may use on an H100
SMEM_SM = 233472           # an SM's shared memory (228 KB)


# ---------------------------------------------------------------------------
# The SD_TPU_FUSED_MM switch (JAX fused_mm_enabled / _site_wins)
# ---------------------------------------------------------------------------


def fused_mm_enabled() -> bool:
    """SD_TPU_FUSED_MM is not "0" (its default): the bf16 fused-matmul sites
    may run K10/K11."""
    return os.environ.get("SD_TPU_FUSED_MM", "0") != "0"


def site_wins(site: str, m: int, k: int, n: int) -> bool:
    """JAX ``_site_wins``: the sites SD_TPU_FUSED_MM=envelope fuses ("ln",
    "res", "gn" at (M, K, N)); "all"/"1" fuse every site.  The thresholds
    are the JAX package's, measured on a TPU v5e."""
    mode = os.environ.get("SD_TPU_FUSED_MM", "0")
    if mode in ("all", "1"):
        return True
    if site == "ln":
        return False
    if site == "res":
        return n <= 384 or (m <= 512 and k >= 2048)
    if site == "gn":
        return k >= 1280
    return True


def fused_site(site: str, m: int, k: int, n: int, impl: str) -> bool:
    """Whether a site on the card runs its fused kernel: the switch is on
    and, under ``impl="auto"``, the site rule says so (JAX ``supported`` and
    ``impl != "auto" or _site_wins``, without the TPU geometry gates)."""
    return fused_mm_enabled() and (impl != "auto" or site_wins(site, m, k, n))


# ---------------------------------------------------------------------------
# bf16 fused matmuls: plain versions, kernel wrapper, entry points
# ---------------------------------------------------------------------------


def layer_norm_plain(x, weight, bias, eps: float = 1e-5):
    """models/layers.layer_norm: f32 statistics, cast back to x's dtype."""
    xf = at_least_f32(x)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * at_least_f32(weight) + at_least_f32(bias)).to(x.dtype)


def linear_plain(x, weight, bias=None, residual=None, ln_weight=None, ln_bias=None, *,
                 eps: float = 1e-5):
    """(LN ->) x @ W^T (+b) (+res): JAX ``_mm_xla``, the function K10 computes."""
    h = x if ln_weight is None else layer_norm_plain(x, ln_weight, ln_bias, eps)
    y = F.linear(h, weight.to(h.dtype))
    if bias is not None:
        y = y + bias.to(h.dtype)
    return y if residual is None else y + residual


def gn_matmul_plain(x, gn_weight, gn_bias, weight, bias=None, *, num_groups: int = 32,
                    eps: float = 1e-5):
    """GroupNorm(x) @ W^T (+b) over NHWC x: JAX ``_gn_mm_xla``, the function
    K11 computes (with K1's scale/shift)."""
    xn = group_norm_plain(x, gn_weight, gn_bias, num_groups, eps)
    y = F.linear(xn, weight.to(xn.dtype))
    return y if bias is None else y + bias.to(xn.dtype)


# K10/K11's compiled variants (csrc/linear.cu SDTK_LIN_VARIANTS): (schedule
# R = 1 (rows resident) or S = 0 (streamed), rows a block, columns a tile,
# ring stages, blocks an SM for the launch bound).
LIN_VARIANTS = ((1, 128, 160, 3, 1), (1, 64, 160, 3, 2), (0, 128, 160, 4, 1), (0, 64, 160, 3, 2))
LIN_KC = 64                # channels a K step: one 128-byte row of bf16
LIN_MAX_KSPLIT = 16
PROLOGUES = ("none", "ln", "gn")


class LinearPlan(NamedTuple):
    """K10/K11's launch at (m, k, n): ``variant`` = (resident, rows a block,
    columns a tile, stages, blocks an SM); schedule R walks ``nsplit``
    contiguous ranges of N tiles a row block, schedule S one tile a block
    over ``ksplit`` ranges of 64-channel K chunks; ``smem`` the dynamic
    shared bytes."""
    variant: tuple
    nsplit: int
    ksplit: int
    smem: int

    @property
    def schedule(self) -> str:
        return "R" if self.variant[0] else "S"

    @property
    def bm(self) -> int:
        return self.variant[1]

    @property
    def bn(self) -> int:
        return self.variant[2]

    def grid(self, m: int, n: int):
        """The launch grid: R (row blocks, N splits), S (N tiles, row
        blocks, K splits)."""
        mb = -(-m // self.bm)
        return (mb, self.nsplit) if self.variant[0] else (-(-n // self.bn), mb, self.ksplit)


def lin_smem(resident: int, bm: int, bn: int, stages: int, kch: int) -> int:
    """1024 bytes to align the ring; R: ``stages`` weight slabs of ``bn``
    rows x 128 bytes, the block's ``bm`` rows of ``kch`` 128-byte chunks and
    the LayerNorm affine (bf16, K padded to whole chunks);
    S: ``stages`` slabs of ``bm`` + ``bn`` rows and the rows' LayerNorm
    mean and rstd (f32); 128 for the mbarriers."""
    if resident:
        return 1024 + stages * bn * 128 + bm * kch * 128 + kch * 256 + 128
    return 1024 + stages * (bm + bn) * 128 + bm * 8 + 128


def _blocks_per_sm(v: tuple, kch: int) -> int:
    return max(1, min(v[4], SMEM_SM // (lin_smem(*v[:4], kch) + 1024)))


@functools.lru_cache(maxsize=None)
def linear_plan(m: int, k: int, n: int, prologue: str = "none", sms: int = 132,
                variant: tuple = None) -> LinearPlan:
    """K10/K11's launch for an (m, k, n) call with ``prologue`` ("none",
    "ln" or "gn") on a card of ``sms`` SMs, as csrc/linear.cu's entry takes
    it (``variant`` names one to measure instead of the planner's).

    Schedule R for a LN or GN prologue wherever a block's rows fit shared
    memory (K <= 1280): 64 rows a block (two blocks an SM at
    K <= 384, which hides one block's prologue under the other's products),
    128 rows at 384 < K <= 640 unless their tiles would leave more than a
    third of the SMs idle.  Its N tiles are split over ``nsplit``
    blocks a row block, the count that finishes in the fewest waves x (tiles
    a block + 1, the block's own rows being about one tile's loads), the
    fewest splits on a tie.  Schedule S elsewhere (a prologue then applied
    to each streamed slab): 64-row blocks, two an SM, but 128 rows at K >=
    1280 where 128-row tiles would fill between half the SMs and all of them
    once; where its tiles leave at least half the SMs idle, K is split
    into ceil(sms / tiles) parts (at least two 64-channel chunks each, at
    most 16).  The variants and rules are the ones the H100 sweep
    (chip_smoke.py --k10-sweep, PERF.md) found fastest per pass."""
    require(prologue in PROLOGUES, f"K10/K11: prologue {prologue!r} not in {PROLOGUES}")
    require(m >= 1 and k >= 8 and k % 8 == 0 and n % 8 == 0,
            f"K10/K11 take K % 8 == 0 and N % 8 == 0, got K={k}, N={n}")
    kch = -(-k // LIN_KC)

    def fits(v):
        return lin_smem(*v[:4], kch) <= SMEM_BLOCK

    if variant is not None:
        require(variant in LIN_VARIANTS, f"K10/K11: no variant {variant}")
        require(fits(variant), f"K10/K11: variant {variant} does not fit K={k}")
        v = variant
    elif prologue != "none" and any(u[0] and fits(u) for u in LIN_VARIANTS):
        v = (1, 128, 160, 3, 1) if 384 < k <= 640 else (1, 64, 160, 3, 2)
        if v[1] == 128 and -(-m // 128) * -(-n // v[2]) * 3 < 2 * sms:
            v = (1, 64, 160, 3, 2)
    else:
        tiles = -(-m // 128) * -(-n // 160)
        v = (0, 128, 160, 4, 1) if k >= 1280 and sms <= 2 * tiles < 2 * sms else (0, 64, 160, 3, 2)
    ntiles = -(-n // v[2])
    mb = -(-m // v[1])
    if v[0]:
        per = sms * _blocks_per_sm(v, kch)
        best = min(range(1, ntiles + 1), key=lambda ns: (-(-mb * ns // per) * (-(-ntiles // ns) + 1), ns))
        return LinearPlan(v, best, 1, lin_smem(*v[:4], kch))
    tiles = mb * ntiles
    ks = 1
    if 2 * tiles <= sms:
        ks = max(1, min(-(-sms // tiles), kch // 2, LIN_MAX_KSPLIT))
    return LinearPlan(v, ntiles, ks, lin_smem(*v[:4], kch))


_LIN_WS = {}  # device index -> f32 scratch: split-K partials


def _lin_workspace(x: torch.Tensor, floats: int) -> int:
    """The pointer of at least ``floats`` f32 of scratch on ``x``'s device,
    reused call after call (calls on one stream are ordered, so two streams
    must not run split-K K10 on one device at once)."""
    buf = _LIN_WS.get(x.get_device())
    if buf is None or buf.numel() < floats:
        buf = torch.empty(max(floats, 1 << 18), device=x.device, dtype=torch.float32)
        _LIN_WS[x.get_device()] = buf
    return buf.data_ptr()


def _k10_refuse(x, weight, bias, residual, ln_weight, ln_bias, scale_shift):
    """Raise the error that names what K10/K11 do not take (their shape
    rules, checked in one expression on the launch path)."""
    name = "K10" if scale_shift is None else "K11"
    require_no_grad(name, x, weight, bias, residual, ln_weight, ln_bias, scale_shift)
    require(x.is_cuda, f"{name} needs a CUDA tensor, got {x.device}")
    k = x.shape[-1]
    n = weight.shape[0]
    require(k % 8 == 0 and n % 8 == 0, f"{name} takes K % 8 == 0 and N % 8 == 0, got K={k}, N={n}")
    require(weight.shape == (n, k), f"{name}: weight {tuple(weight.shape)} for K={k}")
    bf = [x, weight] + [t for t in (bias, residual, ln_weight, ln_bias) if t is not None]
    require(all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in bf),
            f"{name} takes contiguous bf16 activations, weight, bias, residual and LN affine")
    require(all(t.data_ptr() % 16 == 0 for t in bf), f"{name} needs 16-byte alignment")
    require(bias is None or bias.shape == (n,), f"{name}: bias must be (N,)")
    require(residual is None or residual.shape == (*x.shape[:-1], n), f"{name}: residual shape")
    require((ln_weight is None) == (ln_bias is None)
            and (ln_weight is None or ln_weight.shape == ln_bias.shape == (k,)),
            f"{name}: LN weight and bias must both be (K,) or both None")
    require(ln_weight is None, "K11 takes no LayerNorm")
    raise ValueError("K11: scale_shift must be contiguous, 16-byte aligned f32 (B, 2, K)")


def linear_kernel(x, weight, bias=None, residual=None, ln_weight=None, ln_bias=None,
                  scale_shift=None, *, eps: float = 1e-5, _plan: LinearPlan = None):
    """Launch K10, or K11 when ``scale_shift`` is given.  x (..., K) bf16
    contiguous on CUDA; weight (N, K), bias (N,), residual (..., N) and the
    LN affine (K,) bf16; scale_shift (B, 2, K) f32 from K1, x then NHWC
    (B, H, W, K) or (B, S, K), the GroupNorm normalize applied to x first.
    ``_plan`` runs another plan (for measuring)."""
    with (K10 if scale_shift is None else K11).span():
        k = x.shape[-1]
        m = x.numel() // k
        n = weight.shape[0]
        bf = [t for t in (x, weight, bias, residual, ln_weight, ln_bias) if t is not None]
        rows = m // x.shape[0] if scale_shift is not None else 1
        if not (x.is_cuda and k % 8 == 0 and n % 8 == 0 and weight.shape == (n, k)
                and not wants_grad(scale_shift, *bf)
                and all(t.dtype == torch.bfloat16 and t.is_contiguous() and t.data_ptr() % 16 == 0
                        for t in bf)
                and (bias is None or bias.shape == (n,))
                and (residual is None or residual.shape == (*x.shape[:-1], n))
                and (ln_weight is None) == (ln_bias is None)
                and (ln_weight is None or ln_weight.shape == ln_bias.shape == (k,))
                and (scale_shift is None or (ln_weight is None
                                             and scale_shift.shape == (x.shape[0], 2, k)
                                             and scale_shift.dtype == torch.float32
                                             and scale_shift.is_contiguous()
                                             and scale_shift.data_ptr() % 16 == 0))):
            _k10_refuse(x, weight, bias, residual, ln_weight, ln_bias, scale_shift)
        prologue = "gn" if scale_shift is not None else "none" if ln_weight is None else "ln"
        plan = _plan or linear_plan(m, k, n, prologue, _cuda.sm_count(x.get_device()))
        ws = _lin_workspace(x, plan.ksplit * m * n) if plan.ksplit > 1 else None
        out = torch.empty((*x.shape[:-1], n), device=x.device, dtype=x.dtype)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        _cuda.check(_cuda.call_packed(
            _cuda.library().sdtk_linear, x.data_ptr(), ptr(ln_weight), ptr(ln_bias), ptr(scale_shift),
            weight.data_ptr(), ptr(bias), ptr(residual), out.data_ptr(), ws, rows, m, n, k,
            *plan.variant, plan.nsplit, plan.ksplit, _cuda.f32_bits(eps), _cuda.stream_handle(x)),
            "K10/K11 linear")
        if scale_shift is None:
            K10.launched((m, k, n, ln_weight is not None, residual is not None))
        else:
            K11.launched((x.shape[0], rows, k, n))
        return out


def linear_occupancy(k: int = 1280) -> dict:
    """Each compiled K10/K11 variant on the current card, its shared memory
    for K = ``k`` (variants that do not fit it left out): ``{variant:
    {...}}`` with registers a thread, spill (local) bytes a thread, shared
    bytes a block and resident blocks an SM, from the runtime."""
    keys = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm")
    kch = -(-k // LIN_KC)
    out = {}
    for v in LIN_VARIANTS:
        if lin_smem(*v[:4], kch) <= SMEM_BLOCK:
            got = (ctypes.c_int * 4)()
            _cuda.check(_cuda.library().sdtk_linear_attrs(*v, kch, got), "K10/K11 attributes")
            out[v] = dict(zip(keys, got))
    return out


def _k10(x, weight, bias, residual, ln_weight, ln_bias, eps):
    """K10 on the card, in its autograd Function when a gradient is wanted."""
    args = (x, weight, bias, residual, ln_weight, ln_bias)
    if wants_grad(*args):
        return Recompute.apply(lambda *a: linear_kernel(*a, eps=eps),
                               lambda *a: linear_plain(*a, eps=eps), *args)
    return linear_kernel(*args, eps=eps)


def _rows(x) -> int:
    return x.numel() // x.shape[-1]


def ln_matmul(ln_weight, ln_bias, x, weight, bias=None, *, eps: float = 1e-5,
              impl: str = "auto"):
    """LayerNorm(x) @ W^T (+b): K10 with its LN prologue where the switch
    takes the site, else the LayerNorm then ``F.linear``."""
    if use_kernel(impl, x) and fused_site("ln", _rows(x), x.shape[-1], weight.shape[0], impl):
        return _k10(x, weight, bias, None, ln_weight, ln_bias, eps)
    return F.linear(layer_norm_plain(x, ln_weight, ln_bias, eps), weight, bias)


def matmul_residual(x, weight, bias, res, *, impl: str = "auto"):
    """x @ W^T (+b) + res; weight in PyTorch's (out, in) layout: K10 with the
    residual in its epilogue where the switch takes the site."""
    if use_kernel(impl, x) and fused_site("res", _rows(x), x.shape[-1], weight.shape[0], impl):
        return _k10(x, weight, bias, res, None, None, 1e-5)
    return F.linear(x, weight, bias) + res


def gn_matmul(x, gn_weight, gn_bias, weight, bias=None, *, num_groups: int = 32,
              eps: float = 1e-5, impl: str = "auto"):
    """GroupNorm(x) @ W^T + b over NHWC x (the 1x1-conv-as-matmul case): K1
    stats then K11 where the switch takes the site, else K1's normalize then
    ``F.linear``."""
    if use_kernel(impl, x) and fused_site("gn", _rows(x), x.shape[-1], weight.shape[0], impl):
        args = (x, gn_weight, gn_bias, weight, bias)
        kw = dict(num_groups=num_groups, eps=eps)

        def fwd(x, gn_weight, gn_bias, weight, bias):
            ss = gn_scale_shift_kernel(x, gn_weight, gn_bias, **kw)
            return linear_kernel(x, weight, bias, scale_shift=ss)

        if wants_grad(*args):
            return Recompute.apply(fwd, lambda *a: gn_matmul_plain(*a, **kw), *args)
        return fwd(*args)
    xn = group_norm_silu(x, gn_weight, gn_bias, num_groups=num_groups, eps=eps,
                         silu=False, impl=impl)
    return F.linear(xn, weight, bias)


# ---------------------------------------------------------------------------
# Static W8A8: plain version, kernel wrapper, entry points
# ---------------------------------------------------------------------------


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


# K8's compiled variants (csrc/linear_q.cu SDTK_LQ_VARIANTS): (rows a block,
# columns a tile, ring stages, blocks an SM for the launch bound).
LQ_VARIANTS = ((128, 160, 4, 1), (128, 160, 3, 1), (64, 160, 4, 2), (64, 64, 4, 2), (64, 32, 4, 2),
               (64, 16, 4, 2))
LQ_KC = 128                # K a step: one 128-byte row of int8
# The planner's cost model (rates an H100 reaches at best, scaled down):
# int8 tensor work at 60% of 1979 TOP/s over the card; device memory at
# 80% of 3.35 TB/s shared by the busy SMs, at most 60 GB/s an SM; L2 at
# ~40 GB/s an SM; shared memory at ~200 GB/s an SM (wgmma reads A and B
# from it); ~0.3 us a ring step at least and ~2 us a block to start.
_LQ_OPS, _LQ_HBM, _LQ_HBM_SM, _LQ_L2, _LQ_SMEM = 0.6 * 1979e12, 0.8 * 3.35e12, 60e9, 40e9, 200e9
_LQ_STEP, _LQ_BLOCK = 0.3e-6, 2e-6


class LinearQPlan(NamedTuple):
    """K8's launch at (m, k, n): ``variant`` = (rows a block, columns a
    tile, stages, blocks an SM); its N tiles split over ``nsplit`` blocks a
    row block and its 128-byte K chunks over ``ksplit``; ``nkc`` the K
    chunks a block holds; ``smem`` its dynamic shared bytes."""
    variant: tuple
    nsplit: int
    ksplit: int
    nkc: int
    smem: int

    @property
    def bm(self) -> int:
        return self.variant[0]

    @property
    def bn(self) -> int:
        return self.variant[1]

    def grid(self, m: int):
        """(row blocks, N splits, K splits): the launch grid."""
        return -(-m // self.bm), self.nsplit, self.ksplit


def lq_smem(bm: int, bn: int, stages: int, nkc: int) -> int:
    """1024 bytes to align the ring, ``stages`` slabs of ``bn`` weight rows
    x 128 bytes, the block's ``bm`` int8 rows of ``nkc`` 128-byte chunks,
    three tiles' out_scale (f32) and bias (bf16) for their epilogues, 16
    for the split-K ticket's flag."""
    return 1024 + stages * bn * LQ_KC + bm * nkc * LQ_KC + 3 * bn * 6 + 16


def _lq_cost(m: int, k: int, n: int, sms: int, variant: tuple, nsplit: int, ksplit: int) -> float:
    """Seconds the planner expects of the product's launch: waves of
    blocks, each block reading its int8 rows, running its tiles' ring steps
    and storing (or merging) each tile."""
    bm, bn, stages, minb = variant
    kch, ntiles = -(-k // LQ_KC), -(-n // bn)
    nch, tiles = -(-kch // ksplit), -(-ntiles // nsplit)
    resident = max(1, min(minb, SMEM_SM // (lq_smem(bm, bn, stages, nch) + 1024)))
    blocks = -(-m // bm) * nsplit * ksplit
    busy = min(sms, -(-blocks // resident))
    hbm = min(_LQ_HBM / busy, _LQ_HBM_SM) / resident
    ops, l2, sm = _LQ_OPS / sms / resident, _LQ_L2 / resident, _LQ_SMEM / resident
    rows = bm * nch * LQ_KC
    step = max(2 * bm * bn * LQ_KC / ops, bn * LQ_KC / l2,
               (bm + bm // 64 * bn) * LQ_KC / sm, _LQ_STEP)
    tile = nch * step + bm * bn * 2 / hbm + (bm * bn * 8 / l2 if ksplit > 1 else 0)
    block = _LQ_BLOCK + rows / hbm + tiles * tile
    return -(-blocks // (sms * resident)) * block


@functools.lru_cache(maxsize=None)
def linear_q_plan(m: int, k: int, n: int, sms: int = 132, variant: tuple = None) -> LinearQPlan:
    """K8's launch for an (m, k, n) call on a card of ``sms`` SMs, as
    csrc/linear_q.cu's entry takes it (``variant`` names one to measure
    instead of the planner's choice).

    M <= 64 (the time embeddings): 64-row blocks, one tile each, the
    widest tile (64, 32 or 16 columns) whose tiles times K chunks reach
    ``sms`` blocks, and K split until the blocks do (weight-bound: at least
    ``sms`` blocks stream the weight wherever the chunks allow).  Larger M:
    the variant and N split that the cost model (``_lq_cost``) finishes
    soonest, the fewest splits on a tie; K is split only where a block's
    rows of all of K would not fit shared memory (merging M x N int32
    partials by atomics cost 3x at (2048, 1280, 1280) on an NVIDIA H100
    80GB HBM3 at 700 W)."""
    require(m >= 1 and k % 32 == 0 and n % 8 == 0,
            f"K8 takes K % 32 == 0 and N % 8 == 0, got K={k}, N={n}")
    kch = -(-k // LQ_KC)

    def fits(v, ks):
        return lq_smem(*v[:3], -(-kch // ks)) <= SMEM_BLOCK

    def make(v, ns, ks):
        nkc = -(-kch // ks)
        return LinearQPlan(v, ns, ks, nkc, lq_smem(*v[:3], nkc))

    if variant is not None:
        require(variant in LQ_VARIANTS, f"K8: no variant {variant}")
        cands = [variant]
    elif m <= 64:
        small = [v for v in LQ_VARIANTS if v[0] == 64 and v[1] <= 64]
        v = next((v for v in small if -(-n // v[1]) * kch >= sms), small[-1])
        ntiles = -(-n // v[1])
        ks = min(kch, max(-(-sms // ntiles), 1))
        while not fits(v, ks):
            ks += 1
        return make(v, ntiles, ks)
    else:
        cands = [v for v in LQ_VARIANTS if v[1] >= 64]
    best = None
    for v in cands:
        ntiles = -(-n // v[1])
        ks = next((ks for ks in range(1, kch + 1) if fits(v, ks)), None)
        if ks is None:
            continue
        for ns in range(1, ntiles + 1):
            cost = _lq_cost(m, k, n, sms, v, ns, ks)
            if best is None or cost < best[0] * (1 - 1e-9):
                best = (cost, v, ns, ks)
    require(best is not None, f"K8: no variant fits K={k}")
    return make(*best[1:])


_LQ_WS = {}  # device index -> int32 workspace: split-K sums, then tickets; left zero
_LQ_Q = {}   # device index -> uint8 scratch: the quantized rows


def _lq_workspace(x: torch.Tensor, ints: int) -> int:
    """The pointer of at least ``ints`` zero int32 on ``x``'s device, reused
    call after call (K8 leaves what it used zero; calls on one stream are
    ordered, so two streams must not run split-K K8 on one device at once)."""
    buf = _LQ_WS.get(x.get_device())
    if buf is None or buf.numel() < ints:
        buf = torch.zeros(max(ints, 1 << 18), device=x.device, dtype=torch.int32)
        _LQ_WS[x.get_device()] = buf
    return buf.data_ptr()


def _k8_refuse(x, weight_q, s_x, out_scale, bias, residual, ln_weight, ln_bias):
    """Raise the ValueError that names what K8 does not take (its shape
    rules, checked in one expression on the launch path)."""
    require(x.is_cuda, f"K8 needs a CUDA tensor, got {x.device}")
    k = x.shape[-1]
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
    require(bias is None or bias.shape == (n,), "K8: bias must be (N,)")
    require(residual is None or residual.shape == (*x.shape[:-1], n), "K8: residual shape")
    require((ln_weight is None) == (ln_bias is None)
            and (ln_weight is None or ln_weight.shape == ln_bias.shape == (k,)),
            "K8: LN weight and bias must both be (K,) or both None")
    raise ValueError("K8 needs x, weight_q and the LN affine 16-byte aligned")


def _lq_rows(x: torch.Tensor, nbytes: int) -> int:
    """The pointer of at least ``nbytes`` of scratch on ``x``'s device for
    K8's quantized rows, reused call after call (calls on one stream are
    ordered, so two streams must not run K8 on one device at once)."""
    buf = _LQ_Q.get(x.get_device())
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1 << 20), device=x.device, dtype=torch.uint8)
        _LQ_Q[x.get_device()] = buf
    return buf.data_ptr()


def matmul_w8a8_kernel(x, weight_q, s_x, out_scale, bias=None, residual=None,
                       ln_weight=None, ln_bias=None, *, eps: float = 1e-5,
                       _plan: LinearQPlan = None):
    """Launch K8.  x (..., K) bf16 contiguous on CUDA; weight_q (N, K) int8;
    s_x (1,) and out_scale = s_x * weight_scale (N,) f32 (``folded_scales``);
    bias (N,), residual (..., N) and the LN affine (K,) bf16.  ``_plan``
    runs another plan (for measuring)."""
    with K8.span():
        require_no_grad("K8", x, bias, residual, ln_weight, ln_bias)
        k = x.shape[-1]
        m = x.numel() // k
        n = weight_q.shape[0]
        bf = [t for t in (x, bias, residual, ln_weight, ln_bias) if t is not None]
        if not (x.is_cuda and k % 32 == 0 and n % 8 == 0 and weight_q.shape == (n, k)
                and weight_q.dtype == torch.int8 and weight_q.is_contiguous()
                and s_x.shape == (1,) and out_scale.shape == (n,)
                and s_x.dtype == out_scale.dtype == torch.float32
                and s_x.is_contiguous() and out_scale.is_contiguous()
                and all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in bf)
                and all(t.data_ptr() % 16 == 0 for t in (x, weight_q, ln_weight, ln_bias) if t is not None)
                and (bias is None or bias.shape == (n,))
                and (residual is None or residual.shape == (*x.shape[:-1], n))
                and (ln_weight is None) == (ln_bias is None)
                and (ln_weight is None or ln_weight.shape == ln_bias.shape == (k,))):
            _k8_refuse(x, weight_q, s_x, out_scale, bias, residual, ln_weight, ln_bias)
        plan = _plan or linear_q_plan(m, k, n, _cuda.sm_count(x.get_device()))
        ws = tickets = None
        if plan.ksplit > 1:
            rb, nt = -(-m // plan.bm), -(-n // plan.bn)
            ws = _lq_workspace(x, m * n + rb * nt)
            tickets = ws + 4 * m * n
        out = torch.empty((*x.shape[:-1], n), device=x.device, dtype=x.dtype)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        _cuda.check(_cuda.call_packed(
            _cuda.library().sdtk_linear_q, x.data_ptr(), ptr(ln_weight), ptr(ln_bias),
            weight_q.data_ptr(), s_x.data_ptr(), out_scale.data_ptr(), ptr(bias), ptr(residual),
            out.data_ptr(), ws, tickets, _lq_rows(x, m * k), m, n, k, *plan.variant, plan.nsplit,
            plan.ksplit,
            _cuda.f32_bits(eps), _cuda.stream_handle(x)), "K8 linear_q")
        K8.launched((m, k, n, ln_weight is not None, residual is not None))
        return out


def linear_q_occupancy(k: int = 1280) -> dict:
    """Each compiled K8 variant on the current card, its rows of all of
    ``k`` resident (variants that do not fit left out): ``{variant: {...}}``
    with registers a thread, spill (local) bytes a thread, shared bytes a
    block and resident blocks an SM, from the runtime."""
    keys = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm")
    nkc = -(-k // LQ_KC)
    out = {}
    for v in LQ_VARIANTS:
        if lq_smem(*v[:3], nkc) <= SMEM_BLOCK:
            got = (ctypes.c_int * 4)()
            _cuda.check(_cuda.library().sdtk_linear_q_attrs(*v, nkc, got), "K8 attributes")
            out[v] = dict(zip(keys, got))
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
