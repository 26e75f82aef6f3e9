"""GroupNorm(+SiLU) over NHWC: kernel K1 (CUDA) beside its plain version.

K1 (csrc/groupnorm.cu) replaces two TPU kernels of
stable_diffusion_tpu/ops/groupnorm.py: ``_stats_kernel`` (per-channel sums
-> group mean/rstd -> folded (B, 2, C) scale/shift; ``_stats_call``,
``_run_kernels``) and ``_norm_kernel`` (``y = x * scale + shift`` (+SiLU);
``_run_kernels``).  The note at the top of the source says what bounds it
and how it is built: one launch a statistics call (chunk partials merged by
the last block to arrive, with Chan's formula, in chunk order), one more for
the normalize.  :func:`gn_plan` mirrors its C dispatch (``sdtk_gn_plan``);
the CPU tests hold the plan and an emulation of its schedule.

The scale/shift is also exposed on its own (:func:`gn_scale_shift`), since
K2, K7, K11 and K12 apply it in their prologues.  Each wrapper allocates
only its outputs: the statistics kernel's partials and tickets, and the
normalize path's scale/shift, live in one workspace per device, made on
first use and reused (each launch leaves the tickets at 0).  Calls on one
stream are ordered, so two streams must not run K1 on one device at once.

K1's backward (``sdtk_gn_bwd``, two launches: a reduction planned by
:func:`gn_bwd_plan`, then the dx pass) is the closed-form VJP of
GroupNorm(+SiLU) on the statistics the forward kept (:class:`GroupNormFn`,
and ``ops/conv.GnSiluConv3x3Fn``); :func:`group_norm_bwd_plain` follows its
arithmetic on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from stable_diffusion_tpu_torch.ops import _cuda
from stable_diffusion_tpu_torch.ops._autograd import Recompute
from stable_diffusion_tpu_torch.utils.device import (LaunchCounter, at_least_f32, require,
                                                     require_no_grad, use_kernel, wants_grad)

K1 = LaunchCounter("K1")

GN_THREADS = 256    # most threads of a statistics block
GN_RMAX = 8         # most rows a thread holds in registers
GN_MAX_GROUPS = 128  # most groups of a block's channel slab


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and the card's reference)
# ---------------------------------------------------------------------------


def gn_stats_plain(x, num_groups: int = 32, eps: float = 1e-5):
    """(B, G, 2) each group's (mean, 1 / sigma) in f32 (or wider): two-pass
    statistics as models/layers.group_norm; what K1's forward keeps for its
    backward."""
    b, c = x.shape[0], x.shape[-1]
    xf = at_least_f32(x).reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3))
    var = (xf - mean[:, None, :, None]).square().mean(dim=(1, 3))
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=-1)


def _per_channel(stats, c: int):
    """(B, 1, C) mean and rstd of each channel's group, from (B, G, 2) statistics."""
    mean, rstd = stats.repeat_interleave(c // stats.shape[1], dim=1)[:, None].unbind(-1)
    return mean, rstd


def gn_scale_shift_plain(x, weight, bias, num_groups: int = 32, eps: float = 1e-5):
    """(B, 2, C) f32 folded affine with ``y = x * out[:, 0] + out[:, 1]``;
    two-pass f32 statistics as models/layers.group_norm."""
    mean, rstd = _per_channel(gn_stats_plain(x, num_groups, eps), x.shape[-1])
    scale = at_least_f32(weight) * rstd
    shift = at_least_f32(bias) - mean * scale
    return torch.cat([scale, shift], dim=1)


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


def group_norm_bwd_plain(x, dy, weight, bias, stats, num_groups: int = 32, silu: bool = False,
                         affine: bool = True):
    """The VJP of :func:`group_norm_plain` against ``dy`` in closed form, on
    the forward's (B, G, 2) statistics: ``(dx, dweight, dbias)``, the last
    two None unless ``affine``.  K1's backward in f32 (or wider): per
    channel ``scale = gamma rstd``, ``shift = beta - mean scale``; ``dz = dy
    silu'(x scale + shift)`` (``dy`` without the SiLU); per image and channel
    the sums ``P1 = sum dz`` and ``P2 = sum dz x^`` over the rows, ``x^ = (x
    - mean) rstd``; per group ``S1, S2`` = the gamma-weighted sums of
    ``P1, P2`` over its channels, over N = HW C / G; then ``dx = scale dz +
    m x + n`` with ``m = -rstd^2 S2 / N`` and ``n = rstd (mean rstd S2 - S1)
    / N``; ``dgamma = sum_b P2``, ``dbeta = sum_b P1``."""
    b, c = x.shape[0], x.shape[-1]
    xf = at_least_f32(x).reshape(b, -1, c)
    w, bb = at_least_f32(weight), at_least_f32(bias)
    mean, rstd = _per_channel(stats, c)
    scale = w * rstd
    shift = bb - mean * scale
    dz = at_least_f32(dy).reshape(b, -1, c)
    if silu:
        z = xf * scale + shift
        s = torch.sigmoid(z)
        dz = dz * s * (z * (1 - s) + 1)
    p1 = dz.sum(dim=1)
    p2 = (dz * ((xf - mean) * rstd)).sum(dim=1)
    n = xf.shape[1] * (c // num_groups)

    def group_sum(p):
        sums = (w * p).reshape(b, num_groups, -1).sum(-1)
        return sums.repeat_interleave(c // num_groups, -1)[:, None] / n

    t1, t2 = group_sum(p1), group_sum(p2)
    dx = (scale * dz + (-rstd * rstd * t2 * xf + rstd * (mean * rstd * t2 - t1))).to(x.dtype)
    if not affine:
        return dx.reshape(x.shape), None, None
    return dx.reshape(x.shape), p2.sum(0).to(weight.dtype), p1.sum(0).to(bias.dtype)


def gn_silu_prologue(x, scale_shift):
    """``silu(x * scale + shift)`` in f32, cast to x's dtype: the activation
    the convs K2, K7 and K12 take in their prologue, from a (B, 2, C) f32
    ``scale_shift``."""
    xf = at_least_f32(x) * scale_shift[:, None, None, 0] + scale_shift[:, None, None, 1]
    return torch.nn.functional.silu(xf).to(x.dtype)


# ---------------------------------------------------------------------------
# The plan, the workspace and the kernel wrappers
# ---------------------------------------------------------------------------


class GnPlan(NamedTuple):
    """A statistics launch: ``vec`` channels a load (8 bf16 or 4 f32, 1
    where C % that != 0), a block's slab of ``gs`` groups read by ``lanes``
    vector lanes a row and ``tr`` rows at once (of its 256 threads), tiles
    of ``r`` rows a thread held in registers, ``tiles`` of them a block in
    order; ``chunk`` rows a block, ``nchunks`` blocks a (batch, slab);
    ``mlanes`` lanes a group in the last block's merge."""
    vec: int
    gs: int
    r: int
    tiles: int
    lanes: int
    tr: int
    chunk: int
    nchunks: int
    slabs: int
    mlanes: int

    @property
    def ticket(self) -> bool:
        """Whether the chunks meet through the workspace (the last block merges)."""
        return self.nchunks > 1

    def grid(self, b: int):
        return self.nchunks, self.slabs, b


def _slab_ok(g: int, cpg: int, vec: int, d: int) -> bool:
    return g % d == 0 and d <= GN_MAX_GROUPS and d * cpg % vec == 0 and d * cpg // vec <= GN_THREADS


def _plan(vec, gs, r, tiles, hw, c, g) -> GnPlan:
    lanes = gs * (c // g) // vec
    tr = GN_THREADS // lanes
    chunk = tr * r * tiles
    mlanes = 32
    while mlanes * gs > GN_THREADS:
        mlanes //= 2
    return GnPlan(vec, gs, r, tiles, lanes, tr, chunk, -(-hw // chunk), g // gs, mlanes)


def _slabs(c: int, g: int, elem_bytes: int):
    """``(vec, gs)`` candidates of a statistics or backward launch: ``vec``
    channels a load (16 bytes where C allows, else 1) and the slab widths
    ``gs`` (groups) it takes, largest first."""
    require(g >= 1 and c % g == 0, f"K1: C={c} not divisible by {g} groups")
    cpg = c // g
    vec = 16 // elem_bytes
    if c % vec:
        vec = 1
    ok = [d for d in range(g, 0, -1) if _slab_ok(g, cpg, vec, d)]
    if not ok:
        vec = 1
        ok = [d for d in range(g, 0, -1) if _slab_ok(g, cpg, vec, d)]
    require(bool(ok), f"K1: a group of {cpg} channels is wider than a block")
    return vec, ok


@functools.lru_cache(maxsize=None)
def gn_plan(b: int, hw: int, c: int, num_groups: int = 32, sms: int = 132,
            elem_bytes: int = 2) -> GnPlan:
    """K1's statistics launch for a (b, hw, c) input of ``elem_bytes`` a
    value, as csrc/groupnorm.cu ``sdtk_gn_plan`` dispatches it.

    ``vec``: 16 bytes a load where C allows, else 1.  Where some slab of
    ``gs`` groups lets one block hold a whole image's rows (hw <= 8 tr),
    the largest such ``gs`` with r = ceil(hw / tr): one chunk, no ticket
    (the UNet's 8^2 and 16^2 stages).  Else the largest ``gs`` (whole rows
    read contiguously where C allows), the largest r in 8, 4, 2, 1 whose
    tiles give two blocks an SM (1 where none does), and, where there are
    more tiles than that, as many a block as make one wave of two blocks an
    SM (the kernel's occupancy), at least enough for at most 512 chunks a
    (batch, slab) (the last block merges them)."""
    g = num_groups
    require(hw >= 1, f"K1: {hw} rows")
    vec, ok = _slabs(c, g, elem_bytes)
    cpg = c // g
    for d in ok:
        tr = GN_THREADS // (d * cpg // vec)
        if hw <= GN_RMAX * tr:
            return _plan(vec, d, -(-hw // tr), 1, hw, c, g)
    gs = ok[0]
    slabs = g // gs
    tr = GN_THREADS // (gs * cpg // vec)
    r = next((cand for cand in (8, 4, 2) if b * slabs * -(-hw // (tr * cand)) >= 2 * sms), 1)
    ntiles = -(-hw // (tr * r))
    total = b * slabs * ntiles
    tiles = max(-(-total // (2 * sms)) if total > 2 * sms else 1, -(-ntiles // 512))
    return _plan(vec, gs, r, tiles, hw, c, g)


GN_BWD_BLOCKS = 2  # blocks an SM the backward's reduction is planned for


class GnBwdPlan(NamedTuple):
    """A backward reduction launch: the statistics' slab (``vec``, ``gs``,
    ``lanes``, ``tr`` and ``mlanes`` as :class:`GnPlan`'s), ``chunk`` rows
    a block (a multiple of ``tr``) and ``nchunks`` blocks a (batch, slab)."""
    vec: int
    gs: int
    lanes: int
    tr: int
    chunk: int
    nchunks: int
    slabs: int
    mlanes: int

    @property
    def ticket(self) -> bool:
        return self.nchunks > 1

    def grid(self, b: int):
        return self.nchunks, self.slabs, b


@functools.lru_cache(maxsize=None)
def gn_bwd_plan(b: int, hw: int, c: int, num_groups: int = 32, sms: int = 132,
                elem_bytes: int = 2) -> GnBwdPlan:
    """K1's backward reduction for a (b, hw, c) input of ``elem_bytes`` a
    value: the widest slab (whole rows read contiguously where C allows),
    and each (batch, slab) split into as many chunks as make one wave of
    ``GN_BWD_BLOCKS`` blocks an SM over the card (one chunk where the
    batch's slabs fill it), a chunk's rows rounded up to whole row lanes."""
    require(hw >= 1, f"K1: {hw} rows")
    vec, ok = _slabs(c, num_groups, elem_bytes)
    p = _plan(vec, ok[0], 1, 1, hw, c, num_groups)
    split = max(1, GN_BWD_BLOCKS * sms // (b * p.slabs))
    rows = -(-hw // split)
    chunk = -(-rows // p.tr) * p.tr
    return GnBwdPlan(vec, p.gs, p.lanes, p.tr, chunk, -(-hw // chunk), p.slabs, p.mlanes)


_WORKSPACE = {}  # device index -> [partials f32, tickets int32 (all 0), scratch f32]


def _workspace(x: torch.Tensor, n_part: int, n_count: int, n_ss: int = 0):
    """The statistics workspace of ``x``'s device, each part grown to at
    least its count: the chunk partials (floats), the tickets and the
    scratch between two launches of one call (floats: the normalize path's
    scale/shift, the backward's coefficients; reused call after call:
    calls on one stream are ordered); their pointers."""
    ws = _WORKSPACE.get(x.get_device())
    if ws is None or ws[0].numel() < n_part or ws[1].numel() < n_count or ws[2].numel() < n_ss:
        old = ws or [None] * 3
        grow = lambda t, n, make: t if t is not None and t.numel() >= n else make(n)  # noqa: E731
        ws = [grow(old[0], n_part, lambda n: torch.empty(max(n, 1 << 16), device=x.device,
                                                        dtype=torch.float32)),
              grow(old[1], n_count, lambda n: torch.zeros(max(n, 1024), device=x.device,
                                                         dtype=torch.int32)),
              grow(old[2], n_ss, lambda n: torch.empty(max(n, 1 << 14), device=x.device,
                                                     dtype=torch.float32))]
        _WORKSPACE[x.get_device()] = ws
    return ws[0].data_ptr(), ws[1].data_ptr(), ws[2].data_ptr()


_DTYPES = (torch.bfloat16, torch.float32)


def _check(x, weight, bias, num_groups):
    """The shape rules; returns (b, hw, c)."""
    c = x.shape[-1]
    if not (x.is_cuda and x.dtype in _DTYPES and x.is_contiguous() and x.dim() >= 2
            and x.numel() and c % num_groups == 0 and weight.shape == (c,)
            and bias.shape == (c,) and weight.dtype == bias.dtype and weight.dtype in _DTYPES
            and weight.is_contiguous() and bias.is_contiguous() and x.data_ptr() % 16 == 0):
        require(x.is_cuda, f"K1 needs a CUDA tensor, got {x.device}")
        require(x.dtype in _DTYPES, f"K1 takes bf16/f32, got {x.dtype}")
        require(x.is_contiguous() and x.dim() >= 2 and x.numel() > 0,
                "K1 needs a contiguous, non-empty NHWC tensor")
        require(c % num_groups == 0, f"K1: C={c} not divisible by {num_groups} groups")
        require(x.data_ptr() % 16 == 0, "K1 needs a 16-byte aligned tensor")
        raise ValueError(f"K1: GroupNorm weight/bias must be contiguous bf16/f32 (C,), got "
                         f"{tuple(weight.shape)} {weight.dtype}")
    b = x.shape[0]
    return b, x.numel() // (b * c), c


def _stats(x, weight, bias, ss_ptr, b, hw, c, num_groups, eps, mr=None) -> GnPlan:
    """Launch the statistics kernel into the (B, 2, C) f32 at ``ss_ptr``
    (and each group's (mean, rstd) into ``mr``, a (B, G, 2) f32 tensor)."""
    f32 = x.dtype == torch.float32
    plan = gn_plan(b, hw, c, num_groups, _cuda.sm_count(x.get_device()), 4 if f32 else 2)
    part = count = None
    if plan.nchunks > 1:
        part, count, _ = _workspace(x, 2 * b * plan.nchunks * num_groups, b * plan.slabs)
    _cuda.check(_cuda.call_packed(
        _cuda.library().sdtk_gn_stats, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        ss_ptr, part, count, f32, weight.dtype == torch.float32, b, hw, c, num_groups,
        plan.vec, plan.gs, plan.r, plan.tiles, _cuda.f32_bits(eps), _cuda.stream_handle(x),
        None if mr is None else mr.data_ptr()), "K1 statistics")
    return plan


def _stats_out(x, num_groups):
    """An empty (B, G, 2) f32 tensor for each group's (mean, rstd)."""
    return torch.empty((x.shape[0], num_groups, 2), device=x.device, dtype=torch.float32)


def _scale_shift(x, weight, bias, num_groups, eps, keep_stats=False):
    with K1.span():
        b, hw, c = _check(x, weight, bias, num_groups)
        ss = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
        mr = _stats_out(x, num_groups) if keep_stats else None
        _stats(x, weight, bias, ss.data_ptr(), b, hw, c, num_groups, eps, mr)
        K1.launched(("stats", b, hw, c, x.dtype, eps))
        return (ss, mr) if keep_stats else ss


def _norm(x, weight, bias, num_groups, eps, silu, keep_stats=False):
    with K1.span():
        b, hw, c = _check(x, weight, bias, num_groups)
        ss = _workspace(x, 0, 0, b * 2 * c)[2]  # the scale/shift between the two launches
        mr = _stats_out(x, num_groups) if keep_stats else None
        plan = _stats(x, weight, bias, ss, b, hw, c, num_groups, eps, mr)
        y = torch.empty_like(x)
        _cuda.check(_cuda.call_packed(
            _cuda.library().sdtk_gn_apply, x.data_ptr(), ss, y.data_ptr(),
            x.dtype == torch.float32, b, hw, c, plan.vec, silu, _cuda.stream_handle(x)),
            "K1 normalize")
        K1.launched(("norm", b, hw, c, x.dtype, eps, silu))
        return (y, mr) if keep_stats else y


def _bwd(x, dy, weight, bias, stats, num_groups, silu, affine):
    with K1.span():
        b, hw, c = _check(x, weight, bias, num_groups)
        dy = dy.contiguous()
        require(dy.shape == x.shape and dy.dtype == x.dtype and dy.data_ptr() % 16 == 0,
                f"K1 backward: dy {tuple(dy.shape)} {dy.dtype} (16-byte aligned) for x "
                f"{tuple(x.shape)} {x.dtype}")
        require(stats.shape == (b, num_groups, 2) and stats.dtype == torch.float32
                and stats.is_contiguous(), "K1 backward: stats must be contiguous f32 (B, G, 2)")
        f32 = x.dtype == torch.float32
        plan = gn_bwd_plan(b, hw, c, num_groups, _cuda.sm_count(x.get_device()), 4 if f32 else 2)
        n_part = 2 * b * plan.nchunks * (num_groups + c * affine) if plan.ticket else 0
        part, count, scratch = _workspace(x, n_part, b * plan.slabs, b * c * (6 if affine else 4))
        cpart = part + 4 * 2 * b * plan.nchunks * num_groups if affine and plan.ticket else None
        dx = torch.empty_like(x)
        dw, db = (torch.empty_like(weight), torch.empty_like(bias)) if affine else (None, None)
        _cuda.check(_cuda.call_packed(
            _cuda.library().sdtk_gn_bwd, x.data_ptr(), dy.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), stats.data_ptr(), dx.data_ptr(), part if plan.ticket else None,
            cpart, count, scratch, scratch + 4 * 4 * b * c if affine else None,
            None if dw is None else dw.data_ptr(), None if db is None else db.data_ptr(), f32,
            weight.dtype == torch.float32, b, hw, c, num_groups, plan.vec, plan.gs, plan.chunk,
            silu, affine, _cuda.stream_handle(x)), "K1 backward")
        K1.launched(("bwd", b, hw, c, x.dtype, num_groups, silu, affine))
        return dx, dw, db


def gn_scale_shift_kernel(x, weight, bias, *, num_groups: int = 32,
                          eps: float = 1e-5) -> torch.Tensor:
    """Launch K1's statistics kernel: the folded (B, 2, C) f32 affine."""
    require_no_grad("K1", x, weight, bias)
    return _scale_shift(x, weight, bias, num_groups, eps)


def group_norm_silu_kernel(x, weight, bias, *, num_groups: int = 32, eps: float = 1e-5,
                           silu: bool = True) -> torch.Tensor:
    """Launch K1: statistics, then the normalize (+SiLU) pass."""
    require_no_grad("K1", x, weight, bias)
    return _norm(x, weight, bias, num_groups, eps, silu)


def group_norm_bwd_kernel(x, dy, weight, bias, stats, *, num_groups: int = 32,
                          silu: bool = True, affine: bool = True):
    """Launch K1's backward: ``(dx, dweight, dbias)`` of GroupNorm(+SiLU)
    against ``dy`` on the forward's (B, G, 2) statistics, the last two None
    unless ``affine`` (:func:`group_norm_bwd_plain`'s arithmetic)."""
    require_no_grad("K1", x, dy, weight, bias)
    return _bwd(x, dy, weight, bias, stats, num_groups, silu, affine)


def gn_occupancy() -> dict:
    """Each compiled K1 kernel on the current card, ``{(kind, vec): {...}}``
    (kind: the dtype for the statistics kernel, "<dtype> bwd reduce" and
    "<dtype> bwd apply" for the backward's): registers a thread, spill
    (local) bytes a thread, static shared bytes a block and resident blocks
    an SM at 256 threads, from the runtime."""
    keys = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm")
    out = {}
    for name, f32, vec in (("bf16", 0, 8), ("bf16", 0, 1), ("f32", 1, 4), ("f32", 1, 1)):
        got = (ctypes.c_int * 4)()
        _cuda.check(_cuda.library().sdtk_gn_attrs(f32, vec, got), "K1 attributes")
        out[(name, vec)] = dict(zip(keys, got))
        for apply, kind in enumerate(("reduce", "apply")):
            got = (ctypes.c_int * 4)()
            _cuda.check(_cuda.library().sdtk_gn_bwd_attrs(f32, vec, apply, got),
                        "K1 backward attributes")
            out[(f"{name} bwd {kind}", vec)] = dict(zip(keys, got))
    return out


def gn_plan_native(b: int, hw: int, c: int, num_groups: int = 32, sms: int = 132,
                   elem_bytes: int = 2) -> GnPlan:
    """The plan ``sdtk_gn_plan`` computes (the tests hold :func:`gn_plan` to it)."""
    got = (ctypes.c_int * 4)()
    _cuda.check(_cuda.library().sdtk_gn_plan(b, hw, c, num_groups, elem_bytes, sms, got),
                "K1 plan")
    return _plan(*got, hw, c, num_groups)


# ---------------------------------------------------------------------------
# Autograd: the forward and backward are arguments, so the CPU tests run the
# same Function on the plain versions
# ---------------------------------------------------------------------------


class GnOps(NamedTuple):
    """K1 (:data:`KERNEL_OPS`) or its plain versions (:data:`PLAIN_OPS`); each
    forward also returns the (B, G, 2) statistics the backward takes."""
    scale_shift: Callable  # (x, w, b, groups, eps) -> ((B, 2, C) f32 scale/shift, stats)
    norm: Callable         # (x, w, b, groups, eps, silu) -> (y, stats)
    backward: Callable     # (x, dy, w, b, stats, groups, silu, affine) -> (dx, dw, db)


KERNEL_OPS = GnOps(
    lambda x, w, b, groups, eps: _scale_shift(x, w, b, groups, eps, keep_stats=True),
    lambda x, w, b, groups, eps, silu: _norm(x, w, b, groups, eps, silu, keep_stats=True),
    lambda x, dy, w, b, stats, groups, silu, affine: group_norm_bwd_kernel(
        x, dy, w, b, stats, num_groups=groups, silu=silu, affine=affine))
PLAIN_OPS = GnOps(
    lambda x, w, b, groups, eps: (gn_scale_shift_plain(x, w, b, groups, eps),
                                  gn_stats_plain(x, groups, eps)),
    lambda x, w, b, groups, eps, silu: (group_norm_plain(x, w, b, groups, eps, silu),
                                        gn_stats_plain(x, groups, eps)),
    group_norm_bwd_plain)


class GroupNormFn(torch.autograd.Function):
    """GroupNorm(+SiLU) whose backward is the closed-form VJP on the
    forward's statistics (JAX ``_gn_bwd``); dgamma and dbeta only where a
    gradient of either is wanted."""

    @staticmethod
    def forward(ctx, ops: GnOps, x, weight, bias, num_groups, eps, silu):
        y, stats = ops.norm(x, weight, bias, num_groups, eps, silu)
        ctx.ops, ctx.num_groups, ctx.silu = ops, num_groups, silu
        ctx.save_for_backward(x, weight, bias, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, stats = ctx.saved_tensors
        _, nx, nw, nb, _, _, _ = ctx.needs_input_grad
        dx, dw, db = ctx.ops.backward(x, dy, weight, bias, stats, ctx.num_groups, ctx.silu,
                                      nw or nb)
        return None, dx if nx else None, dw if nw else None, db if nb else None, None, None, None


# ---------------------------------------------------------------------------
# Entry points: the kernel on the card (in its autograd Function when a
# gradient is wanted), the plain version on the CPU
# ---------------------------------------------------------------------------


def gn_scale_shift(x, weight, bias, *, num_groups: int = 32, eps: float = 1e-5,
                   impl: str = "auto") -> torch.Tensor:
    """Folded GroupNorm affine (B, 2, C) f32: ``y = x * out[:, 0] + out[:, 1]``."""
    if not use_kernel(impl, x):
        return gn_scale_shift_plain(x, weight, bias, num_groups, eps)
    if wants_grad(x, weight, bias):
        return Recompute.apply(
            functools.partial(gn_scale_shift_kernel, num_groups=num_groups, eps=eps),
            functools.partial(gn_scale_shift_plain, num_groups=num_groups, eps=eps),
            x, weight, bias)
    return _scale_shift(x, weight, bias, num_groups, eps)


def group_norm_silu(x, weight, bias, *, num_groups: int = 32, eps: float = 1e-5,
                    silu: bool = True, impl: str = "auto") -> torch.Tensor:
    """GroupNorm over the channel (last) dim of an NHWC tensor (+SiLU); on
    the card its gradient is K1's backward (:class:`GroupNormFn`)."""
    if not use_kernel(impl, x):
        return group_norm_plain(x, weight, bias, num_groups, eps, silu)
    if wants_grad(x, weight, bias):
        return GroupNormFn.apply(KERNEL_OPS, x, weight, bias, num_groups, eps, silu)
    return _norm(x, weight, bias, num_groups, eps, silu)
