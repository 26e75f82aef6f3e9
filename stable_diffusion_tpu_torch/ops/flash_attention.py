"""Non-causal attention over (B, S, H, D): kernel K3 (CUDA) for the forward
and kernels K5 + K6 (CUDA) for the self-attention backward, beside their
plain versions.

K3 (csrc/attention.cu) replaces three TPU kernels of
stable_diffusion_tpu/ops/flash_attention.py with blockwise softmaxes:
``_single_pass_kernel`` and ``_flash_kernel`` (self-attention) and
``_cross_kernel`` (the 77-token text cross-attention, masked by ``kv_len``).
:func:`attention_plan` picks its body and tile: the UNet's self-attention
at head dims 40, 64, 80 runs the ring body (a cp.async K/V ring, Q held in
registers); the cross-attention (at most 128 keys) the cross body (a
block's K and V loaded once, one exact softmax); the self-attention at head
dims 160 and 512 (SD1.5's deepest stages, the VAE's mid block) the wide
body (TMA-fed tiles, each logit computed once by one warpgroup's ``wgmma``,
the output split by columns across warps, the keys split across blocks
where the query tiles leave SMs idle); every other shape the general body.  :data:`K3_BY_BODY` counts
the launches of each body.
K5 and K6 (csrc/attention_bwd.cu) replace the two passes of
``_premerged_flash_bwd``: ``_bwd_dq_kernel`` (dQ and delta = rowsum(dO*O))
and ``_bwd_dkv_kernel`` (dK, dV).  :func:`attention_bwd_plan` picks their
body and tiles: the UNet's self-attention (head dims 40, 64, 80) runs the
ring bodies (csrc/attention_bwd_ring.cuh: the owned operands' fragments in
registers, the streamed tiles through a cp.async ring), everything else
the general bodies.  The notes at the top of the sources say what bounds
each and how it is built.

q, k and v may be strided views (the split of a fused QKV projection): the
kernels take each tensor's batch and sequence strides and need only the
head and head-dim axes packed.

Gradients (JAX ``_flash_self_premerged`` / ``_flash_cross_premerged``): an
attention with as many keys as queries and a head dim up to
:data:`BWD_MAX_D` saves q, k, v, o and K3's row log-sum-exp and runs K5 +
K6 backward; other shapes (the 77-token cross-attention) differentiate the
plain version, recomputed.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import torch

from stable_diffusion_tpu_torch.ops import _cuda
from stable_diffusion_tpu_torch.ops._autograd import Recompute
from stable_diffusion_tpu_torch.utils.device import (LaunchCounter, at_least_f32, require,
                                                     require_no_grad, use_kernel, wants_grad)

K3 = LaunchCounter("K3")
K5 = LaunchCounter("K5")
K6 = LaunchCounter("K6")

BWD_MAX_D = 160  # widest head dim K5/K6 take (the SD1.5 UNet's deepest stages)

# K3's bodies (csrc/attention.cu), as sdtk_attention numbers them, and the
# launches of each (K3 counts them all).
K3_BODIES = {"general": 0, "ring": 1, "cross": 2, "wide": 3}
K3_BY_BODY = {body: LaunchCounter(f"K3:{body}") for body in K3_BODIES}
K3_BKV = 64          # keys a tile: the general, ring and wide bodies
K3_RING_STAGES = 3   # K/V tiles in the ring body's ring
# The compiled ring variants (SDTK_ATTN_RING_VARIANTS): (padded head dim, query rows a block).
K3_RING = ((48, 128), (64, 64), (64, 192), (64, 256), (80, 128))
# The compiled cross variants (SDTK_ATTN_CROSS_VARIANTS): (padded head dim,
# keys zero-filled to); 64 query rows a tile, 4 warps.
K3_CROSS = ((48, 80), (64, 80), (80, 80), (160, 80), (48, 128), (64, 128), (80, 128))
CROSS_MAX_KEYS = 128
CROSS_MAX_TILES = 4
# Blocks an SM the cross variants' registers allow at least (CrossCfg::MINB,
# their __launch_bounds__): the compiled variants use up to that bound.
CROSS_MINB = {(dp, nk): (4 if nk <= 80 else 3) if dp <= 64 else 3 if dp <= 80 else 2
              for dp, nk in K3_CROSS}
# The compiled wide variants (SDTK_ATTN_WIDE_VARIANTS): padded head dim ->
# (warps, rows, columns of a warp's O block); 64 query rows a block.
K3_WIDE = {160: (4, 16, 160), 512: (8, 64, 64)}
WIDE_MAX_SPLITS = 8
WIDE_WS_BYTES = 128 << 20  # the largest partial workspace a key split may take
SMEM_BLOCK, SMEM_SM = 232448, 233472  # shared bytes a block can use, and an SM has (H100)

# K5/K6's bodies (csrc/attention_bwd.cu), as sdtk_attention_bwd_* number them.
BWD_BODIES = {"general": 0, "ring": 1}
BWD_RING_STAGES = 3  # streamed tiles in the ring bodies' ring
# The compiled ring variants (SDTK_BWD_DQ_RING, SDTK_BWD_DKV_RING): (padded
# head dim, rows a block owns, rows of each streamed tile).
K5_RING = ((48, 128, 64), (64, 128, 64), (80, 128, 64))
K6_RING = ((48, 128, 64), (64, 64, 64), (80, 128, 64))


class AttentionPlan(NamedTuple):
    """K3's launch: ``body`` ("general", "ring", "cross" or "wide"), the head
    dim ``dp`` held in shared memory (padded to a multiple of 16; the general
    body's heads wider than 160 to a multiple of 128, run as ``passes``
    128-column passes) and ``bq`` query rows a block (ring: 16 a warp) or a
    tile (64 in the others).  The cross body also takes ``nk``, the keys
    zero-filled to, and ``tiles``, query tiles a block; the wide body
    ``splits``, the blocks the keys are split across (merged by a second
    launch)."""
    body: str
    dp: int
    bq: int
    passes: int = 1
    nk: int = 0
    tiles: int = 1
    splits: int = 1

    @property
    def threads(self) -> int:
        if self.body == "ring":
            return 2 * self.bq
        if self.body == "wide":
            return 32 * K3_WIDE[self.dp][0]
        return 128

    def grid(self, b: int, sq: int, h: int):
        """The launch grid: (query blocks, batch x heads, passes) (general,
        ring), (query-tile runs, batch x heads, 1) (cross) or (query blocks,
        batch x heads, key splits) (wide)."""
        qb = -(-sq // self.bq)
        if self.body == "cross":
            return -(-qb // self.tiles), b * h, 1
        return qb, b * h, self.splits if self.body == "wide" else self.passes

    @property
    def smem(self) -> int:
        """Dynamic shared memory a block takes (csrc/attention.cu).  General
        and ring: rows of dp + 8 bf16 (16 bytes of padding) for the Q tile
        and each K and V tile of 64 keys, one K/V pair in the general body,
        the ring's three in the ring body.  Cross: the head's K and V (nk
        rows each) and Q buffers of 64 rows, three where a block takes three
        tiles or more, else two.
        Wide: 1024 to align, the Q, K and V tiles (64 rows of 128-byte
        swizzled boxes, one a 64 columns), P (64 rows of 64 + 8 bf16), the
        tile's row maxima and sums (64 f32 each) and three mbarriers."""
        row = (self.dp + 8) * 2
        if self.body == "cross":
            return (2 * self.nk + (3 if self.tiles >= 3 else 2) * 64) * row
        if self.body == "wide":
            return 1024 + 3 * -(-self.dp // 64) * 8192 + 64 * (K3_BKV + 8) * 2 + 2 * 64 * 4 + 64
        kv = K3_RING_STAGES if self.body == "ring" else 1
        return (self.bq + 2 * kv * K3_BKV) * row

    @property
    def resident(self) -> int:
        """Blocks an SM by shared memory (1 KB of it reserved a block) and
        threads; registers can only lower it (attention_occupancy reads
        the compiled kernel's on the card)."""
        return min(2048 // self.threads, 32, SMEM_SM // (self.smem + 1024))

    def workspace(self, b: int, sq: int, h: int, d: int) -> int:
        """f32 values of the wide body's split workspace: each split's
        unnormalized O (b h sq x d) and its row max and sum; 0 unsplit."""
        return self.splits * b * h * sq * (d + 2) if self.splits > 1 else 0


def _cross_plan(b: int, sq: int, h: int, d: int, dp: int, kv: int, sms: int) -> AttentionPlan:
    """The cross body's query tiles a block: enough to fill one wave of
    block slots (the fewest, up to CROSS_MAX_TILES, so each block's K and V
    serve as many tiles as that allows), a slot counted by shared memory
    and by the registers the launch bounds hold (CROSS_MINB).  From
    ``chip_smoke.py --k3-sweep`` on an H100 (PERF.md, Findings): the
    fastest tile count measured, or within the runs' spread of it, at
    every cross shape of the paths."""
    plan = AttentionPlan("cross", dp, 64, nk=80 if kv <= 80 else CROSS_MAX_KEYS)
    ntile = -(-sq // 64)
    slots = sms * min(plan.resident, CROSS_MINB[(dp, plan.nk)])
    return plan._replace(tiles=min(ntile, CROSS_MAX_TILES, -(-ntile * b * h // slots)))


def _wide_plan(b: int, sq: int, h: int, d: int, dp: int, kv: int, sms: int) -> AttentionPlan:
    """The wide body's key splits: the count (up to WIDE_MAX_SPLITS, one key
    tile a split at least, the workspace within WIDE_WS_BYTES) that
    minimizes waves of blocks x key tiles a block, a split counting its
    merge launch as ceil(1024 / dp) tiles more (two at d = 512, whose tiles
    take longest); ties to fewer splits."""
    plan = AttentionPlan("wide", dp, 64)
    qt, nt = -(-sq // 64), -(-kv // K3_BKV)
    slots = sms * plan.resident
    best = None
    for ns in range(1, min(nt, WIDE_MAX_SPLITS) + 1):
        cand = plan._replace(splits=ns)
        if ns > 1 and 4 * cand.workspace(b, sq, h, d) > WIDE_WS_BYTES:
            break
        cost = -(-qt * b * h * ns // slots) * -(-nt // ns) + (-(-1024 // dp) if ns > 1 else 0)
        if best is None or cost < best[0]:
            best = (cost, cand)
    return best[1]


@functools.lru_cache(maxsize=None)
def attention_plan(b: int, sq: int, sk: int, h: int, d: int, sms: int = 132,
                   kv_len: Optional[int] = None) -> AttentionPlan:
    """K3's body and tile for q (b, sq, h, d), k/v (b, sk, h, d) on a card of
    ``sms`` SMs, as csrc/attention.cu compiles them.

    A plain self-attention (sq == sk, no shorter ``kv_len``) at a padded
    head dim of 48, 64 or 80 (d = 40, 64, 80) takes the ring body.  Its
    tile, from ``chip_smoke.py --k3-sweep`` on an H100 (PERF.md, Findings):
    128 query rows at d = 40 and 80; at d = 64, 256 rows where that still
    gives two blocks for every SM (SD2.1's s = 9216), else 192 where that
    gives one (s = 2304), else 64 (s = 576, 144).  At a padded head dim of
    160 or 512 it takes the wide body (:func:`_wide_plan`'s key splits).
    Any other attention over at most 128 keys (the 77-token
    cross-attention; a kv_len that masks) at a padded head dim of 48, 64,
    80 or (up to 80 keys) 160 takes the cross body (:func:`_cross_plan`).  Every other shape
    (odd test widths, more than 128 keys that are not a self-attention)
    takes the general body."""
    dp = -(-d // 16) * 16
    kv = sk if kv_len is None else kv_len
    self_attention = sq == sk and kv == sk
    if self_attention and dp in (48, 64, 80):
        bq = 128
        if dp == 64:
            heads = b * h
            bq = (256 if -(-sq // 256) * heads >= 2 * sms else
                  192 if -(-sq // 192) * heads >= sms else 64)
        return AttentionPlan("ring", dp, bq)
    if self_attention and dp in K3_WIDE:
        return _wide_plan(b, sq, h, d, dp, kv, sms)
    if not self_attention and (dp, 80 if kv <= 80 else CROSS_MAX_KEYS) in K3_CROSS and kv <= CROSS_MAX_KEYS:
        return _cross_plan(b, sq, h, d, dp, kv, sms)
    return general_plan(d)


def general_plan(d: int) -> AttentionPlan:
    """The general body's plan at head dim ``d``: one pass up to a padded
    160, else 128-column passes over the head padded to a multiple of 128.
    The planner gives it only shapes no other body takes; ``_plan=`` runs it
    anywhere (the first design, measured beside the others)."""
    dp = -(-d // 16) * 16
    if dp <= 160:
        return AttentionPlan("general", dp, 64)
    dq = -(-dp // 128) * 128
    return AttentionPlan("general", dq, 64, passes=dq // 128)


class AttentionBwdPlan(NamedTuple):
    """K5's and K6's launch: ``body`` ("general" or "ring"), the head dim
    ``dp`` held in shared memory (padded to a multiple of 16), K5's
    ``q_rows`` owned query rows a block and ``k_tile`` keys a streamed
    tile, K6's ``k_rows`` owned key rows a block and ``q_tile`` queries a
    streamed tile (16 owned rows a warp), and the ring's ``stages``."""
    body: str
    dp: int
    q_rows: int = 64
    k_tile: int = 64
    k_rows: int = 64
    q_tile: int = 64
    stages: int = 1

    @property
    def k5(self):
        """K5's compiled variant: (dp, owned rows, tile rows)."""
        return self.dp, self.q_rows, self.k_tile

    @property
    def k6(self):
        """K6's compiled variant: (dp, owned rows, tile rows)."""
        return self.dp, self.k_rows, self.q_tile

    @property
    def smem(self):
        """(K5, K6) dynamic shared bytes a block (csrc/attention_bwd*.cu):
        rows of dp + 8 bf16.  General: the two owned and two streamed
        64-row tiles and 64 lse and delta values.  Ring: ``stages``
        buffers of two streamed tiles (K6's with the tile's lse and delta),
        the last of which first stages the two owned tiles (Q, dO; K, V)
        and is as large as they are where they are larger."""
        row = (self.dp + 8) * 2
        if self.body == "general":
            return (4 * 64 * row + 2 * 64 * 4,) * 2
        out = []
        for rows, stage in ((self.q_rows, 2 * self.k_tile * row),
                            (self.k_rows, 2 * self.q_tile * (row + 4))):
            out.append((self.stages - 1) * stage + max(stage, 2 * rows * row))
        return tuple(out)

    @property
    def resident(self):
        """(K5, K6) blocks an SM by shared memory (1 KB of it reserved a
        block) and threads; registers can only lower it
        (attention_bwd_occupancy reads the compiled kernels' on the card)."""
        return tuple(min(2048 // (2 * rows), 32, SMEM_SM // (smem + 1024))
                     for rows, smem in zip((self.q_rows, self.k_rows), self.smem))


@functools.lru_cache(maxsize=None)
def attention_bwd_plan(b: int, s: int, h: int, d: int, sms: int = 132) -> AttentionBwdPlan:
    """K5's and K6's body and tiles for q, k, v (b, s, h, d) on a card of
    ``sms`` SMs, as csrc/attention_bwd.cu compiles them.

    A padded head dim of 48, 64 or 80 (d = 40, 64, 80) with s % 4 == 0 (so
    that K6's lse and delta tiles are 16-byte copies) takes the ring
    bodies with 64-row streamed tiles and, from ``chip_smoke.py
    --k56-sweep`` on an H100 (PERF.md, Findings), 128 owned rows a block
    (K6 at d = 64: 64).  Every other shape (d = 160, test shapes) takes
    the general bodies.  ``b``, ``h`` and ``sms`` do not enter the choice
    yet; they are the grid's, as in :func:`attention_plan`."""
    dp = -(-d // 16) * 16
    if dp in (48, 64, 80) and s % 4 == 0:
        return AttentionBwdPlan("ring", dp, q_rows=128, k_tile=64,
                                k_rows=64 if dp == 64 else 128, q_tile=64,
                                stages=BWD_RING_STAGES)
    return AttentionBwdPlan("general", dp)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def attention_plain(q, k, v, *, scale: Optional[float] = None, kv_len: Optional[int] = None,
                    causal: bool = False):
    """Einsum attention with an f32 softmax (ops/attention.py ``_xla_sdpa``):
    f32 logits, probabilities cast to v's dtype for the PV product.  Keys at
    or past ``kv_len`` are masked out."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", at_least_f32(q), at_least_f32(k)) * scale
    sq, sk = q.shape[1], k.shape[1]
    if causal or kv_len is not None:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qi + (sk - sq) >= ki
        if kv_len is not None:
            mask &= ki < kv_len
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def attention_bwd_dq_plain(q, k, v, o, do, scale: Optional[float] = None):
    """What K5 computes (``_bwd_dq_kernel``), in f32: returns dq (q's dtype),
    the row log-sum-exp and delta = rowsum(dO * O), both (B, H, S)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qf, kf, vf, dof = (at_least_f32(t) for t in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    lse = torch.logsumexp(s, dim=-1)
    delta = (dof * at_least_f32(o)).sum(-1).transpose(1, 2)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = torch.exp(s - lse[..., None]) * (dp - delta[..., None]) * scale
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype), lse, delta


def attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale: Optional[float] = None):
    """What K6 computes (``_bwd_dkv_kernel``), in f32: dk, dv (k's dtype)
    from the row log-sum-exp and delta of :func:`attention_bwd_dq_plain`."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qf, kf, vf, dof = (at_least_f32(t) for t in (q, k, v, do))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_plain(q, k, v, o, do, scale: Optional[float] = None):
    """dq, dk, dv of ``softmax(q k^T scale) v`` against do: the explicit f32
    formula of the two TPU backward kernels (K5 then K6)."""
    dq, lse, delta = attention_bwd_dq_plain(q, k, v, o, do, scale)
    dk, dv = attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _strides_ok(t: torch.Tensor, d: int) -> bool:
    s = t.stride()
    return s[3] == 1 and s[2] == d and s[0] % 8 == 0 and s[1] % 8 == 0 and t.data_ptr() % 16 == 0


def attention_kernel(q, k, v, *, scale: Optional[float] = None, kv_len: Optional[int] = None,
                     return_lse: bool = False, _plan: Optional[AttentionPlan] = None):
    """Launch K3.  q (B, Sq, H, D), k/v (B, Sk, H, D), bf16 on CUDA.  With
    ``return_lse`` also the f32 (B, H, Sq) row log-sum-exp in the log2
    domain (log2 sum_k 2^(s_k scale log2 e)), which K5/K6 take.  ``_plan``
    replaces :func:`attention_plan`'s choice (for measuring one body beside
    another; not a switch of the model's path).  Its checks build no
    message when they pass: every K3 call pays them on the host."""
    with K3.span():
        require_no_grad("K3", q, k, v)
        if not q.is_cuda:
            raise ValueError(f"K3 needs a CUDA tensor, got {q.device}")
        require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, "K3 takes (B, S, H, D) tensors")
        b, sq, h, d = q.shape
        sk = k.shape[1]
        if k.shape != (b, sk, h, d) or v.shape != k.shape:
            raise ValueError(f"K3: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
        require(q.dtype == k.dtype == v.dtype == torch.bfloat16, "K3 takes bf16 q, k, v")
        if d % 8 or d > 512:
            raise ValueError(f"K3 takes head dims that are multiples of 8 up to 512, got {d}")
        require(_strides_ok(q, d) and _strides_ok(k, d) and _strides_ok(v, d),
                "K3 needs packed (H, D) axes, strides that are multiples of 8 and 16-byte alignment")
        kv_len = sk if kv_len is None else int(kv_len)
        if not 0 < kv_len <= sk:
            raise ValueError(f"K3: kv_len={kv_len} for Sk={sk}")
        scale = d ** -0.5 if scale is None else float(scale)
        plan = _plan or attention_plan(b, sq, sk, h, d, _cuda.sm_count(q.device.index or 0), kv_len)
        o = torch.empty((b, sq, h, d), device=q.device, dtype=q.dtype)
        lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32) if return_lse else None
        n_ws = plan.workspace(b, sq, h, d)
        ws = torch.empty(n_ws, device=q.device, dtype=torch.float32) if n_ws else None
        code = _cuda.library().sdtk_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            b, h, sq, sk, d, kv_len, scale, K3_BODIES[plan.body], plan.bq, plan.nk, plan.tiles,
            plan.splits, None if ws is None else ws.data_ptr(), _cuda.stream_handle(q))
        if code:
            _cuda.check(code, f"K3 attention ({plan.body} body)")
        K3.launched((b, sq, sk, h, d))
        K3_BY_BODY[plan.body].launched((b, sq, sk, h, d))
        return (o, lse) if return_lse else o


def _bwd_checks(name, q, k, v, lse, *rest):
    require(q.is_cuda, f"{name} needs a CUDA tensor, got {q.device}")
    b, s, h, d = q.shape
    require(all(t.shape == q.shape for t in (k, v, *rest)),
            f"{name}: q, k, v, do must all be (B, S, H, D), got q {tuple(q.shape)}")
    require(all(t.dtype == torch.bfloat16 for t in (q, k, v, *rest)), f"{name} takes bf16 tensors")
    require(d % 8 == 0 and d <= BWD_MAX_D,
            f"{name} takes head dims that are multiples of 8 up to {BWD_MAX_D}, got {d}")
    require(all(_strides_ok(t, d) for t in (q, k, v, *rest)),
            f"{name} needs packed (H, D) axes, strides that are multiples of 8 and 16-byte alignment")
    require(lse.shape == (b, h, s) and lse.dtype == torch.float32 and lse.is_contiguous(),
            f"{name}: lse must be contiguous f32 (B, H, S)")
    return b, s, h, d


def _packed(t: torch.Tensor) -> torch.Tensor:
    return t if _strides_ok(t, t.shape[-1]) else t.contiguous()


def _bwd_plan(q, b, s, h, d, plan: Optional[AttentionBwdPlan]) -> AttentionBwdPlan:
    return plan or attention_bwd_plan(b, s, h, d, _cuda.sm_count(q.device.index or 0))


def attention_bwd_dq_kernel(q, k, v, o, lse, do, *, scale: Optional[float] = None,
                            _plan: Optional[AttentionBwdPlan] = None):
    """Launch K5: dq (B, S, H, D) bf16 and delta (B, H, S) f32.  ``_plan``
    replaces :func:`attention_bwd_plan`'s choice (for measuring one body
    beside another; not a switch of the model's path)."""
    with K5.span():
        require_no_grad("K5", q, k, v, o, do)
        do = _packed(do)
        b, s, h, d = _bwd_checks("K5", q, k, v, lse, o, do)
        scale = d ** -0.5 if scale is None else float(scale)
        plan = _bwd_plan(q, b, s, h, d, _plan)
        delta = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
        dq = torch.empty((b, s, h, d), device=q.device, dtype=q.dtype)
        code = _cuda.library().sdtk_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), o.stride(0), o.stride(1), do.stride(0), do.stride(1),
            b, h, s, d, scale, BWD_BODIES[plan.body], plan.q_rows, plan.k_tile,
            _cuda.stream_handle(q))
        _cuda.check(code, "K5 attention backward (dq)")
        K5.launched((b, s, h, d))
        return dq, delta


def attention_bwd_dkv_kernel(q, k, v, lse, delta, do, *, scale: Optional[float] = None,
                             _plan: Optional[AttentionBwdPlan] = None):
    """Launch K6: dk, dv (B, S, H, D) bf16 from K5's delta.  ``_plan`` as
    in :func:`attention_bwd_dq_kernel`."""
    with K6.span():
        require_no_grad("K6", q, k, v, do)
        do = _packed(do)
        b, s, h, d = _bwd_checks("K6", q, k, v, lse, do)
        require(delta.shape == lse.shape and delta.dtype == torch.float32 and delta.is_contiguous(),
                "K6: delta must be contiguous f32 (B, H, S)")
        scale = d ** -0.5 if scale is None else float(scale)
        plan = _bwd_plan(q, b, s, h, d, _plan)
        dk = torch.empty((b, s, h, d), device=q.device, dtype=q.dtype)
        dv = torch.empty_like(dk)
        code = _cuda.library().sdtk_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), do.stride(0), do.stride(1), b, h, s, d, scale,
            BWD_BODIES[plan.body], plan.k_rows, plan.q_tile, _cuda.stream_handle(q))
        _cuda.check(code, "K6 attention backward (dk, dv)")
        K6.launched((b, s, h, d))
        return dk, dv


def attention_bwd_kernel(q, k, v, o, lse, do, *, scale: Optional[float] = None,
                         _plan: Optional[AttentionBwdPlan] = None):
    """K5 then K6: dq, dk, dv of the self-attention whose forward K3 ran
    (``lse`` from ``attention_kernel(..., return_lse=True)``)."""
    do = _packed(do)
    dq, delta = attention_bwd_dq_kernel(q, k, v, o, lse, do, scale=scale, _plan=_plan)
    dk, dv = attention_bwd_dkv_kernel(q, k, v, lse, delta, do, scale=scale, _plan=_plan)
    return dq, dk, dv


def k3_variants():
    """A plan for each compiled K3 variant the paths reach, and the general
    body at the padded head dims it used to take there: the ring body's
    variants, the cross body's (three Q buffers), the wide body's, and the general body at
    48, 80, 160 and 512 (128-column passes)."""
    out = [AttentionPlan("ring", dp, bq) for dp, bq in K3_RING]
    for dp, nk in K3_CROSS:  # with three Q buffers (a block of three tiles or more)
        out.append(AttentionPlan("cross", dp, 64, nk=nk, tiles=3))
    out += [AttentionPlan("wide", dp, 64) for dp in K3_WIDE]
    out += [AttentionPlan("general", dp, 64) for dp in (48, 80, 160)]
    out.append(AttentionPlan("general", 512, 64, passes=4))
    return out


def attention_occupancy() -> dict:
    """Each plan of :func:`k3_variants` on the current card: ``{plan:
    {...}}`` with registers a thread, spill (local) bytes a thread, shared
    bytes a block and resident blocks an SM, from the runtime."""
    keys = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm")
    out = {}
    for plan in k3_variants():
        got = (ctypes.c_int * 4)()
        _cuda.check(_cuda.library().sdtk_attention_attrs(K3_BODIES[plan.body], plan.dp, plan.bq, plan.nk,
                                                         plan.tiles, got), "K3 attributes")
        out[plan] = dict(zip(keys, got))
    return out


def attention_bwd_occupancy(plan: AttentionBwdPlan) -> dict:
    """The compiled K5 and K6 of ``plan`` on the current card: ``{"K5":
    {...}, "K6": {...}}``, each with its registers a thread, spill (local)
    bytes a thread, shared bytes a block and resident blocks an SM."""
    keys = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm")
    out = {}
    for kernel, (dp, rows, tile) in (("K5", plan.k5), ("K6", plan.k6)):
        got = (ctypes.c_int * 4)()
        _cuda.check(_cuda.library().sdtk_attention_bwd_attrs(
            int(kernel[1]), BWD_BODIES[plan.body], dp, rows, tile, got), f"{kernel} attributes")
        out[kernel] = dict(zip(keys, got))
    return out


def attention_bwd_variants(dp: int):
    """Every compiled K5/K6 body at padded head dim ``dp``: the general
    body's plan and, where the ring is compiled (48, 64, 80), its plan."""
    ring = attention_bwd_plan(1, 64, 1, dp)
    return [AttentionBwdPlan("general", dp)] + ([ring] if ring.body == "ring" else [])


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class AttentionOps(NamedTuple):
    forward: Callable   # (q, k, v, scale) -> (o, row statistics for ``backward``)
    backward: Callable  # (q, k, v, o, stats, do, scale) -> (dq, dk, dv)


KERNEL_OPS = AttentionOps(
    lambda q, k, v, scale: attention_kernel(q, k, v, scale=scale, return_lse=True),
    lambda q, k, v, o, lse, do, scale: attention_bwd_kernel(q, k, v, o, lse, do, scale=scale))
PLAIN_OPS = AttentionOps(
    lambda q, k, v, scale: (attention_plain(q, k, v, scale=scale), None),
    lambda q, k, v, o, _, do, scale: attention_bwd_plain(q, k, v, o, do, scale))


class SelfAttentionFn(torch.autograd.Function):
    """Attention whose backward is the two-pass flash backward (JAX
    ``_self_premerged_fwd`` / ``_self_premerged_bwd``): the forward saves q,
    k, v, o and the row statistics."""

    @staticmethod
    def forward(ctx, ops: AttentionOps, q, k, v, scale):
        o, stats = ops.forward(q, k, v, scale)
        ctx.ops, ctx.scale = ops, scale
        ctx.save_for_backward(q, k, v, o, stats)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, stats = ctx.saved_tensors
        grads = ctx.ops.backward(q, k, v, o, stats, do, ctx.scale)
        return (None, *(g if n else None for g, n in zip(grads, ctx.needs_input_grad[1:4])), None)


def attention(q, k, v, *, scale: Optional[float] = None, kv_len: Optional[int] = None,
              impl: str = "auto"):
    """Non-causal attention: K3 on the card (K5 + K6 for its gradient), the
    plain version on the CPU."""
    if not use_kernel(impl, q):
        return attention_plain(q, k, v, scale=scale, kv_len=kv_len)
    if not wants_grad(q, k, v):
        return attention_kernel(q, k, v, scale=scale, kv_len=kv_len)
    d = q.shape[-1]
    if q.shape[1] == k.shape[1] and kv_len is None and d % 8 == 0 and d <= BWD_MAX_D:
        return SelfAttentionFn.apply(KERNEL_OPS, q, k, v, d ** -0.5 if scale is None else scale)
    fwd = functools.partial(attention_kernel, scale=scale, kv_len=kv_len)
    plain = functools.partial(attention_plain, scale=scale, kv_len=kv_len)
    return Recompute.apply(fwd, plain, q, k, v)
