"""K5's and K6's tiling on the CPU: the planner
(``ops/flash_attention.attention_bwd_plan``) at every K5/K6 shape of the
train step, and a plain-torch emulation of each ring body's schedule
(csrc/attention_bwd_ring.cuh) held against the plain backward.

The emulation follows the kernels.  For each (batch, head) and each block
of owned rows (16 a warp), the owned operands are read once through their
own batch and sequence strides into tiles zero-filled past S and past
column D (d = 40 pads to 48): Q and dO in K5, K and V in K6.  K5 computes
delta = rowsum(dO O) for its rows from those tiles.  The streamed tiles go
through a ring of ``stages`` buffers in the kernels' order (the owned tiles
staged in the last buffer, which the prologue leaves empty; tiles 0 and 1
first; at tile j, after its barrier, tile j + 2 into the buffer tile j - 1
used), zero-filled past S, K6's with the tile's lse and delta.  Each tile
is walked 16 streamed rows at a time: P = 2^(s scale log2 e - lse) from
the log2-domain lse that K3 writes, masked to 0 past S, dS = P (dP -
delta), then K5's dQ += dS K, K6's dV += P^T dO and dK += dS^T Q; the scale
multiplies dQ and dK at the store.  It runs in f32, so it must equal
``attention_bwd_plain`` up to summation order: max|emulated - plain| <=
1e-5 * max|plain| for dq, dk, dv and delta.  It is a test helper, not used
on the main path.

``mask=False`` drops both guards of the ragged tail, the zero fill of the
rows past S (they are then read through the strides, as a copy without the
guard would read them) and the mask of P: far outside the tolerance, so
the comparison can see a masking bug.  (With the zero fill kept, the rows
past S add nothing to any product, so the kernels' P mask is a second
guard.)
"""

import math

import numpy as np
import pytest
import torch

from stable_diffusion_tpu_torch.ops import flash_attention as fa

SMS = 132  # an H100 SXM's SMs
LOG2E = 1.4426950408889634

# (b, s, h, d) of every K5/K6 call of the SD1.5 b4 train step: the UNet's
# self-attention at each level (64^2 latents / 2**level, 8 heads of d =
# 320/640/1280 / 8) and the mid block's.
TRAIN_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80), (4, 256, 8, 160), (4, 64, 8, 160)]


@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_plan_at_every_train_shape(shape):
    b, s, h, d = shape
    plan = fa.attention_bwd_plan(b, s, h, d, SMS)
    assert plan.dp == -(-d // 16) * 16, plan
    if d in (40, 80):
        assert plan.body == "ring" and plan.stages == fa.BWD_RING_STAGES, plan
        assert plan.k5 in fa.K5_RING and plan.k6 in fa.K6_RING, plan
    else:
        assert plan == fa.AttentionBwdPlan("general", 160), plan
    for smem, resident in zip(plan.smem, plan.resident):
        assert smem <= fa.SMEM_BLOCK and resident >= 1, plan


@pytest.mark.parametrize("shape,plan", [
    ((4, 4096, 8, 40), fa.AttentionBwdPlan("ring", 48, 128, 64, 128, 64, 3)),
    ((4, 1024, 8, 80), fa.AttentionBwdPlan("ring", 80, 128, 64, 128, 64, 3)),
    ((2, 9216, 5, 64), fa.AttentionBwdPlan("ring", 64, 128, 64, 64, 64, 3)),
    ((1, 100, 3, 40), fa.AttentionBwdPlan("ring", 48, 128, 64, 128, 64, 3)),
    ((1, 100, 3, 24), fa.AttentionBwdPlan("general", 32)),
    ((2, 192, 2, 128), fa.AttentionBwdPlan("general", 128)),
    ((2, 130, 2, 40), fa.AttentionBwdPlan("general", 48)),
])
def test_plan_tiles(shape, plan):
    """The ring at d = 40, 64, 80 with s % 4 == 0: 128 owned rows a block
    (K6 at d = 64: 64); the general body elsewhere, s = 130 included (K6's
    lse and delta tiles would not be 16-byte aligned)."""
    assert fa.attention_bwd_plan(*shape, SMS) == plan


def test_plan_smem():
    """The shared bytes csrc/attention_bwd_ring.cuh asks for: three buffers
    of two streamed tiles (K6's with 4-byte lse and delta a row), the last
    at least as large as the two owned tiles it stages; rows of dp + 8
    bf16."""
    ring = fa.AttentionBwdPlan("ring", 48, 128, 64, 128, 64, 3)
    assert ring.smem == (2 * 2 * 64 * 56 * 2 + 2 * 128 * 56 * 2,
                         2 * 2 * 64 * (56 * 2 + 4) + 2 * 128 * 56 * 2)
    ring = fa.AttentionBwdPlan("ring", 80, 64, 64, 64, 64, 3)
    assert ring.smem == (3 * 2 * 64 * 88 * 2, 3 * 2 * 64 * (88 * 2 + 4))
    assert fa.AttentionBwdPlan("general", 160).smem == (4 * 64 * 168 * 2 + 512,) * 2


def test_every_variant_is_a_plan():
    """attention_bwd_variants lists the general body and, at 48, 64 and 80,
    the ring plan, whose variants are the compiled ones: one of each
    kernel at each padded head dim."""
    for dp in (48, 64, 80):
        general, ring = fa.attention_bwd_variants(dp)
        assert general == fa.AttentionBwdPlan("general", dp) and ring.body == "ring"
        assert [v for v in fa.K5_RING if v[0] == dp] == [ring.k5]
        assert [v for v in fa.K6_RING if v[0] == dp] == [ring.k6]
        assert all(smem <= fa.SMEM_BLOCK for p in (general, ring) for smem in p.smem)
    assert fa.attention_bwd_variants(160) == [fa.AttentionBwdPlan("general", 160)]


# ---------------------------------------------------------------------------
# The emulation of the ring bodies' schedules
# ---------------------------------------------------------------------------


def _flat(t):
    return torch.as_strided(t, (t.untyped_storage().nbytes() // t.element_size(),), (1,), 0)


def _rows(t, b, h, r0, n, dp, mask=True):
    """Rows [r0, r0 + n) of head h of batch b of t (B, S, H, D), read through
    t's batch and sequence strides from its storage as the kernels' cp.async
    does, zero past column D and (``mask``) past S: (n, dp) f32."""
    s, d = t.shape[1], t.shape[3]
    flat = _flat(t)
    r = torch.arange(r0, r0 + n)[:, None]
    c = torch.arange(dp)[None, :]
    ok = (c < d) & ((r < s) if mask else True)
    off = (t.storage_offset() + b * t.stride(0) + r * t.stride(1) + h * t.stride(2)
           + c.clamp(max=d - 1) * t.stride(3))
    return torch.where(ok, flat[off.clamp(max=flat.numel() - 1)], 0.0).float()


def _stat(x, b, h, r0, n, mask=True):
    """Entries [r0, r0 + n) of row (b, h) of a contiguous (B, H, S) f32
    statistic, zero past S (``mask``) or read on through its storage."""
    s = x.shape[2]
    i = torch.arange(r0, r0 + n)
    flat = x.reshape(-1)
    got = flat[((b * x.shape[1] + h) * s + i).clamp(max=flat.numel() - 1)]
    return torch.where(i < s, got, 0.0) if mask else got


class _Ring:
    """The ring of ``stages`` buffers: the owned tiles staged in the last
    one, tile j in buffer j % stages, never over a tile still to be used."""

    def __init__(self, stages, ntiles, load):
        self.stages, self.ntiles, self.load = stages, ntiles, load
        self.buf = [None] * stages
        self.buf[stages - 1] = ("owned",)

    def prologue(self):
        for j in range(min(self.stages - 1, self.ntiles)):
            self.put(j)

    def put(self, j):
        old = self.buf[j % self.stages]
        assert old is None or old[0] == "owned" or old[0] <= j - self.stages, (old, j)
        self.buf[j % self.stages] = (j, *self.load(j))

    def take(self, j):
        """Tile j, after its barrier: first the load of tile j + stages - 1
        into the buffer tile j - 1 used (the owned tiles' at j = 0)."""
        if j + self.stages - 1 < self.ntiles:
            self.put(j + self.stages - 1)
        tag, *tiles = self.buf[j % self.stages]
        assert tag == j, (tag, j)
        return tiles


def emulate_k5_ring(q, k, v, o, do, lse, plan, scale=None, mask=True):
    """K5's ring body in plain f32 torch (see the module docstring): dq
    (B, S, H, D) and delta (B, H, S).  lse: (B, H, S), log2 domain."""
    b_, s, h_, d = q.shape
    rows, tile, dp = plan.q_rows, plan.k_tile, plan.dp
    assert plan.body == "ring" and tile % 16 == 0
    scale = d ** -0.5 if scale is None else scale
    sl = scale * LOG2E
    ntiles = -(-s // tile)
    dq, delta = torch.zeros(b_, s, h_, d), torch.zeros(b_, h_, s)
    for b in range(b_):
        for h in range(h_):
            for q0 in range(0, s, rows):
                qt, dot = _rows(q, b, h, q0, rows, dp, mask), _rows(do, b, h, q0, rows, dp, mask)
                dl = (_rows(o, b, h, q0, rows, dp, mask) * dot).sum(dim=1)
                l = _stat(lse, b, h, q0, rows, mask)
                ring = _Ring(plan.stages, ntiles, lambda j: (
                    _rows(k, b, h, j * tile, tile, dp, mask), _rows(v, b, h, j * tile, tile, dp, mask)))
                ring.prologue()
                acc = torch.zeros(rows, dp)
                for j in range(ntiles):
                    kt, vt = ring.take(j)
                    valid = min(tile, s - j * tile)
                    for c in range(0, tile, 16):          # 16 keys at a time
                        kc, vc = kt[c:c + 16], vt[c:c + 16]
                        p = torch.exp2(qt @ kc.T * sl - l[:, None])
                        if mask:
                            p[:, max(0, valid - c):] = 0.0
                        acc += p * (dot @ vc.T - dl[:, None]) @ kc
                n = min(rows, s - q0)
                dq[b, q0:q0 + n, h] = (acc[:n] * scale)[:, :d]
                delta[b, h, q0:q0 + n] = dl[:n]
    return dq, delta


def emulate_k6_ring(q, k, v, do, lse, delta, plan, scale=None, mask=True):
    """K6's ring body in plain f32 torch (see the module docstring): dk, dv
    (B, S, H, D) from K5's delta."""
    b_, s, h_, d = q.shape
    rows, tile, dp = plan.k_rows, plan.q_tile, plan.dp
    assert plan.body == "ring" and tile % 16 == 0 and s % 4 == 0
    scale = d ** -0.5 if scale is None else scale
    sl = scale * LOG2E
    ntiles = -(-s // tile)
    dk, dv = torch.zeros(b_, s, h_, d), torch.zeros(b_, s, h_, d)
    for b in range(b_):
        for h in range(h_):
            for k0 in range(0, s, rows):
                kt, vt = _rows(k, b, h, k0, rows, dp, mask), _rows(v, b, h, k0, rows, dp, mask)
                ring = _Ring(plan.stages, ntiles, lambda j: (
                    _rows(q, b, h, j * tile, tile, dp, mask), _rows(do, b, h, j * tile, tile, dp, mask),
                    _stat(lse, b, h, j * tile, tile, mask), _stat(delta, b, h, j * tile, tile, mask)))
                ring.prologue()
                gk, gv = torch.zeros(rows, dp), torch.zeros(rows, dp)
                for j in range(ntiles):
                    qt, dot, lt, dlt = ring.take(j)
                    valid = min(tile, s - j * tile)
                    for c in range(0, tile, 16):          # 16 queries at a time
                        qc, dc = qt[c:c + 16], dot[c:c + 16]
                        pt = torch.exp2(kt @ qc.T * sl - lt[None, c:c + 16])     # P^T
                        if mask:
                            pt[:, max(0, valid - c):] = 0.0
                        gv += pt @ dc
                        gk += pt * (vt @ dc.T - dlt[None, c:c + 16]) @ qc
                n = min(rows, s - k0)
                dk[b, k0:k0 + n, h] = (gk[:n] * scale)[:, :d]
                dv[b, k0:k0 + n, h] = gv[:n, :d]
    return dk, dv


def _inputs(b, s, h, d, fused, seed=0):
    """q, k, v, do (B, S, H, D) f32 and K3's o and log2-domain lse;
    ``fused``: q, k, v views of one (B, S, 3 H D) projection, as the UNet
    hands them to K3 and K5/K6."""
    rng = np.random.default_rng(seed)
    if fused:
        qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d), dtype=np.float32))
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32))
                   for _ in range(3))
    do = torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32))
    return q, k, v, do


def _forward(q, k, v, scale=None):
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    o = fa.attention_plain(q, k, v, scale=scale).contiguous()  # as K3 writes it
    lse = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, dim=-1) * LOG2E
    return o, lse


def _close(got, want, tol=1e-5):
    assert got.shape == want.shape
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= tol, err


def _check_ring(q, k, v, do, plan, scale=None):
    o, lse = _forward(q, k, v, scale)
    dq, delta = emulate_k5_ring(q, k, v, o, do, lse, plan, scale)
    dk, dv = emulate_k6_ring(q, k, v, do, lse, delta, plan, scale)
    want_dq, want_lse, want_delta = fa.attention_bwd_dq_plain(q, k, v, o, do, scale)
    want_dk, want_dv = fa.attention_bwd_dkv_plain(q, k, v, do, want_lse, want_delta, scale)
    for got, want in ((dq, want_dq), (delta, want_delta), (dk, want_dk), (dv, want_dv)):
        _close(got, want)


@pytest.mark.parametrize("shape", [(1, 100, 3, 40), (2, 132, 2, 64), (1, 200, 2, 80),
                                   (1, 64, 1, 40)])
@pytest.mark.parametrize("fused", [True, False])
def test_emulated_rings_match_plain(shape, fused):
    """The planner's plan at ragged lengths (100, 132, 200: no multiple of
    the 64-row tile or block), one exact tile (64), d = 40 (zero-padded to
    48), 64 and 80; q/k/v contiguous or strided as the fused QKV's split."""
    b, s, h, d = shape
    q, k, v, do = _inputs(b, s, h, d, fused)
    if fused:
        assert q.stride(1) == 3 * h * d and not q.is_contiguous()
    plan = fa.attention_bwd_plan(b, s, h, d, SMS)
    assert plan.body == "ring", plan
    _check_ring(q, k, v, do, plan)


@pytest.mark.parametrize("d", [40, 64, 80])
@pytest.mark.parametrize("rows", [64, 128])
def test_emulated_ring_over_blocks(d, rows):
    """Several blocks of owned rows (64 or 128) and a ragged tail (300 rows:
    the ring wraps at least once), fused QKV, a scale that is not d^-0.5;
    the schedule does not depend on the compiled variants."""
    plan = fa.AttentionBwdPlan("ring", -(-d // 16) * 16, rows, 64, rows, 64, fa.BWD_RING_STAGES)
    q, k, v, do = _inputs(1, 300, 2, d, fused=True, seed=1)
    _check_ring(q, k, v, do, plan, scale=0.2)


def test_emulation_sees_a_dropped_mask():
    """The comparison is sharp: with the ragged tail's guards dropped (rows
    past S read through the strides, P unmasked), every gradient is far
    outside the tolerance."""
    q, k, v, do = _inputs(2, 100, 1, 40, fused=True)
    plan = fa.attention_bwd_plan(2, 100, 1, 40, SMS)
    o, lse = _forward(q, k, v)
    want_dq, want_lse, want_delta = fa.attention_bwd_dq_plain(q, k, v, o, do)
    want_dk, want_dv = fa.attention_bwd_dkv_plain(q, k, v, do, want_lse, want_delta)
    dq, delta = emulate_k5_ring(q, k, v, o, do, lse, plan)
    _close(dq, want_dq)
    _close(emulate_k6_ring(q, k, v, do, lse, delta, plan)[0], want_dk)
    bad_dq, _ = emulate_k5_ring(q, k, v, o, do, lse, plan, mask=False)
    bad_dk, bad_dv = emulate_k6_ring(q, k, v, do, lse, delta, plan, mask=False)
    for got, want in ((bad_dq, want_dq), (bad_dk, want_dk), (bad_dv, want_dv)):
        assert ((got - want).abs().max() / want.abs().max()).item() > 1e-3

