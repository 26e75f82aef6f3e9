"""K3's tiling on the CPU: the planner (``ops/flash_attention.attention_plan``)
at every K3 shape of the port's paths, and plain-torch emulations of
the ring, cross and wide bodies' schedules (csrc/attention.cu) held against
the plain attention.

The ring emulation follows the kernel: for each (batch, head) and each
block of ``bq`` query rows (16 a warp), Q is read once through q's own
batch and sequence strides into a tile zero-filled past Sq and past column
D (d = 40 pads to 48); K/V tiles of 64 keys go through a ring of three
buffers in the kernel's order (tiles 0 and 1 first; at tile j, after its
barrier, tile j + 2 into the buffer tile j - 1 used), zero-filled past Sk;
each tile's logits are masked past Sk, the running max is kept in the log2
domain of the scaled logits (p = 2^(s scale log2 e - m)), the output and
the row sum are rescaled by 2^(m_old - m_new), and the row log-sum-exp is m
+ log2 l.

The cross emulation: a block's K and V read once, zero-filled to nk keys
past kv_len; each 64-row query tile of its run, each warp's 16 rows one
exact softmax over all nk keys with the keys at or past kv_len masked; O =
P V / l.

The wide emulation: per block of 64 query rows and key split, each 64-key
tile's logits computed once, by warpgroup 0 (16 rows x 64 keys a warp; a
count of every logit and exponential is kept), each warp's row maxima, P =
2^(s sl - m) for its block, then each warp's RT x CT block of O rescaled
by 2^(m_old - m) and given P V; one split normalizes, more write
(unnormalized O, m, l) and are merged in split order.

They run in f32, so they must equal ``attention_plain`` up to summation
order: max|emulated - plain| <= 1e-5 * max|plain|, and the log-sum-exp
logsumexp(s scale) log2 e within 1e-5 relative.  They are test helpers,
not used on the main path.
"""

import math

import numpy as np
import pytest
import torch

from stable_diffusion_tpu_torch.ops import flash_attention as fa
try:
    from tests.torch_threads import one_thread  # noqa: F401
except ModuleNotFoundError:  # loaded by file on the card, where another ``tests`` package
    pass                     # shadows this one: tests/test_torch_gpu.py reads its shapes

SMS = 132  # an H100 SXM's SMs
LOG2E = 1.4426950408889634

# (b, sq, sk, h, d) of every K3 call on the five paths: the UNet's self- and
# 77-token cross-attention at each attention level (latent side / 2**level,
# heads x d = the level's width), the mid block's, and the VAE's single
# d = 512 head at the latent side.
SD15_LEVELS = [(0, 8, 40), (1, 8, 80), (2, 8, 160)]           # 320/640/1280 channels, 8 heads
SD21_LEVELS = [(0, 5, 64), (1, 10, 64), (2, 20, 64)]          # d = 64 throughout


def _unet(b, side, levels, mid):
    out = []
    for lv, h, d in [*levels, (3, *mid)]:
        s = (side >> lv) ** 2
        out += [(b, s, s, h, d), (b, s, 77, h, d)]
    return out


def _vae(b, side):
    return [(b, side * side, side * side, 1, 512)]


PATHS = {
    "serve_sd15": _unet(2, 64, SD15_LEVELS, (8, 160)) + _vae(1, 64),   # CFG batch 2, VAE b1
    "w8a8": _unet(8, 64, SD15_LEVELS, (8, 160)) + _vae(4, 64),         # b4 requests
    "train": _unet(4, 64, SD15_LEVELS, (8, 160)),                      # b4 train step
    "sd21": _unet(2, 96, SD21_LEVELS, (20, 64)) + _vae(1, 96),         # 96^2 latents
    # img2img b4: the encoder's mid block at b1, the CFG UNet at batch 8, the decoder at b4
    "img2img_b4": _vae(1, 64) + _unet(8, 64, SD15_LEVELS, (8, 160)) + _vae(4, 64),
    # the CLI's default (no CFG) and one-step at b1: UNet batch 1; one-step b4
    "cli_b1": _unet(1, 64, SD15_LEVELS, (8, 160)) + _vae(1, 64),
    "one_step_b4": _unet(4, 64, SD15_LEVELS, (8, 160)) + _vae(4, 64),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_plan_at_every_path_shape(path):
    for shape in PATHS[path]:
        b, sq, sk, h, d = shape
        plan = fa.attention_plan(b, sq, sk, h, d, SMS)
        # the ring body at every self-attention with d = 40, 64, 80, the wide
        # body at d = 160 and 512, the cross body at every 77-token
        # cross-attention: never the general body
        body = ("cross" if sq != sk else "ring" if d in (40, 64, 80) else "wide")
        assert plan.body == body, (shape, plan)
        assert plan.dp == -(-d // 16) * 16 and plan.passes == 1, (shape, plan)
        if body == "ring":
            assert (plan.dp, plan.bq) in fa.K3_RING, (shape, plan)
        elif body == "cross":
            assert (plan.dp, plan.nk) in fa.K3_CROSS and plan.nk >= sk, (shape, plan)
            assert 1 <= plan.tiles <= min(-(-sq // 64), fa.CROSS_MAX_TILES), (shape, plan)
        else:
            assert plan.dp in fa.K3_WIDE and plan.bq == 64, (shape, plan)
            assert 1 <= plan.splits <= min(-(-sk // 64), fa.WIDE_MAX_SPLITS), (shape, plan)
            assert 4 * plan.workspace(b, sq, h, d) <= fa.WIDE_WS_BYTES, (shape, plan)
        # the grid covers every query row once, and the block fits the SM
        qb, bh, z = plan.grid(b, sq, h)
        rows = plan.bq * (plan.tiles if body == "cross" else 1)
        assert (qb - 1) * rows < sq <= qb * rows, (shape, plan)
        assert bh == b * h and z == plan.splits, (shape, plan)
        assert plan.smem <= fa.SMEM_BLOCK, (shape, plan)
        assert plan.resident >= (2 if body == "ring" else 1), (shape, plan)


@pytest.mark.parametrize("shape,plan", [
    ((2, 4096, 4096, 8, 40), fa.AttentionPlan("ring", 48, 128)),
    ((8, 4096, 4096, 8, 40), fa.AttentionPlan("ring", 48, 128)),
    ((2, 1024, 1024, 8, 80), fa.AttentionPlan("ring", 80, 128)),
    ((2, 9216, 9216, 5, 64), fa.AttentionPlan("ring", 64, 256)),
    ((2, 2304, 2304, 10, 64), fa.AttentionPlan("ring", 64, 192)),
    ((2, 576, 576, 20, 64), fa.AttentionPlan("ring", 64, 64)),
    ((2, 4096, 77, 8, 40), fa.AttentionPlan("cross", 48, 64, nk=80, tiles=2)),
    ((2, 9216, 77, 5, 64), fa.AttentionPlan("cross", 64, 64, nk=80, tiles=3)),
    ((8, 1024, 77, 8, 80), fa.AttentionPlan("cross", 80, 64, nk=80, tiles=3)),
    ((4, 1024, 77, 8, 80), fa.AttentionPlan("cross", 80, 64, nk=80, tiles=2)),
    ((8, 4096, 77, 8, 40), fa.AttentionPlan("cross", 48, 64, nk=80, tiles=4)),
    ((2, 64, 77, 8, 160), fa.AttentionPlan("cross", 160, 64, nk=80)),
    ((2, 256, 256, 8, 160), fa.AttentionPlan("wide", 160, 64)),
    ((1, 4096, 4096, 1, 512), fa.AttentionPlan("wide", 512, 64, splits=2)),
    ((1, 9216, 9216, 1, 512), fa.AttentionPlan("wide", 512, 64, splits=6)),
    ((4, 4096, 4096, 1, 512), fa.AttentionPlan("wide", 512, 64)),
    ((1, 100, 37, 3, 24), fa.AttentionPlan("general", 32, 64)),
    ((1, 300, 200, 2, 64), fa.AttentionPlan("general", 64, 64)),
])
def test_plan_tiles(shape, plan):
    """128 query rows at d = 40 and 80; at d = 64 the largest tile that
    still fills the card; the cross body's query tiles enough for one wave
    of the block slots its registers allow (3 an SM at d = 80, 4 at 40 and
    64), at most 4; the wide body's key splits where the
    query blocks leave SMs idle (64 or 144 blocks of one an SM); the general
    body at an odd width or more than 128 keys."""
    assert fa.attention_plan(*shape, SMS) == plan


def test_plan_kv_len_takes_the_general_body():
    """A kv_len shorter than the keys masks them: the cross body takes it up
    to 128 keys, the general body beyond."""
    assert fa.attention_plan(2, 256, 256, 8, 40, SMS, kv_len=200).body == "general"
    assert fa.attention_plan(2, 256, 256, 8, 40, SMS, kv_len=77) == fa.AttentionPlan(
        "cross", 48, 64, nk=80)
    assert fa.attention_plan(2, 256, 256, 8, 80, SMS, kv_len=100).nk == 128
    assert fa.attention_plan(2, 256, 256, 8, 160, SMS, kv_len=100).body == "general"
    assert fa.attention_plan(2, 256, 256, 8, 40, SMS, kv_len=256).body == "ring"


def test_plan_smem():
    """The shared bytes csrc/attention.cu asks for: Q and three K/V tiles of
    64 keys (ring) or one (general), rows of dp + 8 bf16."""
    assert fa.AttentionPlan("ring", 48, 128).smem == (128 + 6 * 64) * 56 * 2
    assert fa.AttentionPlan("ring", 64, 256).smem == (256 + 6 * 64) * 72 * 2
    assert fa.AttentionPlan("general", 512, 64, passes=4).smem == 192 * 520 * 2
    # cross: K and V (nk rows of dp + 8) and two Q buffers of 64 rows, three
    # at three tiles a block or more
    assert fa.AttentionPlan("cross", 48, 64, nk=80).smem == (2 * 80 + 2 * 64) * 56 * 2
    assert fa.AttentionPlan("cross", 160, 64, nk=80, tiles=3).smem == (2 * 80 + 3 * 64) * 168 * 2
    # wide: 1024 to align, Q, K, V in 64-column boxes (8 at d = 512, 3 at
    # 160), P, the tile's row maxima and sums, three mbarriers
    assert fa.AttentionPlan("wide", 512, 64).smem == 1024 + 3 * 8 * 8192 + 64 * 72 * 2 + 2 * 64 * 4 + 64
    assert fa.AttentionPlan("wide", 160, 64).smem == 1024 + 3 * 3 * 8192 + 64 * 72 * 2 + 2 * 64 * 4 + 64


# ---------------------------------------------------------------------------
# The emulation of the ring body's schedule
# ---------------------------------------------------------------------------


def _rows(t, b, h, r0, n, dp):
    """Rows [r0, r0 + n) of head h of batch b of t (B, S, H, D), read through
    t's batch and sequence strides from its storage as the kernel's
    cp.async does, zero-filled past S and past column D: (n, dp) f32."""
    s, d = t.shape[1], t.shape[3]
    flat = torch.as_strided(t, (t.untyped_storage().nbytes() // t.element_size(),), (1,), 0)
    r = torch.arange(r0, r0 + n)[:, None]
    c = torch.arange(dp)[None, :]
    ok = (r < s) & (c < d)
    off = (t.storage_offset() + b * t.stride(0) + r.clamp(max=s - 1) * t.stride(1) + h * d
           + c.clamp(max=d - 1))
    return torch.where(ok, flat[off], 0.0).float()


def emulate_k3_ring(q, k, v, plan, scale=None, mask=True):
    """The ring body's schedule in plain f32 torch (see the module
    docstring): (o (B, S, H, D), lse (B, H, S) in the log2 domain).
    ``mask=False`` drops the mask of the last tile's zero-filled keys."""
    b_, s, h_, d = q.shape
    bq, dp, bkv, stages = plan.bq, plan.dp, fa.K3_BKV, fa.K3_RING_STAGES
    assert plan.body == "ring" and k.shape == q.shape and v.shape == q.shape
    sl = (d ** -0.5 if scale is None else scale) * LOG2E
    ntiles = -(-s // bkv)
    o = torch.zeros(b_, s, h_, d)
    lse = torch.zeros(b_, h_, s)
    for b in range(b_):
        for h in range(h_):
            for q0 in range(0, s, bq):
                qt = _rows(q, b, h, q0, bq, dp)           # the Q tile, read once
                ring = [None] * stages                    # (tile, K, V) per buffer

                def load(j):
                    assert ring[j % stages] is None or ring[j % stages][0] <= j - stages, j
                    ring[j % stages] = (j, _rows(k, b, h, j * bkv, bkv, dp),
                                        _rows(v, b, h, j * bkv, bkv, dp))

                for j in range(min(stages - 1, ntiles)):  # the prologue
                    load(j)
                acc = torch.zeros(bq, dp)
                m = torch.full((bq,), -math.inf)
                lsum = torch.zeros(bq)
                for j in range(ntiles):
                    if j + stages - 1 < ntiles:           # after tile j's barrier
                        load(j + stages - 1)
                    tag, kt, vt = ring[j % stages]
                    assert tag == j, (tag, j)
                    for w0 in range(0, bq, 16):           # each warp's 16 rows
                        rows = slice(w0, w0 + 16)
                        logits = qt[rows] @ kt.T          # raw Q K^T, (16, 64)
                        if mask:
                            logits[:, min(bkv, s - j * bkv):] = -math.inf
                        mn = torch.maximum(m[rows], logits.max(dim=1).values * sl)
                        al = torch.exp2(m[rows] - mn)     # 0 on the first tile
                        p = torch.exp2(logits * sl - mn[:, None])
                        lsum[rows] = lsum[rows] * al + p.sum(dim=1)
                        acc[rows] = acc[rows] * al[:, None] + p @ vt
                        m[rows] = mn
                n = min(bq, s - q0)
                o[b, q0:q0 + n, h] = (acc[:n] / lsum[:n, None])[:, :d]
                lse[b, h, q0:q0 + n] = (m + torch.log2(lsum))[:n]
    return o, lse


def _inputs(b, s, h, d, fused, seed=0):
    """q, k, v (B, S, H, D) f32; ``fused``: views of one (B, S, 3 H D)
    projection, as the UNet hands them to K3."""
    rng = np.random.default_rng(seed)
    if fused:
        qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d), dtype=np.float32))
        return [t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1)]
    return [torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32)) for _ in range(3)]


def _close(got, want, tol=1e-5):
    assert got.shape == want.shape
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= tol, err


@pytest.mark.parametrize("shape", [(1, 100, 3, 40), (2, 130, 2, 64), (1, 200, 2, 80),
                                   (1, 64, 1, 40)])
@pytest.mark.parametrize("fused", [True, False])
def test_emulated_schedule_matches_plain(shape, fused):
    """The planner's tile at ragged lengths (100, 130, 200: no multiple of 64
    keys or of the query block), one exact tile (64), d = 40 (zero-padded to
    48), 64 and 80; q/k/v contiguous or strided as the fused QKV's split."""
    b, s, h, d = shape
    q, k, v = _inputs(b, s, h, d, fused)
    if fused:
        assert q.stride(1) == 3 * h * d and not q.is_contiguous()
    plan = fa.attention_plan(b, s, s, h, d, SMS)
    o, lse = emulate_k3_ring(q, k, v, plan)
    _close(o, fa.attention_plain(q, k, v))
    want = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5, dim=-1) * LOG2E
    _close(lse, want)


@pytest.mark.parametrize("bq", [64, 192, 256])
def test_emulated_schedule_every_d64_tile(bq):
    """Each compiled d = 64 tile over several query blocks and a ragged tail
    (300 rows, 5 key tiles, the ring wrapping once), with a scale that is
    not d^-0.5."""
    q, k, v = _inputs(1, 300, 2, 64, fused=True, seed=1)
    o, _ = emulate_k3_ring(q, k, v, fa.AttentionPlan("ring", 64, bq), scale=0.2)
    _close(o, fa.attention_plain(q, k, v, scale=0.2))


def test_emulated_schedule_sees_a_dropped_mask():
    """The comparison is sharp: without the mask of the last tile's
    zero-filled keys (each would get weight 2^-m), the emulation is far
    outside the tolerance."""
    q, k, v = _inputs(1, 100, 1, 40, fused=False)
    plan = fa.attention_plan(1, 100, 100, 1, 40, SMS)
    want = fa.attention_plain(q, k, v)
    _close(emulate_k3_ring(q, k, v, plan)[0], want)
    unmasked, _ = emulate_k3_ring(q, k, v, plan, mask=False)
    assert ((unmasked - want).abs().max() / want.abs().max()).item() > 1e-3


# ---------------------------------------------------------------------------
# The emulations of the cross and wide bodies' schedules
# ---------------------------------------------------------------------------


def emulate_k3_cross(q, k, v, plan, kv_len=None, scale=None, mask=True):
    """The cross body's schedule in plain f32 torch (see the module
    docstring): (o (B, Sq, H, D), lse (B, H, Sq) in the log2 domain).
    ``mask=False`` drops the mask of the keys at or past kv_len (the
    zero-filled pad to nk, and any real keys past kv_len)."""
    b_, sq, h_, d = q.shape
    sk = k.shape[1]
    kv = sk if kv_len is None else kv_len
    nk, dp = plan.nk, plan.dp
    assert plan.body == "cross" and kv <= nk
    sl = (d ** -0.5 if scale is None else scale) * LOG2E
    ntile = -(-sq // 64)
    o = torch.zeros(b_, sq, h_, d)
    lse = torch.zeros(b_, h_, sq)
    for b in range(b_):
        for h in range(h_):
            for t0 in range(0, ntile, plan.tiles):
                # the block's K and V, read once, zero past kv_len
                kt, vt = _rows(k, b, h, 0, nk, dp), _rows(v, b, h, 0, nk, dp)
                kt[kv:] = 0
                vt[kv:] = 0
                for tile in range(t0, min(ntile, t0 + plan.tiles)):
                    for w in range(4):                   # each warp's 16 rows
                        r0 = 64 * tile + 16 * w
                        logits = _rows(q, b, h, r0, 16, dp) @ kt.T   # (16, nk), one step
                        if mask:
                            logits[:, kv:] = -math.inf
                        m = logits.max(dim=1).values * sl
                        p = torch.exp2(logits * sl - m[:, None])
                        lsum = p.sum(dim=1)
                        n = max(0, min(16, sq - r0))
                        o[b, r0:r0 + n, h] = ((p @ vt) / lsum[:, None])[:n, :d]
                        lse[b, h, r0:r0 + n] = (m + torch.log2(lsum))[:n]
    return o, lse


def emulate_k3_wide(q, k, v, plan, scale=None, counts=None, weighted_merge=True):
    """The wide body's schedule in plain f32 torch (see the module
    docstring): (o (B, S, H, D), lse (B, H, S) in the log2 domain).
    ``counts``, a dict, receives the logits computed and the exponentials
    taken of them, and how many times each (row, key) logit was computed.
    ``weighted_merge=False`` adds the splits without their 2^(m_s - M)."""
    b_, s, h_, d = q.shape
    nw, rt, ct = fa.K3_WIDE[plan.dp]
    ks = 1  # S on warpgroup 0: each of its 4 warps 16 rows x all 64 keys
    nkw, bk, dp = 64 // ks, fa.K3_BKV, plan.dp
    sl = (d ** -0.5 if scale is None else scale) * LOG2E
    nt, ns = -(-s // bk), plan.splits
    seen = torch.zeros(b_, h_, -(-s // 64) * 64, nt * bk, dtype=torch.int32)
    n_exp = 0
    o = torch.zeros(b_, s, h_, d)
    lse = torch.zeros(b_, h_, s)
    for b in range(b_):
        for h in range(h_):
            for q0 in range(0, s, 64):
                qt = _rows(q, b, h, q0, 64, dp)
                parts = []
                for sp in range(ns):
                    cg = dp // ct
                    acc = torch.zeros(64, dp)
                    mo = torch.full((64, cg), -math.inf)   # each O warp's running max and sum
                    lo = torch.zeros(64, cg)
                    ms = torch.full((64,), -math.inf)      # the S warps' running max
                    for j in range(sp * nt // ns, (sp + 1) * nt // ns):
                        kt = _rows(k, b, h, j * bk, bk, dp)
                        vt = _rows(v, b, h, j * bk, bk, dp)
                        valid = min(bk, s - j * bk)
                        sblk = {}                          # each warp's S block, computed once
                        for w in range(4 * ks):
                            rs, kw = w // ks, w % ks
                            rows, keys = slice(16 * rs, 16 * rs + 16), slice(kw * nkw, kw * nkw + nkw)
                            blk = qt[rows] @ kt[keys].T
                            seen[b, h, q0 + 16 * rs:q0 + 16 * rs + 16,
                                 j * bk + kw * nkw:j * bk + kw * nkw + nkw] += 1
                            kidx = torch.arange(kw * nkw, kw * nkw + nkw)
                            blk[:, kidx >= valid] = -math.inf
                            sblk[(rs, kw)] = blk
                        smax = torch.stack([torch.cat([sblk[(rs, kw)].max(dim=1).values
                                                       for rs in range(4)]) for kw in range(ks)], 1)
                        ms = torch.maximum(ms, smax.max(dim=1).values * sl)
                        p = torch.zeros(64, bk)
                        ssum = torch.zeros(64, ks)
                        for (rs, kw), blk in sblk.items():
                            rows = slice(16 * rs, 16 * rs + 16)
                            pb = torch.exp2(blk * sl - ms[rows, None])
                            n_exp += pb.numel()
                            p[rows, kw * nkw:kw * nkw + nkw] = pb
                            ssum[rows, kw] = pb.sum(dim=1)
                        for w in range(nw):                # each warp's RT x CT block of O
                            rr, cc = w // (dp // ct), w % (dp // ct)
                            rows, cols = slice(rt * rr, rt * rr + rt), slice(ct * cc, ct * cc + ct)
                            mn = torch.maximum(mo[rows, cc], smax[rows].max(dim=1).values * sl)
                            al = torch.exp2(mo[rows, cc] - mn)
                            acc[rows, cols] = acc[rows, cols] * al[:, None] + p[rows] @ vt[:, cols]
                            lo[rows, cc] = lo[rows, cc] * al + ssum[rows].sum(dim=1)
                            mo[rows, cc] = mn
                    assert (mo == mo[:, :1]).all() and (lo == lo[:, :1]).all()
                    parts.append((acc, mo[:, 0], lo[:, 0]))
                if ns == 1:
                    acc, m, lsum = parts[0]
                    out = acc / lsum[:, None]
                else:                                      # the merge, in split order
                    m = torch.stack([x[1] for x in parts]).max(dim=0).values
                    lsum, out = torch.zeros(64), torch.zeros(64, dp)
                    for acc, ms_, ls_ in parts:
                        w_ = torch.exp2(ms_ - m) if weighted_merge else torch.ones(64)
                        lsum = lsum + w_ * ls_
                        out = out + w_[:, None] * acc
                    out = out / lsum[:, None]
                n = min(64, s - q0)
                o[b, q0:q0 + n, h] = out[:n, :d]
                lse[b, h, q0:q0 + n] = (m + torch.log2(lsum))[:n]
    if counts is not None:
        counts.update(logits=int(seen.sum()), exps=n_exp, max_per_logit=int(seen.max()),
                      min_per_logit=int(seen.min()))
    return o, lse


def _lse_want(q, k, kv_len=None, scale=None):
    n = k.shape[1] if kv_len is None else kv_len
    sc = q.shape[-1] ** -0.5 if scale is None else scale
    return torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", q, k[:, :n]) * sc, dim=-1) * LOG2E


@pytest.mark.parametrize("shape,kv_len", [((2, 100, 77, 4, 40), None), ((1, 130, 77, 3, 40), 50),
                                          ((1, 70, 128, 2, 64), None), ((1, 64, 100, 1, 160), 77),
                                          ((1, 200, 200, 2, 80), 77)])
def test_emulated_cross_schedule_matches_plain(shape, kv_len):
    """The cross body's key padding (77 -> 80, 128) and kv_len
    masking (50, 77 of 100 keys, and 77 of a 200-key self-attention, keys past kv_len
    real values), ragged query lengths; each plan the planner gives, then
    one tile a block."""
    b, sq, sk, h, d = shape
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((b, sq, h, d), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, sk, h, d), dtype=np.float32)) for _ in range(2))
    plan = fa.attention_plan(b, sq, sk, h, d, SMS, kv_len)
    assert plan.body == "cross", plan
    want = fa.attention_plain(q, k, v, kv_len=kv_len)
    for p in (plan, plan._replace(tiles=1)):
        o, lse = emulate_k3_cross(q, k, v, p, kv_len=kv_len)
        _close(o, want)
        _close(lse, _lse_want(q, k, kv_len))


def test_emulated_cross_schedule_sees_a_dropped_mask():
    """Without the mask of the keys past kv_len (the 3 zero-filled pad keys
    of 77 -> 80, each at weight 2^-m), the emulation is far outside the
    tolerance."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 64, 2, 40), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 77, 2, 40), dtype=np.float32)) for _ in range(2))
    plan = fa.attention_plan(1, 64, 77, 2, 40, SMS)
    want = fa.attention_plain(q, k, v)
    _close(emulate_k3_cross(q, k, v, plan)[0], want)
    unmasked, _ = emulate_k3_cross(q, k, v, plan, mask=False)
    assert ((unmasked - want).abs().max() / want.abs().max()).item() > 1e-3


@pytest.mark.parametrize("shape,splits", [((1, 256, 1, 512), 1), ((1, 256, 1, 512), 3),
                                          ((1, 200, 2, 160), 1), ((1, 200, 2, 160), 4),
                                          ((2, 128, 1, 512), 2)])
@pytest.mark.parametrize("fused", [True, False])
def test_emulated_wide_schedule_matches_plain(shape, splits, fused):
    """The wide body's column split (8 blocks of 64 x 64 at d = 512, four
    of 16 rows x 160 at 160), S by warpgroup 0 (16 rows x 64 keys a warp) and key splits
    merged in split order, at a ragged length (200: the last query
    block and key tile part-filled), q/k/v contiguous or as a fused QKV's
    views; the log2-domain log-sum-exp."""
    b, s, h, d = shape
    q, k, v = _inputs(b, s, h, d, fused, seed=5)
    plan = fa.AttentionPlan("wide", d, 64, splits=splits)
    o, lse = emulate_k3_wide(q, k, v, plan)
    _close(o, fa.attention_plain(q, k, v))
    _close(lse, _lse_want(q, k))


@pytest.mark.parametrize("splits", [1, 2])
def test_emulated_wide_computes_each_logit_once(splits):
    """At d = 512 every logit is computed once and its exponential taken
    once: B H Sq Sk of each at a length that is a multiple of 64."""
    b, s, h, d = 1, 192, 1, 512
    q, k, v = _inputs(b, s, h, d, fused=False, seed=6)
    counts = {}
    emulate_k3_wide(q, k, v, fa.AttentionPlan("wide", d, 64, splits=splits), counts=counts)
    assert counts == dict(logits=b * h * s * s, exps=b * h * s * s, max_per_logit=1,
                          min_per_logit=1), counts


def test_emulated_wide_schedule_sees_a_wrong_merge():
    """The merge is sharp: splits added without their 2^(m_s - M) weights
    land far outside the tolerance."""
    q, k, v = _inputs(1, 256, 1, 160, fused=False, seed=7)
    q = q * 3  # spread the row maxima of the splits apart
    want = fa.attention_plain(q, k, v)
    plan = fa.AttentionPlan("wide", 160, 64, splits=2)
    _close(emulate_k3_wide(q, k, v, plan)[0], want)
    bad, _ = emulate_k3_wide(q, k, v, plan, weighted_merge=False)
    assert ((bad - want).abs().max() / want.abs().max()).item() > 1e-3
