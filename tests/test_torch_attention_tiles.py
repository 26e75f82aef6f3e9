"""K3's tiling on the CPU: the planner (``ops/flash_attention.attention_plan``)
at every K3 shape of the port's four paths, and a plain-torch emulation of
the ring body's schedule (csrc/attention.cu) held against the plain
attention.

The emulation follows the kernel: for each (batch, head) and each block of
``bq`` query rows (16 a warp), Q is read once through q's own batch and
sequence strides into a tile zero-filled past Sq and past column D (d = 40
pads to 48); K/V tiles of 64 keys go through a ring of three buffers in the
kernel's order (tiles 0 and 1 first; at tile j, after its barrier, tile
j + 2 into the buffer tile j - 1 used), zero-filled past Sk; each tile's
logits are masked past Sk, the running max is kept in the log2 domain of
the scaled logits (p = 2^(s scale log2 e - m)), the output and the row sum
are rescaled by 2^(m_old - m_new), and the row log-sum-exp is m + log2 l.
It runs in f32, so it must equal ``attention_plain`` up to summation order:
max|emulated - plain| <= 1e-5 * max|plain|, and the log-sum-exp
logsumexp(s scale) log2 e within 1e-5 relative.  It is a test helper, not
used on the main path.
"""

import math

import numpy as np
import pytest
import torch

from stable_diffusion_tpu_torch.ops import flash_attention as fa

SMS = 132  # an H100 SXM's SMs
LOG2E = 1.4426950408889634

# (b, sq, sk, h, d) of every K3 call on the four paths: the UNet's self- and
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
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_plan_at_every_path_shape(path):
    for shape in PATHS[path]:
        b, sq, sk, h, d = shape
        plan = fa.attention_plan(b, sq, sk, h, d, SMS)
        # the ring body at every self-attention with d = 40, 64, 80, the
        # general body everywhere else
        ring = sq == sk and d in (40, 64, 80)
        assert plan.body == ("ring" if ring else "general"), (shape, plan)
        if ring:
            assert (plan.dp, plan.bq) in fa.K3_RING, (shape, plan)
            assert plan.dp == -(-d // 16) * 16 and plan.passes == 1, (shape, plan)
        else:
            assert plan.bq == 64, (shape, plan)
            assert plan.passes == (4 if d == 512 else 1), (shape, plan)
            assert plan.dp * plan.passes >= d, (shape, plan)
        # the grid covers every query row once, and the block fits the SM
        qb, bh, z = plan.grid(b, sq, h)
        assert (qb - 1) * plan.bq < sq <= qb * plan.bq and bh == b * h and z == plan.passes
        assert plan.smem <= fa.SMEM_BLOCK, (shape, plan)
        assert plan.resident >= (2 if ring else 1), (shape, plan)


@pytest.mark.parametrize("shape,plan", [
    ((2, 4096, 4096, 8, 40), fa.AttentionPlan("ring", 48, 128)),
    ((8, 4096, 4096, 8, 40), fa.AttentionPlan("ring", 48, 128)),
    ((2, 1024, 1024, 8, 80), fa.AttentionPlan("ring", 80, 128)),
    ((2, 9216, 9216, 5, 64), fa.AttentionPlan("ring", 64, 256)),
    ((2, 2304, 2304, 10, 64), fa.AttentionPlan("ring", 64, 192)),
    ((2, 576, 576, 20, 64), fa.AttentionPlan("ring", 64, 64)),
    ((2, 4096, 77, 8, 40), fa.AttentionPlan("general", 48, 64)),
    ((2, 256, 256, 8, 160), fa.AttentionPlan("general", 160, 64)),
    ((1, 9216, 9216, 1, 512), fa.AttentionPlan("general", 512, 64, passes=4)),
    ((1, 100, 37, 3, 24), fa.AttentionPlan("general", 32, 64)),
])
def test_plan_tiles(shape, plan):
    """128 query rows at d = 40 and 80; at d = 64 the largest tile that
    still fills the card; the general body elsewhere."""
    assert fa.attention_plan(*shape, SMS) == plan


def test_plan_kv_len_takes_the_general_body():
    """A kv_len shorter than the keys masks them: only the general body does."""
    assert fa.attention_plan(2, 256, 256, 8, 40, SMS, kv_len=200).body == "general"
    assert fa.attention_plan(2, 256, 256, 8, 40, SMS, kv_len=256).body == "ring"


def test_plan_smem():
    """The shared bytes csrc/attention.cu asks for: Q and three K/V tiles of
    64 keys (ring) or one (general), rows of dp + 8 bf16."""
    assert fa.AttentionPlan("ring", 48, 128).smem == (128 + 6 * 64) * 56 * 2
    assert fa.AttentionPlan("ring", 64, 256).smem == (256 + 6 * 64) * 72 * 2
    assert fa.AttentionPlan("general", 512, 64, passes=4).smem == 192 * 520 * 2


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
