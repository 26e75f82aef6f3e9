"""K8's schedule on the CPU: the planner (``ops/linear.linear_q_plan``) at
every K8 shape of the W8A8 serving path, and a plain-torch emulation of the
kernel's schedule (csrc/linear_q.cu) held against the plain version and
the JAX package's XLA form.

The emulation follows the kernel: each row is LayerNormed (f32 statistics
over all of K, the output left unrounded) and quantized once (the first
launch); then block by block, in a shuffled block order, a block takes its
rows' int8 codes of its own 128-byte K chunks and walks its contiguous
range of N tiles, each tile's int32 product taken over those chunks; with a K split each part adds its partial tile
into an int32 workspace and the part that takes the tile's last ticket
runs the epilogue (acc * out_scale + bias (+ residual) in f32), then
zeroes the workspace and the ticket.  Its int32 sums must equal the plain
version's exactly, its output ``matmul_w8a8_plain`` within 1e-5 in f32
and JAX ``_q_mm_xla`` within 1e-5 (with a LayerNorm over K > 1280, where
XLA's f32 statistics may move a code by one, within one code's product).  These are test helpers, not used on
the main path.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_diffusion_tpu.ops import linear as jlin
from stable_diffusion_tpu_torch.ops import linear as L
from stable_diffusion_tpu_torch.ops.quantize import act_step, folded_scales, int_matmul, quantize_act
from tests.torch_threads import one_thread  # noqa: F401

SMS = 132  # an H100 SXM's SMs

# (M, K, N, LayerNorm, residual) of every K8 call in one b4 W8A8 DDIM step
# (UNet batch 8 at 64^2 latents; chip_smoke.py phase 6 records the same 19
# keys): the time embedding and the resblocks' t_embed at M = 1 (one
# timestep for the whole batch), the transformers' fused QKV / q (LN) and
# out projections (residual) at 4096 / 1024 / 256 / 64 tokens a sample,
# and the cross-attention k/v on the 77-token context (8 x 77 = 616 rows).
W8A8_SHAPES = [
    (1, 1280, 1280, False, False), (1, 1280, 320, False, False), (1, 1280, 640, False, False),
    (1, 320, 1280, False, False),
    (32768, 320, 320, False, True), (32768, 320, 320, True, False), (32768, 320, 960, True, False),
    (8192, 640, 640, False, True), (8192, 640, 640, True, False), (8192, 640, 1920, True, False),
    (2048, 1280, 1280, False, True), (2048, 1280, 1280, True, False),
    (2048, 1280, 3840, True, False),
    (512, 1280, 1280, False, True), (512, 1280, 1280, True, False), (512, 1280, 3840, True, False),
    (616, 768, 320, False, False), (616, 768, 640, False, False), (616, 768, 1280, False, False),
]


def _parts(total: int, splits: int):
    """The C entry's split of ``total`` items over ``splits`` blocks."""
    return [(i * total // splits, (i + 1) * total // splits) for i in range(splits)]


@pytest.mark.parametrize("shape", W8A8_SHAPES + [(100, 64, 40, True, True), (70, 1536, 48, True, False),
                                                 (3000, 4096, 512, False, False)])
def test_linear_q_plan_covers_every_output_once(shape):
    m, k, n = shape[:3]
    plan = L.linear_q_plan(m, k, n, SMS)
    bm, bn = plan.bm, plan.bn
    assert plan.variant in L.LQ_VARIANTS
    assert plan.smem == L.lq_smem(*plan.variant[:3], plan.nkc) <= L.SMEM_BLOCK
    kch, ntiles = -(-k // L.LQ_KC), -(-n // bn)
    assert 1 <= plan.nsplit <= ntiles and 1 <= plan.ksplit <= kch
    # every (row, column) lies in one block's row range and one tile of one
    # block's N range; every K chunk in one part, none past a block's rows
    rows = np.zeros(m, np.int64)
    for bx in range(-(-m // bm)):
        rows[bx * bm:(bx + 1) * bm] += 1
    cols = np.zeros(n, np.int64)
    for t0, t1 in _parts(ntiles, plan.nsplit):
        assert t1 > t0
        for t in range(t0, t1):
            cols[t * bn:(t + 1) * bn] += 1
    chunks = np.zeros(kch, np.int64)
    for c0, c1 in _parts(kch, plan.ksplit):
        assert 1 <= c1 - c0 <= plan.nkc
        chunks[c0:c1] += 1
    assert (rows == 1).all() and (cols == 1).all() and (chunks == 1).all()
    blocks = math.prod(plan.grid(m))
    if m <= 64:
        # weight-bound: at least SMS blocks stream the weight where the
        # chunks and 16-column tiles allow it
        assert blocks >= min(SMS, ntiles * kch), (plan, blocks)
        if (m, k, n) in {s[:3] for s in W8A8_SHAPES}:
            assert blocks >= SMS, (plan, blocks)


def test_linear_q_plan_fills_the_card_at_the_path_shapes():
    """No path shape leaves most SMs idle, and the large-M shapes read their
    rows once or a few times (N split) rather than once a tile."""
    for m, k, n, _, _ in W8A8_SHAPES:
        plan = L.linear_q_plan(m, k, n, SMS)
        blocks = math.prod(plan.grid(m))
        if m >= 2048:
            assert blocks >= SMS // 2 and plan.ksplit == 1, (m, k, n, plan)
            assert plan.nsplit <= -(-n // plan.bn), (m, k, n, plan)


def emulate_k8(x, w_q, s_x, out_scale, bias, residual, ln_w, ln_b, eps, plan, seed=0, merge=True):
    """K8's schedule in plain torch (f32, exact int64 products): returns
    (y, acc), acc the int32 sums each output's epilogue read.  ``merge``
    False stores each K part's partial over the workspace instead of adding
    it (the negative control)."""
    m, k = x.shape
    n = w_q.shape[0]
    bm, bn = plan.bm, plan.bn
    kch, ntiles = -(-k // L.LQ_KC), -(-n // bn)
    ws = torch.zeros(m, n, dtype=torch.int64)
    tickets = torch.zeros(-(-m // bm), ntiles, dtype=torch.int64)
    y = torch.full((m, n), float("nan"))
    acc_seen = torch.full((m, n), -(2 ** 40), dtype=torch.int64)
    blocks = [(bx, ns, ks) for bx in range(-(-m // bm)) for ns in _parts(ntiles, plan.nsplit)
              for ks in _parts(kch, plan.ksplit)]
    order = np.random.default_rng(seed).permutation(len(blocks))
    h = x.float()
    if ln_w is not None:  # statistics over all of K, once a row
        h = L.layer_norm_plain(h, ln_w.float(), ln_b.float(), eps)
    q = quantize_act(h, s_x).to(torch.int64)  # the first launch's int8 rows
    for i in order:
        bx, (t0, t1), (c0, c1) = blocks[i]
        r0, r1 = bx * bm, min(m, (bx + 1) * bm)
        k0, k1 = c0 * L.LQ_KC, min(k, c1 * L.LQ_KC)
        codes = q[r0:r1, k0:k1]  # this block's rows, its part's chunks only
        for t in range(t0, t1):
            n0, n1 = t * bn, min(n, (t + 1) * bn)
            part = codes @ w_q[n0:n1, k0:k1].to(torch.int64).t()
            if plan.ksplit > 1:
                ws[r0:r1, n0:n1] = ws[r0:r1, n0:n1] + part if merge else part
                tickets[bx, t] += 1
                if tickets[bx, t] < plan.ksplit:
                    continue
                part = ws[r0:r1, n0:n1].clone()
                ws[r0:r1, n0:n1] = 0
                tickets[bx, t] = 0
            assert part.abs().max() < 2 ** 31  # an int32 sum
            acc_seen[r0:r1, n0:n1] = part
            out = part.float() * out_scale[n0:n1] + (0 if bias is None else bias[n0:n1].float())
            if residual is not None:
                out = out + residual[r0:r1, n0:n1].float()
            y[r0:r1, n0:n1] = out
    assert not ws.any() and not tickets.any()  # left zero for the next call
    return y, acc_seen


# (M, K, N, LN, residual, sms): the 64-column and 16-column tiles, N
# splits, K splits (small M; few row blocks at a small card), ragged M, N
# and K (K % 128 != 0), and K > 1280 (the rows' three-pass prologue).
EMU_CASES = [(100, 64, 40, True, True, SMS), (1, 320, 1280, False, False, SMS),
             (1, 1280, 320, False, False, SMS), (8, 640, 136, True, True, SMS),
             (300, 768, 320, False, True, 8), (200, 1536, 48, True, False, 4),
             (130, 320, 960, True, False, 2)]


@pytest.mark.parametrize("case", EMU_CASES)
def test_k8_schedule_matches_plain_and_jax(case):
    m, k, n, ln, res, sms = case
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32) * 2)
    w_q = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    w_scale = torch.from_numpy(rng.uniform(0.01, 0.02, n).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(n, dtype=np.float32) * 0.1)
    r = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32)) if res else None
    lw = torch.from_numpy(1 + 0.1 * rng.standard_normal(k, dtype=np.float32)) if ln else None
    lb = torch.from_numpy(0.1 * rng.standard_normal(k, dtype=np.float32)) if ln else None
    h = L.layer_norm_plain(x, lw, lb) if ln else x
    act = h.abs().amax() * 0.9  # a few codes clip, as calibrated scales allow
    s_x, out_scale = folded_scales(w_scale, act)
    plan = L.linear_q_plan(m, k, n, sms)
    if (m, k, n) == (130, 320, 960):  # two 64-column tiles a block, three K parts
        plan = L.LinearQPlan((64, 64, 4, 2), 7, 3, 1, L.lq_smem(64, 64, 4, 1))
    assert plan.nsplit > 1 or plan.ksplit > 1 or m == 100 or k > 1280
    y, acc = emulate_k8(x, w_q, s_x, out_scale, bias, r, lw, lb, 1e-5, plan, seed=m)
    want_acc = int_matmul(quantize_act(h, act_step(act)), w_q).to(torch.int64)
    assert torch.equal(acc, want_acc)
    plain = L.matmul_w8a8_plain(x, w_q, w_scale, act, bias, r, lw, lb)
    torch.testing.assert_close(y, plain, rtol=1e-5, atol=1e-5 * plain.abs().max().item())
    jx = np.asarray(jlin._q_mm_xla(jnp.asarray(x.numpy()), None if lw is None else lw.numpy(),
                                   None if lb is None else lb.numpy(), jnp.asarray(act.numpy()),
                                   w_q.numpy().T, w_scale.numpy(), bias.numpy(),
                                   None if r is None else r.numpy(), 1e-5))
    if ln and k > 1280:
        # XLA's f32 LayerNorm (its reduction order and rsqrt) may put an LN
        # output of a long row on the other side of a half step than torch's:
        # then that row's outputs differ by one code's product, and no more.
        one_code = (act_step(act) * w_scale.max() * 127).item()
        np.testing.assert_allclose(y.numpy(), jx, rtol=0, atol=1.01 * one_code)
        assert (np.abs(y.numpy() - jx) > 1e-5 * np.abs(jx).max()).mean() < 0.02
    else:
        np.testing.assert_allclose(y.numpy(), jx, rtol=1e-5, atol=1e-5 * np.abs(jx).max())


def test_k8_schedule_catches_a_dropped_split():
    """The negative control: the emulation with the K split's partials
    stored over each other instead of added must fail the exact comparison."""
    m, k, n = 1, 1280, 320
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
    w_q = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    w_scale = torch.full((n,), 0.01)
    act = x.abs().amax()
    s_x, out_scale = folded_scales(w_scale, act)
    plan = L.linear_q_plan(m, k, n, SMS)
    assert plan.ksplit > 1
    want = int_matmul(quantize_act(x, s_x), w_q).to(torch.int64)
    _, acc = emulate_k8(x, w_q, s_x, out_scale, None, None, None, None, 1e-5, plan)
    assert torch.equal(acc, want)
    _, acc = emulate_k8(x, w_q, s_x, out_scale, None, None, None, None, 1e-5, plan, merge=False)
    assert not torch.equal(acc, want)
