"""K9's schedule on the CPU: the planner (``ops/ffn.ffn_q_plan``) at the
four K9 shapes of the W8A8 serving path, and a plain-torch emulation of the
kernel's three launches (csrc/ffn_q.cu) held against the plain version and
the JAX package's XLA form.

The emulation follows the kernel: each row is LayerNormed (f32 two-pass
statistics) and quantized once with the first linear's step (launch 1);
G1, block by block in a shuffled order, takes its rows' codes and walks its
range of 128-row W1 tiles, each tile's slab rows paired as the loads pair
them (32 value rows, then the 32 gate rows of the same hidden units, twice),
the int32 product over 128-byte K steps in order, then the epilogue per
(value, gate) column pair: (acc_v * os1 + b1) * gelu(acc_g * os1 + b1) in
f32, quantized with the second linear's step into int8 h (launch 2); G2
multiplies each (BM x BN) tile of h by W2 over all of H and adds b2 and
the residual in f32 (launch 3).  The int32 sums of both products must equal
the plain version's exactly, the output ``geglu_ffn_w8a8_plain`` and JAX
``_ffn_q_xla`` within 1e-5 of the largest value.  These are test helpers,
not used on the main path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stable_diffusion_tpu.ops import ffn as jffn
from stable_diffusion_tpu_torch.ops import ffn
from stable_diffusion_tpu_torch.ops.linear import layer_norm_plain
from stable_diffusion_tpu_torch.ops.quantize import act_step, folded_scales, int_matmul, quantize_act
from tests.torch_threads import one_thread  # noqa: F401

SMS = 132  # an H100 SXM's SMs
SMEM_BLOCK, SMEM_SM = 232448, 233472  # shared memory a block can use, and an SM has (227, 228 KB)

# (M, C, H) of every K9 call in one b4 W8A8 DDIM step (UNet batch 8 at 64^2
# latents; chip_smoke.py's K9_SWEEP_SHAPES) and its calls: 16 FFNs.
K9_SHAPES = [((32768, 320, 1280), 5), ((8192, 640, 2560), 5), ((2048, 1280, 5120), 5),
             ((512, 1280, 5120), 1)]


def _parts(total: int, splits: int):
    """The C entry's split of ``total`` items over ``splits`` blocks."""
    return [(i * total // splits, (i + 1) * total // splits) for i in range(splits)]


@pytest.mark.parametrize("shape", [s for s, _ in K9_SHAPES] + [(300, 160, 640), (77, 1280, 5120)])
def test_ffn_q_plan_covers_every_output_once(shape):
    m, c, hidden = shape
    plan = ffn.ffn_q_plan(m, c, hidden, SMS)
    assert plan.g1 in ffn.FFN_Q_G1_VARIANTS and plan.g2 in ffn.FFN_Q_G2_VARIANTS
    # each block fits, and at least one of each kernel's blocks fits an SM
    assert plan.smem1 == ffn.g1_smem(*plan.g1[:2], c) and plan.smem1 + 1024 <= SMEM_SM
    assert plan.smem2 == ffn.g2_smem(*plan.g2) and plan.smem2 + 1024 <= SMEM_SM
    assert max(plan.smem1, plan.smem2) <= SMEM_BLOCK
    # G1: every (row, hidden unit) in one row block and one tile of one split
    bm1, ntiles = plan.g1[0], hidden // 64
    rb, ns = plan.grid1(m)
    assert rb * bm1 >= m > (rb - 1) * bm1 and 1 <= ns <= ntiles
    units = np.zeros(hidden, np.int64)
    for t0, t1 in _parts(ntiles, ns):
        assert t1 > t0
        for t in range(t0, t1):
            units[t * 64:(t + 1) * 64] += 1
    assert (units == 1).all()
    # G2: every output in one tile
    cols, rows = plan.grid2(m, c)
    assert cols * plan.g2[1] >= c > (cols - 1) * plan.g2[1]
    assert rows * plan.g2[0] >= m > (rows - 1) * plan.g2[0]


def test_ffn_q_plan_fills_the_card_at_the_path_shapes():
    """Each GEMM gives at least half the SMs a block at every path shape,
    and the G2 tile is the widest that does."""
    for (m, c, hidden), _ in K9_SHAPES:
        plan = ffn.ffn_q_plan(m, c, hidden, SMS)
        rb, ns = plan.grid1(m)
        assert 2 * rb * ns >= SMS, plan
        cols, rows = plan.grid2(m, c)
        assert 2 * cols * rows >= SMS, plan
        wider = ffn.FFN_Q_G2_VARIANTS[:ffn.FFN_Q_G2_VARIANTS.index(plan.g2)]
        assert all(2 * -(-m // v[0]) * -(-c // v[1]) < SMS for v in wider), plan


def test_ffn_q_plan_rejects_what_the_kernel_does_not_take():
    for c, hidden in ((48, 256), (2560, 10240), (320, 1000)):
        with pytest.raises(ValueError, match="K9"):
            ffn.ffn_q_plan(64, c, hidden, SMS)


def g1_w1_rows(hidden, pair=True):
    """The W1 row each G1 slab row holds (csrc/ffn_q.cu w1_row): slab row r
    of tile t is hidden unit u = 64 t + 32 (r >> 6) + (r & 31), its value
    row for r & 32 == 0, else its gate row H + u.  ``pair`` False loads W1
    rows in order (values and gates unpaired: the negative control)."""
    r = torch.arange(2 * hidden)
    if not pair:
        return r
    t, r = r // 128, r % 128
    u = 64 * t + 32 * (r >> 6) + (r & 31)
    return torch.where((r & 32) != 0, hidden + u, u)


def emulate_k9(x, lw, lb, w1_q, s1, os1, b1, w2_q, s2, os2, b2, res, plan, eps=1e-5, seed=0,
               pair=True):
    """K9's three launches in plain torch (exact int64 products, f32
    epilogues): returns (out, acc1, acc2), acc1 (M, 2H) the G1 sums in W1's
    row order, acc2 (M, C) the G2 sums."""
    m, c = x.shape
    hidden = w2_q.shape[1]
    kc = ffn.FFN_Q_KC
    h = x if lw is None else layer_norm_plain(x, lw, lb, eps)
    xq = quantize_act(h, s1).to(torch.int64)  # launch 1
    order = g1_w1_rows(hidden, pair)
    w1 = w1_q.to(torch.int64)
    acc1 = torch.full((m, 2 * hidden), -(2 ** 40), dtype=torch.int64)
    hq = torch.full((m, hidden), 999, dtype=torch.int64)
    bm1, ntiles = plan.g1[0], hidden // 64
    rb, ns = plan.grid1(m)
    blocks = [(bi, part) for bi in range(rb) for part in _parts(ntiles, ns)]
    for i in np.random.default_rng(seed).permutation(len(blocks)):
        bi, (t0, t1) = blocks[i]
        r0, r1 = bi * bm1, min(m, (bi + 1) * bm1)
        for t in range(t0, t1):
            rows = order[t * 128:(t + 1) * 128]
            acc = torch.zeros(r1 - r0, 128, dtype=torch.int64)
            for k in range(0, c, kc):  # the K steps, in order
                acc += xq[r0:r1, k:k + kc] @ w1[rows, k:k + kc].T
            assert acc.abs().max() < 2 ** 31
            acc1[r0:r1, rows] = acc
            for p in range(2):  # each 64 columns: 32 values, then their 32 gates
                v = acc[:, 64 * p:64 * p + 32]
                g = acc[:, 64 * p + 32:64 * p + 64]
                jv, jg = rows[64 * p:64 * p + 32], rows[64 * p + 32:64 * p + 64]
                hv = v.float() * os1[jv] + b1[jv]
                pair_buf = torch.empty(r1 - r0, 64)
                pair_buf[:, 32:] = g.float() * os1[jg] + b1[jg]
                # gelu on a strided view, as the plain version takes it on
                # the gate half of its (M, 2H): torch's CPU gelu rounds by the
                # layout it is given (contiguous and strided inputs differ by
                # an ulp), and the codes must match exactly
                gate = F.gelu(pair_buf[:, 32:])
                units = t * 64 + 32 * p + torch.arange(32)
                hq[r0:r1, units] = quantize_act(hv * gate, s2).to(torch.int64)
    assert (hq != 999).all()  # every unit written once
    w2 = w2_q.to(torch.int64)
    acc2 = torch.full((m, c), -(2 ** 40), dtype=torch.int64)
    out = torch.full((m, c), float("nan"))
    bm2, bn2 = plan.g2[0], plan.g2[1]
    cols, rows2 = plan.grid2(m, c)
    for bj in range(cols):
        for bi in range(rows2):
            rs = slice(bi * bm2, min((bi + 1) * bm2, m))
            cs = slice(bj * bn2, min((bj + 1) * bn2, c))
            acc = torch.zeros(rs.stop - rs.start, cs.stop - cs.start, dtype=torch.int64)
            for k in range(0, hidden, kc):
                acc += hq[rs, k:k + kc] @ w2[cs, k:k + kc].T
            assert acc.abs().max() < 2 ** 31
            acc2[rs, cs] = acc
            y = acc.float() * os2[cs] + b2[cs]
            out[rs, cs] = y if res is None else y + res[rs, cs]
    return out, acc1, acc2


def _inputs(m, c, hidden, seed=0):
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale)

    x, lw, lb = rn(m, c), 1 + rn(c, scale=0.1), rn(c, scale=0.1)
    w1 = torch.from_numpy(rng.integers(-127, 128, (2 * hidden, c)).astype(np.int8))
    w2 = torch.from_numpy(rng.integers(-127, 128, (c, hidden)).astype(np.int8))
    ws1 = torch.from_numpy(rng.uniform(0.5, 1.0, 2 * hidden).astype(np.float32) / (64 * c ** 0.5))
    ws2 = torch.from_numpy(rng.uniform(0.5, 1.0, c).astype(np.float32) / (64 * hidden ** 0.5))
    b1, b2, res = rn(2 * hidden, scale=0.1), rn(c, scale=0.1), rn(m, c)
    act1 = layer_norm_plain(x, lw, lb).abs().amax() * 0.9  # a few codes clip
    hh = int_matmul(quantize_act(layer_norm_plain(x, lw, lb), act_step(act1)), w1) * act_step(act1) * ws1 + b1
    act2 = (hh[:, :hidden] * F.gelu(hh[:, hidden:])).abs().amax() * 0.9
    return x, lw, lb, w1, ws1, b1, act1, w2, ws2, b2, act2, res


def _run(args, plan, **kw):
    x, lw, lb, w1, ws1, b1, act1, w2, ws2, b2, act2, res = args
    s1, os1 = folded_scales(ws1, act1)
    s2, os2 = folded_scales(ws2, act2)
    return emulate_k9(x, lw, lb, w1, s1, os1, b1, w2, s2, os2, b2, res, plan, **kw)


def _plain_sums(args):
    """The plain version's int32 sums of both products."""
    x, lw, lb, w1, ws1, b1, act1, w2, ws2, b2, act2, res = args
    hn = layer_norm_plain(x, lw, lb)
    s1 = act_step(act1)
    acc1 = int_matmul(quantize_act(hn, s1), w1)
    hh = acc1 * (s1 * ws1) + b1
    hidden = w2.shape[1]
    h = hh[:, :hidden] * F.gelu(hh[:, hidden:])
    acc2 = int_matmul(quantize_act(h, act_step(act2)), w2)
    return acc1.to(torch.int64), acc2.to(torch.int64)


# (m, c, hidden, sms, G2 variant): ragged M over 128-row G1 and G2 blocks;
# a split G1 on a small card; C not a multiple of 128 (a partial K step);
# each G2 variant, G2 columns past C.
EMU_CASES = [(300, 160, 640, SMS, None), (130, 320, 1280, 8, (128, 160, 4)),
             (200, 96, 256, SMS, (128, 160, 4)), (100, 64, 128, 4, (64, 64, 4))]


@pytest.mark.parametrize("case", EMU_CASES)
def test_k9_schedule_matches_plain_and_jax(case):
    m, c, hidden, sms, g2 = case
    args = _inputs(m, c, hidden, seed=m + c)
    plan = ffn.ffn_q_plan(m, c, hidden, sms, g2=g2)
    if sms == 8:
        assert plan.nsplit1 > 1, plan
    out, acc1, acc2 = _run(args, plan, seed=m)
    want1, want2 = _plain_sums(args)
    assert torch.equal(acc1, want1) and torch.equal(acc2, want2)
    x, lw, lb, w1, ws1, b1, act1, w2, ws2, b2, act2, res = args
    plain = ffn.geglu_ffn_w8a8_plain(*args)
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-5 * plain.abs().max().item())
    p0 = {"kernel_q": w1.numpy().T, "kernel_scale": ws1.numpy().reshape(1, -1), "bias": b1.numpy(),
          "act_scale": jnp.asarray(act1.numpy())}
    p1 = {"kernel_q": w2.numpy().T, "kernel_scale": ws2.numpy().reshape(1, -1), "bias": b2.numpy(),
          "act_scale": jnp.asarray(act2.numpy())}
    jx = np.asarray(jffn._ffn_q_xla(jnp.asarray(x.numpy()), lw.numpy(), lb.numpy(), p0, p1,
                                    res.numpy(), 1e-5))
    np.testing.assert_allclose(out.numpy(), jx, rtol=1e-5, atol=1e-5 * np.abs(jx).max())


def test_k9_schedule_catches_unpaired_values_and_gates():
    """The negative control: W1's rows loaded in order, so a tile's value
    columns meet other units' values and gates, must fail."""
    m, c, hidden = 130, 64, 256
    args = _inputs(m, c, hidden, seed=5)
    plan = ffn.ffn_q_plan(m, c, hidden, SMS)
    out, _, acc2 = _run(args, plan)
    assert torch.equal(acc2, _plain_sums(args)[1])
    out_bad, _, acc2_bad = _run(args, plan, pair=False)
    assert not torch.equal(acc2_bad, _plain_sums(args)[1])
    plain = ffn.geglu_ffn_w8a8_plain(*args)
    assert ((out_bad - plain).abs().max() / plain.abs().max()).item() > 1e-2
