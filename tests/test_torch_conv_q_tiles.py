"""K7's schedule on the CPU: the planner (``ops/conv.conv3x3_q_plan``) at
every K7 shape of the W8A8 serving path, and a plain-torch emulation of the
kernel's two launches (csrc/conv3x3_q.cu) held against the plain version
and the JAX package's Pallas kernel.

The emulation follows the kernel: the GN+SiLU activation is quantized once
into int8 codes (the first launch); then block by block, in a shuffled
order, each output
rectangle's (th+2) x (tw+2) halo of each 128-channel chunk is filled with
its codes, zero out of the image and past Cin, and stored in XOR-swizzled
16-byte pieces; each GEMM row reads its pixel's halo row shifted by the
tap, against the tap's (BN x 128) weight slab, in exact integers.  With a K
split each part adds its partial tile into an int32 workspace and the part
that takes the tile's last ticket runs the epilogue (acc * out_scale +
bias in f32), then zeroes the workspace and the ticket.  Its int32 sums must
equal the exact integer conv of the plain version's codes, its output
``conv3x3_w8a8_plain`` within 1e-5 of the largest value (the same f32
arithmetic), and JAX ``_conv3x3_q`` (interpret mode) within the 2e-6 / 1e-6
of ``tests/test_torch_quant.py::test_k7_plain_matches_jax_conv3x3_q``.
These are test helpers, not used on the main path.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stable_diffusion_tpu.ops import conv as jconv
from stable_diffusion_tpu_torch.ops import conv
from stable_diffusion_tpu_torch.ops.groupnorm import gn_silu_prologue
from stable_diffusion_tpu_torch.ops.quantize import act_step, folded_scales, quantize_act

SMS = 132  # an H100 SXM's SMs
SMEM_BLOCK, SMEM_SM = 232448, 233472  # shared memory a block can use, and an SM has (227, 228 KB)

# (B, H, W, Cin, Cout) of every K7 call in one b4 W8A8 DDIM step (UNet
# batch 8 at 64^2 latents; tests/test_torch_conv_tiles.py's UNET_CONVS with
# the prologue, chip_smoke.py's K7_SWEEP_SHAPES), with its calls: 44 convs.
K7_SHAPES = [((8, 64, 64, 320, 320), 7), ((8, 64, 64, 640, 320), 2), ((8, 64, 64, 960, 320), 1),
             ((8, 32, 32, 320, 640), 1), ((8, 32, 32, 640, 640), 6), ((8, 32, 32, 960, 640), 1),
             ((8, 32, 32, 1280, 640), 1), ((8, 32, 32, 1920, 640), 1), ((8, 16, 16, 640, 1280), 1),
             ((8, 16, 16, 1280, 1280), 6), ((8, 16, 16, 1920, 1280), 1),
             ((8, 16, 16, 2560, 1280), 2), ((8, 8, 8, 1280, 1280), 11), ((8, 8, 8, 2560, 1280), 3)]


def test_k7_shapes_are_the_unet_resblock_convs():
    assert sum(n for _, n in K7_SHAPES) == 44
    spec = importlib.util.spec_from_file_location(
        "conv_tiles", pathlib.Path(__file__).with_name("test_torch_conv_tiles.py"))
    tiles = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tiles)
    want = {(8, 64 >> lv, 64 >> lv, ci, co) for lv, ci, co, pro in tiles.UNET_CONVS if pro}
    assert {s for s, _ in K7_SHAPES} == want


def _coverage(plan, h, w):
    cover = np.zeros((h, w), np.int64)
    for y0 in range(0, h, plan.th):
        for x0 in range(0, w, plan.tw):
            cover[y0:y0 + plan.th, x0:x0 + plan.tw] += 1
    return cover


def _parts(total: int, splits: int):
    """The C entry's split of ``total`` items over ``splits`` blocks."""
    return [(i * total // splits, (i + 1) * total // splits) for i in range(splits)]


@pytest.mark.parametrize("shape", [s for s, _ in K7_SHAPES])
@pytest.mark.parametrize("sms", [SMS, 114])  # an H100 SXM's, and an H100 PCIe's
def test_conv3x3_q_plan_at_every_path_shape(shape, sms):
    b, h, w, cin, cout = shape
    plan = conv.conv3x3_q_plan(*shape, sms)
    assert conv.K7_VARIANTS[(plan.bm, plan.bn)] == plan.stages
    # the column width that finishes in the fewest waves x columns: on an
    # H100 SXM 160 at Cout 320 and at 32^2 x 640, else 128
    widths = [n for n in (128, 160) if cout % n == 0 and (plan.bm, n) in conv.K7_VARIANTS] or [64]
    tiles1 = b * -(-h // plan.th) * -(-w // plan.tw)
    cost = {n: -(-tiles1 * -(-cout // n) // (2 * sms)) * n for n in widths}
    assert plan.bn in widths and cost[plan.bn] == min(cost.values()), (plan, cost)
    if sms == SMS:
        assert plan.bn == (160 if cout == 320 or (h, cout) == (32, 640) else 128), plan
    # every output pixel in one rectangle, every column in one block, every
    # 128-channel chunk in one K part, none empty
    assert plan.th * plan.tw <= plan.bm and plan.th <= h and plan.tw <= w
    assert (_coverage(plan, h, w) == 1).all()
    tiles, cols, ks = plan.grid(b, h, w, cout)
    assert cols * plan.bn >= cout > (cols - 1) * plan.bn
    nchunks = -(-cin // conv.K7_CHUNK)
    chunks = np.zeros(nchunks, np.int64)
    for c0, c1 in _parts(nchunks, ks):
        assert c1 > c0
        chunks[c0:c1] += 1
    assert (chunks == 1).all() and ks <= conv.K7_MAX_KSPLIT
    # fits a block, and two blocks an SM (the launch bound's)
    assert plan.smem <= SMEM_BLOCK and 2 * (plan.smem + 1024) <= SMEM_SM, plan
    # split-K only where the tiles leave SMs without a block: the most parts
    # that fit one wave of two blocks an SM
    if tiles * cols >= sms:
        assert ks == 1, plan
    else:
        assert ks == min(2 * sms // (tiles * cols), nchunks, conv.K7_MAX_KSPLIT), plan
        assert tiles * cols * ks <= 2 * sms < tiles * cols * (ks + 1) or ks == nchunks, plan


def test_conv3x3_q_plan_splits_the_8x8_stage_only():
    ks = {shape: conv.conv3x3_q_plan(*shape, SMS).ksplit for shape, _ in K7_SHAPES}
    assert all(k == 1 for s, k in ks.items() if s[1] >= 16)
    assert all(k == 3 for s, k in ks.items() if s[1] == 8)
    assert conv.conv3x3_q_plan(8, 8, 8, 2560, 1280, SMS).bm == 64


def test_conv3x3_q_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="K7"):
        conv.conv3x3_q_plan(1, 8, 8, 48, 64, SMS)


# ---------------------------------------------------------------------------
# The emulation of the two launches
# ---------------------------------------------------------------------------


def emulate_k7(x, weight_q, s_x, out_scale, bias, scale_shift, plan, seed=0, halo="zero",
               drop_tap=None):
    """K7's schedule in plain torch (exact int64 products, f32 epilogue):
    returns (y, acc), acc the int32 sums each output's epilogue read.
    Negative controls: ``halo`` "edge" fills out-of-image halo pixels with
    the nearest pixel's codes instead of zeros; "unswizzled" stores the
    halo's pieces in order while the taps read them swizzled; ``drop_tap``
    leaves one tap out."""
    b, h, w, cin = x.shape
    cout = weight_q.shape[0]
    th, tw, bm, bn, ch = plan.th, plan.tw, plan.bm, plan.bn, conv.K7_CHUNK
    taps = conv.taps_q(weight_q).reshape(9, cout, cin).to(torch.int64)
    xn = x if scale_shift is None else gn_silu_prologue(x, scale_shift)
    codes = quantize_act(xn, s_x).to(torch.int64)  # the first launch
    hw2, hpix = tw + 2, (th + 2) * (tw + 2)
    pix = torch.arange(hpix)
    hy, hx = pix // hw2, pix % hw2
    slot = torch.arange(8)[None, :] ^ (pix[:, None] & 7)  # piece j of pixel p lives in slot[p, j]
    m = torch.arange(bm)
    hp0 = torch.where(m < th * tw, (m // tw) * hw2 + m % tw, 0)  # GEMM row -> halo pixel, tap (0, 0)
    nchunks = -(-cin // ch)
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    ncols = -(-cout // bn)
    ws = torch.zeros(b, h, w, cout, dtype=torch.int64)
    tickets = torch.zeros(b * tiles_y * tiles_x, ncols, dtype=torch.int64)
    y = torch.full((b, h, w, cout), float("nan"))
    acc_seen = torch.full((b, h, w, cout), -(2 ** 40), dtype=torch.int64)
    blocks = [(t, cb, part) for t in range(b * tiles_y * tiles_x) for cb in range(ncols)
              for part in _parts(nchunks, plan.ksplit)]
    for i in np.random.default_rng(seed).permutation(len(blocks)):
        t, cb, (c_begin, c_end) = blocks[i]
        bi, ty, tx = t // (tiles_y * tiles_x), t // tiles_x % tiles_y, t % tiles_x
        y0, x0, n0 = ty * th, tx * tw, cb * bn
        gy, gx = y0 + hy - 1, x0 + hx - 1
        inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
        ncol = torch.arange(n0, n0 + bn)
        acc = torch.zeros(bm, bn, dtype=torch.int64)
        for c in range(c_begin, c_end):
            chans = torch.arange(c * ch, (c + 1) * ch)
            live = chans < cin
            vals = codes[bi, gy.clamp(0, h - 1), gx.clamp(0, w - 1)][:, chans.clamp(max=cin - 1)]
            if halo == "edge":
                ok = live[None, :].expand(hpix, ch)
            else:
                ok = inside[:, None] & live[None, :]
            fill = torch.where(ok, vals, 0)
            buf = torch.zeros(hpix, 8, 16, dtype=torch.int64)
            stored = torch.arange(8).expand(hpix, 8) if halo == "unswizzled" else slot
            buf[pix[:, None], stored] = fill.view(hpix, 8, 16)
            wc = torch.where(live[None, :] & (ncol < cout)[:, None],
                             taps[:, ncol.clamp(max=cout - 1)][:, :, chans.clamp(max=cin - 1)], 0)
            for tap in range(9):
                if tap == drop_tap:
                    continue
                rows = hp0 + (tap // 3) * hw2 + tap % 3
                a = buf[rows[:, None], slot[rows]].reshape(bm, ch)
                acc += a @ wc[tap].T
        assert acc.abs().max() < 2 ** 31  # an int32 sum
        pixels = [(r, y0 + r // tw, x0 + r % tw) for r in range(th * tw)
                  if y0 + r // tw < h and x0 + r % tw < w]
        cols = slice(n0, min(n0 + bn, cout))
        if plan.ksplit > 1:
            for r, yy, xx in pixels:
                ws[bi, yy, xx, cols] += acc[r, :cols.stop - n0]
            tickets[t, cb] += 1
            if tickets[t, cb] < plan.ksplit:
                continue
            for r, yy, xx in pixels:
                acc[r, :cols.stop - n0] = ws[bi, yy, xx, cols]
                ws[bi, yy, xx, cols] = 0
            tickets[t, cb] = 0
        for r, yy, xx in pixels:
            part = acc[r, :cols.stop - n0]
            acc_seen[bi, yy, xx, cols] = part
            out = part.float() * out_scale[cols]
            y[bi, yy, xx, cols] = out if bias is None else out + bias[cols]
    assert not ws.any() and not tickets.any()  # left zero for the next call
    return y, acc_seen


def _inputs(shape, seed=0):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin), dtype=np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, cin, 3, 3)).astype(np.int8))
    w_scale = torch.from_numpy(rng.uniform(0.5, 1.0, cout).astype(np.float32) / (9 * cin))
    bias = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32) * 0.1)
    # shift ~2: silu(shift) ~1.8, many codes, so a halo not zero-filled would show
    scale = 1 + 0.1 * rng.standard_normal((b, 1, cin), dtype=np.float32)
    shift = 2 + 0.3 * rng.standard_normal((b, 1, cin), dtype=np.float32)
    ss = torch.from_numpy(np.concatenate([scale, shift], axis=1))
    act = gn_silu_prologue(x, ss).abs().amax() * 0.9  # a few codes clip
    return x, wq, w_scale, bias, ss, act


def _exact(x, wq, act, ss):
    """The plain version's int32 sums: its codes convolved in exact integers."""
    codes = quantize_act(gn_silu_prologue(x, ss), act_step(act, floor=True))
    acc = torch.nn.functional.conv2d(codes.permute(0, 3, 1, 2).double(), wq.double(), padding=1)
    return acc.permute(0, 2, 3, 1).round().to(torch.int64)


# (shape, sms): Cin = 320 (a ragged last chunk) split over three parts on
# a small card; a 64-row 8 x 8 tile split in two; rectangles past the image
# and columns past Cout; 40 columns of a 64-wide block; 160 columns.  (JAX's
# Pallas conv plans images of 256 pixels and more: the 8 x 8 one is held to
# the plain version alone.)
EMU_CASES = [((1, 8, 32, 320, 64), 3), ((2, 8, 8, 256, 128), SMS), ((1, 10, 32, 96, 136), 4),
             ((1, 12, 32, 320, 40), 1), ((1, 16, 16, 128, 320), SMS)]


@pytest.mark.parametrize("case", EMU_CASES)
def test_k7_schedule_matches_plain_and_jax(case):
    shape, sms = case
    x, wq, w_scale, bias, ss, act = _inputs(shape, seed=sum(shape))
    s_x, out_scale = folded_scales(w_scale, act, floor=True)
    plan = conv.conv3x3_q_plan(*shape, sms)
    if sms == 3:
        assert plan.ksplit == 3, plan  # the ragged chunk in a part of its own
    if shape[1] == 8 and shape[2] == 8:
        assert plan.bm == 64 and plan.ksplit == 2, plan
    y, acc = emulate_k7(x, wq, s_x, out_scale, bias, ss, plan, seed=shape[1])
    assert torch.equal(acc, _exact(x, wq, act, ss))
    plain = conv.conv3x3_w8a8_plain(x, wq, w_scale, act, bias, ss)
    torch.testing.assert_close(y, plain, rtol=1e-5, atol=1e-5 * plain.abs().max().item())
    if shape[1] * shape[2] < 256:
        return
    xn = gn_silu_prologue(x, ss).numpy()
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(jconv._conv3x3_q(jnp.asarray(xn), wq.permute(2, 3, 1, 0).numpy(),
                                          w_scale.numpy(), jnp.asarray(act.numpy()), bias.numpy()))
    np.testing.assert_allclose(y.numpy(), pal, atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize("control", ["edge", "unswizzled", "tap"])
def test_k7_schedule_negative_controls(control):
    """A halo that is not zero-filled out of the image, a halo stored
    without the swizzle its reads assume, and a dropped tap must each move
    the int32 sums off the plain version's."""
    shape = (1, 8, 8, 64, 64)
    x, wq, w_scale, bias, ss, act = _inputs(shape, seed=3)
    s_x, out_scale = folded_scales(w_scale, act, floor=True)
    plan = conv.conv3x3_q_plan(*shape, SMS)
    want = _exact(x, wq, act, ss)
    _, acc = emulate_k7(x, wq, s_x, out_scale, bias, ss, plan)
    assert torch.equal(acc, want)
    kw = {"drop_tap": 4} if control == "tap" else {"halo": control}
    _, acc = emulate_k7(x, wq, s_x, out_scale, bias, ss, plan, **kw)
    assert not torch.equal(acc, want)
