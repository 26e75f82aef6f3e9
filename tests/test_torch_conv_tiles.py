"""K2's tiling on the CPU: the planner (``ops/conv.conv3x3_plan``) at every K2
shape of the port's paths, and a plain-torch emulation of the kernel's
schedule (csrc/conv3x3.cu) held against the plain conv.

The emulation follows the kernel's addressing: for each split, each output
rectangle and each 64-channel chunk, a halo tile of (th+2) x (tw+2) pixels
is zero-filled and stored in XOR-swizzled 16-byte pieces, the GroupNorm+SiLU
prologue is applied in place to its in-image positions only, and each GEMM
row reads its pixel's halo row shifted by the tap; split-K partial sums are
added in split order.  It runs in f32, so it must equal
``conv3x3_scale_shift_plain`` up to summation order: max|emulated - plain|
<= 1e-5 * max|plain| (f32 sums of up to 9 x 128 terms in two orders).  It
is a test helper, not used on the main path.
"""

import numpy as np
import pytest
import torch

from stable_diffusion_tpu_torch.ops import conv

SMS = 132  # an H100 SXM's SMs
SMEM_BLOCK, SMEM_SM = 232448, 233472  # shared memory a block can use, and an SM has (227, 228 KB)

# (level, Cin, Cout, prologue) of every K2 conv in the UNet (SD1.5 and SD2.1
# share the topology; the latent side is divided by 2**level) and in the VAE
# decoder (the latent side multiplied by 2**level); prologue False: the
# upsamplers' convs.
UNET_CONVS = [(0, 320, 320, True), (0, 640, 320, True), (0, 960, 320, True), (0, 640, 640, False),
              (1, 320, 640, True), (1, 640, 640, True), (1, 960, 640, True), (1, 1280, 640, True),
              (1, 1920, 640, True), (1, 1280, 1280, False), (2, 640, 1280, True),
              (2, 1280, 1280, True), (2, 1920, 1280, True), (2, 2560, 1280, True),
              (2, 1280, 1280, False), (3, 1280, 1280, True), (3, 2560, 1280, True)]
VAE_CONVS = [(0, 512, 512, True), (1, 512, 512, True), (1, 512, 512, False), (2, 256, 256, True),
             (2, 512, 256, True), (2, 512, 512, False), (3, 128, 128, True), (3, 256, 128, True),
             (3, 256, 256, False)]


# (level, Cin, Cout) of every K2 conv in the VAE encoder (all with the
# GN+SiLU prologue; the latent side multiplied by 2**level): its stride-2
# downsamplers and conv_in / conv_out are plain convs.
ENC_CONVS = [(3, 128, 128), (2, 128, 256), (2, 256, 256), (1, 256, 512), (1, 512, 512),
             (0, 512, 512)]


def _enc(b, side):
    return [(b, side << lv, side << lv, ci, co) for lv, ci, co in ENC_CONVS]


def _unet(b, side, dx=False):
    return [(b, side >> lv, side >> lv, *((co, ci) if dx else (ci, co))) for lv, ci, co, _ in UNET_CONVS]


def _vae(b, side):
    return [(b, side << lv, side << lv, ci, co) for lv, ci, co, _ in VAE_CONVS]


PATHS = {
    "serve_sd15": _unet(2, 64) + _vae(1, 64),        # CFG UNet at 64^2 latents, VAE to 512^2
    "sd21": _unet(2, 96) + _vae(1, 96),              # 96^2 latents, VAE to 768^2
    "w8a8": _unet(8, 64) + _vae(4, 64),              # b4 requests: UNet batch 8, VAE batch 4
    "train_forward": _unet(4, 64),                   # b4 train step
    "train_dx": _unet(4, 64, dx=True),               # the input gradient: Cin and Cout swapped
    "img2img_b4": _enc(1, 64) + _unet(8, 64) + _vae(4, 64),  # encoder b1, CFG UNet b8, decoder b4
    "cli_b1": _unet(1, 64) + _vae(1, 64),            # the CLI's default (no CFG) and one-step b1
    "one_step_b4": _unet(4, 64) + _vae(4, 64),       # one-step --batch_size 4
}


def _coverage(plan, h, w):
    cover = np.zeros((h, w), np.int64)
    for y0 in range(0, h, plan.th):
        for x0 in range(0, w, plan.tw):
            cover[y0:y0 + plan.th, x0:x0 + plan.tw] += 1
    return cover


@pytest.mark.parametrize("path", sorted(PATHS))
def test_plan_at_every_path_shape(path):
    for b, h, w, cin, cout in PATHS[path]:
        plan = conv.conv3x3_plan(b, h, w, cin, cout, SMS)
        shape = (b, h, w, cin, cout, plan)
        assert conv.K2_VARIANTS[(plan.bm, plan.bn)] == plan.stages, shape
        assert plan.bn == (128 if cout % 128 == 0 else
                           160 if cout % 160 == 0 and plan.bm == 128 else 64), shape
        # the rectangles tile each image exactly once and none is larger than it
        assert plan.th * plan.tw <= plan.bm and plan.th <= h and plan.tw <= w, shape
        assert (_coverage(plan, h, w) == 1).all(), shape
        # two blocks fit an SM (1 KB of each block's is reserved)
        assert plan.smem <= SMEM_BLOCK and 2 * (plan.smem + 1024) <= SMEM_SM, shape
        # split-K: the fewest splits that give two blocks per SM, whole chunks, at most 16
        tiles, cols, ks = plan.grid(b, h, w, cout)
        nchunks = -(-cin // conv.K2_CHUNK)
        assert 1 <= ks <= min(nchunks, conv.K2_MAX_KSPLIT), shape
        if tiles * cols >= 2 * SMS:
            assert ks == 1, shape
        if ks > 1:
            assert tiles * cols * (ks - 1) < 2 * SMS, shape
            if ks < min(nchunks, conv.K2_MAX_KSPLIT):
                assert tiles * cols * ks >= 2 * SMS, shape


@pytest.mark.parametrize("shape,tile", [((2, 64, 64, 320, 320), (8, 16, 128, 160)),
                                        ((2, 64, 64, 320, 40), (8, 16, 128, 64)),
                                        ((1, 512, 512, 128, 128), (8, 16, 128, 128)),
                                        ((2, 8, 8, 2560, 1280), (8, 8, 64, 128)),
                                        ((2, 12, 12, 2560, 1280), (5, 12, 64, 128)),
                                        ((2, 24, 24, 1280, 1280), (5, 24, 128, 128))])
def test_plan_tiles(shape, tile):
    """8 x 16 where the image allows it; small images get a narrower tile;
    160 columns where Cout is a multiple of 160 but not of 128."""
    plan = conv.conv3x3_plan(*shape, SMS)
    assert (plan.th, plan.tw, plan.bm, plan.bn) == tile


def test_k2_taps_layout():
    w = torch.randn(24, 16, 3, 3)
    taps = conv.k2_taps(w)
    assert taps.shape == (3, 3, 24, 16) and taps.is_contiguous()
    for ky in range(3):
        for kx in range(3):
            torch.testing.assert_close(taps[ky, kx], w[:, :, ky, kx], rtol=0, atol=0)
    torch.testing.assert_close(conv.k2_taps(w, transposed=True), conv.k2_taps(conv.flip_io(w)),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The emulation of the kernel's schedule
# ---------------------------------------------------------------------------


def emulate_k2(x, weight, bias, scale_shift, plan):
    """K2's schedule in plain f32 torch (see the module docstring)."""
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    th, tw, bm, ch = plan.th, plan.tw, plan.bm, conv.K2_CHUNK
    taps = conv.k2_taps(weight).reshape(9, cout, cin)
    hw2 = tw + 2
    hpix = (th + 2) * hw2
    pix = torch.arange(hpix)
    hy, hx = pix // hw2, pix % hw2
    slot = torch.arange(8)[None, :] ^ (pix[:, None] & 7)  # piece j of pixel p lives in slot[p, j]
    m = torch.arange(bm)
    hp0 = torch.where(m < th * tw, (m // tw) * hw2 + m % tw, 0)  # GEMM row -> halo pixel, tap (0, 0)
    nchunks = -(-cin // ch)
    partial = torch.zeros(plan.ksplit, b, h, w, cout)
    for z in range(plan.ksplit):
        c_begin, c_end = z * nchunks // plan.ksplit, (z + 1) * nchunks // plan.ksplit
        for bi in range(b):
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    gy, gx = y0 + hy - 1, x0 + hx - 1
                    inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
                    acc = torch.zeros(bm, cout)
                    for c in range(c_begin, c_end):
                        chans = torch.arange(c * ch, (c + 1) * ch)
                        ok = inside[:, None] & (chans < cin)[None, :]
                        vals = x[bi, gy.clamp(0, h - 1), gx.clamp(0, w - 1)][:, chans.clamp(max=cin - 1)]
                        halo = torch.zeros(hpix, 8, 8)
                        halo[pix[:, None], slot] = torch.where(ok, vals, 0.0).view(hpix, 8, 8)
                        if scale_shift is not None:  # in place, in-image positions only
                            # slot q of pixel p holds piece q ^ (p & 7) = slot[p, q]
                            held = chans.clamp(max=cin - 1).view(8, 8)[slot]
                            sc, sh = scale_shift[bi, 0][held], scale_shift[bi, 1][held]
                            live = torch.zeros(hpix, 8, 8, dtype=torch.bool)
                            live[pix[:, None], slot] = ok.view(hpix, 8, 8)
                            halo = torch.where(live, torch.nn.functional.silu(halo * sc + sh), halo)
                        wc = torch.where((chans < cin)[None, :],
                                         taps[:, :, chans.clamp(max=cin - 1)], 0.0)
                        for tap in range(9):
                            rows = hp0 + (tap // 3) * hw2 + tap % 3
                            a = halo[rows[:, None], slot[rows]].reshape(bm, ch)
                            acc += a @ wc[tap].T
                    for r in range(th * tw):
                        yy, xx = y0 + r // tw, x0 + r % tw
                        if yy < h and xx < w:
                            partial[z, bi, yy, xx] = acc[r]
    y = partial[0]
    for z in range(1, plan.ksplit):  # the reduce's fixed order
        y = y + partial[z]
    return y if bias is None else y + bias


def _close(got, want):
    assert got.shape == want.shape
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= 1e-5, err


def _inputs(shape, prologue, seed=0):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin), dtype=np.float32))
    wt = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3), dtype=np.float32) * (9 * cin) ** -0.5)
    bias = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32) * 0.1)
    ss = None
    if prologue:  # shift ~3: silu(shift) ~2.9, so an activated zero halo would show
        scale = 1 + 0.1 * rng.standard_normal((b, 1, cin), dtype=np.float32)
        shift = 3 + 0.1 * rng.standard_normal((b, 1, cin), dtype=np.float32)
        ss = torch.from_numpy(np.concatenate([scale, shift], axis=1))
    return x, wt, bias, ss


@pytest.mark.parametrize("shape", [(1, 5, 7, 64, 40), (2, 6, 6, 96, 32), (2, 8, 8, 128, 64)])
@pytest.mark.parametrize("prologue", [True, False])
def test_emulated_schedule_matches_plain(shape, prologue):
    x, wt, bias, ss = _inputs(shape, prologue)
    plan = conv.conv3x3_plan(*shape, SMS)
    if shape[3] > conv.K2_CHUNK:
        assert plan.ksplit > 1, plan
    got = emulate_k2(x, wt, bias, ss, plan)
    _close(got, conv.conv3x3_scale_shift_plain(x, wt, bias, ss))


@pytest.mark.parametrize("plan", [conv.Conv3x3Plan(8, 16, 128, 64, 6, 2),
                                  conv.Conv3x3Plan(3, 20, 64, 128, 4, 1)])
def test_emulated_schedule_ragged_tiles(plan):
    """A rectangle that overhangs the image on both sides and a column block
    that overhangs Cout (136 = 2 x 64 + 8)."""
    shape = (1, 10, 20, 128, 136)
    x, wt, bias, ss = _inputs(shape, True, seed=1)
    got = emulate_k2(x, wt, bias, ss, plan)
    _close(got, conv.conv3x3_scale_shift_plain(x, wt, bias, ss))
