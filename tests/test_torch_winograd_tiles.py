"""K12's schedule on the CPU: the planner (``ops/winograd.winograd_plan``)
at every K12 shape of the switched SD2.1 768^2 step, and a plain-torch
emulation of the kernel's F-fold (csrc/winograd.cu) held against the plain
version and the JAX package's Winograd conv.

The emulation follows the kernel block by block: a region of 64 tiles of
one image and 64 output channels; its input halo, (2 th + 2) x (2 tw + 2)
pixels, activated once (the GN+SiLU prologue, zero outside the image after
the activation); Cin in chunks of 64, each chunk four steps k2 = 0..3 in
which V[k1][k2] = B^T (d B[:, k2]) is built in f32 and rounded to the input
dtype, and the position products accumulate into F[o1][k2] with A^T's
signs (F[0] += M0 + M1 + M2, F[1] += M1 - M2 - M3); the epilogue applies A^T
on the other side and adds the bias.  In f32 it must equal
``conv3x3_winograd_plain`` within 1e-5 of the largest output and JAX's
``conv3x3_winograd`` (in interpret mode, as tests/test_torch_winograd.py
runs it) within 1e-4; with one position's sign flipped it must not.  These
are test helpers, not used on the main path.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from stable_diffusion_tpu.ops import winograd as jwg
from stable_diffusion_tpu_torch.ops import winograd as W
from stable_diffusion_tpu_torch.ops.groupnorm import gn_scale_shift_plain, gn_silu_prologue

# (B, H, W, Cin, Cout, prologue) of every K12 call in one switched SD2.1
# 768^2 CFG step (chip_smoke.py phase 8 records the same 24 keys): the UNet
# at 96^2 / 48^2 / 24^2 (the up path's concatenations included) at batch 2,
# the VAE decoder from 96^2 to 768^2 at batch 1.
SD21_SHAPES = [
    (2, 96, 96, 320, 320, True), (2, 96, 96, 640, 320, True), (2, 96, 96, 640, 640, False),
    (2, 96, 96, 960, 320, True), (2, 48, 48, 320, 640, True), (2, 48, 48, 640, 640, True),
    (2, 48, 48, 960, 640, True), (2, 48, 48, 1280, 640, True), (2, 48, 48, 1280, 1280, False),
    (2, 48, 48, 1920, 640, True), (2, 24, 24, 640, 1280, True), (2, 24, 24, 1280, 1280, False),
    (2, 24, 24, 1280, 1280, True), (2, 24, 24, 1920, 1280, True), (2, 24, 24, 2560, 1280, True),
    (1, 96, 96, 512, 512, True), (1, 192, 192, 512, 512, False), (1, 192, 192, 512, 512, True),
    (1, 384, 384, 512, 512, False), (1, 384, 384, 512, 256, True), (1, 384, 384, 256, 256, True),
    (1, 768, 768, 256, 256, False), (1, 768, 768, 256, 128, True), (1, 768, 768, 128, 128, True),
]


@pytest.mark.parametrize("shape", SD21_SHAPES + [(1, 16, 18, 40, 24, False), (3, 10, 40, 96, 72, True)])
def test_winograd_plan_covers_every_tile_once(shape):
    b, h, w, cin, cout, _ = shape
    plan = W.winograd_plan(b, h, w, cin, cout)
    th, tw = plan.region
    assert plan.region in W.WINO_REGIONS and th * tw == W.WINO_TILES
    assert plan.smem == W.WINO_SMEM <= 232448
    assert (2 * th + 2) * (2 * tw + 2) <= 340  # the kernel's halo buffer
    ry, rx = -(-(h // 2) // th), -(-(w // 2) // tw)
    assert plan.grid == (b * ry * rx, -(-cout // W.WINO_BN)) and plan.chunks == -(-cin // W.WINO_KC)
    cover = np.zeros((b, h // 2, w // 2), np.int64)
    for r in range(plan.grid[0]):
        bi, rem = divmod(r, ry * rx)
        ty0, tx0 = rem // rx * th, rem % rx * tw
        cover[bi, ty0:ty0 + th, tx0:tx0 + tw] += 1
    assert (cover == 1).all()
    cols = np.zeros(cout, np.int64)
    for n in range(plan.grid[1]):
        cols[n * W.WINO_BN:(n + 1) * W.WINO_BN] += 1
    assert (cols == 1).all()
    # no region shape pads the tiles less than the one chosen
    pad = lambda r: -(-(h // 2) // r[0]) * r[0] * -(-(w // 2) // r[1]) * r[1]  # noqa: E731
    assert pad(plan.region) == min(pad(r) for r in W.WINO_REGIONS)


_JA, _JB, _PLUS = (0, 1, 2, 1), (2, 2, 1, 3), (False, True, False, False)


def emulate_k12(x, weight, bias, scale_shift, plan, flip=None):
    """K12's F-fold schedule in plain torch, in x's dtype for V and U and
    f32 for the sums.  ``flip`` = (o1, k1) negates that term of the fold
    (the negative control)."""
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    dt = x.dtype
    if scale_shift is not None:
        x = gn_silu_prologue(x, scale_shift)  # the prologue, rounded to x's dtype
    u = W.transform_kernel(weight.to(dt).permute(2, 3, 1, 0)).float()  # (16, Cin, Cout)
    th, tw = plan.region
    ry, rx = -(-(h // 2) // th), -(-(w // 2) // tw)
    # the zero halo, after the activation, wide enough for partial regions
    xp = F.pad(x.float(), (0, 0, 1, 2 * tw * rx - w + 1, 1, 2 * th * ry - h + 1))
    y = torch.zeros(b, h, w, cout)
    signs = {(0, 0): 1, (0, 1): 1, (0, 2): 1, (1, 1): 1, (1, 2): -1, (1, 3): -1}
    if flip is not None:
        signs[flip] = -signs[flip]
    for r in range(plan.grid[0]):
        bi, rem = divmod(r, ry * rx)
        ty0, tx0 = rem // rx * th, rem % rx * tw
        halo = xp[bi, 2 * ty0:2 * ty0 + 2 * th + 2, 2 * tx0:2 * tx0 + 2 * tw + 2]  # (2th+2, 2tw+2, Cin)
        # d[tile, i, j, c]: the 4x4 patch of each of the region's tiles, row-major
        d = halo.unfold(0, 4, 2).unfold(1, 4, 2).permute(0, 1, 3, 4, 2).reshape(th * tw, 4, 4, cin)
        for nb in range(plan.grid[1]):
            n0, n1 = nb * W.WINO_BN, min(cout, (nb + 1) * W.WINO_BN)
            fs = torch.zeros(2, 4, th * tw, n1 - n0)
            for c in range(plan.chunks):
                c0, c1 = c * W.WINO_KC, min(cin, (c + 1) * W.WINO_KC)
                for k2 in range(4):
                    da, db = d[:, :, _JA[k2], c0:c1], d[:, :, _JB[k2], c0:c1]
                    wv = da + db if _PLUS[k2] else da - db  # (tiles, 4, chunk)
                    v = [wv[:, 0] - wv[:, 2], wv[:, 1] + wv[:, 2], wv[:, 2] - wv[:, 1], wv[:, 1] - wv[:, 3]]
                    for k1 in range(4):
                        m = v[k1].to(dt).float() @ u[k1 * 4 + k2, c0:c1, n0:n1]
                        for o1 in range(2):
                            if (o1, k1) in signs:
                                fs[o1, k2] += signs[(o1, k1)] * m
            bias_f = 0 if bias is None else bias[n0:n1].float()
            for o1 in range(2):
                y0 = fs[o1, 0] + fs[o1, 1] + fs[o1, 2] + bias_f
                y1 = fs[o1, 1] - fs[o1, 2] - fs[o1, 3] + bias_f
                for t in range(th * tw):
                    ty, tx = ty0 + t // tw, tx0 + t % tw
                    if ty < h // 2 and tx < w // 2:
                        y[bi, 2 * ty + o1, 2 * tx, n0:n1] = y0[t]
                        y[bi, 2 * ty + o1, 2 * tx + 1, n0:n1] = y1[t]
    return y


def _inputs(seed, b, h, w, cin, cout, prologue):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin)).astype(np.float32))
    k = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3)) * (9 * cin) ** -0.5).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.1)
    ss = None
    if prologue:
        gw = torch.from_numpy(1 + 0.1 * rng.standard_normal(cin).astype(np.float32))
        gb = torch.from_numpy(0.1 * rng.standard_normal(cin).astype(np.float32))
        ss = gn_scale_shift_plain(x, gw, gb, 8 if cin % 32 else 32)
    return x, k, bias, ss


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


# (B, H, W, Cin, Cout, prologue): each region shape (8 x 8, 4 x 16),
# partial regions (20 x 12 tiles), a partial last chunk of Cin and a
# partial last block of Cout.
EMU_CASES = [(1, 16, 16, 128, 128, True), (2, 8, 32, 96, 72, False), (1, 40, 24, 96, 72, True),
             (1, 32, 8, 64, 136, False)]


@pytest.mark.parametrize("case", EMU_CASES)
def test_k12_schedule_matches_plain_and_jax(case):
    b, h, w, cin, cout, prologue = case
    x, k, bias, ss = _inputs(sum(case[:5]), *case)
    plan = W.winograd_plan(b, h, w, cin, cout)
    got = emulate_k12(x, k, bias, ss, plan)
    want = W.conv3x3_winograd_plain(x, k, bias, ss)
    assert _rel(got, want) < 1e-5
    xin = gn_silu_prologue(x, ss) if prologue else x
    with pltpu.force_tpu_interpret_mode():
        jx = jwg.conv3x3_winograd(jnp.asarray(xin.numpy()), jnp.asarray(k.permute(2, 3, 1, 0).numpy()),
                                  jnp.asarray(bias.numpy()))
    assert _rel(got, torch.from_numpy(np.asarray(jx))) < 1e-4


def test_k12_regions_of_each_shape():
    """The emulation cases reach each region shape."""
    assert {W.winograd_plan(*c[:5]).region for c in EMU_CASES} == set(W.WINO_REGIONS)


@pytest.mark.parametrize("flip", [(1, 3), (0, 2)])
def test_k12_schedule_catches_a_flipped_sign(flip):
    """The negative control: one position's sign flipped in the fold must
    miss the plain version by far more than the tolerance."""
    x, k, bias, ss = _inputs(7, 1, 16, 16, 64, 64, False)
    plan = W.winograd_plan(1, 16, 16, 64, 64)
    want = W.conv3x3_winograd_plain(x, k, bias, ss)
    assert _rel(emulate_k12(x, k, bias, ss, plan), want) < 1e-5
    assert _rel(emulate_k12(x, k, bias, ss, plan, flip=flip), want) > 1e-2
