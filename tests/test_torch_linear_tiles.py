"""K10/K11's schedule on the CPU: the planner (``ops/linear.linear_plan``) at
every K10/K11 shape of the switched SD2.1 768^2 and SD1.5 512^2 CFG UNet
steps, enumerated from ``UNetConfig.sd21()`` / ``sd15()``, and a plain-torch
emulation of the kernel's two schedules (csrc/linear.cu) held against the
plain versions and the JAX package's XLA forms.

The emulation follows the kernel block by block, in a shuffled block order.
Schedule R: a block takes its rows of x over all of K, applies the prologue
once (LN: f32 statistics of each row over all of K, two passes; GN: each
row's own image's folded scale/shift, img = row / rows_per_img) and walks
its contiguous range of N tiles, each tile's f32 sum taken 64 channels at a
time.  Schedule S: a block takes one tile and its K part's 64-channel
chunks of x and W (a prologue, where there is one, applied to each chunk
with statistics over all of K); with a K split each part writes an f32
partial tile and the reduce adds them in split order.  The epilogue adds
the bias and the residual to the f32 sum.  In f32 the result must equal
``linear_plain`` / ``gn_matmul_plain`` within 1e-5 of the largest output
and JAX ``_mm_xla`` / ``_gn_mm_xla`` on the same numpy inputs within 1e-5;
LN statistics taken over the first K chunk only, or GN reading the block's
first image for every row, must not.  These are test helpers, not used on
the main path.
"""

import collections
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_diffusion_tpu.ops import linear as jlin
from stable_diffusion_tpu_torch.models.unet import UNetConfig
from stable_diffusion_tpu_torch.ops import linear as L
from stable_diffusion_tpu_torch.ops.groupnorm import gn_scale_shift_plain
from tests.torch_threads import one_thread  # noqa: F401

SMS = 132  # an H100 SXM's SMs
TOL = 1e-5


def unet_sites(cfg: UNetConfig, batch: int, side: int) -> collections.Counter:
    """Every K10/K11 call of one UNet pass at ``batch`` x ``side``^2 latents
    with SD_TPU_FUSED_MM on, as models/unet.py and models/attention.py make
    them: ("ln" | "res" | "gn", M, K, N, rows a sample) -> calls.  A
    transformer: GN -> ``conv_input`` (K11), the fused QKV and the cross
    q (LN), the two attention out projections and ``conv_output``
    (residual); a resblock whose width changes: its skip projection
    (residual)."""
    bc = list(cfg.block_out_channels)
    n = cfg.num_stages
    has = cfg.stage_has_attention
    calls = collections.Counter()

    def transformer(c, s):
        m = batch * s
        calls[("gn", m, c, c, s)] += 1
        calls[("ln", m, c, 3 * c, s)] += 1
        calls[("ln", m, c, c, s)] += 1
        calls[("res", m, c, c, s)] += 3

    def resblock(ci, co, s):
        if ci != co:
            calls[("res", batch * s, ci, co, s)] += 1

    block_in = [bc[0]] + bc
    for i in range(n):
        s = (side >> i) ** 2
        for j in range(cfg.layers_per_block):
            resblock(block_in[i] if j == 0 else bc[i], bc[i], s)
            if has[i]:
                transformer(bc[i], s)
    s = (side >> (n - 1)) ** 2
    resblock(bc[-1], bc[-1], s)
    transformer(bc[-1], s)
    dec_in = bc + [bc[-1]]
    for i in reversed(range(n)):
        s, out = (side >> i) ** 2, bc[i]
        mid_in = dec_in[i - 1] if i > 0 else bc[0]
        ins = [dec_in[i + 1] + out, out + out, out + mid_in]
        for j in range(cfg.layers_per_block + 1):
            resblock(ins[j], out, s)
            if has[i]:
                transformer(out, s)
    return calls


PATHS = {"sd21": unet_sites(UNetConfig.sd21(), 2, 96), "sd15": unet_sites(UNetConfig.sd15(), 2, 64)}
PROLOGUE = {"ln": "ln", "res": "none", "gn": "gn"}


def test_the_sites_are_the_switched_steps():
    """94 K10 and 16 K11 calls a CFG step (as chip_smoke.py phase 8 counts
    them at SD2.1), at M = 18432 / 4608 / 1152 / 288 for SD2.1."""
    for path, calls in PATHS.items():
        k11 = sum(v for key, v in calls.items() if key[0] == "gn")
        assert (sum(calls.values()) - k11, k11) == (94, 16), path
    assert {key[1] for key in PATHS["sd21"]} == {18432, 4608, 1152, 288}
    assert max(key[2] for key in PATHS["sd21"]) == 2560


def _parts(total: int, splits: int):
    """The C entry's split of ``total`` items over ``splits`` blocks."""
    return [(i * total // splits, (i + 1) * total // splits) for i in range(splits)]


def _check_plan(plan, m, k, n, prologue, sms=SMS):
    assert plan.variant in L.LIN_VARIANTS
    assert plan.smem == L.lin_smem(*plan.variant[:4], -(-k // L.LIN_KC)) <= L.SMEM_BLOCK
    kch, ntiles, mb = -(-k // L.LIN_KC), -(-n // plan.bn), -(-m // plan.bm)
    rows = np.zeros(m, np.int64)
    for bx in range(mb):
        rows[bx * plan.bm:(bx + 1) * plan.bm] += 1
    cols = np.zeros(n, np.int64)
    chunks = np.zeros(kch, np.int64)
    if plan.schedule == "R":
        assert plan.grid(m, n) == (mb, plan.nsplit) and plan.ksplit == 1
        for t0, t1 in _parts(ntiles, plan.nsplit):
            assert t1 > t0
            cols[t0 * plan.bn:t1 * plan.bn] += 1
        chunks += 1
    else:
        assert plan.grid(m, n) == (ntiles, mb, plan.ksplit)
        cols += 1
        for c0, c1 in _parts(kch, plan.ksplit):
            assert c1 > c0
            chunks[c0:c1] += 1
    assert (rows == 1).all() and (cols == 1).all() and (chunks == 1).all(), plan
    if plan.ksplit > 1:  # K is split only where the output tiles leave SMs idle
        assert mb * ntiles < sms, (m, k, n, plan)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_linear_plan_at_every_path_shape(path):
    for kind, m, k, n, _ in PATHS[path]:
        plan = L.linear_plan(m, k, n, PROLOGUE[kind], SMS)
        _check_plan(plan, m, k, n, PROLOGUE[kind])
        # every LN and GN site of the path keeps its rows resident; the
        # plain and residual sites stream them
        assert plan.schedule == ("S" if kind == "res" else "R"), (kind, m, k, n, plan)
        blocks = math.prod(plan.grid(m, n))
        if m >= 1152:
            assert blocks >= SMS // 2, (kind, m, k, n, plan)


@pytest.mark.parametrize("shape", [(77, 64, 40, "ln"), (1, 320, 1280, "none"), (288, 2560, 1280, "ln"),
                                   (288, 2560, 1280, "gn"), (100, 72, 24, "gn"), (5000, 1536, 48, "none")])
def test_linear_plan_off_the_path(shape):
    m, k, n, prologue = shape
    plan = L.linear_plan(m, k, n, prologue, SMS)
    _check_plan(plan, m, k, n, prologue)
    if prologue != "none" and k > 1280:  # a block's rows of all of K do not fit shared memory
        assert plan.schedule == "S"
    for v in L.LIN_VARIANTS:  # every variant that fits plans and covers too
        if L.lin_smem(*v[:4], -(-k // L.LIN_KC)) <= L.SMEM_BLOCK:
            _check_plan(L.linear_plan(m, k, n, prologue, SMS, variant=v), m, k, n, prologue)


def emulate_k10(x, w, bias, res, ln_w, ln_b, ss, rows_per_img, eps, plan, *, seed=0,
                ln_one_chunk=False, gn_first_image=False):
    """K10/K11's schedule in plain torch (f32).  ``ln_one_chunk``: LN
    statistics over the first 64 channels only; ``gn_first_image``: every
    row of a block takes the block's first row's image (the negative
    controls)."""
    m, k = x.shape
    n = w.shape[0]
    bm, bn, kc = plan.bm, plan.bn, L.LIN_KC
    kch, ntiles = -(-k // kc), -(-n // bn)
    pro = "gn" if ss is not None else "none" if ln_w is None else "ln"

    def rows_of(r0, r1, k0, k1):  # the block's rows at channels k0..k1, the prologue applied
        xr = x[r0:r1]
        if pro == "ln":
            xs = xr[:, :kc] if ln_one_chunk else xr
            mean = xs.mean(-1, keepdim=True)
            var = (xs - mean).square().mean(-1, keepdim=True)
            xr = (xr - mean) * torch.rsqrt(var + eps) * ln_w + ln_b
        elif pro == "gn":
            img = torch.arange(r0, r1) // rows_per_img
            if gn_first_image:
                img = torch.full_like(img, r0 // rows_per_img)
            xr = xr * ss[img, 0] + ss[img, 1]
        return xr[:, k0:k1]

    def product(a, n0, n1, c0, c1):  # the tile's f32 sum, one 64-channel chunk at a time
        acc = torch.zeros(a.shape[0], n1 - n0)
        for c in range(c0, c1):
            k0, k1 = c * kc, min(k, (c + 1) * kc)
            acc += a[:, k0 - c0 * kc:k1 - c0 * kc] @ w[n0:n1, k0:k1].t()
        return acc

    def epilogue(acc, r0, r1, n0, n1):
        out = acc + (0 if bias is None else bias[n0:n1])
        return out if res is None else out + res[r0:r1, n0:n1]

    y = torch.full((m, n), float("nan"))
    ws = torch.full((plan.ksplit, m, n), float("nan"))
    if plan.schedule == "R":
        blocks = [(bx, tr) for bx in range(-(-m // bm)) for tr in _parts(ntiles, plan.nsplit)]
    else:
        blocks = [(bx, (t, t + 1), kr) for t in range(ntiles) for bx in range(-(-m // bm))
                  for kr in _parts(kch, plan.ksplit)]
    for i in np.random.default_rng(seed).permutation(len(blocks)):
        bx, (t0, t1) = blocks[i][:2]
        r0, r1 = bx * bm, min(m, (bx + 1) * bm)
        c0, c1 = blocks[i][2] if plan.schedule == "S" else (0, kch)
        a = rows_of(r0, r1, c0 * kc, min(k, c1 * kc))  # R: all of K, normalized once
        for t in range(t0, t1):
            n0, n1 = t * bn, min(n, (t + 1) * bn)
            acc = product(a, n0, n1, c0, c1)
            if plan.ksplit > 1:  # the part's f32 partial tile
                ws[_parts(kch, plan.ksplit).index((c0, c1)), r0:r1, n0:n1] = acc
            else:
                y[r0:r1, n0:n1] = epilogue(acc, r0, r1, n0, n1)
    if plan.ksplit > 1:  # the reduce, in split order
        acc = ws[0].clone()
        for z in range(1, plan.ksplit):
            acc += ws[z]
        y = epilogue(acc, 0, m, 0, n)
    assert not torch.isnan(y).any()
    return y


def _inputs(seed, m, k, n, *, ln, res, gn_rows=None):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    d = dict(x=f(m, k, scale=2.0) + 0.5, w=f(n, k, scale=k ** -0.5), b=f(n, scale=0.1),
             res=f(m, n) if res else None, g=1 + f(k, scale=0.1) if ln or gn_rows else None,
             beta=f(k, scale=0.1) if ln or gn_rows else None)
    return d


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30) < tol


# (M, K, N, prologue, residual, rows a GN image, variant or None, sms):
# R with LN (128- and 64-row blocks, N splits, ragged N and K), R with GN
# whose row blocks straddle two images (144 rows an image at BM = 64 and
# 128), S with a residual (K = 2560, ragged M), split K (M = 1 and the mid
# block's 288 rows), and S with a prologue (LN over K > 1280).
EMU_CASES = [
    (300, 320, 960, "ln", False, None, None, SMS),
    (200, 640, 320, "ln", True, None, (1, 128, 160, 3, 1), 4),
    (130, 1280, 480, "ln", False, None, None, SMS),
    (77, 72, 40, "ln", False, None, None, SMS),
    (288, 256, 320, "gn", False, 144, (1, 64, 160, 3, 2), 8),
    (288, 256, 320, "gn", False, 144, (1, 128, 160, 3, 1), 8),
    (576, 384, 480, "gn", False, 144, (1, 128, 160, 3, 1), SMS),
    (250, 2560, 320, "none", True, None, None, SMS),
    (288, 1280, 320, "none", True, None, None, SMS),
    (1, 320, 1280, "none", False, None, None, SMS),
    (96, 1536, 200, "ln", True, None, None, SMS),
]


def _run_case(case, **controls):
    m, k, n, pro, res, gn_rows, variant, sms = case
    d = _inputs(m + k + n, m, k, n, ln=pro == "ln", res=res, gn_rows=gn_rows)
    x, w, b, r = _t(d["x"]), _t(d["w"]), _t(d["b"]), _t(d["res"])
    lw, lb = (_t(d["g"]), _t(d["beta"])) if pro == "ln" else (None, None)
    ss = None
    if pro == "gn":
        x4 = x.reshape(m // gn_rows, gn_rows, 1, k)
        ss = gn_scale_shift_plain(x4, _t(d["g"]), _t(d["beta"]), 32, 1e-6)
    plan = L.linear_plan(m, k, n, pro, sms, variant=variant)
    y = emulate_k10(x, w, b, r, lw, lb, ss, gn_rows, 1e-6 if pro == "gn" else 1e-5, plan,
                    seed=m, **controls)
    if pro == "gn":
        plain = L.gn_matmul_plain(x4, _t(d["g"]), _t(d["beta"]), w, b, eps=1e-6).reshape(m, n)
        jx = jlin._gn_mm_xla(jnp.asarray(d["g"]), jnp.asarray(d["beta"]),
                             jnp.asarray(d["x"].reshape(m // gn_rows, gn_rows, 1, k)),
                             jnp.asarray(d["w"].T), jnp.asarray(d["b"]), 32, 1e-6)
        jx = np.asarray(jx).reshape(m, n)
    else:
        plain = L.linear_plain(x, w, b, r, lw, lb)
        opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
        jx = np.asarray(jlin._mm_xla(jnp.asarray(d["x"]), opt(d["g"]), opt(d["beta"]),
                                     jnp.asarray(d["w"].T), jnp.asarray(d["b"]), opt(d["res"]),
                                     1e-5))
    return plan, y, plain, jx


@pytest.mark.parametrize("case", EMU_CASES, ids=lambda c: "-".join(map(str, c[:5])))
def test_k10_k11_schedule_matches_plain_and_jax(case):
    plan, y, plain, jx = _run_case(case)
    m, k, n, pro, _, gn_rows = case[:6]
    if gn_rows is not None:  # some row block holds rows of two images
        assert any(r0 // gn_rows != (min(m, r0 + plan.bm) - 1) // gn_rows for r0 in range(0, m, plan.bm))
    if (m, k) in ((288, 1280), (1, 320)):
        assert plan.ksplit > 1, plan
    assert plan.schedule == ("S" if pro == "none" or k > 1280 else "R"), plan
    assert _close(y, plain), plan
    assert _close(y, jx), plan


def test_k10_schedule_catches_ln_statistics_of_one_chunk():
    """The negative control: LN statistics over the first 64 channels only
    (as a block that kept one K chunk of its rows would take them)."""
    case = EMU_CASES[0]
    _, y, plain, jx = _run_case(case)
    assert _close(y, plain) and _close(y, jx)
    _, y, plain, jx = _run_case(case, ln_one_chunk=True)
    assert not _close(y, plain) and not _close(y, jx)


@pytest.mark.parametrize("variant", [(1, 64, 160, 3, 2), (1, 128, 160, 3, 1)])
def test_k11_schedule_catches_one_image_a_block(variant):
    """The negative control: every row of a block taking its first row's
    image, which the straddling row blocks at 144 rows an image get wrong."""
    case = (288, 256, 320, "gn", False, 144, variant, 8)
    _, y, plain, jx = _run_case(case)
    assert _close(y, plain) and _close(y, jx)
    _, y, plain, jx = _run_case(case, gn_first_image=True)
    assert not _close(y, plain) and not _close(y, jx)
