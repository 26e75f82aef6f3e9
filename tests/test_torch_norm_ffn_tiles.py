"""K1's and K4's schedules on the CPU: the planners (``ops/groupnorm.gn_plan``,
``ops/ffn.ffn_plan``) at every K1 and K4 shape of the port's paths, and
plain-torch emulations of the kernels' schedules (csrc/groupnorm.cu,
csrc/ffn.cu) held against the plain versions.

K1's emulation follows the statistics kernel: each block's tiles of rows
give per-group (mean, M2) in two passes (mean first, then the squared
deviations from it), merged in order with Chan's formula into the block's
chunk partial; the last block merges the chunk partials in chunk order,
each of ``mlanes`` lanes a group a contiguous run of chunks, then a fixed
shuffle tree over those lanes (lane i takes lane i + off for off = 1, 2,
4, ... where i % 2 off == 0); gamma and beta are folded in.  In f32 it
must equal ``gn_scale_shift_plain``: scale and shift each within 1e-5 of
their largest magnitude, at ragged lengths, group widths 4-80 and an input
of mean 1e3 and std 1, where the one-pass E[x^2] - E[x]^2 over the same
chunks is shown to miss that tolerance.

K4's emulation follows the two GEMMs: G1 over ``bm1``-row blocks, its N
tiles of 128 W1 rows in its loads' order (each 32 value rows, then the 32
gate rows of the same hidden units) split as the plan says,
64-channel K steps over the LayerNormed rows (zero past M and past C), and
the GeGLU taken on each 64 accumulator columns as 32 values beside their 32
gates; G2 over 64-row x ``bn2`` tiles with its K steps split over
``ksplit2`` blocks whose partials are added in split order, then b2 and the
residual.  In f32 it must equal ``geglu_ffn_plain`` within 1e-5 relative;
with the gates loaded first it must not.  These are test helpers, not
used on the main path.
"""

import ast
import math
import pathlib
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stable_diffusion_tpu_torch.ops import _cuda, ffn, groupnorm as gn
try:
    from tests.torch_threads import one_thread  # noqa: F401
except ModuleNotFoundError:  # loaded by file on the card, where another ``tests`` package
    pass                     # shadows this one: tests/test_torch_gpu.py reads its shapes

SMS = 132  # an H100 SXM's SMs
REL = 1e-5

# (level, Cin) of every GroupNorm that reaches K1 in the UNet (resblock
# GN+SiLU before K2, the transformers' GN before conv_input, the output
# GN+SiLU; SD1.5 and SD2.1 share the topology, the latent side divided by
# 2**level) and in the VAE decoder (the latent side multiplied by 2**level).
UNET_GN = [(0, 320), (0, 640), (0, 960), (1, 320), (1, 640), (1, 960), (1, 1280), (1, 1920),
           (2, 640), (2, 1280), (2, 1920), (2, 2560), (3, 1280), (3, 2560)]
VAE_GN = [(0, 512), (1, 512), (2, 512), (2, 256), (3, 256), (3, 128)]


# (level, Cin) of every GroupNorm that reaches K1 in the VAE encoder: the
# resblocks' GN+SiLU before K2 (a stage's first norm at the previous
# stage's width), the mid attention's GN and conv_norm_out.
ENC_GN = [(3, 128), (2, 128), (2, 256), (1, 256), (1, 512), (0, 512)]


def _gn_shapes(b_unet, side, b_vae):
    return ([(b_unet, (side >> lv) ** 2, c) for lv, c in UNET_GN]
            + [(b_vae, (side << lv) ** 2, c) for lv, c in VAE_GN])


GN_PATHS = {
    "serve_sd15": _gn_shapes(2, 64, 1),   # CFG UNet at 64^2 latents, VAE to 512^2
    "sd21": _gn_shapes(2, 96, 1),         # 96^2 latents, VAE to 768^2
    "w8a8": _gn_shapes(8, 64, 4),         # b4 requests: UNet batch 8, VAE batch 4
    "train": [(4, (64 >> lv) ** 2, c) for lv, c in UNET_GN],  # b4 train step
    # img2img b4: the encoder at b1, the CFG UNet at batch 8, the decoder at b4
    "img2img_b4": [(1, (64 << lv) ** 2, c) for lv, c in ENC_GN] + _gn_shapes(8, 64, 4),
    "cli_b1": _gn_shapes(1, 64, 1),       # the CLI's default (no CFG) and one-step b1
    "one_step_b4": _gn_shapes(4, 64, 4),  # one-step --batch_size 4
}

# (M, C) of every K4 call: the transformer blocks at each attention level
# (latent side / 2**level, 320 / 640 / 1280 / 1280 channels) at UNet batch b.
def _ffn_shapes(b, side):
    return [(b * (side >> lv) ** 2, c) for lv, c in ((0, 320), (1, 640), (2, 1280), (3, 1280))]


FFN_PATHS = {"serve_sd15": _ffn_shapes(2, 64), "sd21": _ffn_shapes(2, 96),
             "train": _ffn_shapes(4, 64), "img2img_b4": _ffn_shapes(8, 64),
             "cli_b1": _ffn_shapes(1, 64), "one_step_b4": _ffn_shapes(4, 64)}


# ---------------------------------------------------------------------------
# K1: the plan and the statistics schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", sorted(GN_PATHS))
def test_gn_plan_at_every_path_shape(path):
    for b, hw, c in GN_PATHS[path]:
        plan = gn.gn_plan(b, hw, c, 32, SMS)
        cpg = c // 32
        assert plan.vec == 8 and plan.r <= gn.GN_RMAX, (b, hw, c, plan)
        assert 32 % plan.gs == 0 and plan.gs * cpg % plan.vec == 0, (b, hw, c, plan)
        assert plan.lanes == plan.gs * cpg // plan.vec and plan.tr * plan.lanes <= gn.GN_THREADS
        assert plan.tr * plan.lanes >= 128 and plan.slabs * plan.gs == 32
        assert plan.mlanes * plan.gs <= gn.GN_THREADS and plan.nchunks <= 512
        # the chunks cover every row once
        assert (plan.nchunks - 1) * plan.chunk < hw <= plan.nchunks * plan.chunk
        blocks = b * plan.slabs * plan.nchunks
        if not plan.ticket:  # one block holds the whole image
            assert hw <= gn.GN_RMAX * plan.tr, (b, hw, c, plan)
        elif plan.tiles > 1:  # the large shapes: one wave of two blocks an SM
            assert SMS <= blocks <= 2 * SMS, (b, hw, c, plan)
        else:  # two blocks an SM, or the most blocks the shape has
            assert blocks >= 2 * SMS or plan.r == 1, (b, hw, c, plan)


@pytest.mark.parametrize("shape,want", [
    ((2, 256, 1280, 32), (8, 1, 6, 1)),      # the UNet's 16^2: one chunk, no ticket
    ((2, 64, 2560, 32), (8, 2, 6, 1)),       # 8^2 at 2560 channels
    ((2, 4096, 320, 32), (8, 32, 4, 86)),    # 64^2: whole rows, 2 tiles of 4 rows a thread
    ((1, 262144, 128, 32), (8, 32, 8, 256)),  # the VAE's 512^2: eight tiles a block
    ((2, 130, 20, 4), (1, 2, 6, 1)),         # C % 8 != 0: one channel a load
])
def test_gn_plan_choices(shape, want):
    plan = gn.gn_plan(*shape, SMS)
    assert (plan.vec, plan.gs, plan.r, plan.nchunks) == want, plan


def test_gn_plan_f32_loads_four_channels():
    plan = gn.gn_plan(2, 4096, 320, 32, SMS, elem_bytes=4)
    assert plan.vec == 4 and plan.lanes == 80


def _chan(a, b):
    (n, mean, m2), (nb, mb, m2b) = a, b
    if nb == 0:
        return a
    nn = n + nb
    d = mb - mean
    return nn, mean + d * (nb / nn), m2 + m2b + d * d * (n * (nb / nn))


def emulate_gn_stats(x, weight, bias, num_groups, eps, plan, one_pass=False):
    """K1's statistics schedule in f32 (float32 scalars for the merges): the
    (B, 2, C) scale/shift.  ``one_pass`` takes E[x^2] - E[x]^2 over the
    same chunks instead (the formula the kernel does not use)."""
    b_, hw, c = x.shape
    g = num_groups
    cpg = c // g
    xg = x.float().reshape(b_, hw, g, cpg)
    f = np.float32
    trow = plan.tr * plan.r
    out = torch.empty((b_, 2, c), dtype=torch.float32)
    for b in range(b_):
        parts = []  # per chunk, per group: (n, mean, m2), or (n, sum, sum of squares)
        for i in range(plan.nchunks):
            acc = [(f(0), f(0), f(0))] * g
            for t in range(plan.tiles):  # the block's tiles in order, Chan-merged
                rows = xg[b, i * plan.chunk + t * trow:min(i * plan.chunk + (t + 1) * trow, hw)]
                if rows.shape[0] == 0:
                    break
                n = rows.shape[0] * cpg
                s = rows.sum(dim=(0, 2))
                if one_pass:
                    sq = (rows * rows).sum(dim=(0, 2))
                    acc = [(a[0] + f(n), a[1] + f(s[k]), a[2] + f(sq[k])) for k, a in enumerate(acc)]
                else:
                    mean = s / n
                    m2 = ((rows - mean[None, :, None]) ** 2).sum(dim=(0, 2))
                    acc = [_chan(a, (f(n), f(mean[k]), f(m2[k]))) for k, a in enumerate(acc)]
            parts.append(acc)
        for grp in range(g):
            if one_pass:  # sums of x and x^2 over the chunks, then E[x^2] - E[x]^2
                sx = sum(p[grp][1] for p in parts)
                sxx = sum(p[grp][2] for p in parts)
                mean = f(sx / f(hw * cpg))
                var = f(sxx / f(hw * cpg)) - mean * mean
            else:  # mlanes lanes, each a contiguous run of chunks; a tree over the lanes
                lanes_n = plan.mlanes
                per = -(-plan.nchunks // lanes_n)
                lanes = []
                for lane in range(lanes_n):
                    acc = (f(0), f(0), f(0))
                    for i in range(lane * per, min((lane + 1) * per, plan.nchunks)):
                        acc = _chan(acc, parts[i][grp])
                    lanes.append(acc)
                off = 1
                while off < lanes_n:
                    lanes = [_chan(lanes[i], lanes[i + off]) if i % (2 * off) == 0 else lanes[i]
                             for i in range(lanes_n - off)] + lanes[lanes_n - off:]
                    off *= 2
                _, mean, m2 = lanes[0]
                var = f(m2 / f(hw * cpg))
            rstd = f(1) / f(math.sqrt(f(var + f(eps)))) if var + eps > 0 else f(float("inf"))
            ch = slice(grp * cpg, (grp + 1) * cpg)
            scale = weight[ch].float() * float(rstd)
            out[b, 0, ch] = scale
            out[b, 1, ch] = bias[ch].float() - float(mean) * scale
    return out


def _gn_err(got, want):
    """Scale and shift each against their own largest magnitude."""
    return max(((got[:, k] - want[:, k]).abs().max() / want[:, k].abs().max()).item()
               for k in range(2))


def _gn_inputs(b, hw, c, mean=0.0, std=1.0, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((b, hw, c), dtype=np.float32) * std + mean)
    w = torch.tensor(1 + 0.1 * rng.standard_normal(c, dtype=np.float32))
    bias = torch.tensor(0.1 * rng.standard_normal(c, dtype=np.float32))
    return x, w, bias


@pytest.mark.parametrize("cpg", [4, 8, 10, 20, 30, 40, 60, 80])
@pytest.mark.parametrize("hw", [130, 4096])
def test_emulated_gn_stats_match_plain(cpg, hw):
    """Ragged (130) and many-chunk (4096) lengths at every group width."""
    c = 32 * cpg
    x, w, bias = _gn_inputs(2, hw, c, mean=0.5, std=2.0, seed=cpg)
    plan = gn.gn_plan(2, hw, c, 32, SMS)
    got = emulate_gn_stats(x, w, bias, 32, 1e-5, plan)
    want = gn.gn_scale_shift_plain(x, w, bias, 32, 1e-5)
    assert _gn_err(got, want) <= REL, (plan, _gn_err(got, want))


def test_emulated_gn_stats_lane_runs_and_tree():
    """Several tiles a block and more chunks than merge lanes (uneven runs),
    at a reduced length: the planner's chunking on a small card."""
    x, w, bias = _gn_inputs(1, 8192 + 77, 128, seed=3)
    plan = gn.gn_plan(1, 8192 + 77, 128, 32, 8)
    assert plan.tiles > 1 and plan.nchunks > plan.mlanes and plan.nchunks % plan.mlanes, plan
    got = emulate_gn_stats(x, w, bias, 32, 1e-6, plan)
    assert _gn_err(got, gn.gn_scale_shift_plain(x, w, bias, 32, 1e-6)) <= REL


def test_emulated_gn_stats_far_from_zero_and_one_pass_fails():
    """Mean 1e3, std 1: Chan's merge stays within the tolerance; the
    one-pass formula over the same chunks does not."""
    x, w, bias = _gn_inputs(1, 4096, 128, mean=1e3, std=1.0, seed=5)
    plan = gn.gn_plan(1, 4096, 128, 32, SMS)
    assert plan.ticket
    want = gn.gn_scale_shift_plain(x, w, bias, 32, 1e-6)
    assert _gn_err(emulate_gn_stats(x, w, bias, 32, 1e-6, plan), want) <= REL
    assert _gn_err(emulate_gn_stats(x, w, bias, 32, 1e-6, plan, one_pass=True), want) > REL


def test_port_imports_neither_triton_nor_jax():
    """K1 is CUDA C++ now: no module of the port imports Triton (nor JAX,
    nor the JAX package), at any depth of the module, the evaluation path's
    modules (fid.py, models/inception.py) included; neither do the port's
    CLIs (inference_torch.py, train_lora_dreambooth_torch.py,
    evaluation_torch.py) and the
    checkpoints chip_smoke.py writes (tests/torch_checkpoints.py).  None of
    them imports ``transformers``, ``safetensors`` or ``regex``: the port
    carries its own reader and tokenizer."""
    root = pathlib.Path(gn.__file__).resolve().parents[1]
    banned = ("triton", "jax", "jaxlib", "stable_diffusion_tpu", "transformers", "safetensors",
              "regex")
    extra = [root.parent / "inference_torch.py", root.parent / "train_lora_dreambooth_torch.py",
             root.parent / "evaluation_torch.py", root.parent / "tests" / "torch_checkpoints.py"]
    modules = list(root.rglob("*.py"))
    assert {root / "fid.py", root / "models" / "inception.py"} <= set(modules)
    for path in [*modules, *extra]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


def _imported(node):
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and not node.level:
        return [node.module or ""]
    return []


def _outside_functions(node):
    """The nodes under ``node`` that no function body holds (what runs when
    the module is imported)."""
    for child in ast.iter_child_nodes(node):
        if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            yield child
            yield from _outside_functions(child)


def test_pil_only_where_a_resize_asks_and_chip_smoke_imports_no_jax():
    """PIL is imported inside a function of the port only (the card's
    machine may lack it; images at ``img_size`` need none), never at a
    module's import; chip_smoke.py imports neither JAX nor the JAX package,
    nor PIL at import."""
    root = pathlib.Path(gn.__file__).resolve().parents[1]
    smoke = root.parent / "chip_smoke.py"
    for path in [*root.rglob("*.py"), smoke, root.parent / "inference_torch.py",
                 root.parent / "train_lora_dreambooth_torch.py", root.parent / "evaluation_torch.py"]:
        for node in _outside_functions(ast.parse(path.read_text())):
            for name in _imported(node):
                assert name.split(".")[0] != "PIL", (path, name)
    for node in ast.walk(ast.parse(smoke.read_text())):
        for name in _imported(node):
            assert name.split(".")[0] not in ("jax", "jaxlib", "stable_diffusion_tpu"), name


def test_every_c_entry_binds_its_parameter_count():
    """Each ``extern "C"`` entry of csrc/ takes as many parameters as its
    ctypes argtypes name (a count that differs passes garbage or raises on
    the card only)."""
    entries = {}
    for path in _cuda.CSRC.glob("*.cu"):
        for m in re.finditer(r'extern "C" int (sdtk_\w+)\(([^)]*)\)', path.read_text()):
            entries[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])

    class Lib:  # records what _bind sets
        def __getattr__(self, name):
            fn = type(name, (), {})()
            setattr(self, name, fn)
            return fn

    lib = _cuda._bind(Lib())
    assert {"sdtk_gn_stats", "sdtk_gn_apply", "sdtk_gn_plan", "sdtk_ffn"} <= set(entries)
    for name, n in entries.items():
        assert len(getattr(lib, name).argtypes) == n, name


# ---------------------------------------------------------------------------
# K4: the plan, the W1 layout and the two GEMMs' schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", sorted(FFN_PATHS))
def test_ffn_plan_at_every_path_shape(path):
    for m, c in FFN_PATHS[path]:
        plan = ffn.ffn_plan(m, c, SMS)
        assert plan.g1 in ffn.FFN_G1_VARIANTS and plan.g2 in ffn.FFN_G2_VARIANTS, (m, c, plan)
        assert plan.smem1 <= ffn.SMEM_BLOCK and plan.smem2 <= ffn.SMEM_BLOCK, (m, c, plan)
        assert plan.bm1 == (128 if c <= 640 else 64), (m, c, plan)
        assert plan.bn2 == 160 and c % plan.bn2 == 0, (m, c, plan)  # 320, 640, 1280
        ntiles = c // 16
        assert 1 <= plan.nsplit1 <= ntiles
        mb, ns = plan.grid1(m)
        assert mb * plan.bm1 >= m > (mb - 1) * plan.bm1 and ns == plan.nsplit1
        n2, m2, ks = plan.grid2(m, c)
        assert m2 * plan.bm2 >= m > (m2 - 1) * plan.bm2 and n2 * plan.bn2 == c
        # split-K only where G2's tiles fill at most half the SMs
        assert (ks > 1) == (2 * m2 * n2 <= SMS), (m, c, plan)
        assert ks * 4 <= c // 16 or ks == 1
        if ks > 1:
            assert m2 * n2 * ks >= SMS or ks == min(c // 64, ffn.FFN_MAX_KSPLIT), (m, c, plan)


def test_ffn_plan_splits_k_at_small_m():
    assert ffn.ffn_plan(512, 1280, SMS).ksplit2 > 1
    assert ffn.ffn_plan(128, 1280, SMS).ksplit2 > 1
    assert ffn.ffn_plan(8192, 320, SMS).ksplit2 == 1


@pytest.mark.parametrize("g1", ffn.FFN_G1_VARIANTS)
@pytest.mark.parametrize("g2", ffn.FFN_G2_VARIANTS)
def test_ffn_plan_takes_every_variant(g1, g2):
    """Each compiled variant pair plans (where G1's rows fit beside its ring)."""
    plan = ffn.ffn_plan(2048, 640, SMS, g1=g1, g2=g2)
    assert plan.smem1 == ffn._up_smem(g1[0], g1[1], 640) <= ffn.SMEM_BLOCK
    assert plan.smem2 == ffn._dn_smem(*g2[:3]) <= ffn.SMEM_BLOCK


def test_ffn_plan_rejects_what_the_kernel_does_not_take():
    for c in (24, 2560):
        with pytest.raises(ValueError, match="K4"):
            ffn.ffn_plan(64, c, SMS)


def g1_w1_rows(c, gates_first=False):
    """The W1 row G1's loads take for each of its 8C slab rows (csrc/ffn.cu
    load_slab): slab row r of tile t is hidden unit u = 64 t + 32 (r >> 6)
    + (r & 31), its value row for r & 32 == 0, else its gate row 4C + u."""
    r = torch.arange(8 * c)
    t, r = r // 128, r % 128
    u = 64 * t + 32 * (r >> 6) + (r & 31)
    return torch.where(((r & 32) != 0) != gates_first, 4 * c + u, u)


def _ln(x, lw, lb, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * lw + lb


def emulate_ffn(x, lw, lb, w1, b1, w2, b2, res, plan, eps=1e-5, gates_first=False):
    # G1: each block tile is 128 W1 rows in load order; at bm1 = 128 both
    # warpgroups take all of them (64 rows each), at 64 each takes 64 of them:
    # either way each 64 columns are one (32 values, 32 gates) pair.
    """K4's two GEMMs in f32 with the plan's tiles: the output (M, C)."""
    m, c = x.shape
    hid = 4 * c
    kc = ffn.FFN_KC
    cp = -(-c // kc) * kc
    w1pad = F.pad(w1[g1_w1_rows(c, gates_first)], (0, cp - c))
    h = torch.zeros((m, hid))
    ntiles = c // 16
    mb, ns = plan.grid1(m)
    for bi in range(mb):
        r0 = bi * plan.bm1
        a = torch.zeros((plan.bm1, cp))
        rows = min(plan.bm1, m - r0)
        a[:rows, :c] = _ln(x[r0:r0 + rows], lw, lb, eps)
        for sp in range(ns):
            for t in range(sp * ntiles // ns, (sp + 1) * ntiles // ns):
                acc = torch.zeros((plan.bm1, 128))
                for k in range(0, cp, kc):  # the K steps, in order
                    acc += a[:, k:k + kc] @ w1pad[t * 128:(t + 1) * 128, k:k + kc].T
                for p in range(2):  # each 64 columns: 32 values, then their 32 gates
                    v, g = acc[:rows, 64 * p:64 * p + 32], acc[:rows, 64 * p + 32:64 * p + 64]
                    j = (t * 128 + 64 * p) // 2 + torch.arange(32)
                    h[r0:r0 + rows, j] = (v + b1[j]) * F.gelu(g + b1[hid + j])
    out = torch.empty((m, c))
    kch = hid // kc
    n2, m2, ks = plan.grid2(m, c)
    for bi in range(m2):
        rs = slice(bi * plan.bm2, min((bi + 1) * plan.bm2, m))
        for bj in range(n2):
            cs = slice(bj * plan.bn2, min((bj + 1) * plan.bn2, c))
            total = torch.zeros((rs.stop - rs.start, cs.stop - cs.start))
            for z in range(ks):  # partials added in split order
                part = torch.zeros_like(total)
                for ch in range(z * kch // ks, (z + 1) * kch // ks):
                    k = slice(ch * kc, (ch + 1) * kc)
                    part += h[rs, k] @ w2[cs, k].T
                total += part
            out[rs, cs] = total + b2[cs] + res[rs, cs]
    return out


def _ffn_inputs(m, c, seed=0):
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32) * scale)
    return (rn(m, c), 1 + rn(c, scale=0.1), rn(c, scale=0.1), rn(8 * c, c, scale=c ** -0.5),
            rn(8 * c, scale=0.1), rn(c, 4 * c, scale=(4 * c) ** -0.5), rn(c, scale=0.1), rn(m, c))


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("m,c,sms,g2", [
    (130, 32, SMS, None),      # one 64-wide G2 tile, C padded to a K step
    (200, 64, SMS, None),      # ragged M over 128-row G1 and G2 blocks
    (100, 160, SMS, None),     # bn2 160 and split-K (tiles fill < half the SMs)
    (70, 320, 8, None),        # split G1 N tiles on a small card
    (300, 96, 4, None),        # bn2 64 with columns past C
    (200, 96, SMS, (64, 64, 6, 0)),  # 64-row G2 blocks, split-K
])
def test_emulated_ffn_matches_plain(m, c, sms, g2):
    args = _ffn_inputs(m, c, seed=m + c)
    plan = ffn.ffn_plan(m, c, sms, g2=g2)
    got = emulate_ffn(*args, plan)
    want = ffn.geglu_ffn_plain(*args)
    assert _rel(got, want) <= REL, (plan, _rel(got, want))


def test_emulated_ffn_split_k_and_n_splits_occur():
    assert ffn.ffn_plan(100, 160, SMS).ksplit2 > 1
    assert ffn.ffn_plan(70, 320, 8).nsplit1 > 1


def test_emulated_ffn_sees_swapped_value_and_gate():
    """Slab rows that load each 32 gate rows before their values must fail."""
    m, c = 130, 64
    args = _ffn_inputs(m, c, seed=9)
    plan = ffn.ffn_plan(m, c, SMS)
    got = emulate_ffn(*args, plan, gates_first=True)
    assert _rel(got, ffn.geglu_ffn_plain(*args)) > 1e-2
