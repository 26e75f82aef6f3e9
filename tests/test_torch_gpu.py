"""The port's kernels K1-K12 against their plain versions, on a CUDA card.

Every test here needs the card and skips without one.  This file imports no
JAX, so it also runs where JAX is not installed; run it there with the
repository's conftest (which imports JAX) left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Inputs are bf16 draws from a seeded generator; the reference is the plain
version in f32 on the same values.  Tolerance: max|kernel - plain| <=
2e-2 * max|plain| (bf16 outputs and bf16-rounded intermediates, as in the
JAX kernels).  Gradients through the autograd Functions with
``impl="cuda"`` (bf16) against ``impl="torch"`` (f32, same values): 5e-2
of the largest gradient, since the recomputed plain backward also runs in
bf16 there.  The W8A8 kernels K7-K9 are held to the same 2e-2 against
their plain versions in f32 on the same int8 weights and scales: an
activation code may differ by one where the kernel's bf16 rounding before
the quantizer and the f32 reference's lie on two sides of a half step.
"""

import importlib.util
import os
import subprocess
import sys

import pytest
import torch

from stable_diffusion_tpu_torch.ops import conv, ffn, flash_attention, groupnorm, linear, winograd
from stable_diffusion_tpu_torch.ops.quantize import (act_step, folded_scales, quantize_act,
                                                     quantize_tensor)

pytestmark = pytest.mark.gpu
REL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _rn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).bfloat16()


def _check(got, ref):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    assert rel <= REL, rel


@pytest.mark.parametrize("shape", [(2, 16, 32), (2, 4096, 320), (1, 4096, 512), (2, 64, 2560),
                                   (1, 262144, 128), (4, 262144, 128), (1, 589824, 128)])
@pytest.mark.parametrize("silu", [True, False])
def test_k1_groupnorm(gen, shape, silu):
    """The UNet's and the VAE's shapes (512^2 at b1 and b4, 768^2)."""
    b, hw, c = shape
    x = _rn(gen, b, hw, 1, c, scale=3.0) + 5.0
    w, bias = 1 + _rn(gen, c, scale=0.1), _rn(gen, c, scale=0.1)
    before = groupnorm.K1.launches
    got = groupnorm.group_norm_silu(x, w, bias, eps=1e-6, silu=silu, impl="cuda")
    assert groupnorm.K1.launches == before + 1
    _check(got, groupnorm.group_norm_plain(x.float(), w.float(), bias.float(), 32, 1e-6, silu))
    ss = groupnorm.gn_scale_shift(x, w, bias, eps=1e-6, impl="cuda")
    ref = groupnorm.gn_scale_shift_plain(x.float(), w.float(), bias.float(), 32, 1e-6)
    torch.cuda.synchronize()
    torch.testing.assert_close(ss, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 262144, 128), (2, 4096, 320)])
def test_k1_far_from_zero(gen, shape):
    """Mean 100, std 1 (the one-pass E[x^2] - E[x]^2 loses its digits here)."""
    b, hw, c = shape
    x = _rn(gen, b, hw, 1, c) + 100.0
    w, bias = 1 + _rn(gen, c, scale=0.1), _rn(gen, c, scale=0.1)
    ss = groupnorm.gn_scale_shift(x, w, bias, eps=1e-6, impl="cuda")
    ref = groupnorm.gn_scale_shift_plain(x.float(), w.float(), bias.float(), 32, 1e-6)
    torch.cuda.synchronize()
    torch.testing.assert_close(ss, ref, rtol=1e-4, atol=1e-4)
    _check(groupnorm.group_norm_silu(x, w, bias, eps=1e-6, impl="cuda"),
           groupnorm.group_norm_plain(x.float(), w.float(), bias.float(), 32, 1e-6, True))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 130, 36, 4), (2, 5000, 20, 4), (2, 300, 320, 32)])
def test_k1_scalar_and_f32_loads(gen, dtype, shape):
    """C % 8 != 0 (one channel a load, one chunk and many), and f32 input
    (4 channels a load) with f32 GroupNorm weights."""
    b, hw, c, groups = shape
    x = (torch.randn((b, hw, c), generator=gen, device="cuda") * 2 + 1).to(dtype)
    w = (1 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    bias = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    ss = groupnorm.gn_scale_shift(x, w, bias, num_groups=groups, impl="cuda")
    ref = groupnorm.gn_scale_shift_plain(x.float(), w.float(), bias.float(), groups, 1e-5)
    torch.cuda.synchronize()
    torch.testing.assert_close(ss, ref, rtol=1e-4, atol=1e-4)
    _check(groupnorm.group_norm_silu(x, w, bias, num_groups=groups, impl="cuda"),
           groupnorm.group_norm_plain(x.float(), w.float(), bias.float(), groups, 1e-5, True))


def test_k1_back_to_back_shapes_leave_the_tickets_at_zero(gen):
    """Two ticketed statistics calls of different shapes in a row, then the
    same shapes again: each right, the same bits the second time
    (deterministic merge), and every ticket back at 0."""
    shapes = [(2, 4096, 1, 320), (1, 16384, 1, 512)]
    xs = [_rn(gen, *s, scale=2.0) + 1.0 for s in shapes]
    ws = [(1 + _rn(gen, s[-1], scale=0.1), _rn(gen, s[-1], scale=0.1)) for s in shapes]
    for s in shapes:
        assert groupnorm.gn_plan(s[0], s[1], s[3], 32, torch.cuda.get_device_properties(0)
                                 .multi_processor_count).ticket
    first = [groupnorm.gn_scale_shift(x, *w, impl="cuda") for x, w in zip(xs, ws)]
    again = [groupnorm.gn_scale_shift(x, *w, impl="cuda") for x, w in zip(xs, ws)]
    torch.cuda.synchronize()
    for x, (w, bias), a, b in zip(xs, ws, first, again):
        ref = groupnorm.gn_scale_shift_plain(x.float(), w.float(), bias.float(), 32, 1e-5)
        torch.testing.assert_close(a, ref, rtol=1e-4, atol=1e-4)
        assert torch.equal(a, b)
    _, count, _ = groupnorm._WORKSPACE[torch.cuda.current_device()]
    assert int(count.abs().sum()) == 0


@pytest.mark.parametrize("shape", [(2, 4096, 320), (2, 256, 1280), (2, 64, 2560), (1, 262144, 128),
                                   (4, 262144, 128), (1, 589824, 128), (2, 130, 20), (8, 1024, 960)])
@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_k1_plan_mirrors_the_c_dispatch(gen, shape, elem_bytes):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    groups = 4 if shape[2] == 20 else 32
    assert (groupnorm.gn_plan(*shape, groups, sms, elem_bytes)
            == groupnorm.gn_plan_native(*shape, groups, sms, elem_bytes))


def test_k1_imports_no_triton(gen):
    """K1 is CUDA C++: a process that runs both of its kernels has not
    imported Triton."""
    code = ("import sys, torch\n"
            "from stable_diffusion_tpu_torch.ops import groupnorm as g\n"
            "x = torch.randn(2, 64, 64, 320, device='cuda').bfloat16()\n"
            "w = torch.ones(320, device='cuda').bfloat16()\n"
            "g.group_norm_silu(x, w, w, impl='cuda'); torch.cuda.synchronize()\n"
            "print('triton' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False"


def test_k1_k4_occupancy(gen):
    """Every compiled K1 statistics kernel and K4 variant (G1 at each width
    it takes, G2 at each column tile): no spills, at least one block an SM,
    the shared memory each plan computes."""
    for key, o in groupnorm.gn_occupancy().items():
        assert o["spill_bytes"] == 0 and o["blocks_per_sm"] >= 1, (key, o)
    for c in (320, 640, 1280):
        for key, o in ffn.ffn_occupancy(c).items():
            assert o["spill_bytes"] == 0 and o["blocks_per_sm"] >= 1, (c, key, o)
            want = ffn._up_smem(key[1], key[2], c) if key[0] == "G1" else ffn._dn_smem(*key[1:4])
            assert o["smem_bytes"] == want, (c, key, o)


@pytest.mark.parametrize("shape", [(1, 4, 4, 32, 32), (2, 32, 32, 960, 320), (1, 64, 64, 512, 256),
                                   (2, 8, 8, 2560, 1280), (1, 5, 7, 64, 40), (2, 6, 6, 96, 32),
                                   (2, 12, 12, 2560, 1280), (2, 16, 16, 1280, 1280),
                                   (2, 24, 24, 1280, 1280), (1, 10, 20, 128, 136),
                                   (1, 512, 512, 128, 128)])
@pytest.mark.parametrize("prologue", [True, False])
def test_k2_conv3x3(gen, shape, prologue):
    """Every tile variant of conv3x3_plan: 8 x 16 (bn 64, 128 and 160), 8 x 8
    and 5 x 12 (64 rows) at W < 16, 5 x 24, ragged rectangles and Cout,
    split-K (8^2 to 32^2), and the VAE's 512^2 x 128 channels."""
    b, h, w, cin, cout = shape
    x = _rn(gen, b, h, w, cin)
    wt, bias = _rn(gen, cout, cin, 3, 3, scale=(9 * cin) ** -0.5), _rn(gen, cout, scale=0.1)
    before = conv.K2.launches
    if prologue:
        gw, gb = 1 + _rn(gen, cin, scale=0.1), _rn(gen, cin, scale=0.1)
        got = conv.gn_silu_conv3x3(x, gw, gb, wt, bias, impl="cuda")
        ref = conv.gn_silu_conv3x3_plain(x.float(), gw.float(), gb.float(), wt.float(), bias.float())
    else:
        got = conv.conv3x3(x, wt, bias, impl="cuda")
        ref = conv.conv3x3_plain(x.float(), wt.float(), bias.float())
    assert conv.K2.launches == before + 1
    _check(got, ref)


@pytest.mark.parametrize("shape", [(4, 16, 16, 640, 1280), (4, 64, 64, 320, 320)])
def test_k2_transposed(gen, shape):
    """The train step's input gradient: K2 on the flipped, I/O-swapped weight."""
    b, h, w, cin, cout = shape
    g = _rn(gen, b, h, w, cout)
    wt = _rn(gen, cout, cin, 3, 3, scale=(9 * cout) ** -0.5)
    before = conv.K2.launches
    got = conv.conv3x3_kernel(g, wt, transposed=True)
    assert conv.K2.launches == before + 1 and got.shape == (b, h, w, cin)
    _check(got, conv.conv3x3_plain(g.float(), conv.flip_io(wt).float()))


def test_k2_occupancy(gen):
    """Every compiled K2 variant: no spills, two blocks an SM."""
    for variant, occ in conv.conv3x3_occupancy().items():
        assert occ["spill_bytes"] == 0 and occ["blocks_per_sm"] >= 2, (variant, occ)


def test_k2_zero_halo_after_activation(gen):
    # shift makes silu(shift) far from 0: a halo of silu(shift) would show
    x = _rn(gen, 1, 8, 8, 32)
    wt = _rn(gen, 32, 32, 3, 3, scale=0.1)
    gw, gb = torch.ones(32, device="cuda").bfloat16(), torch.full((32,), 3.0, device="cuda").bfloat16()
    got = conv.gn_silu_conv3x3(x, gw, gb, wt, None, impl="cuda")
    _check(got, conv.gn_silu_conv3x3_plain(x.float(), gw.float(), gb.float(), wt.float()))


@pytest.mark.parametrize("shape", [(1, 16, 16, 2, 16), (2, 4096, 77, 8, 40), (2, 1024, 1024, 8, 80),
                                   (2, 256, 77, 8, 160), (1, 4096, 4096, 1, 512),
                                   (1, 100, 37, 3, 24)])
def test_k3_attention(gen, shape):
    b, sq, sk, h, d = shape
    q, k, v = _rn(gen, b, sq, h, d), _rn(gen, b, sk, h, d), _rn(gen, b, sk, h, d)
    before = flash_attention.K3.launches
    got = flash_attention.attention(q, k, v, impl="cuda")
    assert flash_attention.K3.launches == before + 1
    _check(got, flash_attention.attention_plain(q.float(), k.float(), v.float()))


def test_k3_strided_qkv_and_kv_len(gen):
    b, s, h, d = 2, 256, 5, 64
    qkv = _rn(gen, b, s, 3 * h * d)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    ref = flash_attention.attention_plain(q.float(), k.float(), v.float(), kv_len=77)
    _check(flash_attention.attention(q, k, v, kv_len=77, impl="cuda"), ref)


def _qkv(gen, b, s, h, d):
    """q, k, v as the UNet's self-attention hands them to K3: views of one
    fused QKV projection (sequence stride 3 H D)."""
    qkv = _rn(gen, b, s, 3 * h * d)
    return [t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1)]


def _ring_variants(d):
    dp = (d + 15) // 16 * 16
    return [flash_attention.AttentionPlan("ring", dp, bq) for vdp, bq in flash_attention.K3_RING
            if vdp == dp]


@pytest.mark.parametrize("shape", [(1, 100, 3, 40), (2, 1000, 2, 64), (1, 333, 4, 80),
                                   (2, 4096, 8, 40), (2, 1024, 8, 80), (1, 2304, 10, 64)])
def test_k3_self_attention_bodies(gen, shape):
    """The ring body at d = 40, 64, 80: ragged lengths (100, 333, 1000 are
    no multiple of a tile), q/k/v strided as the fused QKV's split, the row
    log-sum-exp; the planner's choice through the entry point, and every
    compiled variant through the raw kernel."""
    b, s, h, d = shape
    q, k, v = _qkv(gen, b, s, h, d)
    ref = flash_attention.attention_plain(q.float(), k.float(), v.float())
    plan = flash_attention.attention_plan(b, s, s, h, d, torch.cuda.get_device_properties(0)
                                          .multi_processor_count)
    assert plan.body == "ring", plan
    before = flash_attention.K3.launches
    _check(flash_attention.attention(q, k, v, impl="cuda"), ref)
    assert flash_attention.K3.launches == before + 1
    for variant in _ring_variants(d):
        o, lse = flash_attention.attention_kernel(q, k, v, return_lse=True, _plan=variant)
        _check(o, ref)
        _check(lse, _lse2(q, k))


def test_k3_general_body_at_self_shapes(gen):
    """The general body still takes a self-attention shape when asked (the
    chip run times it beside the ring body)."""
    q, k, v = _qkv(gen, 1, 300, 2, 40)
    plan = flash_attention.AttentionPlan("general", 48, 64)
    o, lse = flash_attention.attention_kernel(q, k, v, return_lse=True, _plan=plan)
    _check(o, flash_attention.attention_plain(q.float(), k.float(), v.float()))
    _check(lse, _lse2(q, k))


def test_k3_passes_across_the_grid(gen):
    """The general body at d = 512, in four 128-column passes, one per
    blockIdx.z (asked for: the planner gives d = 512 to the wide body); pass
    0 writes the log-sum-exp."""
    q, k, v = (_rn(gen, 1, 1000, 1, 512) for _ in range(3))
    plan = flash_attention.AttentionPlan("general", 512, 64, passes=4)
    assert flash_attention.attention_plan(1, 1000, 1000, 1, 512).body == "wide"
    o, lse = flash_attention.attention_kernel(q, k, v, return_lse=True, _plan=plan)
    _check(o, flash_attention.attention_plain(q.float(), k.float(), v.float()))
    _check(lse, _lse2(q, k))


def test_k3_occupancy(gen):
    """Every compiled K3 variant the paths reach: no spills, at least one
    block an SM, and the shared memory its plan computes."""
    occ = flash_attention.attention_occupancy()
    for plan, o in occ.items():
        assert o["spill_bytes"] == 0 and o["blocks_per_sm"] >= 1, (plan, o)
        assert o["smem_bytes"] == plan.smem, (plan, o)
    bodies = {plan.body for plan in occ}
    assert bodies == set(flash_attention.K3_BODIES), bodies


def _k3_path_shapes(body):
    """The K3 shapes of the four paths (tests/test_torch_attention_tiles.py
    PATHS) that the planner gives ``body``."""
    spec = importlib.util.spec_from_file_location(
        "k3_tiles", os.path.join(os.path.dirname(__file__), "test_torch_attention_tiles.py"))
    tiles = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tiles)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = sorted({s for shapes in tiles.PATHS.values() for s in shapes})
    return [s for s in out if flash_attention.attention_plan(*s, sms).body == body]


def _by_body():
    return {b: c.launches for b, c in flash_attention.K3_BY_BODY.items()}


@pytest.mark.parametrize("body", ["cross", "wide"])
def test_k3_new_bodies_at_every_path_shape(gen, body):
    """The cross and wide bodies at every K3 shape of the four paths they
    take, through the entry point (one launch of that body, none of
    another), q/k/v of a self-attention as the fused QKV's views, against
    the plain f32 version; the row log-sum-exp too."""
    shapes = _k3_path_shapes(body)
    assert shapes, body
    for b, sq, sk, h, d in shapes:
        if sq == sk:
            q, k, v = _qkv(gen, b, sq, h, d)
        else:
            q, k, v = _rn(gen, b, sq, h, d), _rn(gen, b, sk, h, d), _rn(gen, b, sk, h, d)
        before = _by_body()
        o, lse = flash_attention.attention_kernel(q, k, v, return_lse=True)
        after = _by_body()
        assert {x: after[x] - before[x] for x in after} == {x: int(x == body) for x in after}
        _check(o, flash_attention.attention_plain(q.float(), k.float(), v.float()))
        _check(lse, _lse2(q, k))
        del q, k, v, o, lse


@pytest.mark.parametrize("shape,kv_len", [((2, 100, 128, 8, 40), 77), ((2, 100, 128, 8, 40), 100),
                                          ((1, 333, 77, 3, 40), None), ((2, 130, 120, 5, 64), None),
                                          ((1, 70, 77, 2, 160), 9), ((2, 256, 256, 5, 64), 77),
                                          ((1, 64, 1, 1, 80), None)])
def test_k3_cross_body_kv_len_and_ragged(gen, shape, kv_len):
    """The cross body at ragged query lengths (100, 333, 130, 70), an odd head
    count, 128 keys (nk = 128), a kv_len that masks
    (77, 100, 9; and 77 of a 256-key self-attention), a single key; q/k/v
    strided as a fused QKV's split where Sq == Sk; one and three query
    tiles a block."""
    b, sq, sk, h, d = shape
    if sq == sk:
        q, k, v = _qkv(gen, b, sq, h, d)
    else:
        q, k, v = _rn(gen, b, sq, h, d), _rn(gen, b, sk, h, d), _rn(gen, b, sk, h, d)
    plan = flash_attention.attention_plan(b, sq, sk, h, d, torch.cuda.get_device_properties(0)
                                          .multi_processor_count, kv_len)
    assert plan.body == "cross", plan
    o, lse = flash_attention.attention_kernel(q, k, v, kv_len=kv_len, return_lse=True)
    _check(o, flash_attention.attention_plain(q.float(), k.float(), v.float(), kv_len=kv_len))
    n = sk if kv_len is None else kv_len
    _check(lse, _lse2(q, k[:, :n]))
    for tiles in (1, 3):  # one tile a block (two Q buffers), and three (three buffers)
        o2 = flash_attention.attention_kernel(q, k, v, kv_len=kv_len, _plan=plan._replace(tiles=tiles))
        _check(o2, o.float())


@pytest.mark.parametrize("shape", [(1, 1000, 1, 512), (2, 300, 3, 160), (1, 4096, 1, 512),
                                   (2, 64, 8, 160)])
def test_k3_wide_body_splits(gen, shape):
    """The wide body at a ragged length (1000, 300: the last query block and
    key tile part-filled) and at path shapes, q/k/v as the fused QKV's
    views, with every key split 1-4 (the merge's log-sum-exp equal to the
    unsplit one)."""
    b, s, h, d = shape
    q, k, v = _qkv(gen, b, s, h, d)
    ref = flash_attention.attention_plain(q.float(), k.float(), v.float())
    want_lse = _lse2(q, k)
    base = flash_attention.AttentionPlan("wide", d, 64)
    for splits in range(1, min(4, -(-s // 64)) + 1):
        o, lse = flash_attention.attention_kernel(q, k, v, return_lse=True,
                                                  _plan=base._replace(splits=splits))
        _check(o, ref)
        _check(lse, want_lse)


def test_k3_wide_lse_feeds_k5_k6(gen):
    """At d = 160 the train step's backward (K5 + K6) takes the wide body's
    row log-sum-exp, split or not."""
    b, s, h, d = 4, 256, 8, 160
    q, k, v = _qkv(gen, b, s, h, d)
    do = _rn(gen, b, s, h, d)
    want = flash_attention.attention_bwd_plain(*(t.float() for t in (q, k, v)),
                                               flash_attention.attention_plain(q.float(), k.float(),
                                                                               v.float()),
                                               do.float())
    for splits in (1, 2):
        plan = flash_attention.AttentionPlan("wide", d, 64, splits=splits)
        o, lse = flash_attention.attention_kernel(q, k, v, return_lse=True, _plan=plan)
        got = flash_attention.attention_bwd_kernel(q, k, v, o, lse, do)
        for g, w in zip(got, want):
            _check(g, w)


def test_sd15_request_launches_no_general_body(gen):
    """One SD1.5 512^2 request (full width, seeded random weights, two DDIM
    steps): every K3 call takes the ring, cross or wide body."""
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion
    from stable_diffusion_tpu_torch.utils.weights import init_random_

    pipe = StableDiffusion.for_version("1.5", device="cuda", dtype=torch.bfloat16, impl="cuda")
    for i, m in enumerate((pipe.unet, pipe.text_encoder, pipe.vae)):
        init_random_(m, i)
    for c in flash_attention.K3_BY_BODY.values():
        c.reset()
    img = pipe.generate([[1] * 77], [[0] * 77], img_size=(512, 512), inference_steps=2,
                        output_dtype="uint8")
    torch.cuda.synchronize()
    assert img.shape == (1, 512, 512, 3)
    launches = _by_body()
    assert launches["general"] == 0 and all(launches[b] > 0 for b in ("ring", "cross", "wide")), launches
    del pipe
    torch.cuda.empty_cache()


@pytest.mark.parametrize("shape", [(16, 32), (8192, 320), (2048, 640), (512, 1280), (100, 64),
                                   (128, 1280), (18432, 320), (4608, 640), (1152, 1280), (288, 1280),
                                   (16384, 320), (4096, 640), (1024, 1280), (256, 1280), (100, 320),
                                   (8193, 320), (300, 96)])
@pytest.mark.parametrize("residual", [True, False])
def test_k4_ffn(gen, shape, residual):
    """Every (M, C) of the serve, SD2.1 and train paths, ragged M (100,
    8193), C below a K step (32) and a ragged G2 column tile (96)."""
    m, c = shape
    args = [_rn(gen, m, c), 1 + _rn(gen, c, scale=0.1), _rn(gen, c, scale=0.1),
            _rn(gen, 8 * c, c, scale=c ** -0.5), _rn(gen, 8 * c, scale=0.1),
            _rn(gen, c, 4 * c, scale=(4 * c) ** -0.5), _rn(gen, c, scale=0.1),
            _rn(gen, m, c) if residual else None]
    before = ffn.K4.launches
    got = ffn.geglu_ffn(*args, impl="cuda")
    assert ffn.K4.launches == before + 1
    _check(got, ffn.geglu_ffn_plain(*(None if t is None else t.float() for t in args)))


@pytest.mark.parametrize("shape", [(300, 320), (200, 96), (130, 1280)])
def test_k4_every_variant(gen, shape):
    """Every compiled G1 variant (with the planner's G2) and G2 variant
    (with the planner's G1) through ``_plan``, at ragged M and columns."""
    m, c = shape
    args = [_rn(gen, m, c), 1 + _rn(gen, c, scale=0.1), _rn(gen, c, scale=0.1),
            _rn(gen, 8 * c, c, scale=c ** -0.5), _rn(gen, 8 * c, scale=0.1),
            _rn(gen, c, 4 * c, scale=(4 * c) ** -0.5), _rn(gen, c, scale=0.1), _rn(gen, m, c)]
    ref = ffn.geglu_ffn_plain(*(t.float() for t in args))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = [ffn.ffn_plan(m, c, sms, g1=v) for v in ffn.FFN_G1_VARIANTS
             if ffn._up_smem(v[0], v[1], c) <= ffn.SMEM_BLOCK]
    plans += [ffn.ffn_plan(m, c, sms, g2=v) for v in ffn.FFN_G2_VARIANTS]
    for plan in plans:
        _check(ffn.geglu_ffn_kernel(*args, _plan=plan), ref)


def test_kernels_raise_on_shapes_they_do_not_take(gen):
    x = _rn(gen, 1, 4, 4, 20)  # Cin % 8 != 0
    with pytest.raises(ValueError, match="K2"):
        conv.conv3x3(x, _rn(gen, 32, 20, 3, 3), impl="cuda")
    with pytest.raises(ValueError, match="K3"):
        q = torch.randn(1, 8, 1, 8, device="cuda")  # f32
        flash_attention.attention(q, q, q, impl="cuda")


def _lse2(q, k):
    """The row log-sum-exp K3 saves: log2 domain, (B, H, S)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    return torch.logsumexp(s, dim=-1) * 1.4426950408889634


def _bwd_variant_plans():
    """Every compiled K5/K6 body at d = 40, 64, 80 (the general body and each
    ring variant of either kernel), for ``_plan=``."""
    return [(d, plan) for d in (40, 64, 80)
            for plan in flash_attention.attention_bwd_variants(-(-d // 16) * 16)]


@pytest.mark.parametrize("shape,plan", [
    *(((4, 4096, 8, 40), None), ((4, 1024, 8, 80), None), ((4, 256, 8, 160), None),
      ((4, 64, 8, 160), None), ((1, 100, 3, 24), None), ((2, 192, 2, 128), None),
      ((2, 130, 2, 40), None)),
    *(((2, 300, 3, d), plan) for d, plan in _bwd_variant_plans())])
def test_k5_k6_attention_bwd(gen, shape, plan):
    """K5 then K6 at the train step's shapes and ragged ones, with the
    planner's body and tiles (plan None), and every compiled variant at a
    ragged length (300) through ``_plan``."""
    b, s, h, d = shape
    qkv = _rn(gen, b, s, 3 * h * d)  # strided q, k, v: the split of a fused projection
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    do = _rn(gen, b, s, h, d)
    o, lse = flash_attention.attention_kernel(q, k, v, return_lse=True)
    _check(lse, _lse2(q, k))
    before = (flash_attention.K5.launches, flash_attention.K6.launches)
    got = flash_attention.attention_bwd_kernel(q, k, v, o, lse, do, _plan=plan)
    assert (flash_attention.K5.launches, flash_attention.K6.launches) == (before[0] + 1, before[1] + 1)
    want = flash_attention.attention_bwd_plain(*(t.float() for t in (q, k, v, o, do)))
    for g, w in zip(got, want):
        _check(g, w)


@pytest.mark.parametrize("plan", [
    *(flash_attention.AttentionBwdPlan("general", dp) for dp in (32, 48, 80, 128, 160)),
    *(plan for _, plan in _bwd_variant_plans() if plan.body == "ring")])
def test_k5_k6_occupancy(gen, plan):
    """The runtime's view of the compiled K5/K6: at least one block an SM,
    the shared memory the launch asks for, and no spills in a ring
    variant."""
    occ = flash_attention.attention_bwd_occupancy(plan)
    for k, smem in zip(("K5", "K6"), plan.smem):
        assert occ[k]["blocks_per_sm"] >= 1 and 0 < occ[k]["registers"] <= 255, occ
        assert occ[k]["smem_bytes"] >= smem, occ
        if plan.body == "ring":
            assert occ[k]["spill_bytes"] == 0, occ


def _grads(fn, args, impl, seed=1):
    args = [a.detach().clone().requires_grad_(a.is_floating_point()) for a in args]
    out = fn(*args, impl=impl)
    w = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(seed),
                    device="cuda")
    loss = (out.float() * w).sum()
    return torch.autograd.grad(loss, [a for a in args if a.requires_grad])


def _function_cases(gen):
    x = _rn(gen, 2, 16, 16, 64) + 0.5
    gw, gb = 1 + _rn(gen, 64, scale=0.1), _rn(gen, 64, scale=0.1)
    wt, bias = _rn(gen, 96, 64, 3, 3, scale=(9 * 64) ** -0.5), _rn(gen, 96, scale=0.1)
    m, c = 128, 64
    ffn_args = [_rn(gen, m, c), 1 + _rn(gen, c, scale=0.1), _rn(gen, c, scale=0.1),
                _rn(gen, 8 * c, c, scale=c ** -0.5), _rn(gen, 8 * c, scale=0.1),
                _rn(gen, c, 4 * c, scale=(4 * c) ** -0.5), _rn(gen, c, scale=0.1), _rn(gen, m, c)]
    q, k, v = (_rn(gen, 2, 256, 4, 40) for _ in range(3))
    kc, vc = _rn(gen, 2, 77, 4, 40), _rn(gen, 2, 77, 4, 40)
    return {
        "group_norm_silu": (lambda x, w, b, impl: groupnorm.group_norm_silu(x, w, b, impl=impl),
                            [x, gw, gb]),
        "gn_scale_shift": (lambda x, w, b, impl: groupnorm.gn_scale_shift(x, w, b, impl=impl),
                           [x, gw, gb]),
        "conv3x3": (lambda x, w, b, impl: conv.conv3x3(x, w, b, impl=impl), [x, wt, bias]),
        "gn_silu_conv3x3": (lambda x, gw, gb, w, b, impl: conv.gn_silu_conv3x3(
            x, gw, gb, w, b, impl=impl), [x, gw, gb, wt, bias]),
        "geglu_ffn": (lambda *a, impl: ffn.geglu_ffn(*a, impl=impl), ffn_args),
        "self_attention": (lambda q, k, v, impl: flash_attention.attention(q, k, v, impl=impl),
                           [q, k, v]),
        "cross_attention": (lambda q, k, v, impl: flash_attention.attention(q, k, v, impl=impl),
                            [q, kc, vc]),
    }


@pytest.mark.parametrize("case", ["group_norm_silu", "gn_scale_shift", "conv3x3",
                                  "gn_silu_conv3x3", "geglu_ffn", "self_attention",
                                  "cross_attention"])
def test_function_grads_cuda_vs_torch(gen, case):
    fn, args = _function_cases(gen)[case]
    got = _grads(fn, args, "cuda")
    want = _grads(fn, [a.float() for a in args], "torch")
    for g, w in zip(got, want):
        torch.cuda.synchronize()
        assert torch.isfinite(g).all()
        rel = ((g.float() - w).abs().max() / w.abs().max()).item()
        assert rel <= 5e-2, (case, rel)


def test_self_attention_backward_runs_k5_k6(gen):
    q, k, v = (_rn(gen, 1, 128, 2, 80).requires_grad_() for _ in range(3))
    before = (flash_attention.K5.launches, flash_attention.K6.launches)
    flash_attention.attention(q, k, v, impl="cuda").float().sum().backward()
    assert (flash_attention.K5.launches, flash_attention.K6.launches) == (before[0] + 1, before[1] + 1)
    with pytest.raises(RuntimeError, match="carries no gradient"):
        flash_attention.attention_kernel(q, k, v)


def _q8(gen, n, k):
    """(n, k) int8 codes and f32 scales of a seeded N(0, 1/k) weight."""
    q, scale = quantize_tensor(torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5, axis=1)
    return q, scale.reshape(-1)


def _act(x):
    return x.float().abs().amax() * 0.9  # a calibrated range that clips the largest few


def _k7_inputs(gen, shape, prologue):
    """x, the OIHW int8 weight and its scales, bias, scale_shift and the
    calibrated act_scale of a K7 case."""
    b, h, w, cin, cout = shape
    x = _rn(gen, b, h, w, cin)
    q, scale = _q8(gen, cout, 9 * cin)
    wq = q.reshape(cout, 3, 3, cin).permute(0, 3, 1, 2).contiguous()
    bias = _rn(gen, cout, scale=0.1)
    ss = None
    if prologue:
        gw, gb = 1 + _rn(gen, cin, scale=0.1), _rn(gen, cin, scale=0.1)
        ss = groupnorm.gn_scale_shift_plain(x, gw, gb)
    act = _act(x if ss is None else conv.gn_silu_prologue(x.float(), ss))
    return x, wq, scale, bias, ss, act


@pytest.mark.parametrize("shape", [(1, 16, 16, 320, 320), (8, 32, 32, 640, 640), (8, 8, 8, 2560, 1280),
                                   (2, 64, 64, 320, 320), (1, 5, 7, 64, 40), (2, 6, 6, 96, 32),
                                   (8, 16, 16, 1920, 1280), (8, 64, 64, 960, 320),
                                   (3, 10, 21, 352, 136)])
@pytest.mark.parametrize("prologue", [True, False])
def test_k7_conv3x3_q(gen, shape, prologue):
    """The planner's launch at the W8A8 path's classes (64^2 at Cin = 960, a
    ragged last chunk; the split-K 16^2 and 8^2 stages) and ragged shapes
    (rectangles past the image, Cout past a column block, Cin = 352)."""
    x, wq, scale, bias, ss, act = _k7_inputs(gen, shape, prologue)
    before = conv.K7.launches
    s_x, out_scale = folded_scales(scale, act, floor=True)
    got = conv.conv3x3_w8a8_kernel(x, wq, s_x, out_scale, bias, ss)
    assert conv.K7.launches == before + 1
    _check(got, conv.conv3x3_w8a8_plain(x.float(), wq, scale, act, bias.float(), ss))


@pytest.mark.parametrize("variant", sorted(conv.K7_VARIANTS))
@pytest.mark.parametrize("ksplit", [1, 3])
def test_k7_every_variant(gen, variant, ksplit):
    """Each compiled K7 variant with one and three K parts (the ticketed
    split-K merge) on a ragged shape (rectangles past the image, Cout past
    a column block, a 96-channel last chunk); called twice, so the second
    finds the workspace the first left zero."""
    shape = (2, 9, 19, 352, 200)
    x, wq, scale, bias, ss, act = _k7_inputs(gen, shape, True)
    bm, bn = variant
    tw = 16 if bm == 128 else 8
    plan = conv.Conv3x3QPlan(8, tw, bm, bn, conv.K7_VARIANTS[variant], ksplit)
    s_x, out_scale = folded_scales(scale, act, floor=True)
    want = conv.conv3x3_w8a8_plain(x.float(), wq, scale, act, bias.float(), ss)
    for _ in range(2):
        _check(conv.conv3x3_w8a8_kernel(x, wq, s_x, out_scale, bias, ss, _plan=plan), want)
    ws = conv._Q_WS.get(x.get_device())
    assert ws is None or not ws.any()


@pytest.mark.parametrize("act_scale", [12.7, 3.3, 0.077, 15.875])
def test_k7_codes_equal_the_plain_quantizer(gen, act_scale):
    """Through a weight whose centre tap is the identity K7 returns each
    activation's code times s_x: every code, ties and values an ulp from a
    half step included, must equal quantize_act's (x / s_x rounded half to
    even, clipped), in the scratch and in the output."""
    c = 128
    s_x = act_step(torch.tensor(act_scale, device="cuda"), floor=True)
    steps = torch.randn(4, 16, 16, c, generator=gen, device="cuda") * 60
    x = (steps.round() + 0.5 * (torch.rand(steps.shape, generator=gen, device="cuda") < 0.5)) * s_x
    x = torch.cat([x.bfloat16(), (torch.randn(x.shape, generator=gen, device="cuda") * 200 * s_x)
                   .bfloat16()])
    wq = torch.zeros(c, c, 3, 3, device="cuda", dtype=torch.int8)
    wq[:, :, 1, 1] = torch.eye(c, device="cuda", dtype=torch.int8)
    s, out_scale = folded_scales(torch.ones(c, device="cuda"), torch.tensor(act_scale, device="cuda"),
                                 floor=True)
    got = conv.conv3x3_w8a8_kernel(x, wq, s, out_scale)
    want = quantize_act(x, s_x)
    torch.cuda.synchronize()
    assert torch.equal(conv.k7_codes(x), want)
    assert torch.equal(got, (want.float() * s_x).bfloat16())


def test_k7_occupancy(gen):
    """Every compiled K7 variant: no spills, two blocks an SM (the
    planner's split counts on it), the shared memory the planner computes."""
    for (bm, bn), o in conv.conv3x3_q_occupancy().items():
        assert o["spill_bytes"] == 0 and o["blocks_per_sm"] == 2, (bm, bn, o)
        plan = conv.Conv3x3QPlan(8, 16 if bm == 128 else 8, bm, bn, conv.K7_VARIANTS[(bm, bn)], 1)
        assert o["smem_bytes"] == plan.smem, (bm, bn, o)


@pytest.mark.parametrize("shape", [(32768, 320, 960, True, False), (32768, 320, 320, False, True),
                                   (8192, 640, 640, True, True), (8192, 640, 1920, True, False),
                                   (2048, 1280, 3840, True, False), (512, 1280, 1280, False, True),
                                   (616, 768, 1280, False, False), (616, 768, 320, False, False),
                                   (8, 1280, 1280, False, False), (8, 640, 320, True, True),
                                   (1, 1280, 320, False, False), (1, 320, 1280, False, False),
                                   (100, 64, 40, True, True), (200, 1536, 48, True, False),
                                   (3000, 4096, 512, False, True)])
def test_k8_linear_q(gen, shape):
    """The W8A8 path's classes (LN and residual on and off; M = 32768,
    8192, 2048, 616 and 512, the M = 1 and 8 time embeddings, split K),
    ragged M and N, K > 1280 (the rows' three-pass prologue)."""
    m, k, n, ln, res = shape
    x = _rn(gen, m, k, scale=2.0)
    q, scale = _q8(gen, n, k)
    bias = _rn(gen, n, scale=0.1)
    lw, lb = (1 + _rn(gen, k, scale=0.1), _rn(gen, k, scale=0.1)) if ln else (None, None)
    r = _rn(gen, m, n) if res else None
    h = linear.layer_norm_plain(x.float(), lw, lb) if ln else x
    act = _act(h)
    before = linear.K8.launches
    if ln:
        got = linear.ln_matmul_w8a8(lw, lb, x, q, scale, act, bias, residual=r, impl="cuda")
    else:
        got = linear.matmul_w8a8(x, q, scale, act, bias, residual=r, impl="cuda")
    assert linear.K8.launches == before + 1
    f = lambda t: None if t is None else t.float()  # noqa: E731
    _check(got, linear.matmul_w8a8_plain(x.float(), q, scale, act, bias.float(), f(r), f(lw), f(lb)))


@pytest.mark.parametrize("m", [77, 154])
@pytest.mark.parametrize("k,n", [(768, 2304), (768, 768), (768, 3072), (3072, 768)])
def test_k8_w8a8_text_tower_shapes(gen, m, k, n):
    """The W8A8 ViT-L text tower's linears (fused QKV, out projection, fc1,
    fc2) at b1 (M = 77) and with CFG (154): K8 launched once, against the
    plain version."""
    x = _rn(gen, m, k, scale=2.0)
    q, scale = _q8(gen, n, k)
    bias = _rn(gen, n, scale=0.1)
    act = _act(x)
    before = linear.K8.launches
    got = linear.matmul_w8a8(x, q, scale, act, bias, impl="cuda")
    assert linear.K8.launches == before + 1
    _check(got, linear.matmul_w8a8_plain(x.float(), q, scale, act, bias.float()))


@pytest.mark.parametrize("b", [1, 8])
def test_k3_ring_body_at_the_vision_tower(gen, b):
    """CLIP ViT-L/14 at 224: s = 257 = 4 * 64 + 1 (a last key tile of one key
    and a ragged last query tile), 16 heads of 64, q/k/v a fused QKV's
    split; the planner's ring variant through the entry point and every
    compiled ring variant at d = 64 through the raw kernel."""
    q, k, v = _qkv(gen, b, 257, 16, 64)
    plan = flash_attention.attention_plan(b, 257, 257, 16, 64, torch.cuda.get_device_properties(0)
                                          .multi_processor_count)
    assert plan.body == "ring", plan
    ref = flash_attention.attention_plain(q.float(), k.float(), v.float())
    before = flash_attention.K3.launches
    _check(flash_attention.attention(q, k, v, impl="cuda"), ref)
    assert flash_attention.K3.launches == before + 1
    for variant in _ring_variants(64):
        _check(flash_attention.attention_kernel(q, k, v, _plan=variant), ref)


@pytest.mark.parametrize("shape", [(2, 4096, 8, 40), (2, 1024, 8, 80), (2, 256, 8, 160),
                                   (2, 64, 8, 160)])
def test_k3_cross_body_with_one_key(gen, shape):
    """Class2img's cross-attention: one context token, so one key, at every
    cross site of the SD1.5 UNet at 512^2 with CFG; the cross body, against
    the plain version (each query's output is that key's value)."""
    b, sq, h, d = shape
    q, k, v = _rn(gen, b, sq, h, d), _rn(gen, b, 1, h, d), _rn(gen, b, 1, h, d)
    plan = flash_attention.attention_plan(b, sq, 1, h, d, torch.cuda.get_device_properties(0)
                                          .multi_processor_count)
    assert plan.body == "cross", plan
    before = flash_attention.K3.launches
    got = flash_attention.attention(q, k, v, impl="cuda")
    assert flash_attention.K3.launches == before + 1
    _check(got, flash_attention.attention_plain(q.float(), k.float(), v.float()))
    _check(got, v.float().expand(b, sq, h, d))


@pytest.mark.parametrize("variant", linear.LQ_VARIANTS)
@pytest.mark.parametrize("shape", [(616, 768, 320, True, True), (8, 768, 200, False, True)])
@pytest.mark.parametrize("ksplit", [1, 3])
def test_k8_every_variant(gen, variant, shape, ksplit):
    """Each compiled K8 variant, with one and three K parts (the split-K
    workspace merge), two N tiles a block; the workspace is left zero."""
    m, k, n, ln, res = shape
    x = _rn(gen, m, k, scale=2.0)
    q, scale = _q8(gen, n, k)
    bias = _rn(gen, n, scale=0.1)
    lw, lb = (1 + _rn(gen, k, scale=0.1), _rn(gen, k, scale=0.1)) if ln else (None, None)
    r = _rn(gen, m, n) if res else None
    act = _act(linear.layer_norm_plain(x.float(), lw, lb) if ln else x)
    s_x, out_scale = folded_scales(scale, act)
    kch, nt = -(-k // linear.LQ_KC), -(-n // variant[1])
    nkc = -(-kch // ksplit)
    plan = linear.LinearQPlan(variant, max(1, nt // 2), ksplit, nkc, linear.lq_smem(*variant[:3], nkc))
    f = lambda t: None if t is None else t.float()  # noqa: E731
    want = linear.matmul_w8a8_plain(x.float(), q, scale, act, bias.float(), f(r), f(lw), f(lb))
    for _ in range(2):  # the second call finds the workspace the first left
        _check(linear.matmul_w8a8_kernel(x, q, s_x, out_scale, bias, r, lw, lb, _plan=plan), want)
    ws = linear._LQ_WS.get(x.get_device())
    assert ws is None or not ws.any()


@pytest.mark.parametrize("act_scale", [12.7, 3.3, 0.077, 15.875])
def test_k8_codes_equal_the_plain_quantizer(gen, act_scale):
    """Through an identity weight K8 returns each activation's code times
    s_x: every code, ties and values an ulp from a half step included, must
    equal quantize_act's (x / s_x rounded half to even, clipped)."""
    k = 256
    s_x = act_step(torch.tensor(act_scale, device="cuda"))
    steps = torch.randn(4096, k, generator=gen, device="cuda") * 60
    x = (steps.round() + 0.5 * (torch.rand(4096, k, generator=gen, device="cuda") < 0.5)) * s_x
    x = torch.cat([x.bfloat16(), (torch.randn(4096, k, generator=gen, device="cuda") * 200 * s_x)
                   .bfloat16()])
    eye = torch.eye(k, device="cuda", dtype=torch.int8)
    s, out_scale = folded_scales(torch.ones(k, device="cuda"), torch.tensor(act_scale, device="cuda"))
    got = linear.matmul_w8a8_kernel(x, eye, s, out_scale)
    want = (quantize_act(x, s_x).float() * s_x).bfloat16()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_k8_occupancy(gen):
    """Every compiled K8 variant: no spills, its launch bound's blocks an SM
    where shared memory allows, the shared memory the planner computes."""
    for k in (320, 768, 1280):
        nkc = -(-k // linear.LQ_KC)
        for v, o in linear.linear_q_occupancy(k).items():
            assert o["spill_bytes"] == 0 and o["blocks_per_sm"] >= 1, (k, v, o)
            assert o["smem_bytes"] == linear.lq_smem(*v[:3], nkc), (k, v, o)
    for m, k, n in ((32768, 320, 960), (2048, 1280, 3840), (616, 768, 1280), (1, 1280, 1280)):
        plan = linear.linear_q_plan(m, k, n)
        assert plan.smem == linear.lq_smem(*plan.variant[:3], plan.nkc) <= linear.SMEM_BLOCK


def _k9_inputs(gen, m, c, hidden):
    x = _rn(gen, m, c)
    lw, lb = 1 + _rn(gen, c, scale=0.1), _rn(gen, c, scale=0.1)
    q1, s1 = _q8(gen, 2 * hidden, c)
    q2, s2 = _q8(gen, c, hidden)
    b1, b2, r = _rn(gen, 2 * hidden, scale=0.1), _rn(gen, c, scale=0.1), _rn(gen, m, c)
    hn = linear.layer_norm_plain(x.float(), lw.float(), lb.float())
    act1 = _act(hn)
    hh = linear.matmul_w8a8_plain(hn, q1, s1, act1, b1.float())
    act2 = _act(hh[:, :hidden] * torch.nn.functional.gelu(hh[:, hidden:]))
    return [x, lw, lb, q1, s1, b1, act1, q2, s2, b2, act2, r]


def _k9_want(args):
    return ffn.geglu_ffn_w8a8_plain(*(t.float() if t is not None and t.dtype == torch.bfloat16 else t
                                      for t in args))


@pytest.mark.parametrize("shape", [(32768, 320), (8192, 640), (2048, 1280), (512, 1280), (100, 64),
                                   (300, 160), (77, 1280)])
def test_k9_ffn_q(gen, shape):
    """The planner's launch at the four W8A8 path shapes and ragged M."""
    m, c = shape
    args = _k9_inputs(gen, m, c, 4 * c)
    before = ffn.K9.launches
    got = ffn.geglu_ffn_w8a8(*args, impl="cuda")
    assert ffn.K9.launches == before + 1
    _check(got, _k9_want(args))


@pytest.mark.parametrize("shape", [(300, 320, 1280), (200, 1280, 5120), (70, 96, 256)])
@pytest.mark.parametrize("variant", ffn.FFN_Q_G2_VARIANTS)
def test_k9_every_variant(gen, shape, variant):
    """Each compiled G2 variant behind the planner's G1 at ragged M (rows
    past a block) and at C = 96 (a partial K step, G2 columns past C);
    twice, so the second call runs on the scratch the first left."""
    m, c, hidden = shape
    plan = ffn.ffn_q_plan(m, c, hidden, g2=variant)
    args = _k9_inputs(gen, m, c, hidden)
    want = _k9_want(args)
    s1, os1 = folded_scales(args[4], args[6])
    s2, os2 = folded_scales(args[8], args[10])
    for _ in range(2):
        _check(ffn.geglu_ffn_w8a8_kernel(args[0], args[1], args[2], args[3], s1, os1, args[5],
                                         args[7], s2, os2, args[9], args[11], _plan=plan), want)


@pytest.mark.parametrize("act_scale", [12.7, 3.3, 0.077])
def test_k9_codes_equal_the_plain_quantizer(gen, act_scale):
    """Both quantize points give the plain quantizer's codes exactly.  The
    first: x (no LayerNorm) with ties and values an ulp from a half step.
    The second: a W1 whose value rows are the identity on x's codes and
    whose gate rows are zero with gate bias 8 (gelu(8) == 8 in f32), and a
    second step 16 x the first, so each GeGLU value over the second step is
    within an ulp of half an x code: every odd x code is a near-tie."""
    m, c, hidden = 2048, 128, 256
    s_x = act_step(torch.tensor(act_scale, device="cuda"))
    steps = torch.randn(m // 2, c, generator=gen, device="cuda") * 60
    x = (steps.round() + 0.5 * (torch.rand(steps.shape, generator=gen, device="cuda") < 0.5)) * s_x
    x = torch.cat([x.bfloat16(), (torch.randn(m // 2, c, generator=gen, device="cuda") * 200 * s_x)
                   .bfloat16()])
    w1 = torch.zeros(2 * hidden, c, device="cuda", dtype=torch.int8)
    w1[:c] = torch.eye(c, device="cuda", dtype=torch.int8)
    b1 = torch.zeros(2 * hidden, device="cuda", dtype=torch.bfloat16)
    b1[hidden:] = 8.0
    w2, sc2 = _q8(gen, c, hidden)
    b2 = _rn(gen, c, scale=0.1)
    act1 = torch.tensor(act_scale, device="cuda")
    act2 = act1 * 16
    ones = torch.ones(2 * hidden, device="cuda")
    args = [x, None, None, w1, ones, b1, act1, w2, sc2, b2, act2, None]
    got = ffn.geglu_ffn_w8a8(*args, impl="cuda")
    xq, hq = ffn.k9_codes(x, hidden)
    want_x = quantize_act(x, s_x)
    hv = linear.matmul_w8a8_plain(x.float(), w1, ones, act1, b1.float())
    want_h = quantize_act(hv[:, :hidden] * torch.nn.functional.gelu(hv[:, hidden:]), act_step(act2))
    torch.cuda.synchronize()
    assert torch.equal(xq, want_x)
    assert torch.equal(hq, want_h)
    assert (want_x.abs() % 2 == 1).any()  # near-ties were there to be rounded
    _check(got, _k9_want(args))


def test_k9_occupancy(gen):
    """Every compiled K9 variant: no spills, at least one block an SM, G1's
    shared memory the planner computes."""
    for c in (320, 640, 1280):
        for key, o in ffn.ffn_q_occupancy(c).items():
            assert o["spill_bytes"] == 0 and o["blocks_per_sm"] >= 1, (c, key, o)
            if key[0] == "G1":
                assert o["smem_bytes"] == ffn.g1_smem(key[1], key[2], c), (c, key, o)
            else:
                assert o["smem_bytes"] == ffn.g2_smem(*key[1:]), (c, key, o)


def test_w8a8_kernels_raise_on_shapes_they_do_not_take(gen):
    x = _rn(gen, 4, 48)  # K % 32 != 0
    q, scale = _q8(gen, 64, 48)
    with pytest.raises(ValueError, match="K8"):
        linear.matmul_w8a8(x, q, scale, _act(x), impl="cuda")
    with pytest.raises(NotImplementedError, match="inference-only"):
        linear.matmul_w8a8(_rn(gen, 4, 64).requires_grad_(), *_q8(gen, 64, 64),
                           torch.tensor(1.0, device="cuda"), impl="cuda")


# ---------------------------------------------------------------------------
# K10-K12: the bf16 fused matmuls and the Winograd conv, behind the switches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(18432, 320, 960), (4608, 640, 640), (1152, 1280, 1280),
                                   (288, 2560, 1280), (77, 64, 40), (1, 320, 1280)])
@pytest.mark.parametrize("ln,res", [(True, False), (False, True), (False, False)])
def test_k10_linear(gen, monkeypatch, shape, ln, res):
    monkeypatch.setenv("SD_TPU_FUSED_MM", "all")
    m, k, n = shape
    x, w = _rn(gen, m, k, scale=2.0), _rn(gen, n, k, scale=k ** -0.5)
    bias, r = _rn(gen, n, scale=0.1), _rn(gen, m, n)
    lw, lb = 1 + _rn(gen, k, scale=0.1), _rn(gen, k, scale=0.1)
    before = linear.K10.launches
    if ln:
        got = linear.ln_matmul(lw, lb, x, w, bias, impl="cuda")
        ref = linear.linear_plain(x.float(), w.float(), bias.float(), None, lw.float(), lb.float())
    elif res:
        got = linear.matmul_residual(x, w, bias, r, impl="cuda")
        ref = linear.linear_plain(x.float(), w.float(), bias.float(), r.float())
    else:
        got = linear.linear_kernel(x, w, bias)
        ref = linear.linear_plain(x.float(), w.float(), bias.float())
    assert linear.K10.launches == before + 1
    _check(got, ref)


@pytest.mark.parametrize("shape", [(2, 96, 96, 320, 320), (2, 24, 24, 1280, 1280), (1, 5, 7, 64, 40),
                                   (3, 10, 10, 96, 32), (2, 12, 12, 1280, 1280), (1, 8, 16, 2560, 320)])
def test_k11_gn_matmul(gen, monkeypatch, shape):
    """Row blocks straddle images where H * W is not a multiple of the
    plan's rows a block (the mid block's 144 rows); K = 2560 streams its
    rows (schedule S with the GroupNorm applied to each slab)."""
    monkeypatch.setenv("SD_TPU_FUSED_MM", "all")
    b, h, w_, c, n = shape
    x = _rn(gen, b, h, w_, c, scale=2.0) + 0.5
    gw, gb = 1 + _rn(gen, c, scale=0.1), _rn(gen, c, scale=0.1)
    w, bias = _rn(gen, n, c, scale=c ** -0.5), _rn(gen, n, scale=0.1)
    before = (linear.K11.launches, linear.K10.launches)
    got = linear.gn_matmul(x, gw, gb, w, bias, eps=1e-6, impl="cuda")
    assert (linear.K11.launches, linear.K10.launches) == (before[0] + 1, before[1])
    _check(got, linear.gn_matmul_plain(x.float(), gw.float(), gb.float(), w.float(), bias.float(),
                                       eps=1e-6))


# (M, K, N, LN, residual) of schedule R and S cases: the switched SD2.1
# step's widest, K = 2560 skip projections, the mid block's 288 rows (split
# K), M = 1, ragged N and K, and LN beside a residual.
K10_VARIANT_SHAPES = [(18432, 320, 960, True, False), (4608, 640, 640, False, True),
                      (1152, 1280, 3840, True, False), (288, 2560, 1280, False, True),
                      (288, 1280, 1280, True, True), (1, 320, 1280, False, False),
                      (77, 72, 40, True, True)]


@pytest.mark.parametrize("shape", K10_VARIANT_SHAPES)
def test_k10_every_variant(gen, shape):
    """Each compiled variant that fits the shape (schedule R only with a
    prologue; S also takes the LayerNorm where R's rows do not fit) against
    the plain f32 version, through ``linear_kernel(..., _plan=...)``."""
    m, k, n, ln, res = shape
    x, w = _rn(gen, m, k, scale=2.0), _rn(gen, n, k, scale=k ** -0.5)
    bias, r = _rn(gen, n, scale=0.1), (_rn(gen, m, n) if res else None)
    lw, lb = (1 + _rn(gen, k, scale=0.1), _rn(gen, k, scale=0.1)) if ln else (None, None)
    ref = linear.linear_plain(x.float(), w.float(), bias.float(), None if r is None else r.float(),
                              None if lw is None else lw.float(), None if lb is None else lb.float())
    ran = 0
    for v in linear.LIN_VARIANTS:
        if v[0] and not ln:
            continue
        try:
            plan = linear.linear_plan(m, k, n, "ln" if ln else "none", variant=v)
        except ValueError:
            continue  # its rows do not fit shared memory at this K
        before = linear.K10.launches
        _check(linear.linear_kernel(x, w, bias, r, lw, lb, _plan=plan), ref)
        assert linear.K10.launches == before + 1
        ran += 1
    assert ran >= 2, shape


@pytest.mark.parametrize("rows", [144, 576, 64])
@pytest.mark.parametrize("variant", [v for v in linear.LIN_VARIANTS if v[0]])
def test_k11_row_blocks_straddle_images(gen, rows, variant):
    """K11 where row blocks of 64 and 128 hold rows of two images (144 rows
    an image: SD2.1's mid block; 576: its 24^2 stage), each R variant."""
    b, k, n = 2, 320, 640
    x = _rn(gen, b, rows, 1, k, scale=2.0) + 0.5
    x = x + torch.arange(b, device="cuda").view(b, 1, 1, 1).bfloat16() * 3  # images differ
    gw, gb = 1 + _rn(gen, k, scale=0.1), _rn(gen, k, scale=0.1)
    w, bias = _rn(gen, n, k, scale=k ** -0.5), _rn(gen, n, scale=0.1)
    ss = groupnorm.gn_scale_shift(x, gw, gb, eps=1e-6, impl="cuda")
    plan = linear.linear_plan(b * rows, k, n, "gn", variant=variant)
    got = linear.linear_kernel(x, w, bias, scale_shift=ss, _plan=plan)
    _check(got, linear.gn_matmul_plain(x.float(), gw.float(), gb.float(), w.float(), bias.float(),
                                       eps=1e-6))


def test_k10_k11_plan_mirrors_the_c_dispatch(gen):
    """The planner's shared bytes are the runtime's for the variant at that
    K, every variant compiles without spills, and the C entry refuses a plan
    outside its rules (an N split past the tiles, a K split under R)."""
    for k in (320, 640, 1280, 2560):
        kch = -(-k // linear.LIN_KC)
        for v, o in linear.linear_occupancy(k).items():
            assert o["spill_bytes"] == 0 and o["blocks_per_sm"] >= 1, (k, v, o)
            assert o["smem_bytes"] == linear.lin_smem(*v[:4], kch), (k, v, o)
    shapes = [(18432, 320, 960, "ln"), (4608, 640, 640, "gn"), (1152, 1280, 3840, "ln"),
              (288, 2560, 1280, "none"), (288, 1280, 1280, "gn"), (1, 320, 1280, "none")]
    for m, k, n, pro in shapes:
        plan = linear.linear_plan(m, k, n, pro)
        occ = linear.linear_occupancy(k)[plan.variant]
        assert occ["smem_bytes"] == plan.smem <= linear.SMEM_BLOCK, (m, k, n, plan)
    x, w = _rn(gen, 256, 320), _rn(gen, 320, 320)
    lw, lb = torch.ones(320, device="cuda").bfloat16(), torch.zeros(320, device="cuda").bfloat16()
    good = linear.linear_plan(256, 320, 320, "ln")
    for bad in (good._replace(nsplit=3), good._replace(ksplit=2)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            linear.linear_kernel(x, w, None, None, lw, lb, _plan=bad)


def test_k10_split_k_is_deterministic(gen):
    """Split K (the mid block's residual sites): the same bits twice."""
    m, k, n = 288, 2560, 1280
    x, w, r = _rn(gen, m, k), _rn(gen, n, k, scale=k ** -0.5), _rn(gen, m, n)
    assert linear.linear_plan(m, k, n).ksplit > 1
    a = linear.linear_kernel(x, w, None, r)
    b = linear.linear_kernel(x, w, None, r)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_fused_switch_off_launches_no_k10_k11(gen, monkeypatch):
    monkeypatch.setenv("SD_TPU_FUSED_MM", "0")
    x, w = _rn(gen, 64, 64), _rn(gen, 32, 64, scale=0.125)
    before = (linear.K10.launches, linear.K11.launches)
    linear.matmul_residual(x, w, None, _rn(gen, 64, 32), impl="cuda")
    linear.ln_matmul(torch.ones(64, device="cuda").bfloat16(), torch.zeros(64, device="cuda")
                     .bfloat16(), x, w, impl="cuda")
    linear.gn_matmul(x.reshape(1, 8, 8, 64), torch.ones(64, device="cuda").bfloat16(),
                     torch.zeros(64, device="cuda").bfloat16(), w, impl="cuda")
    assert (linear.K10.launches, linear.K11.launches) == before


@pytest.mark.parametrize("shape", [(2, 96, 96, 320, 320), (2, 48, 48, 640, 640), (2, 24, 24, 1280, 1280),
                                   (2, 48, 48, 1920, 640), (1, 96, 96, 512, 512), (1, 16, 18, 40, 24),
                                   (1, 16, 16, 128, 8), (2, 24, 24, 2560, 1280), (1, 40, 24, 96, 72),
                                   (1, 32, 16, 64, 136), (1, 384, 384, 256, 256)])
@pytest.mark.parametrize("prologue", [True, False])
def test_k12_winograd(gen, monkeypatch, shape, prologue):
    """K12 against its plain f32 version, and against the f32 direct conv
    (TF32 off) within 2.5x of K2's own error (tests/test_winograd.py's bar)."""
    monkeypatch.setenv("SD_TPU_WINOGRAD", "1")
    b, h, w, cin, cout = shape
    x = _rn(gen, b, h, w, cin)
    wt, bias = _rn(gen, cout, cin, 3, 3, scale=(9 * cin) ** -0.5), _rn(gen, cout, scale=0.1)
    gw, gb = 1 + _rn(gen, cin, scale=0.1), _rn(gen, cin, scale=0.1)
    groups = 32 if cin % 32 == 0 else 8
    k12, k2 = winograd.K12.launches, conv.K2.launches
    if prologue:
        got = conv.gn_silu_conv3x3(x, gw, gb, wt, bias, num_groups=groups, impl="cuda")
        ss = groupnorm.gn_scale_shift_plain(x.float(), gw.float(), gb.float(), groups)
    else:
        got = conv.conv3x3(x, wt, bias, impl="cuda")
        ss = None
    assert winograd.K12.launches == k12 + 1 and conv.K2.launches == k2
    _check(got, winograd.conv3x3_winograd_plain(x.float(), wt.float(), bias.float(), ss))
    monkeypatch.setenv("SD_TPU_WINOGRAD", "0")
    direct = (conv.gn_silu_conv3x3(x, gw, gb, wt, bias, num_groups=groups, impl="cuda") if prologue
              else conv.conv3x3(x, wt, bias, impl="cuda"))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        xin = conv.gn_silu_prologue(x.float(), ss) if prologue else x.float()
        truth = conv.conv3x3_plain(xin, wt.float(), bias.float())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    scale = truth.abs().max()
    e12 = ((got.float() - truth).abs().max() / scale).item()
    e2 = ((direct.float() - truth).abs().max() / scale).item()
    assert e12 <= 2.5 * max(e2, 1e-4), (e12, e2)


@pytest.mark.parametrize("region", winograd.WINO_REGIONS)
def test_k12_every_region(gen, region):
    """Each region shape a block can take, at one shape, against the plain
    f32 version."""
    x = _rn(gen, 2, 32, 48, 96)
    wt, bias = _rn(gen, 72, 96, 3, 3, scale=(9 * 96) ** -0.5), _rn(gen, 72, scale=0.1)
    plan = winograd.winograd_plan(2, 32, 48, 96, 72)._replace(region=region)
    got = winograd.conv3x3_winograd_kernel(x, wt, bias, _plan=plan)
    _check(got, winograd.conv3x3_winograd_plain(x.float(), wt.float(), bias.float()))


def test_k12_occupancy(gen):
    """K12's kernel: no spills, one block an SM, the planner's shared bytes."""
    o = winograd.winograd_occupancy()
    assert o["spill_bytes"] == 0 and o["blocks_per_sm"] >= 1, o
    assert o["smem_bytes"] == winograd.WINO_SMEM == winograd.winograd_plan(2, 96, 96, 320, 320).smem, o


def test_k10_k12_raise_on_shapes_they_do_not_take(gen):
    with pytest.raises(ValueError, match="K10"):
        linear.linear_kernel(_rn(gen, 4, 20), _rn(gen, 8, 20))  # K % 8 != 0
    with pytest.raises(ValueError, match="K12"):
        winograd.conv3x3_winograd_kernel(_rn(gen, 1, 16, 16, 20), _rn(gen, 32, 20, 3, 3))
    with pytest.raises(RuntimeError, match="carries no gradient"):
        winograd.conv3x3_winograd_kernel(_rn(gen, 1, 16, 16, 32).requires_grad_(),
                                         _rn(gen, 32, 32, 3, 3))


@pytest.mark.parametrize("case", ["ln_matmul", "matmul_residual", "gn_matmul", "conv3x3_winograd",
                                  "gn_silu_conv3x3_winograd"])
def test_k10_k12_function_grads_cuda_vs_torch(gen, monkeypatch, case):
    """One gradient through each K10-K12 autograd Function (the recompute
    VJP of the plain version) against autograd through the plain version."""
    monkeypatch.setenv("SD_TPU_FUSED_MM", "all")
    monkeypatch.setenv("SD_TPU_WINOGRAD", "1")
    x = _rn(gen, 2, 16, 16, 64) + 0.5
    gw, gb = 1 + _rn(gen, 64, scale=0.1), _rn(gen, 64, scale=0.1)
    wt, cb = _rn(gen, 96, 64, 3, 3, scale=(9 * 64) ** -0.5), _rn(gen, 96, scale=0.1)
    w, bias, r = _rn(gen, 96, 64, scale=0.125), _rn(gen, 96, scale=0.1), _rn(gen, 2, 256, 96)
    xs = x.reshape(2, 256, 64)
    fn, args = {
        "ln_matmul": (lambda x, g, b, w, bb, impl: linear.ln_matmul(g, b, x, w, bb, impl=impl),
                      [xs, gw, gb, w, bias]),
        "matmul_residual": (lambda x, w, b, r, impl: linear.matmul_residual(x, w, b, r, impl=impl),
                            [xs, w, bias, r]),
        "gn_matmul": (lambda x, g, b, w, bb, impl: linear.gn_matmul(x, g, b, w, bb, impl=impl),
                      [x, gw, gb, w, bias]),
        "conv3x3_winograd": (lambda x, w, b, impl: conv.conv3x3(x, w, b, impl=impl), [x, wt, cb]),
        "gn_silu_conv3x3_winograd": (lambda x, g, b, w, bb, impl: conv.gn_silu_conv3x3(
            x, g, b, w, bb, impl=impl), [x, gw, gb, wt, cb]),
    }[case]
    before = linear.K10.launches + linear.K11.launches + winograd.K12.launches
    got = _grads(fn, args, "cuda")
    assert linear.K10.launches + linear.K11.launches + winograd.K12.launches == before + 1
    want = _grads(fn, [a.float() for a in args], "torch")
    for g, wnt in zip(got, want):
        torch.cuda.synchronize()
        assert torch.isfinite(g).all()
        rel = ((g.float() - wnt).abs().max() / wnt.abs().max()).item()
        assert rel <= 5e-2, (case, rel)


# ---------------------------------------------------------------------------
# The img2img path: the VAE encoder's new K1 / K2 shapes, K4 at the CFG
# batch-8 UNet's largest M, and a tiny img2img and inpaint, kernels vs plain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 65536, 128), (1, 16384, 256)])
def test_k1_at_the_encoder_shapes(gen, shape):
    """A stage's first GroupNorm at the previous stage's width: 256^2 x 128
    and 128^2 x 256 (a 512^2 image), statistics and normalize."""
    b, hw, c = shape
    x = _rn(gen, b, hw, 1, c, scale=3.0) + 5.0
    w, bias = 1 + _rn(gen, c, scale=0.1), _rn(gen, c, scale=0.1)
    ss = groupnorm.gn_scale_shift(x, w, bias, eps=1e-6, impl="cuda")
    ref = groupnorm.gn_scale_shift_plain(x.float(), w.float(), bias.float(), 32, 1e-6)
    torch.cuda.synchronize()
    torch.testing.assert_close(ss, ref, rtol=1e-4, atol=1e-4)
    for silu in (True, False):
        _check(groupnorm.group_norm_silu(x, w, bias, eps=1e-6, silu=silu, impl="cuda"),
               groupnorm.group_norm_plain(x.float(), w.float(), bias.float(), 32, 1e-6, silu))


@pytest.mark.parametrize("shape", [(1, 256, 256, 128, 256), (1, 128, 128, 256, 512)])
def test_k2_at_the_encoder_shapes(gen, shape):
    """The encoder's widening convs with the GN+SiLU prologue (K1's
    statistics of the previous width), which no decoder or UNet path has."""
    b, h, w, cin, cout = shape
    x = _rn(gen, b, h, w, cin)
    wt, bias = _rn(gen, cout, cin, 3, 3, scale=(9 * cin) ** -0.5), _rn(gen, cout, scale=0.1)
    gw, gb = 1 + _rn(gen, cin, scale=0.1), _rn(gen, cin, scale=0.1)
    before = conv.K2.launches
    got = conv.gn_silu_conv3x3(x, gw, gb, wt, bias, impl="cuda")
    assert conv.K2.launches == before + 1
    _check(got, conv.gn_silu_conv3x3_plain(x.float(), gw.float(), gb.float(), wt.float(),
                                           bias.float()))


def test_k4_at_the_cfg_batch8_unet(gen):
    """(32768, 320): the first level of the UNet at batch 8 (img2img b4 with CFG)."""
    m, c = 32768, 320
    args = [_rn(gen, m, c), 1 + _rn(gen, c, scale=0.1), _rn(gen, c, scale=0.1),
            _rn(gen, 8 * c, c, scale=c ** -0.5), _rn(gen, 8 * c, scale=0.1),
            _rn(gen, c, 4 * c, scale=(4 * c) ** -0.5), _rn(gen, c, scale=0.1), _rn(gen, m, c)]
    _check(ffn.geglu_ffn(*args, impl="cuda"),
           ffn.geglu_ffn_plain(*(t.float() for t in args)))


@pytest.mark.parametrize("mode", ["img2img", "inpaint"])
def test_tiny_img2img_and_inpaint_kernels_vs_plain(gen, mode):
    """A tiny pipeline on the card (seeded random weights, 64^2, DDPM on the
    cosine schedule, strength 0.5 of 4 steps, injected noise): the final
    latents with the kernels in bf16 within 5e-2 relative L2 of the plain
    path in f32 (TF32 off), and K1-K4 launched."""
    import numpy as np

    from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig
    from stable_diffusion_tpu_torch.models.unet import UNetConfig
    from stable_diffusion_tpu_torch.models.vae import VAEConfig
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion
    from stable_diffusion_tpu_torch.utils.weights import init_random_

    pipe = StableDiffusion.build(
        UNetConfig(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
                   cross_attention_dim=24, t_embed_dim=16),
        CLIPTextConfig(hidden_size=24, intermediate_size=48, num_hidden_layers=2,
                       num_attention_heads=4, max_position_embeddings=77, vocab_size=64),
        VAEConfig(ch_mult=(1, 1, 1, 1), base_channels=32), device="cuda", impl="torch")
    for i, m in enumerate((pipe.unet, pipe.text_encoder, pipe.vae)):
        init_random_(m, i)
    rng = np.random.default_rng(0)
    b = 2 if mode == "img2img" else 1
    lat = (b, 8, 8, 4)
    draws = dict(encode_noise=rng.standard_normal((1, 8, 8, 4), dtype=np.float32),
                 latent_noise=rng.standard_normal(lat, dtype=np.float32),
                 step_noise=rng.standard_normal((2, *lat), dtype=np.float32))
    ids, unc = np.arange(b * 77).reshape(b, 77) % 64, np.zeros((b, 77), np.int64)
    image = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    kw = dict(img_size=(64, 64), inference_steps=4, strength=0.5, sampler="ddpm",
              use_cosine_schedule=True, return_latents=True, **draws)
    if mode == "img2img":
        run = lambda: pipe.generate(ids, unc, input_image=image, **kw)  # noqa: E731
    else:
        mask = np.zeros((64, 64), np.uint8)
        mask[8:40, 16:48] = 255
        draws["mask_noise"] = rng.standard_normal(lat, dtype=np.float32)
        run = lambda: pipe.inpaint(ids, unc, image, mask, mask_noise=draws["mask_noise"], **kw)  # noqa: E731
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        want = run()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    for m in (pipe.unet, pipe.text_encoder, pipe.vae):
        m.to(torch.bfloat16)
    pipe.impl = "cuda"
    counters = (groupnorm.K1, conv.K2, flash_attention.K3, ffn.K4)
    before = [c.launches for c in counters]
    got = run()
    assert all(c.launches > n for c, n in zip(counters, before))
    assert np.isfinite(got).all()
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert rel <= 5e-2, rel


# ---------------------------------------------------------------------------
# The inference CLI's path: K1-K4 at the UNet's batch 1 (no CFG, one-step)
# and batch 4 (one-step b4), checkpoints loaded on the card, one-step
# ---------------------------------------------------------------------------

CLI_PATHS = ("cli_b1", "one_step_b4")


def _tests_module(name):
    """A module of tests/ loaded from its file (another ``tests`` package may
    shadow this one): a CPU plan test's path shape lists, the checkpoint
    writers; none imports JAX."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(os.path.dirname(__file__),
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", CLI_PATHS)
def test_k1_k2_k4_at_the_cli_shapes(gen, path):
    """Every K1 (statistics and normalize), K2 (GN+SiLU prologue) and K4
    shape of the UNet at batch 1 / 4 and its decode (the CPU plan tests'
    ``cli_b1`` / ``one_step_b4`` lists), each one launch, against plain f32."""
    nf, ct = _tests_module("test_torch_norm_ffn_tiles"), _tests_module("test_torch_conv_tiles")
    for b, hw, c in sorted(set(nf.GN_PATHS[path])):
        x = _rn(gen, b, hw, 1, c, scale=3.0) + 5.0
        w, bias = 1 + _rn(gen, c, scale=0.1), _rn(gen, c, scale=0.1)
        torch.testing.assert_close(
            groupnorm.gn_scale_shift(x, w, bias, eps=1e-6, impl="cuda"),
            groupnorm.gn_scale_shift_plain(x.float(), w.float(), bias.float(), 32, 1e-6),
            rtol=1e-4, atol=1e-4)
        _check(groupnorm.group_norm_silu(x, w, bias, eps=1e-6, silu=True, impl="cuda"),
               groupnorm.group_norm_plain(x.float(), w.float(), bias.float(), 32, 1e-6, True))
        del x
    for b, h, w, cin, cout in sorted(set(ct.PATHS[path])):
        x = _rn(gen, b, h, w, cin)
        wt, bias = _rn(gen, cout, cin, 3, 3, scale=(9 * cin) ** -0.5), _rn(gen, cout, scale=0.1)
        gw, gb = 1 + _rn(gen, cin, scale=0.1), _rn(gen, cin, scale=0.1)
        before = conv.K2.launches
        got = conv.gn_silu_conv3x3(x, gw, gb, wt, bias, impl="cuda")
        assert conv.K2.launches == before + 1
        _check(got, conv.gn_silu_conv3x3_plain(x.float(), gw.float(), gb.float(), wt.float(),
                                               bias.float()))
        del x, got
    for m, c in nf.FFN_PATHS[path]:
        args = [_rn(gen, m, c), 1 + _rn(gen, c, scale=0.1), _rn(gen, c, scale=0.1),
                _rn(gen, 8 * c, c, scale=c ** -0.5), _rn(gen, 8 * c, scale=0.1),
                _rn(gen, c, 4 * c, scale=(4 * c) ** -0.5), _rn(gen, c, scale=0.1), _rn(gen, m, c)]
        before = ffn.K4.launches
        got = ffn.geglu_ffn(*args, impl="cuda")
        assert ffn.K4.launches > before
        _check(got, ffn.geglu_ffn_plain(*(t.float() for t in args)))


@pytest.mark.parametrize("path", CLI_PATHS)
def test_k3_at_the_cli_shapes(gen, path):
    """Every K3 shape of the UNet at batch 1 / 4 and its decode: the body
    the planner names, one launch of it, against plain f32 (self-attention
    as the fused QKV's views)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, sq, sk, h, d in sorted(set(_tests_module("test_torch_attention_tiles").PATHS[path])):
        body = flash_attention.attention_plan(b, sq, sk, h, d, sms).body
        assert body != "general", (b, sq, sk, h, d)
        if sq == sk:
            q, k, v = _qkv(gen, b, sq, h, d)
        else:
            q, k, v = _rn(gen, b, sq, h, d), _rn(gen, b, sk, h, d), _rn(gen, b, sk, h, d)
        before = _by_body()
        got = flash_attention.attention(q, k, v, impl="cuda")
        after = _by_body()
        assert {x: after[x] - before[x] for x in after} == {x: int(x == body) for x in after}
        _check(got, flash_attention.attention_plain(q.float(), k.float(), v.float()))
        del q, k, v, got


def _tiny_pipe(dtype=torch.float32, impl="torch", seed=0):
    from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig
    from stable_diffusion_tpu_torch.models.unet import UNetConfig
    from stable_diffusion_tpu_torch.models.vae import VAEConfig
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion
    from stable_diffusion_tpu_torch.utils.weights import init_random_

    pipe = StableDiffusion.build(
        UNetConfig(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
                   cross_attention_dim=24, t_embed_dim=16),
        CLIPTextConfig(hidden_size=24, intermediate_size=48, num_hidden_layers=2,
                       num_attention_heads=4, max_position_embeddings=77, vocab_size=49408),
        VAEConfig(ch_mult=(1, 1, 1, 1), base_channels=32), device="cuda", dtype=dtype, impl=impl)
    for i, m in enumerate((pipe.unet, pipe.text_encoder, pipe.vae)):
        init_random_(m, seed + i)
    return pipe


@pytest.mark.parametrize("kind", ["diffusers", "ldm"])
def test_from_pretrained_on_the_card_bit_for_bit(gen, tmp_path, kind):
    """A tiny f16 checkpoint (diffusers directory or LDM .ckpt) loaded on the
    card in bf16: every tensor the source cast to bf16, bit for bit."""
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion
    from stable_diffusion_tpu_torch.utils import model_converter as mc

    TC = _tests_module("torch_checkpoints")
    src_pipe = _tiny_pipe(torch.float16)
    src = {n: {k: v.cpu() for k, v in getattr(src_pipe, n).state_dict().items()}
           for n in ("unet", "text_encoder", "vae")}
    unet_json = dict(TC.TINY_UNET, block_out_channels=[32, 64, 64, 64], attention_head_dim=[2, 4, 4, 4])
    if kind == "diffusers":
        TC.write_diffusers_dir(str(tmp_path), src["unet"], src["text_encoder"], src["vae"],
                               unet_config=unet_json, text_config=TC.TINY_TEXT,
                               vae_config={"block_out_channels": [32, 32, 32, 32]})
        pipe = StableDiffusion.from_pretrained(str(tmp_path), dtype=torch.bfloat16, device="cuda")
    else:
        path = str(tmp_path / "tiny.ckpt")
        torch.save({"state_dict": TC.to_ldm(src["unet"], src["vae"], src["text_encoder"],
                                            version="1.5")}, path)
        pipe = _tiny_pipe(torch.bfloat16, "auto")
        for name, sd in mc.load_ldm_checkpoint(path).items():
            mc.load_into(getattr(pipe, name), sd)
    for name in ("unet", "text_encoder", "vae"):
        got = getattr(pipe, name).state_dict()
        assert sorted(got) == sorted(src[name])
        for k, v in got.items():
            assert v.is_cuda and v.dtype == torch.bfloat16, k
            assert torch.equal(v, src[name][k].cuda().to(torch.bfloat16)), k


@pytest.mark.parametrize("batch", [1, 3])
def test_tiny_one_step_kernels_vs_plain(gen, batch):
    """A tiny pipeline's one-step image (64^2, seeded random weights, the
    same latents; batch 3 cycles two rows of ids): the kernels in bf16
    within 5e-2 relative L2 of the plain path in f32 (TF32 off), K1-K4
    launched."""
    import numpy as np

    pipe = _tiny_pipe()
    ids = np.arange(2 * 77).reshape(2, 77) % 49408 if batch > 1 else np.arange(77)[None]
    lat = np.random.default_rng(0).standard_normal((batch, 8, 8, 4), dtype=np.float32)
    run = lambda: pipe.generate_in_one_step(ids, img_size=(64, 64), batch_size=batch,  # noqa: E731
                                            initial_latents=lat) * 2 - 1
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        want = run()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    for m in (pipe.unet, pipe.text_encoder, pipe.vae):
        m.to(torch.bfloat16)
    pipe.impl = "cuda"
    counters = (groupnorm.K1, conv.K2, flash_attention.K3, ffn.K4)
    before = [c.launches for c in counters]
    got = run()
    assert all(c.launches > n for c, n in zip(counters, before))
    assert got.shape == (batch, 64, 64, 3) and np.isfinite(got).all()
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert rel <= 5e-2, rel


# ---------------------------------------------------------------------------
# DeepCache's split UNet and the trainer's checkpoints on the card
# ---------------------------------------------------------------------------

SERVING_COUNTERS = {"K1": groupnorm.K1, "K2": conv.K2, "K3": flash_attention.K3, "K4": ffn.K4}


def _sd15_unet():
    from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
    from stable_diffusion_tpu_torch.utils.weights import build, init_random_

    return init_random_(build(UNet, UNetConfig.sd15(), device="cuda", dtype=torch.bfloat16), 0)


def _recorded(fn):
    """K1-K4's launch shapes (Counters) in ``fn()``, and K3's general-body
    launches."""
    counters = {**SERVING_COUNTERS, "general": flash_attention.K3_BY_BODY["general"]}
    for c in counters.values():
        c.record()
    try:
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
    finally:
        shapes = {k: c.stop_recording() for k, c in counters.items()}
    return out, shapes


@pytest.mark.parametrize("batch", [1, 2])
def test_split_unet_shapes_are_a_subset_of_the_full_unets(gen, batch):
    """At 512^2 (64^2 latents), UNet batch 1 and 2: every K1-K4 shape of
    ``forward_split`` is one of ``forward``'s at the same counts (the split
    is the same body), and a cached step launches only shapes of the full
    pass, fewer K2, K3 and K4 than it, and never K3's general body."""
    unet = _sd15_unet()
    x = _rn(gen, batch, 64, 64, 4)
    cond = _rn(gen, batch, 77, 768)
    t = torch.tensor([500], device="cuda")
    full, full_shapes = _recorded(lambda: unet(x, t, cond, impl="cuda"))
    (split, deep), split_shapes = _recorded(lambda: unet.forward_split(x, t, cond, impl="cuda"))
    assert torch.equal(full, split) and split_shapes == full_shapes
    assert deep.shape == (batch, 64, 64, 640)
    cached, cached_shapes = _recorded(
        lambda: unet.forward_cached(x, torch.tensor([480], device="cuda"), cond, deep, impl="cuda"))
    assert torch.isfinite(cached).all()
    for k in SERVING_COUNTERS:
        assert set(cached_shapes[k]) <= set(full_shapes[k]), k
    for k in ("K2", "K3", "K4"):
        assert 0 < sum(cached_shapes[k].values()) < sum(full_shapes[k].values()), k
    assert not cached_shapes["general"] and not full_shapes["general"]


def test_deepcache_request_launches_fewer_kernels(gen):
    """Two DDIM steps at 512^2 with CFG: k = 2 (a full step, then a cached
    one) launches fewer K2, K3 and K4 than k = 1 (two full steps), the text
    encode and the decode the same in both; its image is finite."""
    import numpy as np

    from stable_diffusion_tpu_torch.pipeline import StableDiffusion
    from stable_diffusion_tpu_torch.utils.weights import init_random_

    pipe = StableDiffusion.for_version("1.5", device="cuda", dtype=torch.bfloat16, impl="cuda")
    for i, m in enumerate((pipe.unet, pipe.text_encoder, pipe.vae)):
        init_random_(m, i)
    ids, unc = np.arange(77)[None] % 49408, np.zeros((1, 77), np.int64)
    launches = {}
    for k in (1, 2):
        before = {n: c.launches for n, c in SERVING_COUNTERS.items()}
        img = pipe.generate(ids, unc, img_size=(512, 512), inference_steps=2, seed=0,
                            deepcache_interval=k, output_dtype="uint8")
        launches[k] = {n: c.launches - before[n] for n, c in SERVING_COUNTERS.items()}
        assert img.shape == (1, 512, 512, 3) and int(img.max()) > int(img.min())
    for n in ("K2", "K3", "K4"):
        assert 0 < launches[2][n] < launches[1][n], (n, launches)


def test_train_checkpoint_loads_back_onto_cuda_bit_for_bit(gen, tmp_path):
    """A train state after two micro-steps (one update) of a tiny UNet on the
    card with the 8-bit Adam, EMA and accumulation 2, saved and loaded onto
    cuda: every tensor on the card, of its dtype, equal bit for bit."""
    from stable_diffusion_tpu_torch import optim, training as T
    from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
    from stable_diffusion_tpu_torch.schedulers import schedule as S
    from stable_diffusion_tpu_torch.utils import checkpoint as ckpt
    from stable_diffusion_tpu_torch.utils.tree import tree_leaves
    from stable_diffusion_tpu_torch.utils.weights import build, init_random_

    unet = init_random_(build(UNet, UNetConfig(block_out_channels=(32, 64, 64, 64),
                                               attention_head_dim=(2, 4, 4, 4),
                                               cross_attention_dim=24, t_embed_dim=16),
                              device="cuda", dtype=torch.bfloat16), 0)
    cfg = T.TrainConfig(rank=4, alpha=4.0, use_ema=True, ema_start=0, grad_accum_steps=2,
                        use_8bit_adam=True)
    state = T.init_train_state(gen, {"unet": unet}, cfg)
    step = T.make_train_step({"unet": unet}, schedule=S.make_schedule(), train_cfg=cfg,
                             impl="cuda")
    for _ in range(2):
        t, noise, vnoise = T.sample_noise_for_latents(gen, (4, 8, 8, 4), dtype=torch.bfloat16)
        state, _ = step(state, {"t": t, "noise": noise, "vae_noise": vnoise,
                                "latent_mean": _rn(gen, 4, 8, 8, 4),
                                "latent_std": _rn(gen, 4, 8, 8, 4).abs(),
                                "text_emb": _rn(gen, 4, 77, 24)})
    path = ckpt.save_train_checkpoint(str(tmp_path / "epoch-0"), {"epoch": 0, "state": state})
    back = ckpt.load_train_checkpoint(path, device=torch.device("cuda"))["state"]
    assert back["step"] == state["step"] == 2
    assert isinstance(tree_leaves(back["opt_state"]["inner"][1]["mu"])[0], optim.Q8)

    def tensors(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        if isinstance(tree, dict):
            return [t for k in sorted(tree) for t in tensors(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [t for v in tree for t in tensors(v)]
        return []

    a, b = tensors(state), tensors(back)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert y.is_cuda and y.dtype == x.dtype and torch.equal(x, y)
