"""The port's kernels K1-K4 against their plain versions, on a CUDA card.

Every test here needs the card and skips without one.  This file imports no
JAX, so it also runs where JAX is not installed; run it there with the
repository's conftest (which imports JAX) left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Inputs are bf16 draws from a seeded generator; the reference is the plain
version in f32 on the same values.  Tolerance: max|kernel - plain| <=
2e-2 * max|plain| (bf16 outputs and bf16-rounded intermediates, as in the
JAX kernels).
"""

import pytest
import torch

from stable_diffusion_tpu_torch.ops import conv, ffn, flash_attention, groupnorm

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


@pytest.mark.parametrize("shape", [(2, 16, 32), (2, 4096, 320), (1, 4096, 512), (2, 64, 2560)])
@pytest.mark.parametrize("silu", [True, False])
def test_k1_groupnorm(gen, shape, silu):
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


@pytest.mark.parametrize("shape", [(1, 4, 4, 32, 32), (2, 32, 32, 960, 320), (1, 64, 64, 512, 256),
                                   (2, 8, 8, 2560, 1280), (1, 5, 7, 64, 40), (2, 6, 6, 96, 32)])
@pytest.mark.parametrize("prologue", [True, False])
def test_k2_conv3x3(gen, shape, prologue):
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


@pytest.mark.parametrize("shape", [(16, 32), (8192, 320), (2048, 640), (512, 1280), (100, 64)])
def test_k4_ffn(gen, shape):
    m, c = shape
    args = [_rn(gen, m, c), 1 + _rn(gen, c, scale=0.1), _rn(gen, c, scale=0.1),
            _rn(gen, 8 * c, c, scale=c ** -0.5), _rn(gen, 8 * c, scale=0.1),
            _rn(gen, c, 4 * c, scale=(4 * c) ** -0.5), _rn(gen, c, scale=0.1), _rn(gen, m, c)]
    before = ffn.K4.launches
    got = ffn.geglu_ffn(*args, impl="cuda")
    assert ffn.K4.launches == before + 1
    _check(got, ffn.geglu_ffn_plain(*(t.float() for t in args)))


def test_kernels_raise_on_shapes_they_do_not_take(gen):
    x = _rn(gen, 1, 4, 4, 20)  # Cin % 8 != 0
    with pytest.raises(ValueError, match="K2"):
        conv.conv3x3(x, _rn(gen, 32, 20, 3, 3), impl="cuda")
    with pytest.raises(ValueError, match="K3"):
        q = torch.randn(1, 8, 1, 8, device="cuda")  # f32
        flash_attention.attention(q, q, q, impl="cuda")
