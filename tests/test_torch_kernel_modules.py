"""Each kernel-holding module of the port, in its plain version, against the
JAX package's Pallas kernel run as the JAX tests run it on the CPU
(``pltpu.force_tpu_interpret_mode()``): the same numpy inputs, f32.

K1 groupnorm ``_run_kernels`` / ``_stats_call``, K2 conv ``_gn_silu_conv`` /
``_conv3x3``, K3 flash_attention ``_flash`` (d = 40, 64, 80, 160, 512; 128
and 200 rows) / ``_flash_cross`` (d = 40, 64, 160), K4 ffn ``_ln_ffn_res``.  Tolerances: 2e-5 absolute, as the JAX package's own
interpret-mode tests (the TPU kernels sum in blocks, and the GN stats kernel
takes the one-pass variance), 1e-4 for the stats."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stable_diffusion_tpu.ops import conv as jconv
from stable_diffusion_tpu.ops import ffn as jffn
from stable_diffusion_tpu.ops import flash_attention as jfa
from stable_diffusion_tpu.ops import groupnorm as jgn
from stable_diffusion_tpu_torch.ops import conv as tconv
from stable_diffusion_tpu_torch.ops import ffn as tffn
from stable_diffusion_tpu_torch.ops import flash_attention as tfa
from stable_diffusion_tpu_torch.ops import groupnorm as tgn
from tests.torch_threads import one_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("silu", [True, False])
def test_groupnorm_matches_pallas(rng, silu):
    x = rng.standard_normal((2, 16, 16, 64), dtype=np.float32) * 2 + 1
    w = rng.standard_normal(64, dtype=np.float32)
    b = rng.standard_normal(64, dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jgn._run_kernels(w, b, x, 32, 1e-6, silu))
    got = tgn.group_norm_silu(_t(x), _t(w), _t(b), eps=1e-6, silu=silu, impl="torch").numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_gn_scale_shift_matches_pallas_stats(rng):
    x = rng.standard_normal((2, 8, 8, 320), dtype=np.float32) + 0.5
    w = rng.standard_normal(320, dtype=np.float32)
    b = rng.standard_normal(320, dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jgn._stats_call(w, b, x, 32, 1e-5))
    got = tgn.gn_scale_shift(_t(x), _t(w), _t(b), eps=1e-5, impl="torch").numpy()
    assert got.shape == (2, 2, 320)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_gn_silu_conv_matches_pallas(rng):
    x = rng.standard_normal((1, 16, 16, 64), dtype=np.float32)
    k = rng.standard_normal((3, 3, 64, 64), dtype=np.float32) * 0.05
    bias = rng.standard_normal(64, dtype=np.float32)
    gm = rng.standard_normal(64, dtype=np.float32)
    bt = rng.standard_normal(64, dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jconv._gn_silu_conv(gm, bt, x, k, bias, 32, 1e-5))
        want_plain = np.asarray(jconv._conv3x3(x, k, bias))
    w_oihw = _t(np.transpose(k, (3, 2, 0, 1)))
    got = tconv.gn_silu_conv3x3(_t(x), _t(gm), _t(bt), w_oihw, _t(bias), impl="torch").numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    got_plain = tconv.conv3x3(_t(x), w_oihw, _t(bias), impl="torch").numpy()
    np.testing.assert_allclose(got_plain, want_plain, atol=2e-5)


@pytest.mark.parametrize("d", [40, 64, 80])
def test_self_attention_matches_pallas(rng, d):
    q, k, v = (rng.standard_normal((1, 128, 2, d), dtype=np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa._flash(q, k, v, d ** -0.5))
    got = tfa.attention(_t(q), _t(k), _t(v), impl="torch").numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("d", [40, 80])
def test_self_attention_ragged_matches_pallas(rng, d):
    """200 rows: no multiple of K3's 64-key tile or of its query blocks."""
    q, k, v = (rng.standard_normal((1, 200, 2, d), dtype=np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa._flash(q, k, v, d ** -0.5))
    got = tfa.attention(_t(q), _t(k), _t(v), impl="torch").numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("shape", [(1, 128, 2, 160), (1, 128, 1, 512)])
def test_wide_self_attention_matches_pallas(rng, shape):
    """The head dims K3's wide body takes (SD1.5's d = 160, the VAE's single
    d = 512 head)."""
    d = shape[-1]
    q, k, v = (rng.standard_normal(shape, dtype=np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa._flash(q, k, v, d ** -0.5))
    got = tfa.attention(_t(q), _t(k), _t(v), impl="torch").numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("d", [64, 160])
def test_cross_attention_widths_match_pallas(rng, d):
    """77 text tokens at the head dims of K3's cross body beside d = 40:
    SD2.1's 64 and SD1.5's deepest 160."""
    q = rng.standard_normal((2, 128, 2, d), dtype=np.float32)
    k, v = (rng.standard_normal((2, 77, 2, d), dtype=np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa._flash_cross(q, k, v, d ** -0.5))
    got = tfa.attention(_t(q), _t(k), _t(v), impl="torch").numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_cross_attention_matches_pallas(rng):
    q = rng.standard_normal((2, 128, 2, 40), dtype=np.float32)
    k, v = (rng.standard_normal((2, 77, 2, 40), dtype=np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa._flash_cross(q, k, v, 40 ** -0.5))
    got = tfa.attention(_t(q), _t(k), _t(v), impl="torch").numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    # kv_len masks the tail exactly like a shorter K/V
    kp, vp = (np.concatenate([a, np.full((2, 51, 2, 40), 9.0, np.float32)], axis=1) for a in (k, v))
    got_masked = tfa.attention(_t(q), _t(kp), _t(vp), kv_len=77, impl="torch").numpy()
    np.testing.assert_allclose(got_masked, got, atol=1e-6)


def test_ln_geglu_ffn_matches_pallas(rng):
    b, s, c, hidden = 1, 128, 128, 512
    x = rng.standard_normal((b, s, c), dtype=np.float32)
    res = rng.standard_normal((b, s, c), dtype=np.float32)
    gamma = rng.standard_normal(c, dtype=np.float32)
    beta = rng.standard_normal(c, dtype=np.float32)
    w1 = rng.standard_normal((c, 2 * hidden), dtype=np.float32) * 0.05
    b1 = rng.standard_normal(2 * hidden, dtype=np.float32) * 0.1
    w2 = rng.standard_normal((hidden, c), dtype=np.float32) * 0.05
    b2 = rng.standard_normal(c, dtype=np.float32) * 0.1
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jffn._ln_ffn_res(jnp.asarray(x), gamma, beta, w1, b1, w2, b2,
                                           jnp.asarray(res), 1e-5))
    got = tffn.geglu_ffn(_t(x), _t(gamma), _t(beta), _t(w1.T), _t(b1), _t(w2.T), _t(b2),
                         _t(res), impl="torch").numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
