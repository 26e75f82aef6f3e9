"""The port's primitives against the JAX package on the CPU in f32: layers,
the plain attention (with the causal mask), and the DDIM schedule.  Inputs
are numpy draws from a seed fed to both.  Tolerance 1e-5 absolute unless
stated (f32; reductions run in different orders)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from stable_diffusion_tpu import schedulers as JS
from stable_diffusion_tpu.models import layers as JL
from stable_diffusion_tpu.ops.attention import _xla_sdpa
from stable_diffusion_tpu_torch.models import layers as TL
from stable_diffusion_tpu_torch.ops import attention as TA
from stable_diffusion_tpu_torch.schedulers import schedule as TS
from stable_diffusion_tpu_torch.utils.weights import from_jax_params

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _module(mod, jax_params):
    mod.load_state_dict(from_jax_params(jax_params))
    return mod


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_linear_and_embedding(rng):
    p = {"kernel": rng.standard_normal((6, 5), dtype=np.float32),
         "bias": rng.standard_normal(5, dtype=np.float32)}
    x = rng.standard_normal((2, 3, 6), dtype=np.float32)
    got = TL.linear(_module(nn.Linear(6, 5), p), _t(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(JL.linear(p, x)), atol=ATOL)
    table = rng.standard_normal((9, 4), dtype=np.float32)
    ids = rng.integers(0, 9, (2, 5))
    emb = nn.Embedding(9, 4)
    emb.weight.data = _t(table)
    np.testing.assert_array_equal(TL.embedding(emb, _t(ids)).detach().numpy(),
                                  np.asarray(JL.embedding({"embedding": table}, ids)))


@pytest.mark.parametrize("k,stride,padding", [(3, 1, None), (1, 1, None), (3, 2, 1)])
def test_conv2d(rng, k, stride, padding):
    p = {"kernel": rng.standard_normal((k, k, 8, 6), dtype=np.float32) * 0.2,
         "bias": rng.standard_normal(6, dtype=np.float32)}
    x = rng.standard_normal((2, 8, 8, 8), dtype=np.float32)
    jpad = "SAME" if padding is None else padding
    want = np.asarray(JL.conv2d(p, x, stride=stride, padding=jpad))
    mod = _module(nn.Conv2d(8, 6, k), p)
    got = TL.conv2d(mod, _t(x), stride=stride, padding=padding).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_norms(rng):
    c = 64
    p = {"scale": rng.standard_normal(c, dtype=np.float32),
         "bias": rng.standard_normal(c, dtype=np.float32)}
    x = rng.standard_normal((2, 4, 4, c), dtype=np.float32) * 3 + 2
    gn = _module(nn.GroupNorm(32, c), p)
    got = TL.group_norm(gn, _t(x), eps=1e-6).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(JL.group_norm(p, x, eps=1e-6)), atol=ATOL)
    ln = _module(nn.LayerNorm(c), p)
    got = TL.layer_norm(ln, _t(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(JL.layer_norm(p, x)), atol=ATOL)


def test_activations_geglu_upsample(rng):
    x = rng.standard_normal((3, 4, 4, 8), dtype=np.float32) * 3
    for t_fn, j_fn in ((TL.silu, JL.silu), (TL.gelu, JL.gelu), (TL.quick_gelu, JL.quick_gelu)):
        np.testing.assert_allclose(t_fn(_t(x)).numpy(), np.asarray(j_fn(x)), atol=ATOL)
    np.testing.assert_array_equal(TL.upsample_nearest_2x(_t(x)).numpy(),
                                  np.asarray(JL.upsample_nearest_2x(x)))
    p = {"proj": {"kernel": rng.standard_normal((8, 12), dtype=np.float32),
                  "bias": rng.standard_normal(12, dtype=np.float32)}}
    got = TL.geglu(_module(TL.GEGLU(8, 6), p), _t(x)).detach().numpy()
    # outputs reach ~200 here, so the f32 bound is relative as well
    np.testing.assert_allclose(got, np.asarray(JL.geglu(p, x)), atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_plain(rng, causal):
    q, k, v = (rng.standard_normal((2, 10, 3, 8), dtype=np.float32) for _ in range(3))
    want = np.asarray(_xla_sdpa(q, k, v, causal=causal))
    got = TA.sdpa(_t(q), _t(k), _t(v), causal=causal, impl="torch").numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_schedule_tables():
    js, ts_ = JS.make_schedule(), TS.make_schedule()
    for name in ("betas", "alphas", "alphas_hat"):
        np.testing.assert_array_equal(getattr(ts_, name), getattr(js, name))
    for steps in (2, 4, 50):
        np.testing.assert_array_equal(TS.inference_timesteps(ts_, steps, kind="ddim"),
                                      JS.inference_timesteps(js, steps, kind="ddim"))


@pytest.mark.parametrize("steps", [1, 2, 4, 50, 999])
def test_inference_timesteps_default_kind(steps):
    """Called without ``kind``, both packages give the same timesteps (the
    port's default was "ddim", every step one above the JAX default's)."""
    js, ts_ = JS.make_schedule(), TS.make_schedule()
    np.testing.assert_array_equal(TS.inference_timesteps(ts_, steps),
                                  JS.inference_timesteps(js, steps))


@pytest.mark.parametrize("pred,eta,t,pt", [("epsilon", 0.0, 981, 961), ("epsilon", 0.0, 1, -19),
                                            ("v_prediction", 0.0, 501, 1),
                                            ("epsilon", 0.7, 501, 481)])
def test_ddim_step(rng, pred, eta, t, pt):
    sched = JS.make_schedule()
    table = sched.alphas_hat
    x = rng.standard_normal((1, 4, 4, 4), dtype=np.float32)
    mo = rng.standard_normal((1, 4, 4, 4), dtype=np.float32)
    noise = rng.standard_normal((1, 4, 4, 4), dtype=np.float32)
    want = np.asarray(JS.ddim_step(jnp.asarray(table), x, jnp.asarray(t), jnp.asarray(pt), mo,
                                   prediction_type=pred, eta=eta, noise=noise))
    got = TS.ddim_step(_t(table), _t(x), t, pt, _t(mo), prediction_type=pred, eta=eta,
                       noise=_t(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("hw", [(1, 1), (1, 3), (2, 2)])
def test_upsample_nearest_2x_is_contiguous(hw):
    """From a 1x1 (or 1-row) image too: K2 takes only contiguous NHWC."""
    x = np.random.default_rng(hw[1]).standard_normal((2, *hw, 8)).astype(np.float32)
    got = TL.upsample_nearest_2x(torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(JL.upsample_nearest_2x(x)))
