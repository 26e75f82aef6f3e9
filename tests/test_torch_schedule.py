"""The port's schedule module against the JAX package's, on the CPU in f32:
the cosine tables bit for bit, ``schedule_from_config``, ``apply_strength``,
``prev_timesteps`` and ``ddpm_step`` (within 1e-6: the same f32 formula,
evaluated by two libraries)."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stable_diffusion_tpu.schedulers import schedule as JS
from stable_diffusion_tpu_torch.schedulers import schedule as TS

STEP_ATOL = 1e-6


@pytest.mark.parametrize("cosine", [True, False])
@pytest.mark.parametrize("steps", [1000, 500])
def test_tables_equal_jax(cosine, steps):
    want = JS.make_schedule(num_train_timesteps=steps, use_cosine_schedule=cosine)
    got = TS.make_schedule(num_train_timesteps=steps, use_cosine_schedule=cosine)
    for name in ("betas", "alphas", "alphas_hat"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == np.float32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if cosine:  # the 0.999 clips are in the tables
        assert got.alphas_hat.max() == np.float32(0.999) and got.betas.max() == np.float32(0.999)


@pytest.mark.parametrize("cosine", [True, False])
def test_schedule_from_config(tmp_path, cosine):
    cfg = {"num_train_timesteps": 1000, "beta_start": 0.001, "beta_end": 0.02,
           "prediction_type": "v_prediction"}
    (tmp_path / "scheduler_config.json").write_text(json.dumps(cfg))
    want = JS.schedule_from_config(str(tmp_path), use_cosine_schedule=cosine)
    got = TS.schedule_from_config(str(tmp_path), use_cosine_schedule=cosine)
    assert got.prediction_type == want.prediction_type == "v_prediction"
    assert got.num_train_timesteps == want.num_train_timesteps
    np.testing.assert_array_equal(got.alphas_hat, want.alphas_hat)
    np.testing.assert_array_equal(got.betas, want.betas)


@pytest.mark.parametrize("strength", [0.3, 0.8, 1.0])
@pytest.mark.parametrize("kind", ["ddpm", "ddim"])
@pytest.mark.parametrize("steps", [50, 7])
def test_apply_strength_and_prev_timesteps(strength, kind, steps):
    sched = TS.make_schedule()
    ts = TS.inference_timesteps(sched, steps, kind=kind)
    want_ts = JS.apply_strength(JS.inference_timesteps(JS.make_schedule(), steps, kind=kind),
                                strength)
    got_ts = TS.apply_strength(ts, strength)
    np.testing.assert_array_equal(got_ts, want_ts)
    assert len(got_ts) == int(steps * strength)
    np.testing.assert_array_equal(TS.prev_timesteps(sched, got_ts, steps),
                                  JS.prev_timesteps(JS.make_schedule(), want_ts, steps))


@pytest.mark.parametrize("t,prev_t", [(781, 761), (20, 0), (0, -20), (19, -1)])
@pytest.mark.parametrize("cosine", [True, False])
def test_ddpm_step_matches_jax(t, prev_t, cosine):
    """t > 0 (noise added), t = 0 (no noise), prev_t < 0 (alphas_hat := 1)."""
    rng = np.random.default_rng(t + 7)
    x, eps, noise = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32) for _ in range(3))
    table = JS.make_schedule(use_cosine_schedule=cosine).alphas_hat
    want = np.asarray(JS.ddpm_step(jnp.asarray(table), jnp.asarray(x), jnp.int32(t),
                                   jnp.int32(prev_t), jnp.asarray(eps), jnp.asarray(noise)))
    got = TS.ddpm_step(torch.from_numpy(TS.make_schedule(use_cosine_schedule=cosine).alphas_hat),
                       torch.from_numpy(x), t, prev_t, torch.from_numpy(eps),
                       torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=STEP_ATOL, rtol=0)
    without = TS.ddpm_step(torch.from_numpy(table), torch.from_numpy(x), t, prev_t,
                           torch.from_numpy(eps), torch.zeros(2, 4, 4, 4)).numpy()
    # the noise is added only where t > 0; at prev_t < 0 the variance is
    # floored at 1e-20, so it moves nothing there either
    assert (np.abs(got - without).max() > 1e-3) == (t > 0 and prev_t >= 0)
