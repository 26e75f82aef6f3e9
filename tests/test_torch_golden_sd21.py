"""The full-width SD2.1 golden, tests/golden/full_sd21_ddim2.npz.

The JAX package makes it on the CPU (``python -m tests.test_torch_golden_sd21``
regenerates it): the SD2.1 UNet (``UNetConfig.sd21()``: heads of d=64,
cross dim 1024) on numpy Philox(7) parameters, 96x96 latents (768^2
images) and a (1, 77, 1024) context from Philox(11), DDIM-2 without CFG,
v-prediction, XLA (plain) formulation.  ``chip_smoke.py`` phase 8 holds the
port against it on the card, as phase 4 holds it against the SD1.5 golden.

The tier-1 test here runs no UNet: it checks that the port rebuilds the
same inputs with numpy alone, from the fingerprints the JAX side stored
beside the latents (every parameter's key and shape in Philox draw order,
the first draws of the stream, and the latents and context themselves).
"""

import hashlib
import os

import numpy as np
from tests.torch_threads import one_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "full_sd21_ddim2.npz")
LATENT_HW = 96
CTX_DIM = 1024
PARAM_SEED, INPUT_SEED, SCALE = 7, 11, 0.02
HEAD_DRAWS = 64


def shapes_digest(shapes: dict) -> str:
    """sha256 of the sorted ``key:shape`` list: the order Philox draws in."""
    text = "\n".join(f"{k}:{tuple(int(d) for d in shapes[k])}" for k in sorted(shapes))
    return hashlib.sha256(text.encode()).hexdigest()


def first_draws(shapes: dict) -> np.ndarray:
    """The first HEAD_DRAWS parameter values (of the first key in sorted
    order), drawn as the full parameter set draws them."""
    first = sorted(shapes)[0]
    rng = np.random.Generator(np.random.Philox(PARAM_SEED))
    vals = rng.standard_normal(tuple(shapes[first]), dtype=np.float32) * SCALE
    return vals.reshape(-1)[:HEAD_DRAWS]


def inputs():
    """(latents, context): numpy Philox(11) draws, as the JAX side makes them."""
    rng = np.random.Generator(np.random.Philox(INPUT_SEED))
    lat0 = rng.standard_normal((1, LATENT_HW, LATENT_HW, 4), dtype=np.float32)
    ctx = rng.standard_normal((1, 77, CTX_DIM), dtype=np.float32) * 0.1
    return lat0, ctx


def test_port_rebuilds_the_golden_inputs_with_numpy():
    from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
    from stable_diffusion_tpu_torch.utils import weights as W

    import torch

    with torch.device("meta"):
        unet = UNet(UNetConfig.sd21())
    shapes = W.jax_param_shapes(unet)
    g = np.load(GOLDEN)
    assert g["latents"].shape == (1, LATENT_HW, LATENT_HW, 4)
    assert np.isfinite(g["latents"]).all() and float(g["latents"].std()) > 0
    assert shapes_digest(shapes) == str(g["shapes_sha256"])
    assert len(shapes) == int(g["n_params"])
    assert sum(int(np.prod(s)) for s in shapes.values()) == int(g["n_values"])
    np.testing.assert_array_equal(first_draws(shapes), g["first_draws"])
    lat0, ctx = inputs()
    np.testing.assert_array_equal(lat0, g["lat0"])
    np.testing.assert_array_equal(ctx[0, :4], g["ctx_head"])
    assert float(ctx.astype(np.float64).sum()) == float(g["ctx_sum"])


def _regenerate():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import stable_diffusion_tpu.pipeline as P
    from stable_diffusion_tpu import schedulers as S
    from stable_diffusion_tpu.models import unet as junet
    from stable_diffusion_tpu.utils.torch_interop import flatten_tree

    ucfg = junet.UNetConfig.sd21()
    tree = jax.eval_shape(lambda k: junet.init_unet(k, ucfg), jax.random.key(0))
    shapes = {k: v.shape for k, v in flatten_tree(tree).items()}
    rng = np.random.Generator(np.random.Philox(PARAM_SEED))
    params = {}
    for k in sorted(shapes):
        node = params
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(rng.standard_normal(shapes[k], dtype=np.float32) * SCALE)
    sched = S.make_schedule(prediction_type="v_prediction")
    ts = S.inference_timesteps(sched, 2, kind="ddim")
    prev_ts = ts - sched.num_train_timesteps // 2
    lat0, ctx = inputs()
    lat = P._denoise_jit(
        params, jnp.asarray(lat0), jnp.asarray(ctx), jnp.asarray(ts), jnp.asarray(prev_ts),
        jnp.asarray(sched.alphas_hat), jnp.asarray(5.0, jnp.float32), jax.random.key(3), ucfg,
        False, "ddim", "v_prediction", 0.0, "xla")
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(
        GOLDEN, latents=np.asarray(lat), lat0=lat0, ctx_head=ctx[0, :4],
        ctx_sum=np.float64(ctx.astype(np.float64).sum()), shapes_sha256=shapes_digest(shapes),
        n_params=len(shapes), n_values=sum(int(np.prod(s)) for s in shapes.values()),
        first_draws=first_draws(shapes))
    print("wrote", GOLDEN, np.asarray(lat).std())


if __name__ == "__main__":
    _regenerate()
