"""The full-width VAE encoder golden, tests/golden/full_vae_encode.npz.

The JAX package makes it on the CPU (``python -m tests.test_torch_golden_vae``
regenerates it): the whole SD VAE (``VAEConfig()``: base 128, ch_mult (1, 2,
4, 4)) on numpy Philox(7) parameters at scale 0.02, drawn in sorted key
order over the whole ``init_vae`` tree, and a (1, 256, 256, 3) image in
[-1, 1) from Philox(11); ``encode_moments``' mean and std, (1, 32, 32, 4)
each, XLA (plain) formulation.  ``chip_smoke.py`` phase 9 holds the port's
encoder against it on the card.

The tier-1 test here runs no encoder: it checks that the port rebuilds the
same inputs with numpy alone, from the fingerprints the JAX side stored
beside the moments (every parameter's key and shape in Philox draw order,
the first draws of the stream, and the image).
"""

import hashlib
import os

import numpy as np

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "full_vae_encode.npz")
IMAGE_HW = 256
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


def image() -> np.ndarray:
    """The (1, 256, 256, 3) input in [-1, 1): numpy Philox(11) draws."""
    rng = np.random.Generator(np.random.Philox(INPUT_SEED))
    return rng.random((1, IMAGE_HW, IMAGE_HW, 3), dtype=np.float32) * 2 - 1


def test_port_rebuilds_the_golden_inputs_with_numpy():
    import torch

    from stable_diffusion_tpu_torch.models.vae import VAE, VAEConfig
    from stable_diffusion_tpu_torch.utils import weights as W

    with torch.device("meta"):
        vae = VAE(VAEConfig())
    shapes = W.jax_param_shapes(vae)
    g = np.load(GOLDEN)
    for name in ("mean", "std"):
        assert g[name].shape == (1, IMAGE_HW // 8, IMAGE_HW // 8, 4), name
        assert np.isfinite(g[name]).all() and float(g[name].std()) > 0, name
    assert shapes_digest(shapes) == str(g["shapes_sha256"])
    assert len(shapes) == int(g["n_params"])
    assert sum(int(np.prod(s)) for s in shapes.values()) == int(g["n_values"])
    np.testing.assert_array_equal(first_draws(shapes), g["first_draws"])
    x = image()
    np.testing.assert_array_equal(x[0, 0, :8], g["image_head"])
    assert float(x.astype(np.float64).sum()) == float(g["image_sum"])


def _regenerate():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from stable_diffusion_tpu.models import vae as jvae
    from stable_diffusion_tpu.utils.torch_interop import flatten_tree

    cfg = jvae.VAEConfig()
    tree = jax.eval_shape(lambda k: jvae.init_vae(k, cfg), jax.random.key(0))
    shapes = {k: v.shape for k, v in flatten_tree(tree).items()}
    rng = np.random.Generator(np.random.Philox(PARAM_SEED))
    params = {}
    for k in sorted(shapes):
        node = params
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(rng.standard_normal(shapes[k], dtype=np.float32) * SCALE)
    x = image()
    mean, std = jax.jit(lambda p, x: jvae.encode_moments(p, x, cfg, impl="xla"))(
        params, jnp.asarray(x))
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(
        GOLDEN, mean=np.asarray(mean), std=np.asarray(std), image_head=x[0, 0, :8],
        image_sum=np.float64(x.astype(np.float64).sum()), shapes_sha256=shapes_digest(shapes),
        n_params=len(shapes), n_values=sum(int(np.prod(s)) for s in shapes.values()),
        first_draws=first_draws(shapes))
    print("wrote", GOLDEN, "mean std", float(np.asarray(mean).std()), "std mean",
          float(np.asarray(std).mean()), "std std", float(np.asarray(std).std()))


if __name__ == "__main__":
    _regenerate()
