"""The port's VQ-VAE against the JAX package's, on the CPU in f32, at the
small config of tests/test_vae.py (ch_mult (1, 2), base 32, 16 codes).

Encode (quantized latent, loss, indices), decode, one EMA codebook update
and the straight-through gradient to the encoder, JAX-initialised and
bridged.  The nearest code is an argmin over distances that the two
frameworks sum in different orders (they differ by ~1e-6), so an index
could flip at a near-tie: the test first asserts that at every position the
best and second-best distances lie more than 1e-4 apart, so that equal
indices are a finding and no flip can hide.  Tolerances: the latents,
images, loss and codebook within 1e-5 of each tensor's largest value (f32
through the encoder's ~40 layers), the gradients within 1e-4 (the backward
through the same layers); indices equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu_torch.models import vae as tvae
from stable_diffusion_tpu_torch.utils.weights import from_jax_params
from tests.torch_threads import one_thread  # noqa: F401

CFG = dict(ch_mult=(1, 2), base_channels=32)
K = 16
TOL = 1e-5
MARGIN = 1e-4


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.fixture(scope="module")
def models():
    jp = jvae.init_vqvae(jax.random.key(0), jvae.VAEConfig(**CFG), codebook_size=K)
    # a codebook on the encoder's scale, so codes compete
    z = jvae.encoder_apply(jp["encoder"], jnp.asarray(_x(9)), jvae.VAEConfig(**CFG))
    flat = np.asarray(z).reshape(-1, z.shape[-1])
    jp["quant_embedding"]["embedding"] = jnp.asarray(flat[::max(1, len(flat) // K)][:K])
    model = tvae.VQVAE(tvae.VAEConfig(**CFG), codebook_size=K)
    model.load_state_dict(from_jax_params(jp), strict=True)
    return jp, model


def _x(seed):
    return np.random.default_rng(seed).standard_normal((2, 16, 16, 3)).astype(np.float32)


def test_encode_decode_match_jax(models):
    jp, model = models
    x = _x(0)
    quant, loss, idx = jvae.vqvae_encode(jp, jnp.asarray(x), jvae.VAEConfig(**CFG))
    with torch.no_grad():
        z = tvae.encoder_apply(model.encoder, torch.from_numpy(x), model.cfg.norm_eps, "torch")
        d = tvae.vq_distances(z.reshape(-1, z.shape[-1]), model.quant_embedding.weight)
        two = torch.topk(d, 2, dim=-1, largest=False).values
        assert float((two[:, 1] - two[:, 0]).min()) > MARGIN
        tq, tloss, tidx = tvae.vqvae_encode(model, torch.from_numpy(x), impl="torch")
        img = tvae.vqvae_decode(model, tq, impl="torch")
    assert tq.shape == (2, 8, 8, 8) and tidx.shape == (2, 8, 8) and img.shape == (2, 16, 16, 3)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    assert len(np.unique(np.asarray(idx))) > 1
    _close(tq, quant)
    _close(tloss, loss)
    _close(img, jvae.vqvae_decode(jp, quant, jvae.VAEConfig(**CFG)))


def test_ema_codebook_update_matches_jax(models):
    jp, model = models
    import copy

    model = copy.deepcopy(model)
    quant, _, idx = jvae.vqvae_encode(jp, jnp.asarray(_x(1)), jvae.VAEConfig(**CFG))
    rng = np.random.default_rng(2)
    state = {"N": rng.random(K).astype(np.float32) + 0.5,
             "M": rng.standard_normal((K, 8)).astype(np.float32)}
    new_jp, new_state = jvae.vqvae_ema_codebook_update(
        jp, {k: jnp.asarray(v) for k, v in state.items()}, idx, quant, beta=0.9)
    _, got = tvae.vqvae_ema_codebook_update(
        model, {k: torch.from_numpy(v) for k, v in state.items()},
        torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(quant)), beta=0.9)
    _close(got["N"], new_state["N"])
    _close(got["M"], new_state["M"])
    _close(model.quant_embedding.weight.detach(), new_jp["quant_embedding"]["embedding"])


def test_straight_through_gradient_matches_jax(models):
    """d/d(encoder, codebook) of sum(quant * g) + loss: the straight-through
    copy passes g to the encoder's output as if quantization were the
    identity; the codebook learns from the vq term alone."""
    jp, model = models
    x = _x(3)
    g = np.random.default_rng(4).standard_normal((2, 8, 8, 8)).astype(np.float32)

    def jloss(p):
        quant, loss, _ = jvae.vqvae_encode(dict(jp, **p), jnp.asarray(x), jvae.VAEConfig(**CFG))
        return jnp.sum(quant * g) + loss

    want = jax.grad(jloss)({"encoder": jp["encoder"], "quant_embedding": jp["quant_embedding"]})
    model.zero_grad()
    quant, loss, _ = tvae.vqvae_encode(model, torch.from_numpy(x), impl="torch")
    ((quant * torch.from_numpy(g)).sum() + loss).backward()
    got = {k: p.grad for k, p in model.named_parameters() if not k.startswith("decoder.")}
    flat_want = from_jax_params(jax.tree.map(np.asarray, want))
    assert sorted(flat_want) == sorted(got)
    for k, w in flat_want.items():
        _close(got[k], w, 1e-4)
    assert float(got["quant_embedding.weight"].abs().max()) > 0
