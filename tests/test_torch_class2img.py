"""Class2img and the v1 text tower of the port against the JAX package's, on
the CPU in f32.

The class encoder (a table of ``num_classes + 1`` rows) equals JAX's
exactly; the v1-named ViT-L tower (``TextEncoderV1``) is within 1e-5 of
``text_encoder_v1_apply``; ``generate(context=...)`` on a class embedding
(a (B, D) context is one token) replays JAX's ``generate(context=...)`` on
JAX's own draws (the modular path's ``split(key(seed), 3)``: starting
latents from the second key, the DDPM step noise from the third), images
within 1e-4 as tests/test_torch_img2img.py holds them, with CFG (the
[uncond; cond] contexts) and without.
"""

import numpy as np
import jax
import pytest
import torch

from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu_torch.models import clip as tclip
from stable_diffusion_tpu_torch.utils.weights import from_jax_params
from test_torch_deepcache import pipes  # noqa: F401  (the port-initialised pipelines)
from test_torch_img2img import ATOL, TEXT, _normal, _step_draws
from tests.torch_threads import one_thread  # noqa: F401

V1 = dict(TEXT, vocab_size=100)


def test_class_encoder_is_jax_s():
    jp = jclip.init_class_encoder(jax.random.key(0), num_classes=10, emb_dim=24)
    enc = tclip.ClassEncoder(10, 24)
    enc.load_state_dict(from_jax_params(jp), strict=True)
    labels = np.array([0, 3, 10, 7])
    want = np.asarray(jclip.class_encoder_apply(jp, labels))
    got = tclip.class_encoder_apply(enc, torch.from_numpy(labels)).detach().numpy()
    assert got.shape == (4, 24)
    np.testing.assert_array_equal(got, want)
    assert tclip.init_class_encoder(0, 10, 24, device="cpu").embedding.weight.shape == (11, 24)


def test_text_encoder_v1_matches_jax():
    cfg = jclip.CLIPTextConfig(**V1)
    jp = jclip.init_text_encoder_v1(jax.random.key(1), cfg)
    tower = tclip.TextEncoderV1(tclip.CLIPTextConfig(**V1))
    tower.load_state_dict(from_jax_params(jp), strict=True)
    ids = np.random.default_rng(0).integers(0, 100, size=(2, 77))
    want = np.asarray(jclip.text_encoder_v1_apply(jp, ids, cfg, impl="xla"))
    with torch.no_grad():
        got = tclip.text_encoder_v1_apply(tower, torch.from_numpy(ids), impl="torch").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    seeded = tclip.init_text_encoder_v1(0, tclip.CLIPTextConfig(**V1), device="cpu")
    assert sorted(seeded.state_dict()) == sorted(tower.state_dict())


@pytest.mark.parametrize("do_cfg,sampler", [(True, "ddim"), (False, "ddpm")])
def test_generate_with_a_class_context_matches_jax(pipes, do_cfg, sampler):  # noqa: F811
    jpipe, pipe = pipes
    b, steps, seed = 2, 3, 5
    table = np.random.default_rng(1).standard_normal((11, 24)).astype(np.float32)
    labels = np.array([3, 7])
    ctx = table[np.concatenate([[10, 10], labels])] if do_cfg else table[labels]  # 10: uncond
    kw = dict(img_size=(32, 32), do_cfg=do_cfg, cfg_scale=4.0, inference_steps=steps,
              sampler=sampler, seed=seed)
    want = jpipe.generate("", batch_size=b, context=ctx, **kw)
    _, key_lat, key_steps = jax.random.split(jax.random.key(seed), 3)
    shape = (b, 4, 4, 4)
    draws = dict(initial_latents=_normal(key_lat, shape))
    if sampler == "ddpm":
        draws["step_noise"] = _step_draws(key_steps, steps, shape)
    got = pipe.generate(context=ctx, **draws, **kw)
    assert got.shape == (b, 32, 32, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_context_refusals(pipes):  # noqa: F811
    pipe = pipes[1]
    with pytest.raises(ValueError, match="cond_ids or a context"):
        pipe.generate(img_size=(32, 32), inference_steps=1)
    with pytest.raises(ValueError, match=r"\[uncond; cond\]"):
        pipe.generate(context=np.zeros((3, 24), np.float32), img_size=(32, 32), inference_steps=1)
