"""The port's LoRA DreamBooth training step against the JAX package's, on
the CPU in f32, at the tiny configs of tests/test_training_cached.py, with
the JAX-initialised base weights carried over by the weight bridge and one
LoRA tree (B made non-zero, so gradients reach A, B and alpha) given to
both.

The latents are 16x16 (128^2 images): at 4x4 the deepest stages are 1x1
and their GroupNorms average two values, which makes the gradients so ill
conditioned that the two frameworks' summation orders alone differ by 25%
on some alpha leaves; at 16x16 they agree to ~7e-6.

Tolerances: the loss to 1e-5 relative; gradients per leaf to 2e-4 of the
leaf's largest value (f32 through a UNet summed in another order), and the
0-d alpha leaves to 2e-4 of the largest alpha gradient (each is a reduction
over a whole weight, and some nearly cancel to 0); LoRA and
EMA states after three calls to 1e-5 relative and 1e-5 absolute, a
hundredth of the learning rate: Adam divides each element's gradient by its
own magnitude, so an element whose gradient is near the two frameworks'
noise floor may move by a visibly different fraction of the rate."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stable_diffusion_tpu import schedulers as JS
from stable_diffusion_tpu import training as JT
from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.models import ema as jema
from stable_diffusion_tpu.models import lora as jlora
from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu_torch import training as TT
from stable_diffusion_tpu_torch.models import clip as tclip
from stable_diffusion_tpu_torch.models import ema as tema
from stable_diffusion_tpu_torch.models import unet as tunet
from stable_diffusion_tpu_torch.models import vae as tvae
from stable_diffusion_tpu_torch.schedulers import schedule as TS
from stable_diffusion_tpu_torch.utils.tree import tree_leaves
from stable_diffusion_tpu_torch.utils.weights import from_jax_params, lora_from_jax, lora_to_jax

UNET = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
            cross_attention_dim=32, t_embed_dim=16)
TEXT = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=77, vocab_size=64)
VCFG = jvae.VAEConfig(ch_mult=(1, 1, 1, 1), base_channels=32)


@pytest.fixture(scope="module")
def tiny():
    ucfg, tcfg = junet.UNetConfig(**UNET), jclip.CLIPTextConfig(**TEXT)
    ks = jax.random.split(jax.random.key(0), 2)
    jbase = {"unet": junet.init_unet(ks[0], ucfg), "text_encoder": jclip.init_text_model(ks[1], tcfg)}
    unet = tunet.UNet(tunet.UNetConfig(**UNET))
    unet.load_state_dict(from_jax_params(jbase["unet"]), strict=True)
    text = tclip.CLIPTextModel(tclip.CLIPTextConfig(**TEXT))
    text.load_state_dict(from_jax_params(jbase["text_encoder"]), strict=True)
    return jbase, {"unet": unet, "text_encoder": text}, ucfg, tcfg


def _lora(jbase, cfg, seed=3):
    """JAX's init_lora, with B drawn non-zero from numpy."""
    rng = np.random.default_rng(seed)
    tree = {"unet": jlora.init_lora(jax.random.key(seed), jbase["unet"], rank=cfg.rank,
                                    alpha=cfg.alpha, targets=cfg.lora_targets)}
    if cfg.train_text_encoder:
        tree["text_encoder"] = jlora.init_lora(jax.random.key(seed + 1), jbase["text_encoder"],
                                               rank=cfg.rank, alpha=cfg.alpha,
                                               targets=TT.TEXT_TARGETS)
    tree = jax.tree.map(np.asarray, tree)
    for part in tree.values():
        for entry in part.values():
            entry["lora_B"] = (0.01 * rng.standard_normal(entry["lora_B"].shape)).astype(np.float32)
    return tree


def _batch(seed, *, text_emb=True, hw=16):
    rng = np.random.default_rng(seed)
    b = 4  # 2 instance + 2 prior
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    batch = {"t": rng.integers(0, 1000, b).astype(np.int32), "noise": f(b, hw, hw, 4),
             "vae_noise": f(b, hw, hw, 4), "latent_mean": f(b, hw, hw, 4),
             "latent_std": np.log1p(np.exp(f(b, hw, hw, 4)))}
    if text_emb:
        batch["text_emb"] = f(b, 77, 32)
    else:
        batch["input_ids"] = rng.integers(0, 64, (b, 77)).astype(np.int32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _grads_close(got, want, tol=2e-4):
    leaves = jax.tree_util.tree_leaves_with_path(want)
    alpha_scale = max(abs(float(w)) for _, w in leaves if np.ndim(w) == 0)
    for (path, w), g in zip(leaves, tree_leaves(got)):
        w, g = np.asarray(w), g.numpy()
        scale = alpha_scale if w.ndim == 0 else float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (
            f"{jax.tree_util.keystr(path)}: max|d| {err:.3e} vs leaf scale {scale:.3e}")


@pytest.mark.parametrize("text_emb", [True, False])
def test_dreambooth_loss_and_grads_match_jax(tiny, text_emb):
    """Loss and its gradient over the whole LoRA tree, alpha included; the
    frozen text tower either cached (text_emb) or run on input_ids."""
    jbase, tbase, ucfg, tcfg = tiny
    cfg = TT.TrainConfig(rank=2, alpha=2.0)
    lora = _lora(jbase, cfg)
    batch = _batch(1, text_emb=text_emb)
    table = jnp.asarray(JS.make_schedule().alphas_hat)
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda lo, bt: JT.dreambooth_loss(lo, jbase, bt, ucfg=ucfg, tcfg=tcfg, vcfg=VCFG,
                                          alphas_hat=table, train_cfg=JT.TrainConfig(rank=2, alpha=2.0),
                                          impl="xla")))(lora, batch)
    loss, grads = TT.loss_and_grad(lora_from_jax(lora), tbase, _torch_batch(batch),
                                   alphas_hat=torch.from_numpy(TS.make_schedule().alphas_hat),
                                   train_cfg=cfg, impl="torch")
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert len(tree_leaves(grads)) == len(jax.tree.leaves(want_g)) == 3 * 192
    _grads_close(grads, want_g)


@pytest.mark.parametrize("variant", ["epsilon", "text_lora_v_prediction"])
def test_three_train_steps_match_jax(tiny, variant):
    """Three calls with grad_accum_steps=2, EMA from step 0 and clipping at
    1.0: loss and grad_norm of each call, then the LoRA, EMA and step."""
    jbase, tbase, ucfg, tcfg = tiny
    text_lora = variant != "epsilon"
    kw = dict(rank=2, alpha=2.0, learning_rate=1e-3, grad_accum_steps=2, use_ema=True,
              ema_start=0, max_grad_norm=1.0, train_text_encoder=text_lora)
    jcfg, tcfg_ = JT.TrainConfig(**kw), TT.TrainConfig(**kw)
    pred = "v_prediction" if text_lora else "epsilon"
    lora = _lora(jbase, jcfg)
    jlo = jax.tree.map(jnp.asarray, lora)
    jstate = {"lora": jlo, "opt_state": JT.make_optimizer(jcfg).init(jlo),
              "ema": jema.ema_init(jlo), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(JT.make_train_step(jbase, ucfg=ucfg, tcfg=tcfg, vcfg=VCFG,
                                       schedule=JS.make_schedule(prediction_type=pred),
                                       train_cfg=jcfg, impl="xla"))
    tlo = lora_from_jax(lora)
    tstate = {"lora": tlo, "opt_state": TT.make_optimizer(tcfg_).init(tlo),
              "ema": tema.ema_init(tlo), "step": 0}
    tstep = TT.make_train_step(tbase, schedule=TS.make_schedule(prediction_type=pred),
                               train_cfg=tcfg_, impl="torch")
    before = lora_to_jax(tstate["lora"])
    for call in range(3):
        batch = _batch(10 + call, text_emb=not text_lora)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, _torch_batch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        changed = any(not np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(lora_to_jax(tstate["lora"])), jax.tree.leaves(before)))
        assert changed == (call == 1), call  # the LoRA moves on every 2nd call only
        before = lora_to_jax(tstate["lora"])
    assert tstate["step"] == int(jstate["step"]) == 3
    for name in ("lora", "ema"):
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                                             atol=1e-5, err_msg=name),
                     lora_to_jax(tstate[name]), jstate[name])
    _grads_close(tstate["opt_state"]["acc"], jstate["opt_state"].acc_grads)


def test_gradient_checkpointing_gives_the_same_gradients(tiny):
    """Remat on and off, through the LoRA merge (the recompute must see the
    merged weights that functional_call substituted)."""
    jbase, tbase, _, _ = tiny
    lora = lora_from_jax(_lora(jbase, TT.TrainConfig(rank=2, alpha=2.0)))
    batch = _torch_batch(_batch(5))
    table = torch.from_numpy(TS.make_schedule().alphas_hat)
    outs = [TT.loss_and_grad(lora, tbase, batch, alphas_hat=table, impl="torch",
                             train_cfg=TT.TrainConfig(rank=2, alpha=2.0, gradient_checkpointing=r))
            for r in (False, True)]
    assert float(outs[0][0]) == float(outs[1][0])
    for a, b in zip(tree_leaves(outs[0][1]), tree_leaves(outs[1][1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_a_lora_leaf_cut_from_the_loss_raises(tiny, monkeypatch):
    """A LoRA leaf the graph does not reach (here the first target's delta
    detached, as a detached fused weight would cut it) raises instead of
    reading as a zero gradient."""
    _, tbase, _, _ = tiny
    lora = lora_from_jax(_lora(tiny[0], TT.TrainConfig(rank=2, alpha=2.0)))
    delta, calls = TT.lora_m.lora_delta, []

    def cut_first(entry):
        calls.append(entry)
        return delta(entry).detach() if len(calls) == 1 else delta(entry)
    monkeypatch.setattr(TT.lora_m, "lora_delta", cut_first)
    with pytest.raises(RuntimeError, match="not have been used in the graph"):
        TT.loss_and_grad(lora, tbase, _torch_batch(_batch(5)), impl="torch",
                         alphas_hat=torch.from_numpy(TS.make_schedule().alphas_hat),
                         train_cfg=TT.TrainConfig(rank=2, alpha=2.0))


def test_sample_noise_and_the_unported_image_branch(tiny, vae):
    """The noise draws, and the image branch (ported since: the frozen VAE
    encodes the images with the batch's noise, unscaled, as the cached
    moments give the same latents)."""
    gen = torch.Generator().manual_seed(0)
    t, eps, vn = TT.sample_noise_for_latents(gen, (4, 8, 8, 4))
    assert t.shape == (4,) and t.dtype == torch.int64 and 0 <= int(t.min()) <= int(t.max()) < 1000
    assert eps.shape == vn.shape == (4, 8, 8, 4) and not torch.equal(eps, vn)
    t2, _, _ = TT.sample_batch_noise(torch.Generator().manual_seed(0), torch.zeros(4, 64, 64, 3))
    assert torch.equal(t, t2)
    _, tbase, _, _ = tiny
    batch = _torch_batch(_batch(6, hw=4))
    images = torch.from_numpy(_images(6, 4, 32))
    mean, std = TT.precompute_latent_moments(vae[1], images.numpy(), impl="torch")
    assert mean.shape == std.shape == (4, 4, 4, 4) and mean.dtype == np.float32
    base = dict(tbase, vae=vae[1])
    kw = dict(alphas_hat=torch.from_numpy(TS.make_schedule().alphas_hat),
              train_cfg=TT.TrainConfig(rank=2, alpha=2.0), impl="torch")
    lora = lora_from_jax(_lora(tiny[0], TT.TrainConfig(rank=2, alpha=2.0)))
    cached = dict(batch, latent_mean=torch.from_numpy(mean), latent_std=torch.from_numpy(std))
    del batch["latent_mean"], batch["latent_std"]
    with torch.no_grad():
        from_images = TT.dreambooth_loss(lora, base, dict(batch, images=images), **kw)
        from_moments = TT.dreambooth_loss(lora, base, cached, **kw)
    torch.testing.assert_close(from_images, from_moments, rtol=1e-6, atol=0)


def _images(seed, n, hw):
    return np.random.default_rng(seed).uniform(-1, 1, (n, hw, hw, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def vae():
    params = jvae.init_vae(jax.random.key(7), VCFG)
    model = tvae.VAE(tvae.VAEConfig(ch_mult=VCFG.ch_mult, base_channels=VCFG.base_channels))
    model.load_state_dict(from_jax_params(params), strict=True)
    return params, model.eval()


def test_dreambooth_loss_images_branch_matches_jax(tiny, vae):
    """The loss and its LoRA gradients with ``images`` (128^2, the frozen VAE
    encoding them with ``vae_noise``) against JAX's."""
    jbase, tbase, ucfg, tcfg = tiny
    cfg = TT.TrainConfig(rank=2, alpha=2.0)
    lora = _lora(jbase, cfg)
    batch = _batch(8)
    del batch["latent_mean"], batch["latent_std"]
    batch["images"] = _images(8, 4, 128)
    table = jnp.asarray(JS.make_schedule().alphas_hat)
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda lo, bt: JT.dreambooth_loss(lo, dict(jbase, vae=vae[0]), bt, ucfg=ucfg, tcfg=tcfg,
                                          vcfg=VCFG, alphas_hat=table, train_cfg=cfg,
                                          impl="xla")))(lora, batch)
    loss, grads = TT.loss_and_grad(lora_from_jax(lora), dict(tbase, vae=vae[1]),
                                   _torch_batch(batch),
                                   alphas_hat=torch.from_numpy(TS.make_schedule().alphas_hat),
                                   train_cfg=cfg, impl="torch")
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _grads_close(grads, want_g)


@pytest.mark.parametrize("n,micro_batch", [(5, 2), (3, 8), (4, 4)])
def test_precompute_latent_moments_matches_jax(vae, n, micro_batch):
    """Streamed in micro-batches (the last one padded when n % micro_batch),
    from an indexable sequence of images; within 1e-5 of JAX's."""
    images = list(_images(n, n, 32))
    want_m, want_s = JT.precompute_latent_moments(vae[0], images, VCFG, impl="xla",
                                                  micro_batch=micro_batch)
    got_m, got_s = TT.precompute_latent_moments(vae[1], images, impl="torch",
                                                micro_batch=micro_batch)
    assert got_m.shape == want_m.shape == (n, 4, 4, 4)
    np.testing.assert_allclose(got_m, want_m, atol=1e-5)
    np.testing.assert_allclose(got_s, want_s, atol=1e-5)
