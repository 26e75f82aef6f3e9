"""The port's trainer pieces that hold no kernel against the JAX package, on
the CPU in f32: the LoRA merge, the EMA, the noising of the schedule, and
the optimizer chain against optax (and ``adamw_8bit``) over several steps.

Tolerances: 1e-6 relative for elementwise maths done in the same order
(LoRA, EMA, schedule); 1e-5 relative, 1e-7 absolute for optimizer states
after several steps (f32 pow, sqrt and division in another library)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from stable_diffusion_tpu import optim as joptim
from stable_diffusion_tpu import schedulers as JS
from stable_diffusion_tpu.models import ema as jema
from stable_diffusion_tpu.models import lora as jlora
from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu_torch import optim as toptim
from stable_diffusion_tpu_torch.models import ema as tema
from stable_diffusion_tpu_torch.models import lora as tlora
from stable_diffusion_tpu_torch.models import unet as tunet
from stable_diffusion_tpu_torch.schedulers import schedule as TS
from stable_diffusion_tpu_torch.utils.weights import lora_from_jax, lora_to_jax

UNET = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
            cross_attention_dim=32, t_embed_dim=16)


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _tree(rng, shapes):
    return {k: (rng.standard_normal(s).astype(np.float32) if isinstance(s, tuple)
                else _tree(rng, s)) for k, s in shapes.items()}


def test_match_targets_agree_with_jax():
    params = junet.init_unet(jax.random.key(0), junet.UNetConfig(**UNET))
    with torch.device("meta"):
        model = tunet.UNet(tunet.UNetConfig(**UNET))
    for targets in (jlora.DEFAULT_UNET_TARGETS, ("q_proj", "k_proj", "v_proj", "out_proj")):
        assert tlora.match_targets(model, targets) == jlora.match_targets(params, targets)


@pytest.mark.parametrize("conv", [False, True])
def test_lora_delta_and_merge_match_jax(rng, conv):
    r, o, i = 4, 12, 8
    a_shape, b_shape = ((o, r, 3, 3), (r, i, 3, 3)) if conv else ((o, r), (r, i))
    entry = {"lora_A": rng.standard_normal(a_shape).astype(np.float32),
             "lora_B": rng.standard_normal(b_shape).astype(np.float32),
             "alpha": np.float32(3.0)}
    w_torch = rng.standard_normal((o, i, 3, 3) if conv else (o, i)).astype(np.float32)
    w_jax = np.transpose(w_torch, (2, 3, 1, 0)) if conv else w_torch.T
    merged = jlora.merge_lora({"m": {"kernel": jnp.asarray(w_jax)}},
                              {"m": jax.tree.map(jnp.asarray, entry)})["m"]["kernel"]
    want = np.transpose(np.asarray(merged), (3, 2, 0, 1)) if conv else np.asarray(merged).T
    lora = lora_from_jax({"m": entry})
    got = tlora.merge_lora({"m.weight": torch.from_numpy(w_torch)}, lora)["m.weight"]
    _close(got, want, atol=1e-6)
    # the delta alone, and the round trip of the tree
    _close(tlora.lora_delta(lora["m"]) + torch.from_numpy(w_torch), want, atol=1e-6)
    back = lora_to_jax(lora)
    for k in entry:
        np.testing.assert_array_equal(back["m"][k], entry[k])


def test_lora_merge_casts_delta_to_weight_dtype(rng):
    lora = {"m": {"lora_A": torch.randn(6, 2), "lora_B": torch.randn(2, 5),
                  "alpha": torch.tensor(2.0)}}
    w = torch.randn(6, 5).bfloat16()
    got = tlora.merge_lora({"m.weight": w, "other": w}, lora)
    assert got["m.weight"].dtype == torch.bfloat16 and got["other"] is w


@pytest.mark.parametrize("step,start", [(3, 5), (7, 5), (1, 0)])
def test_ema_matches_jax(rng, step, start):
    shapes = {"a": {"lora_A": (4, 3), "alpha": ()}, "b": {"lora_B": (2, 5)}}
    ema, params = _tree(rng, shapes), _tree(rng, shapes)
    want = jema.ema_update(jax.tree.map(jnp.asarray, ema), jax.tree.map(jnp.asarray, params),
                           step, beta=0.995, start_ema=start)
    got = tema.ema_update(lora_from_jax(ema), lora_from_jax(params), step, beta=0.995,
                          start_ema=start)
    jax.tree.map(lambda g, w: _close(g, w), lora_to_jax(got), jax.tree.map(np.asarray, want))
    init = tema.ema_init(lora_from_jax(ema))
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, w), lora_to_jax(init), ema)


def test_forward_process_and_v_targets_match_jax(rng):
    sched = JS.make_schedule()
    table = jnp.asarray(sched.alphas_hat)
    x0, noise = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    t = np.array([0, 517, 999], np.int32)
    ttable = torch.from_numpy(TS.make_schedule().alphas_hat)
    _close(TS.forward_process(ttable, torch.from_numpy(x0), torch.from_numpy(t),
                              torch.from_numpy(noise)),
           JS.forward_process(table, x0, t, noise), atol=1e-7)
    _close(TS.v_prediction_targets(ttable, torch.from_numpy(x0), torch.from_numpy(noise),
                                   torch.from_numpy(t)),
           JS.v_prediction_targets(table, x0, noise, t), atol=1e-7)
    # a scalar t broadcasts over the batch
    _close(TS.forward_process(ttable, torch.from_numpy(x0), 321, torch.from_numpy(noise)),
           JS.forward_process(table, x0, jnp.int32(321), noise), atol=1e-7)


@pytest.mark.parametrize("kind", ["constant", "constant_with_warmup", "cosine"])
def test_lr_schedules_match_optax(kind):
    want = joptim.make_lr_schedule(kind, 3e-4, warmup_steps=5, total_steps=40)
    got = toptim.make_lr_schedule(kind, 3e-4, warmup_steps=5, total_steps=40)
    for count in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        _close(float(got(count)), float(want(jnp.int32(count))), rtol=1e-6, atol=1e-12)


def _run_both(jtx, ttx, rng, steps, shapes):
    params = _tree(rng, shapes)
    jp, tp = jax.tree.map(jnp.asarray, params), lora_from_jax(params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for _ in range(steps):
        g = jax.tree.map(lambda x: x * 3.0, _tree(rng, shapes))
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update(lora_from_jax(g), ts, tp)
        tp = toptim.apply_updates(tp, tu)
        jax.tree.map(lambda a, b: _close(a, b, rtol=1e-5, atol=1e-7),
                     lora_to_jax(tu), jax.tree.map(np.asarray, ju))
    jax.tree.map(lambda a, b: _close(a, b, rtol=1e-5, atol=1e-7),
                 lora_to_jax(tp), jax.tree.map(np.asarray, jp))
    return js, ts


SHAPES = {"x.q_proj": {"lora_A": (7, 3), "lora_B": (3, 5), "alpha": ()},
          "y.conv": {"lora_A": (4, 3, 3, 3), "lora_B": (3, 300, 3, 3), "alpha": ()}}


@pytest.mark.parametrize("kind,accum,clip", [("constant_with_warmup", 2, 1.0),
                                             ("cosine", 3, 1.0), ("constant", 1, None)])
def test_adamw_chain_matches_optax(rng, kind, accum, clip):
    """MultiSteps(chain(clip_by_global_norm, adamw)) as the JAX trainer
    builds it; grads of norm ~30 so the clip acts."""
    lr_j = joptim.make_lr_schedule(kind, 1e-2, warmup_steps=2, total_steps=10)
    lr_t = toptim.make_lr_schedule(kind, 1e-2, warmup_steps=2, total_steps=10)
    jtx, ttx = optax.adamw(lr_j, weight_decay=1e-2), toptim.adamw(lr_t, weight_decay=1e-2)
    if clip:
        jtx = optax.chain(optax.clip_by_global_norm(clip), jtx)
        ttx = toptim.chain(toptim.clip_by_global_norm(clip), ttx)
    if accum > 1:
        jtx, ttx = optax.MultiSteps(jtx, accum), toptim.multi_steps(ttx, accum)
    js, ts = _run_both(jtx, ttx, rng, 7, SHAPES)
    if accum > 1:
        assert ts["mini_step"] == int(js.mini_step)
        assert ts["gradient_step"] == int(js.gradient_step)
        jax.tree.map(lambda a, b: _close(a, b, rtol=1e-5, atol=1e-7),
                     lora_to_jax(ts["acc"]), jax.tree.map(np.asarray, js.acc_grads))


def test_adamw_8bit_matches_jax(rng):
    lr_j = joptim.make_lr_schedule("constant_with_warmup", 1e-2, warmup_steps=3)
    lr_t = toptim.make_lr_schedule("constant_with_warmup", 1e-2, warmup_steps=3)
    js, ts = _run_both(joptim.adamw_8bit(lr_j), toptim.adamw_8bit(lr_t), rng, 4, SHAPES)
    assert ts["count"] == int(js.count)
    for path in SHAPES:
        for leaf in SHAPES[path]:
            for tq, jq in ((ts["mu"][path][leaf], js.mu[path][leaf]),
                           (ts["nu"][path][leaf], js.nu[path][leaf])):
                assert tq.q.dtype == {np.int8: torch.int8, np.uint8: torch.uint8}[
                    np.asarray(jq.q).dtype.type]
                np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
                _close(tq.scale, jq.scale, rtol=1e-5)
    assert toptim.opt_state_nbytes(ts) < toptim.opt_state_nbytes(
        toptim.adamw(1e-3).init(lora_from_jax(_tree(rng, SHAPES))))
