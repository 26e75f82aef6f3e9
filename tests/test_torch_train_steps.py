"""The port's train step over three calls against the JAX package's, on the
CPU in f32 (gradient accumulation, EMA, clipping; the LoRA, EMA and
accumulator states after the third call).  The tiny models, LoRA trees,
batches and tolerances are tests/test_torch_training.py's, whose module
fixture ``tiny`` this file shares; the two files run on separate workers.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stable_diffusion_tpu import schedulers as JS
from stable_diffusion_tpu import training as JT
from stable_diffusion_tpu.models import ema as jema
from stable_diffusion_tpu_torch import training as TT
from stable_diffusion_tpu_torch.models import ema as tema
from stable_diffusion_tpu_torch.schedulers import schedule as TS
from stable_diffusion_tpu_torch.utils.weights import lora_from_jax, lora_to_jax
from test_torch_training import VCFG, _batch, _grads_close, _lora, _torch_batch, tiny  # noqa: F401
from tests.torch_threads import one_thread  # noqa: F401


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
