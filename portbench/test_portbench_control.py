"""The correctness check fails what it must, on the CPU at tiny widths.

* A run drives the whole harness but the look for a chip (the program on
  its plain path in f32), with the timed path broken underneath: a served
  image altered where it is produced; a train step that returns its state
  unchanged; a train step given half of its batch, the mean taken over
  the rest; a train step that leaves the EMA unchanged.  Each run's ``correct`` comes out false; the sound run's true.
* The control, the reference computed in float8 in the program's place,
  reads above each cell's limit (served images), or above one of the
  cell's limits (training), at a size a test run holds.
"""

import numpy as np
import pytest
import torch

from portbench import harness, tiny
from portbench.drivers import serve, train
from portbench.lib import inputs, program
from portbench.reference import nets

SEED = 2 ** 32 + 99
CPU = torch.device("cpu")
SERVE_CELLS = ("sd15-txt2img-b4", "sd21-768-txt2img-b2", "sd15-onestep-b4")


def cell_kw(cell):
    return {"prediction_type": "v_prediction", "act": "gelu"} if "sd21" in cell else {}


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_sound_serving_run_is_correct(cell):
    r = tiny.run(tiny.spec(cell, **cell_kw(cell)), seed=SEED)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_altered_answer_is_not_correct(cell, monkeypatch):
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion

    for name in ("generate", "generate_in_one_step"):
        real = getattr(StableDiffusion, name)

        def altered(self, *a, _real=real, **k):  # one lane's image changed where it is made
            imgs = _real(self, *a, **k).copy()
            imgs[-1] = 255 - imgs[-1]
            return imgs

        monkeypatch.setattr(StableDiffusion, name, altered)
    r = tiny.run(tiny.spec(cell, **cell_kw(cell)), seed=SEED)
    assert not r["correct"], r["compared"]


def test_sound_training_run_is_correct():
    r = tiny.run(tiny.spec("sd15-lora-train-b32"), seed=SEED)
    assert r["correct"], r["compared"]


def _broken_step(monkeypatch, fault):
    from stable_diffusion_tpu_torch import training

    real = training.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def broken(state, batch):
            if fault == "unchanged":
                return state, step(state, batch)[1]
            if fault == "ema_unchanged":
                new, metrics = step(state, batch)
                return {**new, "ema": state["ema"]}, metrics
            return step(state, train.half_rows(batch))

        return broken

    monkeypatch.setattr(training, "make_train_step", make)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "ema_unchanged"])
def test_broken_train_step_is_not_correct(fault, monkeypatch):
    _broken_step(monkeypatch, fault)
    r = tiny.run(tiny.spec("sd15-lora-train-b32"), seed=SEED)
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_serving_control_fails_the_limit(cell):
    s = tiny.spec(cell, **cell_kw(cell))
    ctx = harness.Context(s, seed=SEED, seconds=0.0, trace=False, device=CPU, impl="torch",
                          dtype=torch.float32, t0=0.0)
    w = program.reference_weights(s.config, SEED, CPU, torch.float32)
    low = [(i, np.round(serve.reference_images(w, s.config, s.traffic, SEED, i, CPU,
                                               torch.float32, nets.Ops("fp8")) * 255.0)
            .clip(0, 255).astype(np.uint8)) for i in range(s.traffic["check_requests"])]
    assert serve.check(ctx, low) > s.limits["image_rms"]


def test_training_control_fails_a_limit():
    s = tiny.spec("sd15-lora-train-b32")
    ctx = harness.Context(s, seed=SEED, seconds=0.0, trace=False, device=CPU, impl="torch",
                          dtype=torch.float32, t0=0.0)
    lora0 = inputs.lora_tree(SEED, nets.param_shapes(s.config)["unet"], s.traffic["targets"], 4,
                             4, CPU)
    gaps = train.compare(train.reference(ctx, lora0, ops=nets.Ops("fp8")),
                         train.reference(ctx, lora0))
    assert any(v > s.limits[k] for k, v in gaps.items()), gaps
