"""The benchmark's plain reference against the port's plain path
(``impl="torch"``) at tiny widths on the CPU, in float64: the text towers (ViT-L's
QuickGELU, ViT-H's GELU), the UNet, the VAE decoder, DDIM txt2img under CFG
with epsilon and v prediction, the one step, and the LoRA train step's
first micro-steps through AdamW, clipping, accumulation and EMA (in f32,
as the program keeps its LoRA tree and optimizer in f32).  Both sides get
the same seeded weights.  In float32 a random UNet amplifies rounding to
about 2e-4 of its output's scale; in float64 the two agree to about 2e-7
(the module) and 6e-6 (the image), far below any difference of the
mathematics."""

import numpy as np
import pytest
import torch

from portbench import harness, tiny
from portbench.drivers import serve, train
from portbench.lib import inputs, program
from portbench.reference import nets, sampling

SEED = 2 ** 31 + 12345
CPU = torch.device("cpu")
F64 = torch.float64
# the port's plain path keeps a few quantities in f32 whatever its dtype (the
# timestep sinusoid, GroupNorm's scale and shift, the sampler's update)
TOL = 1e-6
TOL_IMAGES = 1e-4


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module", params=[("epsilon", "quick_gelu"), ("v_prediction", "gelu")],
                ids=["sd15-like", "sd21-like"])
def models(request):
    torch.manual_seed(0)
    cfg = tiny.config(*request.param)
    pipe = program.build_pipeline(cfg, SEED, device=CPU, dtype=F64, impl="torch")
    weights = {net: {k: v.double() for k, v in w.items()}
               for net, w in program.reference_weights(cfg, SEED, CPU, torch.float32).items()}
    return cfg, pipe, weights


def test_text_tower(models):
    cfg, pipe, w = models
    cond, _ = inputs.request_ids(SEED, 0, 3)
    with torch.no_grad():
        port = pipe.text_encoder(torch.as_tensor(cond), impl="torch")
    ref = nets.text_encoder(nets.Params(w["text_encoder"]), cfg["text"], torch.as_tensor(cond),
                            nets.Ops())
    assert rel(port, ref) < TOL


def test_unet(models):
    cfg, pipe, w = models
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 8, 8, 4), generator=g, dtype=F64)
    ctx = torch.randn((2, 77, 24), generator=g, dtype=F64)
    t = torch.tensor([10, 900])
    with torch.no_grad():
        port = pipe.unet(x, t, ctx, impl="torch")
    ref = nets.unet(nets.Params(w["unet"]), cfg["unet"], x.permute(0, 3, 1, 2), t, ctx,
                    nets.Ops()).permute(0, 2, 3, 1)
    assert rel(port, ref) < TOL


def test_vae_decode(models):
    cfg, pipe, w = models
    z = torch.randn((2, 8, 8, 4), generator=torch.Generator().manual_seed(2), dtype=F64)
    with torch.no_grad():
        port = pipe.vae.decode(z, impl="torch")
    ref = nets.vae_decode(nets.Params(w["vae"]), cfg["vae"], z.permute(0, 3, 1, 2),
                          nets.Ops()).permute(0, 2, 3, 1)
    assert rel(port, ref) < TOL


@pytest.mark.parametrize("entry", ["txt2img", "one_step"])
def test_served_images(models, entry):
    cfg, pipe, w = models
    tr = {"entry": entry, "batch": 2, "steps": 3, "cfg_scale": 7.5}
    cond, uncond = inputs.request_ids(SEED, 4, 2)
    lat = inputs.request_latents(SEED, 4, serve.latent_shape(cfg, tr), CPU, F64)
    size = (cfg["resolution"],) * 2
    if entry == "txt2img":
        port = pipe.generate(cond, uncond, img_size=size, inference_steps=3, cfg_scale=7.5,
                             initial_latents=lat)
        dec = sampling.txt2img(w, cfg, cond, uncond, lat, steps=3, cfg_scale=7.5, ops=nets.Ops())
    else:
        port = pipe.generate_in_one_step(cond, img_size=size, initial_latents=lat)
        dec = sampling.one_step(w, cfg, cond, lat, ops=nets.Ops())
    ref = ((dec + 1.0) / 2.0).permute(0, 2, 3, 1)
    assert port.shape == tuple(ref.shape)
    assert rel(port, ref) < TOL_IMAGES


def test_train_first_steps():
    cfg = tiny.config()
    s = tiny.spec("sd15-lora-train-b32")
    ctx = harness.Context(s, seed=SEED, seconds=0.0, trace=False, device=CPU, impl="torch",
                          dtype=torch.float32, t0=0.0)
    shapes = nets.param_shapes(cfg)["unet"]
    unet = program.build_unet(cfg, SEED, device=CPU, dtype=torch.float32)
    lora0 = inputs.lora_tree(SEED, shapes, s.traffic["targets"], 4, 4, CPU)
    prog, state, _ = train.first_steps(ctx, unet, lora0)
    ref = train.reference(ctx, lora0)
    gaps = train.compare(prog, ref)
    assert train.loss_gap(prog, ref) < 1e-4
    # alpha's gradient sums many cancelling terms, so f32's summation order shows
    # there, and in Adam's step where that gradient is near eps
    assert gaps["grad_norm_gap"] < 5e-2
    assert gaps["change_norm_gap"] < 5e-2
    assert gaps["ema_change_norm_gap"] < 5e-2
    # before ema_start the EMA copies the parameters
    assert ref["ema_change_norms"] == ref["change_norms"]
    assert state["step"] == s.traffic["check_steps"]
