"""``StableDiffusion.training_loss`` of the port against JAX's
``pipe.training_loss``, on the CPU in f32.

The tiny pipeline of tests/test_pipeline.py's ``test_training_loss`` (its
UNet, a 24-wide text tower of vocabulary 100, a four-stage VAE), here
JAX-initialised and carried over by the weight bridge, and its inputs (b2
images, zero token ids, t = (10, 500)) at 128^2 (16^2 latents) where it
has 64^2: at 8^2 latents the UNet's deepest stage is 1x1 and its
GroupNorms normalise two values, so f32 summation order alone moves its
gradients by 2e-4 of their scale (tests/test_torch_training.py found the
same at 4^2; at 16^2 the two frameworks agree to ~1e-5).  Under the epsilon
schedule and the v-prediction one, the loss within 1e-5 (relative) and the
gradient of every UNet leaf, transposed by the bridge's rule
(``from_jax_params`` of JAX's gradient tree), within 1e-4 relative: of the
leaf's largest value, or of a hundredth of the tree's largest where the
leaf's is smaller.  A leaf whose gradient nearly cancels (a time embedding
into a GroupNorm, at 2e-9 against the tree's 0.13) carries the f32
summation noise of its terms, not of its sum.

On a sharded pipeline (tests/torch_parallel_train_worker.py, a gloo world
of two ranks started once for the module, meshes (1, 2) and (2, 1)): every
rank's loss is JAX's, and its gradient summed over "data", on the rank's
slice of every UNet leaf (``local_shard``), JAX's gradient, by the same
rules (epsilon schedule).
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stable_diffusion_tpu import pipeline as JP
from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig
from stable_diffusion_tpu_torch.models.unet import UNetConfig
from stable_diffusion_tpu_torch.models.vae import VAEConfig
from stable_diffusion_tpu_torch.parallel import mesh as pmesh
from stable_diffusion_tpu_torch.pipeline import StableDiffusion
from stable_diffusion_tpu_torch.utils.weights import from_jax_params
from tests.torch_threads import one_thread  # noqa: F401

UNET = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
            cross_attention_dim=24, t_embed_dim=16)
TEXT = dict(hidden_size=24, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=77, vocab_size=100)
VAE_CFG = dict(ch_mult=(1, 1, 1, 1), base_channels=32)
SCHEDULES = {"epsilon": {"prediction_type": "epsilon"},
             "v_prediction": {"prediction_type": "v_prediction"}}
MESHES = [(1, 2), (2, 1)]
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_train_worker.py")


@pytest.fixture(scope="module")
def params():
    ks = jax.random.split(jax.random.key(11), 3)
    return {"unet": junet.init_unet(ks[0], junet.UNetConfig(**UNET)),
            "text_encoder": jclip.init_text_model(ks[1], jclip.CLIPTextConfig(**TEXT)),
            "vae": jvae.init_vae(ks[2], jvae.VAEConfig(**VAE_CFG))}


def inputs():
    """test_pipeline.py's training_loss inputs at 128^2, from a seeded numpy generator."""
    rng = np.random.default_rng(0)
    return {"images": rng.standard_normal((2, 128, 128, 3), dtype=np.float32),
            "input_ids": np.zeros((2, 77), np.int64), "t": np.asarray([10, 500]),
            "noise": rng.standard_normal((2, 16, 16, 4), dtype=np.float32)}


def port(params, scheduler_config=None) -> StableDiffusion:
    pipe = StableDiffusion.build(UNetConfig(**UNET), CLIPTextConfig(**TEXT), VAEConfig(**VAE_CFG),
                                 device="cpu", impl="torch", scheduler_config=scheduler_config)
    for name in ("unet", "text_encoder", "vae"):
        getattr(pipe, name).load_state_dict(from_jax_params(params[name]), strict=True)
    return pipe


@pytest.fixture(scope="module")
def sharded(params, tmp_path_factory):
    """Two ranks taking the loss on each mesh, started before JAX's compile
    and awaited by the test that reads them."""
    d = tmp_path_factory.mktemp("training_loss_mesh")
    torch.save({"unet_config": UNET, "text_config": TEXT, "vae_config": VAE_CFG,
                "scheduler_config": SCHEDULES["epsilon"], "meshes": MESHES, "cases": {},
                "states": {n: from_jax_params(params[n]) for n in ("unet", "text_encoder", "vae")},
                "training_loss": inputs()}, d / "job.pt")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "2", str(d / "init"), str(d / "job.pt"),
                               str(d)], env=dict(os.environ, OMP_NUM_THREADS="1"),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]

    def wait():
        for p in procs:
            out, _ = p.communicate(timeout=600)
            assert p.returncode == 0, out[-4000:]
        return {m: [dict(np.load(d / f"rank{r}_{m[0]}x{m[1]}.npz")) for r in range(2)]
                for m in MESHES}
    yield wait
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_results(params, sharded):
    """JAX's loss and ``jax.grad`` over the UNet tree under each schedule,
    the latter as a torch state dict (one compile for both)."""
    pipes = {name: JP.StableDiffusion(params=params, unet_config=junet.UNetConfig(**UNET),
                                      text_config=jclip.CLIPTextConfig(**TEXT),
                                      vae_config=jvae.VAEConfig(**VAE_CFG), impl="xla",
                                      scheduler_config=cfg)
             for name, cfg in SCHEDULES.items()}
    x = inputs()
    args = (jnp.asarray(x["images"]), jnp.asarray(x["input_ids"], jnp.int32),
            jnp.asarray(x["t"], jnp.int32), jnp.asarray(x["noise"]))
    both = jax.jit(lambda p: {name: jax.value_and_grad(lambda q: pipe.training_loss(q, *args))(p)
                              for name, pipe in pipes.items()})(params["unet"])
    return {name: (float(loss), from_jax_params(grads)) for name, (loss, grads) in both.items()}


def assert_grads_close(got, want, tol=1e-4, what=""):
    """Every leaf within ``tol`` of the wanted leaf's largest value, floored
    at a hundredth of the wanted tree's largest (see the module docstring)."""
    assert got.keys() == want.keys()
    floor = 1e-2 * max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        g = got[k]
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        w = w.numpy()
        err = float(np.abs(g - w).max())
        assert err <= tol * max(float(np.abs(w).max()), floor), f"{what}{k}: max|d| {err:.3e}"


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_training_loss_matches_jax(params, jax_results, schedule):
    want_loss, want = jax_results[schedule]
    pipe = port(params, SCHEDULES[schedule])
    unet_params = {k: v.detach().requires_grad_(True) for k, v in pipe.unet.named_parameters()}
    loss = pipe.training_loss(unet_params, **inputs())
    grads = torch.autograd.grad(loss, list(unet_params.values()))
    loss = float(loss.detach())
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert np.isfinite(loss) and loss > 0
    assert_grads_close(dict(zip(unet_params, grads)), want)


def test_sharded_training_loss_matches_jax(sharded, jax_results):
    """Meshes (1, 2) and (2, 1), every rank: JAX's loss, and its gradient on
    the rank's slice of every UNet leaf."""
    loss, grads = jax_results["epsilon"]
    results = sharded()
    for (data, model), ranks in results.items():
        for rank, res in enumerate(ranks):
            tag = f"{data}x{model} rank {rank} "
            np.testing.assert_allclose(res["training_loss/loss"], loss, rtol=1e-5, err_msg=tag)
            place = pmesh.Mesh(data, model, divmod(rank, model), {}, "gloo")
            want = {k: pmesh.local_shard(k, g, place) for k, g in grads.items()}
            assert_grads_close({k: res[f"training_loss/grad/{k}"] for k in want}, want, what=tag)
            assert any(res[f"training_loss/grad/{k}"].shape != g.shape for k, g in grads.items()) \
                == (model > 1)
