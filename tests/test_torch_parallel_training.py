"""The port's LoRA train step across a ("data", "model") mesh on the CPU
(gloo), against the unsharded port and the JAX package.

Spawned worker processes (tests/torch_parallel_train_worker.py) form gloo
worlds of 2 and 4 ranks, started once for the module: meshes (1, 2) and
(2, 1) on the two, (2, 2) on the four.  The models are the tiny UNet and
text tower of tests/test_torch_parallel.py, JAX-initialised and carried over
by the weight bridge; the LoRA trees JAX's ``init_lora`` on
``DEFAULT_UNET_TARGETS`` (replicated convs, column- and row-parallel
linears) and, with the text tower trained, on its six targets, with B drawn
non-zero so that A, B and alpha all get gradients (``lora_from_jax``).
Batches are b4 (2 instance + 2 prior) at 16^2 latents
(tests/test_torch_training.py's reason: at 4^2 the deepest GroupNorms make
the gradients ill conditioned).

Cases: epsilon on cached text embeddings; the same with gradient
checkpointing; v-prediction with the text tower's LoRA trained (token ids).
Each makes four train-step calls with accumulation 2 (two updates; AdamW,
clipping at 1.0, EMA from step 0).  Every rank's losses, first-call
gradients (the accumulator after it), LoRA and EMA trees lie within 1e-4 of
the unsharded port's (gradients relative to each leaf's largest value, the
0-d alphas to the largest alpha gradient) and within
tests/test_torch_train_steps.py's tolerances of JAX's ``make_train_step``
on the same LoRA init and batches (the result that GSPMD gives); the ranks
of a mesh hold equal trees.  The LoRA trees after the updates are held
element by element with one exception, the rule tests/test_train_cli.py
and chip_smoke.py's trainer phase apply: Adam moves an element by about lr
sign(g), so an element whose gradient lies within f32 summation noise of
zero may move the other way.  At most TREE_SHARE of the elements may lie
beyond the tolerance, and none beyond 2 lr.  (The unsharded port against
JAX shows the same: 8 of 57024 elements beyond 1e-5, at most 2.2e-4.)  A tensor-parallel mesh whose column-input mates are
dropped gives other ``conv_input`` LoRA gradients (the control).
``StableDiffusion.training_loss`` on a sharded pipeline is held to JAX's in
tests/test_torch_training_loss.py, through the same worker.
"""

import os
import subprocess
import sys

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
from stable_diffusion_tpu_torch.parallel import mesh as pmesh
from stable_diffusion_tpu_torch.utils.tree import tree_unflatten
from stable_diffusion_tpu_torch.utils.weights import from_jax_params, lora_from_jax
from test_torch_training import _grads_close
from tests.test_torch_parallel import TEXT, UNET, VAE_CFG
from tests.torch_parallel_train_worker import pipeline, train_case
from tests.torch_threads import one_thread  # noqa: F401

TOL = 1e-4
LR = 1e-3
TREE_SHARE = 1e-3
WORLDS = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
MESHES = [m for ms in WORLDS.values() for m in ms]
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_train_worker.py")
BASE = dict(rank=2, alpha=2.0, learning_rate=LR, use_ema=True, ema_start=0, max_grad_norm=1.0,
            grad_accum_steps=2)
CASES = {
    "eps": dict(config=BASE, prediction_type="epsilon", lora="unet", batches=(0, 1, 2, 3)),
    "remat": dict(config=dict(BASE, gradient_checkpointing=True), prediction_type="epsilon",
                  lora="unet", batches=(0, 1, 2, 3)),
    "text": dict(config=dict(BASE, train_text_encoder=True), prediction_type="v_prediction",
                 lora="text", batches=(4, 5, 6, 7)),
}


@pytest.fixture(scope="module")
def params():
    ks = jax.random.split(jax.random.key(17), 3)
    return {"unet": junet.init_unet(ks[0], junet.UNetConfig(**UNET)),
            "text_encoder": jclip.init_text_model(ks[1], jclip.CLIPTextConfig(**TEXT)),
            "vae": jvae.init_vae(ks[2], jvae.VAEConfig(**VAE_CFG))}


def _lora(params, text: bool):
    """JAX's init_lora trees (numpy), B drawn non-zero."""
    rng = np.random.default_rng(5)
    tree = {"unet": jlora.init_lora(jax.random.key(5), params["unet"], rank=2, alpha=2.0,
                                    targets=TT.TrainConfig().lora_targets)}
    if text:
        tree["text_encoder"] = jlora.init_lora(jax.random.key(6), params["text_encoder"], rank=2,
                                               alpha=2.0, targets=TT.TEXT_TARGETS)
    tree = jax.tree.map(np.asarray, tree)
    for part in tree.values():
        for entry in part.values():
            entry["lora_B"] = (0.01 * rng.standard_normal(entry["lora_B"].shape)).astype(np.float32)
    return tree


def _batch(seed, *, ids: bool):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    batch = {"t": rng.integers(0, 1000, 4).astype(np.int64), "noise": f(4, 16, 16, 4),
             "vae_noise": f(4, 16, 16, 4), "latent_mean": f(4, 16, 16, 4),
             "latent_std": np.log1p(np.exp(f(4, 16, 16, 4)))}
    if ids:
        batch["input_ids"] = rng.integers(0, TEXT["vocab_size"], (4, 77)).astype(np.int64)
    else:
        batch["text_emb"] = f(4, 77, TEXT["hidden_size"])
    return batch


@pytest.fixture(scope="module")
def job(params, tmp_path_factory):
    d = tmp_path_factory.mktemp("train_mesh")
    states = {n: from_jax_params(params[n]) for n in ("unet", "text_encoder", "vae")}
    trees = {"unet": _lora(params, False), "text": _lora(params, True)}
    job = {"unet_config": UNET, "text_config": TEXT, "vae_config": VAE_CFG, "states": states,
           "jax_lora": trees, "lora": {k: lora_from_jax(v) for k, v in trees.items()},
           "batches": [_batch(s, ids=s >= 4) for s in range(8)], "cases": CASES,
           "dir": d}
    return job


@pytest.fixture(scope="module")
def sharded(job):
    """{(data, model): [each rank's results]}, from one spawn of each world;
    the ranks run while the module's unsharded and JAX references are made."""
    d = job["dir"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for world, meshes in WORLDS.items():
        path = d / f"job{world}.pt"
        torch.save({k: v for k, v in job.items() if k not in ("dir", "jax_lora")} | {"meshes": meshes},
                   path)
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(rank), str(world), str(d / f"init{world}"), str(path),
                 str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    results = {}

    def wait():
        if not results:
            for p in procs:
                out, _ = p.communicate(timeout=600)
                assert p.returncode == 0, out[-4000:]
            results.update({(dm, mm): [dict(np.load(d / f"rank{r}_{dm}x{mm}.npz"))
                                       for r in range(dm * mm)] for dm, mm in MESHES})
        return results
    yield wait
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def unsharded(job, sharded):
    """The unsharded port's results of every case (the same helper as the ranks')."""
    pipe = pipeline(job)
    base = {"unet": pipe.unet, "text_encoder": pipe.text_encoder}
    for m in base.values():
        m.requires_grad_(False)
    return {name: train_case(base, case, job, None) for name, case in CASES.items()}


@pytest.fixture(scope="module")
def jax_ref(params, job, unsharded):
    """JAX's ``make_train_step`` on each case's batches: each call's loss,
    the first call's gradients (its accumulator) and the last state."""
    tcfg, vcfg = jclip.CLIPTextConfig(**TEXT), jvae.VAEConfig(**VAE_CFG)
    out = {}
    for name, case in CASES.items():
        if name == "remat":  # gradient checkpointing changes nothing in JAX's numbers
            continue
        cfg = JT.TrainConfig(**case["config"])
        lora = jax.tree.map(jnp.asarray, job["jax_lora"][case["lora"]])
        state = {"lora": lora, "opt_state": JT.make_optimizer(cfg).init(lora),
                 "ema": jema.ema_init(lora), "step": jnp.zeros((), jnp.int32)}
        step = jax.jit(JT.make_train_step(
            params, ucfg=junet.UNetConfig(**UNET), tcfg=tcfg, vcfg=vcfg, train_cfg=cfg,
            schedule=JS.make_schedule(prediction_type=case["prediction_type"]), impl="xla"))
        losses = []
        for call, i in enumerate(case["batches"]):
            state, m = step(state, job["batches"][i])
            losses.append(float(m["loss"]))
            if call == 0:
                grads = state["opt_state"].acc_grads
        out[name] = dict(loss=losses, grads=grads, lora=state["lora"], ema=state["ema"])
    out["remat"] = out["eps"]
    return out


def _leaves(res, name, what):
    """Leaves ``{name}/{what}/i`` of a result (``{what}/i`` where name is "")."""
    prefix = f"{name}/{what}/" if name else f"{what}/"
    return [res[f"{prefix}{i}"] for i in range(sum(k.startswith(prefix) for k in res))]


def _close(got, want, tol=TOL, what=""):
    """Gradients leaf by leaf within ``tol`` of the wanted leaf's largest
    value; 0-d leaves (alpha) of the largest wanted 0-d leaf."""
    assert len(got) == len(want) > 0
    scale0 = max([abs(float(w)) for w in want if np.ndim(w) == 0] or [1.0])
    for i, (g, w) in enumerate(zip(got, want)):
        scale = scale0 if np.ndim(w) == 0 else float(np.abs(w).max())
        err = float(np.abs(np.asarray(g) - np.asarray(w)).max())
        assert err <= tol * scale, f"{what} leaf {i}: max|d| {err:.3e} vs scale {scale:.3e}"


def _tree_close(got, want, atol, what):
    """A LoRA tree after Adam updates (see the module docstring): at most
    TREE_SHARE of the elements beyond ``atol`` (and ``atol`` relative), none
    beyond 2 lr."""
    got, want = ([np.asarray(t, np.float64).ravel() for t in tree] for tree in (got, want))
    assert len(got) == len(want) > 0
    d = np.concatenate([np.abs(g - w) for g, w in zip(got, want)])
    over = d > atol * (1 + np.abs(np.concatenate(want)))
    assert d.max() <= 2 * LR and over.mean() <= TREE_SHARE, (
        f"{what}: {int(over.sum())} of {d.size} elements beyond {atol}, max|d| {d.max():.3e}")


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_step_matches_unsharded_and_jax(job, sharded, unsharded, jax_ref, mesh, name):
    """Four calls' losses, the first call's gradients, the LoRA and EMA
    trees after two updates, on every rank."""
    ranks, base, ref = sharded()[mesh], unsharded[name], jax_ref[name]
    for rank, res in enumerate(ranks):
        tag = f"{mesh} rank {rank} {name}"
        losses = _leaves(res, name, "loss")
        np.testing.assert_allclose(losses, _leaves(base, "", "loss"), rtol=TOL, err_msg=tag)
        np.testing.assert_allclose(losses, ref["loss"], rtol=1e-5, err_msg=tag)
        _close(_leaves(res, name, "grad"), _leaves(base, "", "grad"), what=f"{tag} grad")
        _grads_close(tree_unflatten(job["lora"][CASES[name]["lora"]],
                                    [torch.from_numpy(g) for g in _leaves(res, name, "grad")]),
                     ref["grads"])
        _tree_close(_leaves(res, name, "lora"), _leaves(base, "", "lora"), TOL, f"{tag} lora")
        _tree_close(_leaves(res, name, "lora"), jax.tree.leaves(ref["lora"]), 1e-5,
                    f"{tag} lora vs JAX")
        for i, (g, w) in enumerate(zip(_leaves(res, name, "ema"), _leaves(base, "", "ema"))):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=f"{tag} ema {i}")
        for g, w in zip(_leaves(res, name, "ema"), jax.tree.leaves(ref["ema"]), strict=True):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=tag)
    for what in ("loss", "grad", "lora", "ema"):  # the ranks hold one tree
        for res in ranks[1:]:
            for a, b in zip(_leaves(ranks[0], name, what), _leaves(res, name, what)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh", [m for m in MESHES if m[1] > 1], ids=lambda m: f"{m[0]}x{m[1]}")
def test_a_missing_mate_is_caught(job, sharded, unsharded, mesh):
    """Without the column-input mates the gradient reaches conv_input (whose
    LoRA is replicated) through the rank's own heads only: it differs from
    the unsharded gradient, which the mates give (the test above)."""
    tree = job["lora"]["unet"]["unet"]
    keys = [(p, k) for p in sorted(tree) for k in sorted(tree[p])]
    picked = [i for i, (p, _) in enumerate(keys) if p.endswith("conv_input")]
    assert picked
    worst = 0.0
    for res in sharded()[mesh]:
        for i in picked:
            want = unsharded["eps"][f"grad/{i}"]
            worst = max(worst, float(np.abs(res[f"unmated/{i}"] - want).max() / np.abs(want).max()))
    assert worst > 100 * TOL, worst
