"""The port's mesh (parallel/mesh.py) and sharded serving
(``StableDiffusion.shard``) on the CPU, against the JAX package.

``param_spec`` is held to JAX's ``param_spec`` for every leaf of a tiny
UNet, text tower and VAE (JAX-initialised, carried by the weight bridge: the
leaf's JAX path through ``jax_key``, a kernel's spec transposed).  Sharded
serving runs in spawned worker processes (tests/torch_parallel_worker.py)
on gloo worlds of 2 and 4 ranks, started once for the module: meshes (1, 2)
and (2, 1) on the two, (2, 2) on the four.  Every rank's output is held to
the unsharded port's within 1e-4 (f32 with the row-parallel sums taken in
another order), and the DDIM request to JAX's ``generate`` within 1e-4 too,
as tests/test_torch_img2img.py holds the unsharded port; the progress calls
must be the unsharded request's.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from stable_diffusion_tpu import pipeline as JP
from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.models import unet as junet
from stable_diffusion_tpu.models import vae as jvae
from stable_diffusion_tpu.parallel import mesh as jmesh
from stable_diffusion_tpu_torch.models.clip import CLIPTextModel, CLIPTextConfig
from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
from stable_diffusion_tpu_torch.models.vae import VAE, VAEConfig
from stable_diffusion_tpu_torch.parallel import mesh as pmesh
from stable_diffusion_tpu_torch.pipeline import StableDiffusion
from stable_diffusion_tpu_torch.utils.weights import flatten_tree, from_jax_params, jax_key
from tests.torch_parallel_worker import run_request
from tests.torch_threads import one_thread  # noqa: F401

ATOL = 1e-4
UNET = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
            cross_attention_dim=24, t_embed_dim=16)
TEXT = dict(hidden_size=24, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=77, vocab_size=64)
VAE_CFG = dict(ch_mult=(1, 1, 1, 1), base_channels=32)
MODULES = {"unet": (UNet, UNetConfig, UNET), "text_encoder": (CLIPTextModel, CLIPTextConfig, TEXT),
           "vae": (VAE, VAEConfig, VAE_CFG)}
WORLDS = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
MESHES = [m for ms in WORLDS.values() for m in ms]
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")


@pytest.fixture(scope="module")
def params():
    ks = jax.random.split(jax.random.key(7), 3)
    return {"unet": junet.init_unet(ks[0], junet.UNetConfig(**UNET)),
            "text_encoder": jclip.init_text_model(ks[1], jclip.CLIPTextConfig(**TEXT)),
            "vae": jvae.init_vae(ks[2], jvae.VAEConfig(**VAE_CFG))}


def _ids(b):
    return (np.arange(77)[None] + 5 * np.arange(b)[:, None]) % 64, np.zeros((b, 77), np.int64)


def _requests():
    """Name -> (method, kwargs): the same on every rank and in the unsharded pipeline."""
    rng = np.random.default_rng(3)
    ids, unc = _ids(2)
    mask = np.zeros((32, 32), np.uint8)
    mask[8:24, 4:20] = 255
    common = dict(img_size=(32, 32), cfg_scale=3.0)
    return {
        "ddim": ("generate", dict(cond_ids=ids, uncond_ids=unc, inference_steps=3, seed=4,
                                  initial_latents=rng.standard_normal((2, 4, 4, 4))
                                  .astype(np.float32), **common)),
        "ddpm_progress": ("generate", dict(cond_ids=ids, uncond_ids=unc, inference_steps=4,
                                           sampler="ddpm", seed=7, progress=True, progress_every=3,
                                           **common)),
        "one_step": ("generate_in_one_step", dict(cond_ids=ids[:1], batch_size=2, seed=5,
                                                  img_size=(32, 32))),
        "inpaint": ("inpaint", dict(cond_ids=ids[:1], uncond_ids=unc[:1], seed=9, inference_steps=5,
                                    input_image=rng.integers(0, 256, (32, 32, 3)).astype(np.uint8),
                                    mask=mask, **common)),
    }


def _port(params):
    pipe = StableDiffusion.build(UNetConfig(**UNET), CLIPTextConfig(**TEXT), VAEConfig(**VAE_CFG),
                                 device="cpu", impl="torch")
    for name in MODULES:
        getattr(pipe, name).load_state_dict(from_jax_params(params[name]), strict=True)
    return pipe


@pytest.fixture(scope="module")
def sharded(params, tmp_path_factory):
    """{(data, model): [each rank's outputs]}, from one spawn of each world."""
    d = tmp_path_factory.mktemp("mesh")
    pipe = _port(params)
    job = d / "job.pt"
    torch.save({"unet_config": UNET, "text_config": TEXT, "vae_config": VAE_CFG,
                "states": {n: getattr(pipe, n).state_dict() for n in MODULES},
                "requests": _requests()}, job)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for world, meshes in WORLDS.items():
        w_job = d / f"job{world}.pt"
        torch.save({**torch.load(job, weights_only=False), "meshes": meshes}, w_job)
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(rank), str(world), str(d / f"init{world}"), str(w_job),
                 str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out[-4000:]
    return {(dm, mm): [dict(np.load(d / f"rank{r}_{dm}x{mm}.npz")) for r in range(dm * mm)]
            for dm, mm in MESHES}


@pytest.fixture(scope="module")
def unsharded(params):
    pipe = _port(params)
    return {name: run_request(pipe, *req) for name, req in _requests().items()}


@pytest.mark.parametrize("tree", sorted(MODULES))
def test_param_spec_matches_jax(params, tree):
    """Every leaf: JAX's spec on its path, transposed for a 2-D kernel, is
    the port's on the PyTorch name; and every JAX leaf is reached."""
    cls, cfg, kw = MODULES[tree]
    module = cls(cfg(**kw))
    jflat = flatten_tree(params[tree])
    seen, split = set(), 0
    for name, t in module.state_dict().items():
        key = jax_key(name, t.dim())
        want = tuple(jmesh.param_spec(key, jflat[key]))
        want += (None,) * (t.dim() - len(want))
        if key.endswith(".kernel") and t.dim() == 2:
            want = want[::-1]
        want = want if any(want) else ()
        assert pmesh.param_spec(name, t) == want, (name, key)
        seen.add(key)
        split += bool(want)
    assert seen == set(jflat)
    assert split > 0  # the rules reach every tree: attention (and FFN) linears


def test_local_shards_pair_value_and_gate():
    """The GeGLU projection's rank share: its value rows beside the same
    hidden units' gate rows; q_proj's rows and out_proj's columns in one
    block each; an int8 holder's bias whole in ``shard_params``."""
    mesh = pmesh.Mesh(1, 2, (0, 1), {}, "gloo")
    w1 = torch.arange(16.0)[:, None].expand(16, 3)
    got = pmesh.local_shard("ffn.0.proj.weight", w1, mesh)[:, 0]
    assert got.tolist() == [4, 5, 6, 7, 12, 13, 14, 15]
    assert pmesh.local_shard("ffn.0.proj.bias", torch.arange(16.0), mesh).tolist() == got.tolist()
    assert pmesh.local_shard("attn1.q_proj.weight", w1, mesh)[:, 0].tolist() == list(range(8, 16))
    assert pmesh.local_shard("attn1.out_proj.weight", w1.T, mesh).shape == (3, 8)
    state = {"attn1.q_proj.weight_q": torch.zeros(8, 4, dtype=torch.int8),
             "attn1.q_proj.bias": torch.arange(8.0), "attn1.k_proj.weight": torch.zeros(8, 4),
             "attn1.k_proj.bias": torch.arange(8.0)}
    local = pmesh.shard_params(state, mesh)
    assert local["attn1.q_proj.bias"].shape == (8,) and local["attn1.k_proj.bias"].shape == (4,)
    assert local["attn1.k_proj.weight"].shape == (4, 4)


@pytest.mark.parametrize("cards, backend", [
    (["", ""], "gloo"),                          # ranks on the CPU
    (["GPU-a"], "nccl"),                         # one rank, one card
    (["GPU-a", "GPU-b"], "nccl"),                # a card a rank, on one host or on two
    (["GPU-a", "GPU-a"], "gloo"),                # two ranks on one card
    (["GPU-a", "GPU-b", "GPU-c", "GPU-a"], "gloo"),
    (["GPU-a", ""], "gloo"),
])
def test_backend_for_the_cards_held(cards, backend):
    """The backend follows the cards the ranks hold (their UUIDs), not the
    count of cards a rank can see: NCCL only where no two ranks share one."""
    assert pmesh.backend_for(cards) == backend


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_generate_matches_unsharded_and_jax(params, sharded, unsharded, mesh):
    """DDIM with CFG at b2 on every rank of the mesh: the unsharded port's
    image and JAX's ``generate`` on the same ids and starting latents."""
    _, kwargs = _requests()["ddim"]
    jpipe = JP.StableDiffusion(params=params, unet_config=junet.UNetConfig(**UNET),
                               text_config=jclip.CLIPTextConfig(**TEXT),
                               vae_config=jvae.VAEConfig(**VAE_CFG), impl="xla")
    want = np.asarray(jpipe.generate("", batch_size=2, **kwargs))
    base = unsharded["ddim"][0]
    np.testing.assert_allclose(base, want, atol=ATOL)
    for rank, out in enumerate(sharded[mesh]):
        np.testing.assert_allclose(out["ddim"], base, atol=ATOL, err_msg=f"rank {rank}")
        np.testing.assert_allclose(out["ddim"], want, atol=ATOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", ["ddpm_progress", "one_step", "inpaint"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_requests_match_unsharded(sharded, unsharded, mesh, name):
    """DDPM in progress mode (the full batch's draws, each rank's lanes),
    one-step with a cycled row, and inpaint (one lane, on every data rank)."""
    base, calls = unsharded[name]
    if name == "ddpm_progress":
        assert calls.tolist() == [[0, 4], [3, 4], [4, 4]]
    for rank, out in enumerate(sharded[mesh]):
        assert out[name].shape == base.shape and out[name].dtype == base.dtype
        np.testing.assert_allclose(out[name].astype(np.float32), base.astype(np.float32),
                                   atol=1 if base.dtype == np.uint8 else ATOL,
                                   err_msg=f"rank {rank}")
        assert out[f"{name}_progress"].tolist() == calls.tolist()
