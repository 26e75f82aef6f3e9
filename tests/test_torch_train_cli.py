"""The port's trainer CLI (train_lora_dreambooth_torch.py) and its training
checkpoints, on the CPU in f32.

Tiny models (tests/torch_checkpoints.py's configs, seeded by the port)
written as a diffusers directory with a synthesized CLIP vocabulary, and a
DreamBooth data directory of 4 instance and 4 prior 20x20 PNGs trained at
32^2 (4x4 latents).  batch 2, accumulation 2 and 2 updates make two epochs
of two micro-steps, as chip_smoke.py's phase 12 runs at full width.  The
train step itself is held against JAX's in tests/test_torch_training.py;
here the CLI is held against itself: cached and uncached encoders on one
seed give the same end state, a resume continues the saved state, and
``inference_torch.py --lora_ckpt`` on a checkpoint equals a manual merge.

Across ranks: gloo worlds of two (tests/torch_train_cli_worker.py, the
launcher's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT set here) run
``main`` at ``--mesh_model_axis 2`` (a (1, 2) mesh) and at 1 (JAX's data
axis gcd(4, 2) = 2: a (2, 1) mesh) on the same directory and seed, at 128^2
(16^2 latents: at 32^2 the UNet's deepest stage is 1x1, its GroupNorms
normalise two values, and the order of a sum alone moves gradients by 2%;
tests/test_torch_training.py's finding); each end checkpoint lies within
1e-4 of a one-rank run's at 128^2 (the LoRA tree by the rule of
tests/test_torch_parallel_training.py, Adam's sign flips near a zero
gradient), the two ranks' states are equal, and only rank 0 saves
checkpoints and opens a writer.  A world the mesh would leave ranks of is
refused before anything loads.
"""

import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import inference_torch as icli
import train_lora_dreambooth as jax_cli
import train_lora_dreambooth_torch as cli
from stable_diffusion_tpu_torch import optim
from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from stable_diffusion_tpu_torch.models.lora import merge_lora_
from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
from stable_diffusion_tpu_torch.models.vae import VAE, VAEConfig
from stable_diffusion_tpu_torch.utils import checkpoint as ckpt
from stable_diffusion_tpu_torch.utils.tree import tree_leaves
from stable_diffusion_tpu_torch.utils.weights import init_random_
from tests import torch_checkpoints as C
from tests.torch_threads import one_thread  # noqa: F401

UPDATES = 2
SCALARS = []  # (tag, values, epoch) of every add_scalars call


class _Writer:
    """torch.utils.tensorboard's SummaryWriter, recording (importing the
    real one loads TensorFlow here, ~15 s)."""

    def __init__(self, log_dir):
        self.log_dir = log_dir

    def add_scalars(self, tag, values, step):
        SCALARS.append((tag, dict(values), step))

    def close(self):
        pass


@pytest.fixture(scope="module", autouse=True)
def recording_writer():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard",
                   types.SimpleNamespace(SummaryWriter=_Writer))
        yield


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("train_cli")
    models = {"unet": init_random_(UNet(UNetConfig(**C.TINY_UNET)), 0),
              "text": init_random_(CLIPTextModel(CLIPTextConfig(**C.TINY_TEXT)), 1),
              "vae": init_random_(VAE(VAEConfig(**C.TINY_VAE)), 2)}
    C.write_diffusers_dir(str(root / "model"), *(m.state_dict() for m in models.values()),
                          unet_config=dict(C.TINY_UNET), text_config=C.TINY_TEXT,
                          vae_config={"block_out_channels": [32, 32, 32, 32], "latent_channels": 4},
                          scheduler_config={"prediction_type": "epsilon"})
    C.write_vocab(str(root / "model" / "tokenizer"))
    rng = np.random.default_rng(0)
    for d, label in (("instance_data", "a photo of sks dog"), ("class_prior_data", "a photo of a dog")):
        (root / "data" / d).mkdir(parents=True)
        for i in range(4):
            Image.fromarray((rng.random((20, 20, 3)) * 255).astype(np.uint8)).save(
                root / "data" / d / f"{i}.png")
        (root / "data" / d / "label.txt").write_text(label)
    return root


def _argv(root, run, *extra):
    return ["--model_path", str(root / "model"), "--tokenizer_dir", str(root / "model" / "tokenizer"),
            "--data_dir", str(root / "data"), "--device", "cpu", "--img_size", "32",
            "--batch_size", "2", "--gradient_accumulation_steps", "2",
            "--max_train_steps", str(UPDATES), "--use_ema", "--lr", "1e-3", "--seed", "0",
            "--checkpoint_dir", str(root / run), "--log_dir", str(root / run / "logs"), *extra]


@pytest.fixture(scope="module")
def cached_run(dirs):
    return cli.main(_argv(dirs, "cached"))


def _leaves(state):
    return tree_leaves({k: state[k] for k in ("lora", "ema")})


def test_cached_and_uncached_runs_end_equal(dirs, cached_run, capsys):
    """Same seed, the cache on (the default) and off: one batch order and one
    noise stream, so the same losses and the same end state (the encoders
    run at another batch size, so to f32 rounding)."""
    capsys.readouterr()
    plain = cli.main(_argv(dirs, "uncached", "--no-cache_latents"))
    out = capsys.readouterr().out
    assert "cached frozen encoders" not in out
    assert cached_run["step"] == plain["step"] == 2 * UPDATES  # micro-steps
    assert cached_run["opt_state"]["gradient_step"] == plain["opt_state"]["gradient_step"] == UPDATES
    a, b = _leaves(cached_run), _leaves(plain)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    losses = [v for tag, v, _ in SCALARS if tag == "Loss"]
    assert len(losses) >= 4 and all(np.isfinite([v["train"], v["test"]]).all() for v in losses)
    first = ckpt.load_train_checkpoint(str(dirs / "cached" / "epoch-0.ckpt"))["state"]
    moved = max((x - y).abs().max().item() for x, y in zip(_leaves(first), a))
    assert moved > 1e-4  # the second epoch's update changed the tree


def test_resume_continues_the_saved_state(dirs, cached_run, capsys):
    """--pretrained_path epoch-1.ckpt starts at epoch 2 from the saved state
    (the 8-bit Adam here: its moments round-trip through the checkpoint)
    and counts on: step, optimizer updates, the EMA's warm-up."""
    first = cli.main(_argv(dirs, "adam8", "--use_8bit_adam"))
    capsys.readouterr()
    resumed = cli.main(_argv(dirs, "adam8", "--use_8bit_adam", "--pretrained_path",
                             str(dirs / "adam8" / "epoch-1.ckpt")))
    out = capsys.readouterr().out
    assert "epoch 2:" in out and "epoch 0:" not in out
    assert sorted(os.listdir(dirs / "adam8"))[:4] == [f"epoch-{i}.ckpt" for i in range(4)]
    assert resumed["step"] == 2 * first["step"] == 4 * UPDATES
    inner = resumed["opt_state"]["inner"][1]
    assert resumed["opt_state"]["gradient_step"] == inner["count"] == 2 * UPDATES
    assert isinstance(tree_leaves(inner["mu"])[0], optim.Q8)
    assert max((x - y).abs().max().item()
               for x, y in zip(_leaves(first), _leaves(resumed))) > 1e-4


def test_inference_lora_ckpt_equals_a_manual_merge(dirs, cached_run, tmp_path):
    """inference_torch.py --device cpu --lora_ckpt epoch-1.ckpt merges the
    checkpoint's LoRA tree: the weights and a one-step image equal the
    model loaded without it and merged by hand with that tree."""
    path = str(dirs / "cached" / "epoch-1.ckpt")
    argv = ["--model_path", str(dirs / "model"), "--tokenizer_dir", str(dirs / "model" / "tokenizer"),
            "--prompt", "a photo of sks dog", "--device", "cpu", "--dtype", "float32",
            "--img_size", "32", "--one_step", "--n_samples", "1", "--output_dir", str(tmp_path)]
    args = icli.parse_args(argv + ["--lora_ckpt", path])
    merged = icli.load_model(args)
    manual = icli.load_model(icli.parse_args(argv))
    before = {k: v.clone() for k, v in manual.unet.state_dict().items()}
    lora = ckpt.load_train_checkpoint(path)["state"]["lora"]
    assert set(lora) == {"unet"}
    merge_lora_(manual.unet, lora["unet"])
    for k, v in manual.unet.state_dict().items():
        assert torch.equal(merged.unet.state_dict()[k], v), k
    assert any(not torch.equal(v, before[k]) for k, v in manual.unet.state_dict().items())
    got = icli.inference(args, merged, save=False)
    np.testing.assert_array_equal(got[0], icli.inference(args, manual, save=False)[0])
    icli.main(argv + ["--lora_ckpt", path])
    assert os.listdir(tmp_path) == ["img_0_0.jpg"]


def _opt_states():
    """Two updates of each optimizer the trainer builds on a small tree."""
    g = torch.Generator().manual_seed(3)
    params = {"a": {"w": torch.randn(300, generator=g), "b": torch.randn(3, 5, generator=g)}}
    out = {}
    for name, tx in (("adamw", optim.adamw(1e-3)), ("adamw_8bit", optim.adamw_8bit(1e-3))):
        tx = optim.multi_steps(optim.chain(optim.clip_by_global_norm(1.0), tx), 2)
        state = tx.init(params)
        for _ in range(4):
            grads = {"a": {k: torch.randn(v.shape, generator=g) for k, v in params["a"].items()}}
            _, state = tx.update(grads, state, params)
        out[name] = {"lora": params, "opt_state": state, "ema": params, "step": 4}
    return out


@pytest.mark.parametrize("name", ["adamw", "adamw_8bit"])
def test_checkpoint_round_trip_is_exact(tmp_path, name):
    state = _opt_states()[name]
    path = ckpt.save_train_checkpoint(str(tmp_path / "epoch-3"), {"epoch": 3, "state": state})
    assert path.endswith("epoch-3.ckpt") and os.listdir(tmp_path) == ["epoch-3.ckpt"]
    back = ckpt.load_train_checkpoint(path, device=torch.device("cpu"))
    assert back["epoch"] == 3

    def same(a, b):
        assert type(a) is type(b)
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b

    same(back["state"], state)


@pytest.mark.parametrize("path", ["run/epoch-0.msgpack", "run/epoch-0.orbax", "orbax_dir"])
def test_jax_checkpoint_formats_raise(tmp_path, path):
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(ValueError, match="msgpack|orbax"):
        ckpt.load_train_checkpoint(str(tmp_path / path))


def test_refusals_come_before_any_load(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="mesh_model_axis"):
        cli.main(["--model_path", str(tmp_path / "absent"), "--device", "cpu",
                  "--mesh_model_axis", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["--model_path", str(tmp_path / "absent")])


def test_flags_and_defaults_are_train_lora_dreambooth_py_s():
    ours, theirs = cli.build_parser(), jax_cli.build_parser()
    opts = lambda p: {a.dest: (tuple(a.option_strings), a.default, a.choices)  # noqa: E731
                      for a in p._actions if a.dest != "help"}
    want = opts(theirs)
    want["device"] = (("--device",), "cuda", None)  # honoured here; JAX picks its backend
    assert opts(ours) == want


WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_train_cli_worker.py")
MESH_SIZE = ["--img_size", "128"]
MESH_RUNS = {"tp2": ["--mesh_model_axis", "2", *MESH_SIZE],
             "dp2": ["--mesh_model_axis", "1", *MESH_SIZE]}


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh_runs(dirs):
    """{run: [each rank's {"state", "saved", "writers"}]}: a world of two for
    each of MESH_RUNS, started together."""
    procs = {}
    for run, extra in MESH_RUNS.items():
        env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
        procs[run] = [subprocess.Popen(
            [sys.executable, WORKER, str(dirs / f"{run}_rank{r}.pt"), *_argv(dirs, run, *extra)],
            env=dict(env, RANK=str(r)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
    try:
        for ranks in procs.values():
            for p in ranks:
                out, _ = p.communicate(timeout=600)
                assert p.returncode == 0, out[-4000:]
    finally:
        for p in (p for ranks in procs.values() for p in ranks):
            if p.poll() is None:
                p.kill()
                p.wait()
    return {run: [torch.load(dirs / f"{run}_rank{r}.pt", weights_only=False) for r in range(2)]
            for run in MESH_RUNS}


@pytest.fixture(scope="module")
def one_rank_run(dirs):
    """The one-rank run the mesh runs are held to (128^2)."""
    return cli.main(_argv(dirs, "one_rank", *MESH_SIZE))


@pytest.mark.parametrize("run", sorted(MESH_RUNS))
def test_mesh_runs_end_at_the_one_rank_run(dirs, mesh_runs, one_rank_run, run):
    from test_torch_parallel_training import _tree_close

    ranks = mesh_runs[run]
    assert ranks[0]["saved"] == [str(dirs / run / f"epoch-{e}") for e in range(2)]
    assert ranks[1]["saved"] == [] and ranks[1]["writers"] == []
    assert ranks[0]["writers"] == [str(dirs / run / "logs")]
    assert sorted(os.listdir(dirs / run)) == ["epoch-0.ckpt", "epoch-1.ckpt"]
    for a, b in zip(_leaves(ranks[0]["state"]), _leaves(ranks[1]["state"])):
        assert torch.equal(a, b)
    end = ckpt.load_train_checkpoint(str(dirs / run / "epoch-1.ckpt"))["state"]
    one = ckpt.load_train_checkpoint(str(dirs / "one_rank" / "epoch-1.ckpt"))["state"]
    assert end["step"] == one["step"] == ranks[0]["state"]["step"] == 2 * UPDATES
    for name in ("lora", "ema"):
        _tree_close(tree_leaves(end[name]), tree_leaves(one[name]), 1e-4, f"{run} {name}")
        for a, b in zip(tree_leaves(end[name]), tree_leaves(ranks[0]["state"][name])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("world, flags", [
    ("3", ["--mesh_model_axis", "2"]),                     # the axis does not divide the world
    ("3", ["--mesh_model_axis", "1", "--batch_size", "1"]),  # data gcd(2, 3) = 1: 2 ranks idle
    ("8", ["--mesh_model_axis", "2", "--batch_size", "1"]),  # data gcd(2, 4) = 2: 4 ranks idle
])
def test_a_world_the_mesh_leaves_ranks_of_is_refused(tmp_path, monkeypatch, world, flags):
    """JAX leaves the devices outside gcd(2 * batch_size, world / model) x
    model idle; the port refuses such a world before anything loads (and
    before any process group is joined)."""
    monkeypatch.setenv("WORLD_SIZE", world)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="mesh_model_axis"):
        cli.main(["--model_path", str(tmp_path / "absent"), "--device", "cpu", *flags])
    args = cli.build_parser().parse_args(["--mesh_model_axis", "2", "--batch_size", "2"])
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert cli.mesh_shape(args) == (4, 2, 2)
