"""One rank of a sharded-training world on the CPU (gloo), for
tests/test_torch_parallel_training.py and tests/test_torch_training_loss.py.

    python tests/torch_parallel_train_worker.py RANK WORLD INIT_FILE JOB OUT_DIR

JOB is a ``torch.save`` file the test wrote: the three models' configs and
state dicts, the meshes to build, the LoRA trees, the batches and the cases
(``TrainConfig`` keywords, the prediction type and the LoRA tree of each).
For each mesh the rank builds the plain f32 models, shards them
(``shard_module_``) and, for every case, calls ``training.make_train_step``
on each of the case's batches (with accumulation, the first call's
gradients are its accumulator); on a tensor-parallel mesh it also takes the
first case's gradients (``training.loss_and_grad``) with every
column-input mate dropped; and, given inputs, it takes
``StableDiffusion.training_loss`` (the pipeline's scheduler config) and its
gradient over the UNet's local parameters, summed over "data".
It writes ``OUT_DIR/rank{RANK}_{data}x{model}.npz``.  It imports no JAX.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from stable_diffusion_tpu_torch import training as T  # noqa: E402
from stable_diffusion_tpu_torch.models import ema  # noqa: E402
from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig  # noqa: E402
from stable_diffusion_tpu_torch.models.unet import UNetConfig  # noqa: E402
from stable_diffusion_tpu_torch.models.vae import VAEConfig  # noqa: E402
from stable_diffusion_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from stable_diffusion_tpu_torch.pipeline import StableDiffusion  # noqa: E402
from stable_diffusion_tpu_torch.schedulers import schedule as S  # noqa: E402
from stable_diffusion_tpu_torch.utils.tree import tree_leaves  # noqa: E402


def pipeline(job) -> StableDiffusion:
    pipe = StableDiffusion.build(UNetConfig(**job["unet_config"]),
                                 CLIPTextConfig(**job["text_config"]),
                                 VAEConfig(**job["vae_config"]), device="cpu", impl="torch",
                                 scheduler_config=job.get("scheduler_config"))
    for name in ("unet", "text_encoder", "vae"):
        getattr(pipe, name).load_state_dict(job["states"][name], strict=True)
    return pipe


def as_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def train_case(base, case, job, mesh):
    """{"loss/i", "grad/i", "lora/i", "ema/i"} of one case: each call's
    loss, the first call's gradients (the accumulator after it) and the
    LoRA and EMA trees after the last call."""
    cfg = T.TrainConfig(**case["config"])
    schedule = S.make_schedule(prediction_type=case["prediction_type"])
    lora = job["lora"][case["lora"]]
    state = {"lora": lora, "opt_state": T.make_optimizer(cfg).init(lora),
             "ema": ema.ema_init(lora) if cfg.use_ema else lora, "step": 0}
    step = T.make_train_step(base, schedule=schedule, train_cfg=cfg, impl="torch", mesh=mesh)
    out = {}
    for call, i in enumerate(case["batches"]):
        state, m = step(state, as_torch(job["batches"][i]))
        out[f"loss/{call}"] = m["loss"].numpy()
        if call == 0:
            out.update({f"grad/{j}": t.numpy()
                        for j, t in enumerate(tree_leaves(state["opt_state"]["acc"]))})
    for name in ("lora", "ema"):
        out.update({f"{name}/{j}": t.numpy() for j, t in enumerate(tree_leaves(state[name]))})
    return out


def unmated_grads(base, case, job, mesh):
    """The case's LoRA gradients with every column-input mate dropped."""
    mate = pmesh.Mesh.column_input
    pmesh.Mesh.column_input = lambda self, t, axis=pmesh.MODEL_AXIS: t
    try:
        cfg = T.TrainConfig(**case["config"])
        _, grads = T.loss_and_grad(job["lora"][case["lora"]], base,
                                   as_torch(job["batches"][case["batches"][0]]),
                                   alphas_hat=torch.from_numpy(S.make_schedule().alphas_hat),
                                   train_cfg=cfg, impl="torch", mesh=mesh)
    finally:
        pmesh.Mesh.column_input = mate
    return {str(i): g.numpy() for i, g in enumerate(tree_leaves(grads))}


def training_loss(pipe, inputs, mesh):
    """StableDiffusion.training_loss on the rank's shard, and its gradient
    over every local UNet parameter, summed over "data"."""
    params = {k: v.detach().requires_grad_(True) for k, v in pipe.unet.named_parameters()}
    loss = pipe.training_loss(params, **inputs)
    grads = torch.autograd.grad(loss, list(params.values()))
    grads = mesh.sum_flat(grads, pmesh.DATA_AXIS)
    out = {"loss": loss.detach().numpy()}
    out.update({f"grad/{k}": g.numpy() for k, g in zip(params, grads)})
    return out


def main(rank: int, world: int, init_file: str, job_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)  # written by the test that started this rank
    pmesh.init_distributed(rank, world, f"file://{init_file}", device="cpu")
    try:
        for data, model in job["meshes"]:
            mesh = pmesh.make_mesh(data, model)
            pipe = pipeline(job)
            lora_base = {"unet": pipe.unet, "text_encoder": pipe.text_encoder}
            for m in lora_base.values():
                m.requires_grad_(False)
            pipe.shard(mesh)
            out = {}
            for name, case in job["cases"].items():
                out.update({f"{name}/{k}": v for k, v in train_case(lora_base, case, job,
                                                                     mesh).items()})
            if model > 1 and job["cases"]:
                first = next(iter(job["cases"].values()))
                out.update({f"unmated/{k}": v
                            for k, v in unmated_grads(lora_base, first, job, mesh).items()})
            for m in lora_base.values():
                m.requires_grad_(True)
            if "training_loss" in job:
                inputs = {k: torch.from_numpy(v) for k, v in job["training_loss"].items()}
                out.update({f"training_loss/{k}": v
                            for k, v in training_loss(pipe, inputs, mesh).items()})
            np.savez(os.path.join(out_dir, f"rank{rank}_{data}x{model}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
