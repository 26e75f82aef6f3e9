"""One rank of a sharded-serving world on the CPU (gloo), for
tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py RANK WORLD INIT_FILE JOB OUT_DIR

JOB is a ``torch.save`` file the test wrote: the three models' configs and
state dicts, the meshes to build, and the requests (``StableDiffusion``
method name and keyword arguments).  For each mesh the rank builds the
plain f32 pipeline, shards it (``StableDiffusion.shard``) and runs every
request, then writes ``OUT_DIR/rank{RANK}_{data}x{model}.npz`` with each
request's output and the progress calls it saw.  It imports no JAX.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig  # noqa: E402
from stable_diffusion_tpu_torch.models.unet import UNetConfig  # noqa: E402
from stable_diffusion_tpu_torch.models.vae import VAEConfig  # noqa: E402
from stable_diffusion_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from stable_diffusion_tpu_torch.pipeline import StableDiffusion  # noqa: E402


def pipeline(job) -> StableDiffusion:
    pipe = StableDiffusion.build(UNetConfig(**job["unet_config"]),
                                 CLIPTextConfig(**job["text_config"]),
                                 VAEConfig(**job["vae_config"]), device="cpu", impl="torch")
    for name in ("unet", "text_encoder", "vae"):
        getattr(pipe, name).load_state_dict(job["states"][name], strict=True)
    return pipe


def run_request(pipe: StableDiffusion, method: str, kwargs: dict):
    """(output, progress calls as an (n, 2) array) of one request; a
    ``progress`` key in ``kwargs`` asks for the calls to be recorded."""
    kwargs, calls = dict(kwargs), []
    if kwargs.pop("progress", False):
        kwargs["progress_callback"] = lambda done, total: calls.append((done, total))
    return getattr(pipe, method)(**kwargs), np.asarray(calls, np.int64).reshape(-1, 2)


def main(rank: int, world: int, init_file: str, job_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)  # written by the test that started this rank
    pmesh.init_distributed(rank, world, f"file://{init_file}", device="cpu")
    try:
        for data, model in job["meshes"]:
            mesh = pmesh.make_mesh(data, model)
            pipe = pipeline(job).shard(mesh)
            out = {}
            for name, (method, kwargs) in job["requests"].items():
                out[name], out[f"{name}_progress"] = run_request(pipe, method, kwargs)
            np.savez(os.path.join(out_dir, f"rank{rank}_{data}x{model}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
