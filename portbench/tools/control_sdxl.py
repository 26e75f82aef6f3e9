"""The readings that set ``sdxl-txt2img-b2``'s limit (not run by the
benchmark's own runs), in one process: on each of ``--seeds`` the
program's first checked request, and the reference held in bf16, each as an
RMS pixel gap from the f32 reference and over the bf16 reference's gap, as
``serve_sdxl.check`` takes it; on each of ``--control-seeds`` also the
control, the reference with float8 product inputs in the program's place.
The f32 reference runs once a seed.  One JSON line a seed on standard output.

    python3 portbench/tools/control_sdxl.py --workload sdxl-txt2img-b2 \\
        --seeds 1,2,3 --control-seeds 1,2,3
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[0] = ROOT
os.environ["SD_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build", "torch_kernels")

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.drivers import serve, serve_sdxl  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    spec = harness.cell_spec(args.workload)
    if not torch.cuda.is_available():
        print("control_sdxl: no CUDA device", file=sys.stderr)
        return 2
    ctx = harness.Context(spec, seed=seeds[0], seconds=0.0, trace=False,
                          device=torch.device("cuda", 0), impl="cuda",
                          dtype=getattr(torch, spec.config["dtype"]), t0=time.perf_counter())
    cfg, tr = ctx.config, ctx.traffic
    pipe = serve_sdxl.build_pipeline(cfg, seeds[0], device=ctx.device, dtype=ctx.dtype,
                                     impl=ctx.impl)
    for w in range(tr["warmup_requests"]):
        serve_sdxl.request(pipe, cfg, tr, seeds[0], -1 - w)
    for seed in seeds:
        ctx.seed = seed
        serve_sdxl.load_pipeline_weights(pipe, cfg, seed)
        t = time.perf_counter()
        served = serve_sdxl.request(pipe, cfg, tr, seed, 0)
        served_s = time.perf_counter() - t
        t = time.perf_counter()
        ref = serve_sdxl.references(ctx, [0], control=seed in control)[0]
        gaps = {"program": serve.image_rms(served, ref["f32"])}
        gaps.update({k: serve.image_rms(v, ref["f32"]) for k, v in ref.items() if k != "f32"})
        print(json.dumps({"seed": seed, "image_rms": gaps,
                          "over_bf16_ref": {k: v / gaps["bf16"] for k, v in gaps.items()},
                          "served_s": served_s, "references_s": time.perf_counter() - t}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
