"""The readings that set a cell's correctness limits (not run by the
benchmark's own runs): in one process, the program's number on each of
``--seeds`` (a short window of ``check_requests`` requests, or the first
``check_steps`` micro-steps, compared with the f32 reference as a run
compares them), and on each of ``--control-seeds`` the control, the
reference computed in float8 (e4m3, per-tensor scales) in the program's
place, compared the same way; for a training cell also the fault "half of
the batch left out", planted in the reference.  One JSON line a reading on
standard output.

    python3 portbench/tools/control.py --workload sd15-txt2img-b4 \
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
from portbench.lib import inputs, program  # noqa: E402
from portbench.reference import nets  # noqa: E402


def say(**kw) -> None:
    print(json.dumps(kw), flush=True)


def serve_readings(ctx, serve, seeds, control_seeds):
    cfg, tr = ctx.config, ctx.traffic
    pipe = program.build_pipeline(cfg, seeds[0], device=ctx.device, dtype=ctx.dtype,
                                  impl=ctx.impl)
    for w in range(tr["warmup_requests"]):
        serve.request(pipe, cfg, tr, seeds[0], -1 - w)
    for seed in seeds:
        ctx.seed = seed
        program.load_pipeline_weights(pipe, cfg, seed)
        t = time.perf_counter()
        kept = [(i, serve.request(pipe, cfg, tr, seed, i)) for i in range(tr["check_requests"])]
        served = time.perf_counter() - t
        t = time.perf_counter()
        value = serve.check(ctx, kept)
        say(kind="program", seed=seed, image_rms=value, served_s=served,
            reference_s=time.perf_counter() - t)
        if seed in control_seeds:
            with nets.f32_products():
                w = program.reference_weights(cfg, seed, ctx.device, ctx.dtype)
                low = [(i, (serve.reference_images(w, cfg, tr, seed, i, ctx.device, ctx.dtype,
                                                   nets.Ops("fp8")) * 255.0).round()
                        .clip(0, 255).astype("uint8")) for i in range(tr["check_requests"])]
                del w
            say(kind="control_fp8", seed=seed, image_rms=serve.check(ctx, low))


def train_readings(ctx, train, seeds, control_seeds):
    cfg, tr = ctx.config, ctx.traffic
    shapes = nets.param_shapes(cfg)["unet"]
    unet = program.build_unet(cfg, seeds[0], device=ctx.device, dtype=ctx.dtype)
    for seed in seeds:
        ctx.seed = seed
        program.load(unet, inputs.make_weights({"unet": shapes}, seed, ctx.device,
                                               ctx.dtype)["unet"])
        lora0 = inputs.lora_tree(seed, shapes, tr["targets"], tr["rank"], tr["alpha"],
                                 ctx.device)
        t = time.perf_counter()
        prog, state, step_fn = train.first_steps(ctx, unet, lora0)
        del state, step_fn
        torch.cuda.empty_cache()
        served = time.perf_counter() - t
        t = time.perf_counter()
        ref = train.reference(ctx, lora0)
        say(kind="program", seed=seed, **train.compare(prog, ref),
            loss_gap=train.loss_gap(prog, ref), steps_s=served,
            reference_s=time.perf_counter() - t, losses=prog["losses"], ref_losses=ref["losses"])
        if seed in control_seeds:
            for kind, kw in (("control_fp8", {"ops": nets.Ops("fp8")}),
                             ("fault_half_batch", {"rows": train.half_rows})):
                low = train.reference(ctx, lora0, **kw)
                say(kind=kind, seed=seed, **train.compare(low, ref),
                    loss_gap=train.loss_gap(low, ref), losses=low["losses"])


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
        print("control: no CUDA device", file=sys.stderr)
        return 2
    ctx = harness.Context(spec, seed=seeds[0], seconds=0.0, trace=False,
                          device=torch.device("cuda", 0), impl="cuda",
                          dtype=getattr(torch, spec.config["dtype"]), t0=time.perf_counter())
    driver = harness.load_file(harness.BENCH / "drivers" / f"{spec.traffic['driver']}.py")
    if spec.traffic["driver"] == "train":
        train_readings(ctx, driver, seeds, control)
    else:
        serve_readings(ctx, driver, seeds, control)
    return 0


if __name__ == "__main__":
    sys.exit(main())
