"""The highest rate a serving cell sustains, found once by a sweep (not
run by the benchmark's own runs): one process sets the cell up, serves a
backlog for ``--seconds`` (its rate of completions is the capacity), then
serves each of ``--rates`` (requests a second) for ``--seconds`` and
prints the p95 latency, the completions a second and how late the last
request finished behind its due time.

    python3 portbench/tools/sweep.py --workload sd15-onestep-b4 --seed 1 \
        --seconds 20 --rates 10,11,12,13
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.lib import program, stats  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args()
    spec = harness.cell_spec(args.workload)
    ctx = harness.Context(spec, seed=args.seed, seconds=args.seconds, trace=False,
                          device=torch.device("cuda", 0), impl="cuda",
                          dtype=getattr(torch, spec.config["dtype"]), t0=time.perf_counter())
    serve = harness.load_file(harness.BENCH / "drivers" / "serve.py")
    pipe = program.build_pipeline(spec.config, args.seed, device=ctx.device, dtype=ctx.dtype,
                                  impl="cuda")
    for w in range(spec.traffic["warmup_requests"]):
        serve.request(pipe, spec.config, spec.traffic, args.seed, -1 - w)
    base = dict(spec.traffic)
    first = 0
    for rate in [None] + [float(r) for r in args.rates.split(",")]:
        ctx.traffic = {**base, "rate": rate, "check_requests": 0}
        spans, _, lat, failed, _ = serve.serve_window(ctx, pipe, args.seconds, first)
        first += len(lat)
        done = max(e for _, e in spans)
        due_last = min(s for s, _ in spans) + (len(lat) - 1) / rate if rate else done
        print(json.dumps({"rate": rate, "requests": len(lat), "failed": failed,
                          "req_per_s": stats.rate(len(spans), spans),
                          "img_per_s": stats.rate(len(spans) * base["batch"], spans),
                          "p50_s": float(np.median(lat)), "p95_s": stats.p95(lat),
                          "last_late_s": done - due_last}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
