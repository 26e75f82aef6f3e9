"""One traced run of a cell, as ``run.py --trace 1`` makes it (its result
line printed as usual), then the program's spans held against that trace
(not run by the benchmark's own runs): each span's count by the recorder
beside the trace's; each span's device milliseconds a call (the union of
what it launched) beside the benchmark's model ranges (``unet_ms``,
``vae_decode_ms``); device operations launched a call of each span; and the
window's device idle time by the innermost host operation running in the
gap, summed over all names (``sd.*`` spans apart, then the aten operations
and the gaps no host operation names).  ``--spans 0`` leaves the program's
spans off for the run, to time the traced window without them.

    python3 portbench/tools/spancheck.py --workload sd15-txt2img-b4 --seed 7 \
        --seconds 50 [--spans 0]
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[0] = ROOT
os.environ["SD_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build", "torch_kernels")

from portbench import harness  # noqa: E402
from portbench.lib import readers, spans  # noqa: E402


def report(ctx) -> dict:
    t = ctx.trace_data
    view = SimpleNamespace(trace=t, shapes=ctx.shapes, untraced=None, exps_per_s=0.0)
    traced = collections.Counter(n[len(spans.PREFIX):] for n, _, _ in t.host_ops
                                 if n.startswith(spans.PREFIX))
    recorded = collections.Counter(ctx.shapes.get(spans.ALIAS) or {})
    gaps = collections.Counter()
    for name, s in t.idle_gaps(top=100000):
        group = (name if name.startswith(spans.PREFIX) else
                 "aten" if name.startswith("aten::") else name)
        gaps[group] += s
    return {"window_s": t.window_s, "busy_s": t.busy_s(),
            "recorded": recorded, "traced": traced, "counts_equal": recorded == traced,
            "span_device_ms": {n: spans.device_ms_per_call(view, n) for n in sorted(traced)},
            "range_device_ms": {n: readers.range_ms(view, n)
                                for n in ("text", "unet", "vae_decode")},
            "launches_per_call": {n: spans.launches_per_call(view, n) for n in sorted(traced)},
            "idle_s_by_host_op": dict(gaps.most_common())}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = p.parse_args()
    if not args.spans:
        spans.PROGRAM_RECORDER = (spans.PROGRAM_RECORDER[0], "_no_such_recorder")
    seen = {}
    metrics = harness.per_layer_metrics

    def kept(ctx, outcome, exps_per_s):
        seen["ctx"] = ctx
        return metrics(ctx, outcome, exps_per_s)

    harness.per_layer_metrics = kept
    rc = harness.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                       str(args.seconds), "--trace", "1"], t0=T0)
    if "ctx" in seen:
        print("spancheck: " + json.dumps({"spans": args.spans, **report(seen["ctx"])}),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
