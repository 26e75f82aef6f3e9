"""The benchmark's harness: one run of one cell.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (its ``file`` under ``configs/``) and a traffic mix
(``traffic/<traffic>.json``, whose ``driver`` names the generator under
``drivers/``); its correctness limits are ``limits/<cell>.json`` and each
of its per-layer metrics is read by ``metrics/<metric>.py``, or, where there
is no such file, by the reader of the name's first part (``mfu.serve`` and
``mfu.train`` by ``metrics/mfu.py``).  So a cell, a configuration or a
metric is added with new files and entries only.

A run: set up the program, measure the window (``--trace 0``: the cell's
end-to-end metrics) or trace a shorter window under ``torch.profiler``
(``--trace 1``: its per-layer metrics), then compare what the window
produced with the plain reference, and print one JSON object as the last
line of standard output, the compared numbers with their limits as the last
lines of standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import resource
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names the run may not hold: the JAX stack and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "stable_diffusion_tpu")
# the program's kernel switches: left to the program's defaults
SWITCHES = ("SD_TPU_FUSED_MM", "SD_TPU_WINOGRAD")


def load_file(path: Path) -> ModuleType:
    """A module from a file whose name need not be an identifier."""
    name = "portbench_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(metric: str) -> Path:
    """The reader of the per-layer metric ``metric``."""
    path = BENCH / "metrics" / f"{metric}.py"
    return path if path.exists() else BENCH / "metrics" / f"{metric.split('.')[0]}.py"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _applies(metric: dict, cell: str, e2e_names=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def cell_spec(cell: str) -> SimpleNamespace:
    """Everything ``BENCHMARK.json`` and the data files say of ``cell``."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no workload named {cell!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    with open(BENCH / "limits" / f"{cell}.json") as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, cell, names)]
    return SimpleNamespace(name=cell, chips=entry["chips"], config=config, traffic=traffic,
                           limits=limits, end_to_end=e2e, per_layer=per_layer)


class Context:
    """What a driver gets: the cell, the seed, the window's length, the
    device, and the tracing and range helpers."""

    def __init__(self, spec, *, seed: int, seconds: float, trace: bool, device, impl: str,
                 dtype, t0: float):
        self.spec, self.seed, self.seconds, self.trace = spec, int(seed), float(seconds), trace
        self.config, self.traffic, self.limits = spec.config, spec.traffic, spec.limits
        self.device, self.impl, self.dtype, self.t0 = device, impl, dtype, t0
        self.readers: Dict[str, ModuleType] = {}
        self.trace_data = None
        self.shapes: Dict[str, object] = {}

    def note(self, msg: str) -> None:
        print(msg, flush=True)

    def range(self, name: str):
        """A profiler range ``portbench.<name>`` in a traced run, else nothing."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function("portbench." + name)

    @contextlib.contextmanager
    def host_load(self):
        """Notes this process's CPU seconds and involuntary context switches
        while the block ran, beside its host-clock seconds: a run whose
        process held a core all the while and still served less was slowed
        by the core's speed, not by waiting for one."""
        t0, r0 = time.perf_counter(), resource.getrusage(resource.RUSAGE_SELF)
        yield
        t1, r1 = time.perf_counter(), resource.getrusage(resource.RUSAGE_SELF)
        self.note("host: " + json.dumps({
            "wall_s": t1 - t0, "cpu_s": (r1.ru_utime + r1.ru_stime) - (r0.ru_utime + r0.ru_stime),
            "involuntary_switches": r1.ru_nivcsw - r0.ru_nivcsw}))

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def profiled(self, fn: Callable[[], object]):
        """``fn()`` under ``torch.profiler`` inside the ``portbench.window``
        range, with the launch counters the cell's readers name recording
        their shape keys; the trace is kept for the readers."""
        import torch
        from portbench.lib.trace import Trace, WINDOW

        counters = {}
        for reader in self.readers.values():
            for alias, where in getattr(reader, "COUNTERS", {}).items():
                module, attr = where.split(":")
                counters[alias] = getattr(importlib.import_module(module), attr)
        for c in counters.values():
            c.record()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                out = fn()
                self.sync()
        self.shapes = {alias: c.stop_recording() for alias, c in counters.items()}
        self.trace_data = Trace.from_profiler(prof)
        return out


def _card(device) -> dict:
    """The card's name, power limit, clocks and SM count (nvidia-smi where
    it answers)."""
    import torch

    out = {"kind": torch.cuda.get_device_name(device),
           "sms": torch.cuda.get_device_properties(device).multi_processor_count}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit,clocks.max.sm,clocks.sm,"
                            "power.draw,temperature.gpu", "--format=csv,noheader,nounits",
                            f"--id={device.index or 0}"],
                           capture_output=True, text=True, timeout=60, check=True)
        vals = [v.strip() for v in q.stdout.strip().splitlines()[0].split(",")]
        out.update(power_limit_w=vals[0], max_sm_clock_mhz=float(vals[1]), sm_clock_mhz=vals[2],
                   power_draw_w=vals[3], temperature_c=vals[4])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
        out["nvidia_smi"] = f"unavailable: {e}"
    return out


def per_layer_metrics(ctx: Context, outcome: dict, exps_per_s: float) -> dict:
    """Each reader's value, in the order of ``BENCHMARK.json``; a reader that
    finds nothing to read returns None and its metric is left out."""
    view = SimpleNamespace(trace=ctx.trace_data, shapes=ctx.shapes, exps_per_s=exps_per_s,
                           untraced=outcome.get("untraced"))
    out = {}
    for m in ctx.spec.per_layer:
        value = ctx.readers[m["name"]].read(view)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(spec, *, seed: int, seconds: float, trace: bool, device, impl: str, dtype,
             t0: float, exps_per_s: float = 0.0) -> dict:
    """One run of ``spec`` on ``device``: the result object (without
    ``device``), and ``memory_peak_bytes`` beside it."""
    ctx = Context(spec, seed=seed, seconds=seconds, trace=trace, device=device, impl=impl,
                  dtype=dtype, t0=t0)
    if trace:
        ctx.readers = {m["name"]: load_file(reader_path(m["name"])) for m in spec.per_layer}
    driver = load_file(BENCH / "drivers" / f"{spec.traffic['driver']}.py")
    outcome = driver.run(ctx)
    checks = outcome["checks"]
    correct = outcome["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    if trace:
        metrics = per_layer_metrics(ctx, outcome, exps_per_s)
    else:
        metrics = {}
        for m in spec.end_to_end:
            value = outcome["setup_s"] if m["name"] == "setup_s" else outcome["metrics"][m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(outcome["attempted"]),
              "failed": int(outcome["failed"]), "metrics": metrics}
    if trace:
        t = ctx.trace_data
        result["trace"] = {"busy_s": t.busy_s(), "window_s": t.window_s}
        result["breakdown"] = {"device_ops": t.device_ops(), "idle_gaps": t.idle_gaps()}
    result["memory_peak_bytes"] = int(outcome["memory_peak_bytes"])
    result["compared"] = checks
    return result


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = cell_spec(args.workload)
    for k in SWITCHES:
        os.environ.pop(k, None)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {spec.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = _card(device)
    print("card: " + json.dumps(card), flush=True)
    from portbench.lib.work import exp_rate

    exps = exp_rate(card["sms"], card["max_sm_clock_mhz"]) if "max_sm_clock_mhz" in card else 0.0
    dtype = getattr(torch, spec.config["dtype"])
    result = run_cell(spec, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device=device, impl="cuda", dtype=dtype, t0=t0, exps_per_s=exps)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}, which the port must not use", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": card["kind"], "count": spec.chips,
           "memory_peak_bytes": result.pop("memory_peak_bytes")}
    dev.update(result.pop("trace", {}))
    compared = result.pop("compared")
    out = {**result, "device": dev}
    if "breakdown" in out:
        out["breakdown"] = out.pop("breakdown")
    out["compared"] = compared
    for name, c in compared.items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
