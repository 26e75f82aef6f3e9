"""The reduction of a ``torch.profiler`` trace of the traced window.

The trace is exported as Chrome JSON into the run's temporary directory,
read once and deleted.  What the per-layer readers take from it:

* ``device``: every GPU activity (kernels, copies, fills) as (name, start,
  end) in microseconds, and for kernels the correlation id of the host
  call that launched it;
* ``launch_ts``: the host time of each launch, by correlation id;
* ``ranges``: the ``record_function`` ranges the benchmark put around the
  models (``portbench.<name>``) on the host, as (start, end);
* the window: the ``portbench.window`` range.

A kernel belongs to a model range when the host call that launched it lies
inside the range.  Device busy time is the union of the activity intervals
inside the window, so overlapping kernels count once.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PREFIX = "portbench."
WINDOW = PREFIX + "window"
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
_LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
_SCAN = 4096  # host ops looked back over for the one running in a gap


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


class Trace:
    """The events of one traced window (times in microseconds)."""

    def __init__(self, events: Sequence[dict]):
        self.device: List[Tuple[str, float, float, Optional[int]]] = []
        self.launch_ts: Dict[int, float] = {}
        self.ranges: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
        self.host_ops: List[Tuple[str, float, float]] = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, ts, dur = ev.get("cat", ""), float(ev["ts"]), float(ev.get("dur", 0.0))
            args = ev.get("args") or {}
            if cat in _DEVICE_CATS:
                self.device.append((ev["name"], ts, ts + dur, args.get("correlation")))
            elif cat in _LAUNCH_CATS:
                if "correlation" in args:
                    self.launch_ts[args["correlation"]] = ts
            elif cat == "user_annotation" and ev["name"].startswith(PREFIX):
                self.ranges[ev["name"][len(PREFIX):]].append((ts, ts + dur))
            elif cat in ("cpu_op", "user_annotation", "python_function"):
                self.host_ops.append((ev["name"], ts, ts + dur))
        windows = self.ranges.pop("window", [])
        if len(windows) != 1:
            raise ValueError(f"expected one {WINDOW} range in the trace, found {len(windows)}")
        self.lo, self.hi = windows[0]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def kernels(self, names: Sequence[str] = ()) -> List[Tuple[str, float, float, Optional[int]]]:
        """Device activity inside the window whose name contains one of
        ``names`` (all of it when ``names`` is empty)."""
        return [k for k in self.device if k[2] > self.lo and k[1] < self.hi
                and (not names or any(n in k[0] for n in names))]

    def busy_s(self, names: Sequence[str] = ()) -> float:
        return union_length(clip([(k[1], k[2]) for k in self.kernels(names)], self.lo,
                                 self.hi)) / 1e6

    def in_range(self, name: str) -> List[Tuple[str, float, float, Optional[int]]]:
        """The kernels launched from inside the host ranges ``name``."""
        spans = merged(self.ranges.get(name, []))
        starts = [s for s, _ in spans]
        out = []
        for k in self.kernels():
            ts = self.launch_ts.get(k[3])
            i = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
            if i >= 0 and ts <= spans[i][1]:
                out.append(k)
        return out

    def range_device_s(self, name: str) -> float:
        """Device time (the union) of the kernels launched inside ``name``."""
        return union_length((k[1], k[2]) for k in self.in_range(name)) / 1e6

    def range_count(self, name: str) -> int:
        return len(self.ranges.get(name, []))

    def device_ops(self, top: int = 10) -> List[list]:
        """[name, seconds] of the device operations that took most time."""
        by = collections.Counter()
        for name, s, e, _ in self.kernels():
            by[name] += (min(e, self.hi) - max(s, self.lo)) / 1e6
        return [[n, t] for n, t in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """[host op, seconds]: the window's device idle time, each gap named
        by the innermost host operation running at its middle, summed by
        name; the largest ``top``."""
        busy = merged(clip([(k[1], k[2]) for k in self.kernels()], self.lo, self.hi))
        gaps, t = [], self.lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.hi:
            gaps.append((t, self.hi))
        ops = sorted(self.host_ops, key=lambda o: o[1])
        starts = [o[1] for o in ops]
        by = collections.Counter()
        for s, e in gaps:
            mid = (s + e) / 2
            name = "(no aten op: Python, ctypes launches)"
            # nested host ops: the latest to start among those still running
            # at ``mid`` is the innermost
            first = bisect.bisect_right(starts, mid) - 1
            for i in range(first, max(first - _SCAN, -1), -1):
                if ops[i][2] >= mid:
                    name = ops[i][0]
                    break
            by[name] += (e - s) / 1e6
        return [[n, t] for n, t in by.most_common(top)]
