"""What the per-layer metric files share: each file under ``metrics/``
names its kernels, counters and ranges, and calls one of these on the
traced window's ``view`` (``view.trace``: :class:`lib.trace.Trace`;
``view.shapes``: the recorded launch counters' shape keys by alias;
``view.untraced``: (model FLOPs, seconds) of the same work as the traced
window's (as many requests or micro-steps, at the same shapes) run untraced
just before it, its seconds on the host clock and, for requests, only while
one was being served; ``view.exps_per_s``: the card's exponential rate).
Each returns None when the window holds nothing to read.

The profiler slows the host's launches (1.7x with CUDA activity alone), so
what depends on the host's pace is taken over the untraced seconds; device
times are the profiler's and do not depend on it."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from portbench.lib import work


def range_ms(view, name: str) -> Optional[float]:
    """Device milliseconds a call of the model range ``name``: the union of
    the kernels launched inside its calls over the number of calls."""
    calls = view.trace.range_count(name)
    if not calls:
        return None
    busy = view.trace.range_device_s(name)
    return busy / calls * 1e3 if busy > 0 else None


def roofline(view, alias: str, kernels: Sequence[str], work_fn: Callable,
             flop_rate: float = work.BF16_FLOPS) -> Optional[float]:
    """Percent of the roofline: the least time of the operations that the
    launch counter ``alias`` recorded (their shapes' work at the peaks) over
    the device time of the kernels whose names contain one of ``kernels``."""
    shapes = view.shapes.get(alias)
    device_s = view.trace.busy_s(kernels)
    if not shapes or device_s <= 0:
        return None
    least = 0.0
    for key, n in shapes.items():
        w = work_fn(key)
        least += n * work.bound_s(w["flops"], w["nbytes"], flop_rate, w.get("exps", 0.0),
                                  view.exps_per_s)
    return 100.0 * least / device_s


def mfu(view) -> Optional[float]:
    """Percent of the bf16 peak: the model FLOPs of the untraced pass over its
    seconds."""
    if not view.untraced or view.untraced[1] <= 0:
        return None
    flops, seconds = view.untraced
    return 100.0 * flops / seconds / work.BF16_FLOPS


def idle_share(view) -> Optional[float]:
    """Percent of the untraced pass's seconds in which the device would be
    idle: 1 - the traced window's device busy time (the union of its
    activity) over the untraced seconds of the same work."""
    busy = view.trace.busy_s()
    if busy <= 0 or not view.untraced or view.untraced[1] <= 0:
        return None
    return 100.0 * (1.0 - busy / view.untraced[1])
