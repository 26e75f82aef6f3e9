"""The program's own spans in a traced window.

The port opens ``torch.profiler.record_function`` ranges named ``sd.<name>``
(``stable_diffusion_tpu_torch/utils/device.py``: ``span`` and the recorder
``SPANS``, off unless something records them) around a denoise step, a
UNet pass, a train step, the backward and each hand-written kernel's
wrapper.  They reach :class:`lib.trace.Trace` as host operations
(``Trace.host_ops``), on the clock of the device activity.

A reader that needs them names ``COUNTERS`` below: the harness records
:data:`RECORDER` around the traced window like a launch counter, so the
program's spans are on exactly while the window is traced, and
``view.shapes["spans"]`` holds the recorder's count of each span (by name,
without ``sd.``).  On a program without spans the recorder does nothing,
the trace holds no ``sd.*`` range and the readers return None.

A device operation belongs to a span when the host call that launched it
(``Trace.launch_ts``) lies inside one of the span's ranges; ranges of one
name are merged first, so a nested or overlapping pair counts an operation
once.  Launches from autograd's engine thread count by their time, like
any other: the thread that opened ``sd.backward`` waits in it meanwhile.
"""

from __future__ import annotations

import bisect
import importlib
from typing import List, Optional, Tuple

from portbench.lib.trace import merged, union_length

PREFIX = "sd."
ALIAS = "spans"
PROGRAM_RECORDER = ("stable_diffusion_tpu_torch.utils.device", "SPANS")


class _Recorder:
    """The program's span recorder where it has one, else nothing: the
    harness's ``record()`` / ``stop_recording()`` pass through to it."""

    def __init__(self):
        self._on = None

    def record(self) -> None:
        module, attr = PROGRAM_RECORDER
        try:
            self._on = getattr(importlib.import_module(module), attr, None)
        except ImportError:
            self._on = None
        if self._on is not None:
            self._on.record()

    def stop_recording(self):
        rec, self._on = self._on, None
        return rec.stop_recording() if rec is not None else None


RECORDER = _Recorder()
COUNTERS = {ALIAS: "portbench.lib.spans:RECORDER"}


def ranges(trace, name: str) -> List[Tuple[float, float]]:
    """The host ranges of the span ``sd.<name>`` in the trace (us)."""
    full = PREFIX + name
    return [(s, e) for n, s, e in trace.host_ops if n == full]


def launched_in(trace, name: str) -> list:
    """The window's device operations (kernels, copies, fills) launched from
    inside the span ``sd.<name>``."""
    spans = merged(ranges(trace, name))
    starts = [s for s, _ in spans]
    out = []
    for k in trace.kernels():
        ts = trace.launch_ts.get(k[3])
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= spans[i][1]:
            out.append(k)
    return out


def calls(view, name: str) -> int:
    """The recorder's count of the span ``sd.<name>`` in the traced window."""
    return int((view.shapes.get(ALIAS) or {}).get(name, 0))


def launches_per_call(view, name: str) -> Optional[float]:
    """Device operations launched inside the span, over the recorder's
    count of it; None where the trace holds none of it."""
    n = calls(view, name)
    if not n or not ranges(view.trace, name):
        return None
    return len(launched_in(view.trace, name)) / n


def device_ms_per_call(view, name: str) -> Optional[float]:
    """Device milliseconds (the union) of what the span launched, over the
    recorder's count of it; None where the trace holds none of it."""
    n = calls(view, name)
    if not n or not ranges(view.trace, name):
        return None
    busy = union_length((k[1], k[2]) for k in launched_in(view.trace, name))
    return busy / 1e3 / n if busy > 0 else None
