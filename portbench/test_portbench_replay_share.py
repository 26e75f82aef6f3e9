"""The reader of ``unet_replay_share.serve`` on synthetic traces, on the
CPU: the share of the recorder's ``sd.unet`` calls that were replays of a
captured CUDA graph (``sd.unet_replay``), and nothing to read where the
trace holds no replay (a program without the span, or one that replayed
nothing)."""

import collections
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.lib import spans
from portbench.lib.trace import Trace


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def view(trace, **counts):
    return SimpleNamespace(trace=trace, shapes={"spans": collections.Counter(counts)},
                           untraced=None, exps_per_s=0.0)


def reader():
    return harness.load_file(harness.reader_path("unet_replay_share.serve"))


def unet_calls(replayed: bool) -> Trace:
    """Three UNet calls in a 100 us window, each with its replay inside where
    ``replayed``, and a kernel launched from each."""
    events = [ev("user_annotation", "portbench.window", 0, 100)]
    for i, s in enumerate((0, 30, 60)):
        events += [ev("user_annotation", "sd.unet", s, 20),
                   ev("cuda_runtime", "cudaGraphLaunch", s + 5, 1, correlation=i),
                   ev("kernel", "void conv3x3_kernel<64>(ConvArgs)", s + 6, 10, correlation=i)]
        if replayed:
            events.append(ev("user_annotation", "sd.unet_replay", s + 2, 16))
    return Trace(events)


def test_every_call_replayed_reads_100():
    assert reader().read(view(unet_calls(True), unet=3, unet_replay=3)) == pytest.approx(100.0)


def test_a_call_run_eagerly_lowers_the_share():
    assert reader().read(view(unet_calls(True), unet=3, unet_replay=2)) == pytest.approx(200 / 3)


@pytest.mark.parametrize("counts", [dict(unet=3), dict(), None])
def test_nothing_to_read_without_the_replay_span(counts):
    v = (SimpleNamespace(trace=unet_calls(False), shapes={}, untraced=None, exps_per_s=0.0)
         if counts is None else view(unet_calls(False), **counts))
    assert reader().read(v) is None


def test_the_reader_names_the_recorder():
    module, attr = reader().COUNTERS["spans"].split(":")
    assert getattr(__import__(module, fromlist=[attr]), attr) is spans.RECORDER
