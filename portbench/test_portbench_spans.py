"""The readers of the program's spans on synthetic traces, on the CPU:
device operations attributed to a span by the host time of their launch
(inside and outside it, nested and overlapping spans counted once, copies
and fills counted like kernels), each over the recorder's count; the
backward's device time as a union; nothing to read where the trace holds
no ``sd.*`` span (the parent of the spans); and the recorder, which passes
through to the program's and does nothing without one."""

import collections
import json
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.lib import spans
from portbench.lib.trace import Trace


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def launch(ts, corr):
    return ev("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=corr)


def serving() -> Trace:
    """Two denoise steps (0-30, 40-70 us), each with a UNet pass inside and
    a K2 span inside that; a kernel and a memcpy launched in each step, a
    fill in the second's UNet, and a kernel launched between the steps."""
    return Trace([
        ev("user_annotation", "portbench.window", 0, 100),
        ev("user_annotation", "sd.denoise_step", 0, 30),
        ev("user_annotation", "sd.unet", 2, 20),
        ev("user_annotation", "sd.K2", 4, 4),
        ev("user_annotation", "sd.denoise_step", 40, 30),
        ev("user_annotation", "sd.unet", 42, 20),
        launch(5, 1),                                                  # step 1, in K2
        ev("cuda_runtime", "cudaMemcpyAsync", 25, 1, correlation=2),   # step 1, after the UNet
        launch(35, 3),                                                 # between the steps
        ev("cuda_runtime", "cudaMemsetAsync", 45, 1, correlation=4),   # step 2, in the UNet
        launch(50, 5),                                                 # step 2
        ev("kernel", "void conv3x3_kernel<64>(ConvArgs)", 6, 10, correlation=1),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 26, 3, correlation=2),
        ev("kernel", "elementwise", 36, 2, correlation=3),
        ev("gpu_memset", "Memset (Device)", 46, 1, correlation=4),
        ev("kernel", "void conv3x3_kernel<64>(ConvArgs)", 51, 10, correlation=5),
    ])


def view(trace, **counts):
    return SimpleNamespace(trace=trace, shapes={"spans": collections.Counter(counts)},
                           untraced=None, exps_per_s=0.0)


def reader(name):
    return harness.load_file(harness.reader_path(name))


def test_launches_inside_and_outside_the_spans():
    t = serving()
    assert [k[3] for k in spans.launched_in(t, "denoise_step")] == [1, 2, 4, 5]
    assert [k[3] for k in spans.launched_in(t, "unet")] == [1, 4, 5]
    assert [k[3] for k in spans.launched_in(t, "K2")] == [1]
    assert spans.launched_in(t, "backward") == []
    v = view(t, denoise_step=2, unet=2, K2=1)
    assert spans.launches_per_call(v, "denoise_step") == 2.0  # 4 over 2 steps
    assert reader("launches_per_step.serve").read(v) == 2.0
    assert spans.device_ms_per_call(v, "unet") == pytest.approx((10 + 1 + 10) / 1e3 / 2)


def test_nested_and_overlapping_spans_count_once():
    t = Trace([
        ev("user_annotation", "portbench.window", 0, 100),
        ev("user_annotation", "sd.denoise_step", 0, 50),
        ev("user_annotation", "sd.denoise_step", 10, 20),   # nested in the first
        ev("user_annotation", "sd.denoise_step", 40, 30),   # overlapping its end
        launch(15, 1), launch(45, 2), launch(65, 3), launch(80, 4),
        *[ev("kernel", f"k{i}", 20 * i, 5, correlation=i) for i in (1, 2, 3, 4)],
    ])
    assert [k[3] for k in spans.launched_in(t, "denoise_step")] == [1, 2, 3]
    assert spans.launches_per_call(view(t, denoise_step=3), "denoise_step") == 1.0


def test_the_step_is_the_train_step_in_a_training_trace():
    t = Trace([
        ev("user_annotation", "portbench.window", 0, 100),
        ev("user_annotation", "sd.train_step", 0, 90),
        ev("user_annotation", "sd.backward", 20, 60),
        launch(10, 1), launch(30, 2), launch(31, 3), launch(95, 4),
        # the backward's kernels overlap (two streams): their union counts once
        ev("kernel", "forward", 12, 8, correlation=1),
        ev("kernel", "bwd_dq_ring", 32, 10, correlation=2),
        ev("kernel", "bwd_dkv_ring", 36, 10, correlation=3),
        ev("kernel", "after", 96, 2, correlation=4),
    ])
    v = view(t, train_step=1, backward=1)
    assert reader("launches_per_step.train").read(v) == 3.0
    assert reader("backward_ms.train").read(v) == pytest.approx(14 / 1e3)  # 32-46 us
    assert reader("backward_ms.train").read(view(t, train_step=2, backward=2)) == \
        pytest.approx(7 / 1e3)


def test_nothing_to_read_without_spans():
    t = Trace([ev("user_annotation", "portbench.window", 0, 100),
               ev("user_annotation", "portbench.unet", 0, 50),
               launch(5, 1), ev("kernel", "k", 6, 10, correlation=1)])
    for v in (view(t), SimpleNamespace(trace=t, shapes={}, untraced=None, exps_per_s=0.0)):
        for name in ("launches_per_step.serve", "launches_per_step.latency",
                     "launches_per_step.train", "backward_ms.train"):
            assert reader(name).read(v) is None, name
    # a recorder that counted a span the trace lacks reads nothing either
    assert spans.launches_per_call(view(t, denoise_step=1), "denoise_step") is None


def test_recorder_passes_through_or_does_nothing(monkeypatch):
    fake = SimpleNamespace(calls=None)
    fake.record = lambda: setattr(fake, "calls", collections.Counter(unet=0))
    fake.stop_recording = lambda: fake.calls
    mod = SimpleNamespace(SPANS=fake)
    monkeypatch.setattr(spans.importlib, "import_module", lambda name: mod)
    spans.RECORDER.record()
    fake.calls["unet"] += 2
    assert spans.RECORDER.stop_recording() == {"unet": 2}
    del mod.SPANS  # a program without spans
    spans.RECORDER.record()
    assert spans.RECORDER.stop_recording() is None


def test_span_readers_name_the_recorder():
    with open(harness.ROOT / "BENCHMARK.json") as f:
        names = [m["name"] for m in json.load(f)["per_layer"]
                 if m["name"].split(".")[0] in ("launches_per_step", "backward_ms")]
    assert len(names) == 4
    for name in names:
        module, attr = reader(name).COUNTERS["spans"].split(":")
        assert getattr(__import__(module, fromlist=[attr]), attr) is spans.RECORDER


def test_traced_tiny_run_records_the_programs_spans(monkeypatch):
    """The harness's traced window on the CPU (the program's plain path, no
    device operations): the readers turn the program's spans on, and the
    recorder counts each span as the trace holds it."""
    import time

    import torch

    from portbench import tiny

    seen = {}
    metrics = harness.per_layer_metrics

    def kept(ctx, outcome, exps_per_s):
        seen["ctx"] = ctx
        return metrics(ctx, outcome, exps_per_s)

    monkeypatch.setattr(harness, "per_layer_metrics", kept)
    s = tiny.spec("sd15-onestep-b4")
    harness.run_cell(s, seed=2 ** 33 + 7, seconds=0.5, trace=True, device=torch.device("cpu"),
                     impl="torch", dtype=torch.float32, t0=time.perf_counter())
    ctx = seen["ctx"]
    traced = collections.Counter(n[len(spans.PREFIX):] for n, _, _ in ctx.trace_data.host_ops
                                 if n.startswith(spans.PREFIX))
    n = s.traffic["trace_requests"]
    assert ctx.shapes["spans"] == traced == collections.Counter(
        text=n, denoise_step=n, unet=n, sampler=n, vae_decode=n, to_host=n)
