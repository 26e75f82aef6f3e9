"""The arithmetic of the metrics on synthetic traces, on the CPU: device busy
time as a union of intervals (overlapping kernels count once), kernels
attributed to a model range by the host time of their launch, the idle
share and its gaps, the p95 rule, the rate over whole requests, a
roofline from shape keys against the published peaks, the MFU, and the
model FLOPs counted on the meta device at the configurations' full
widths."""

import collections
import json
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.lib import readers, stats, work
from portbench.lib.trace import Trace, union_length
from portbench.reference import nets


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def synthetic() -> Trace:
    """A 100 us window: a UNet range (0-20 us) launching two overlapping
    kernels, a decode range (40-50 us) launching a third; host ops between."""
    return Trace([
        ev("user_annotation", "portbench.window", 0, 100),
        ev("user_annotation", "portbench.unet", 0, 20),
        ev("user_annotation", "portbench.vae_decode", 40, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 15, 1, correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 45, 1, correlation=3),
        ev("kernel", "void conv3x3_kernel<64>(ConvArgs)", 10, 20, correlation=1),
        ev("kernel", "attention_kernel_ring", 20, 20, correlation=2),
        ev("kernel", "void conv3x3_kernel<64>(ConvArgs)", 50, 10, correlation=3),
        ev("cpu_op", "aten::copy_", 60, 40),
        ev("cpu_op", "aten::sleep", 70, 5),
    ])


def test_union_of_overlapping_intervals():
    assert union_length([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20
    assert union_length([]) == 0


def test_trace_busy_ranges_and_idle():
    t = synthetic()
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx(40e-6)  # 10-40 once, 50-60
    assert t.busy_s(["conv3x3_kernel"]) == pytest.approx(30e-6)
    assert [k[3] for k in t.in_range("unet")] == [1, 2]
    assert t.range_device_s("unet") == pytest.approx(30e-6)
    assert t.range_device_s("vae_decode") == pytest.approx(10e-6)
    view = SimpleNamespace(trace=t, shapes={}, untraced=None, exps_per_s=0.0)
    assert readers.idle_share(view) is None  # no untraced pass to read
    assert readers.range_ms(view, "unet") == pytest.approx(30e-3)
    gaps = dict(t.idle_gaps())
    # gaps 0-10 and 40-50 (no aten op), 60-100 (mid 80: aten::copy_, which outlasts the sleep)
    assert gaps["aten::copy_"] == pytest.approx(40e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)
    ops = dict(t.device_ops())
    assert ops["void conv3x3_kernel<64>(ConvArgs)"] == pytest.approx(30e-6)


def test_trace_needs_one_window():
    with pytest.raises(ValueError):
        Trace([ev("kernel", "k", 0, 1)])


@pytest.mark.parametrize("n,want", [(1, 1), (19, 19), (20, 19), (100, 95), (400, 380)])
def test_p95_nearest_rank(n, want):
    assert stats.p95([float(v) for v in range(n, 0, -1)]) == want


def test_rate_over_whole_requests():
    assert stats.rate(8, [(1.0, 2.0), (2.0, 4.0)]) == pytest.approx(8 / 3)


def test_roofline_from_shape_keys():
    t = synthetic()
    key = (2, 64, 64, 320, 320, True)
    view = SimpleNamespace(trace=t, shapes={"K2": collections.Counter({key: 3})},
                           untraced=None, exps_per_s=0.0)
    w = work.conv3x3_work(key)
    least = 3 * max(w["flops"] / 989e12, w["nbytes"] / 3.35e12)
    got = readers.roofline(view, "K2", ("conv3x3_kernel",), work.conv3x3_work)
    assert got == pytest.approx(100 * least / 30e-6)
    assert readers.roofline(view, "K3", ("x",), work.attention_work) is None  # nothing to read


def test_attention_bound_takes_the_exponentials():
    w = work.attention_work((2, 4096, 4096, 8, 40))
    rate = work.exp_rate(132, 1980.0)
    assert w["exps"] == 2 * 8 * 4096 * 4096
    assert work.bound_s(w["flops"], w["nbytes"], exps=w["exps"], exps_per_s=rate) == \
        pytest.approx(w["exps"] / rate)


def test_mfu_and_idle_share_over_the_untraced_seconds():
    # the synthetic window's 40 us of device work took 50 us untraced
    view = SimpleNamespace(trace=synthetic(), shapes={}, untraced=(989e12 * 25e-6, 50e-6),
                           exps_per_s=0.0)
    assert readers.mfu(view) == pytest.approx(50.0)
    assert readers.idle_share(view) == pytest.approx(20.0)
    assert readers.mfu(SimpleNamespace(untraced=None)) is None


def test_service_seconds_leave_out_arrival_gaps():
    # an open loop's requests served 0-1 s and 5-6 s, a retried stretch overlapping
    assert union_length([(0.0, 1.0), (5.0, 6.0), (5.5, 5.8)]) == pytest.approx(2.0)


def test_readers_are_found_by_name_or_its_first_part():
    assert harness.reader_path("mfu.train").name == "mfu.py"
    assert harness.reader_path("idle_share.serve").name == "idle_share.py"
    with open(harness.ROOT / "BENCHMARK.json") as f:
        for m in json.load(f)["per_layer"]:
            assert harness.reader_path(m["name"]).exists(), m["name"]


def _config(name):
    with open(harness.ROOT / "portbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


# model FLOPs at full width, counted on meta over the reference: one UNet
# sample-pass at the latent size, one image's decode, one prompt's text tower
@pytest.mark.parametrize("name,unet,vae,text", [("sd15", 0.803e12, 2.515e12, 13e9),
                                                ("sd21-768", 2.149e12, 5.754e12, 45e9)])
def test_model_flops_on_meta(name, unet, vae, text):
    cfg = _config(name)
    r = cfg["resolution"] // 8
    ops, P = nets.Ops(), nets.Params.recording()
    d = cfg["text"]["hidden_size"]
    got_unet = work.model_flops(lambda: nets.unet(
        P, cfg["unet"], work.meta_randn(1, 4, r, r),
        torch.zeros((1,), dtype=torch.long, device="meta"), work.meta_randn(1, 77, d), ops))
    got_vae = work.model_flops(lambda: nets.vae_decode(P, cfg["vae"], work.meta_randn(1, 4, r, r),
                                                       ops))
    ids = torch.zeros((1, 77), dtype=torch.long, device="meta")
    got_text = work.model_flops(lambda: nets.text_encoder(P, cfg["text"], ids, ops))
    assert got_unet == pytest.approx(unet, rel=0.01)
    assert got_vae == pytest.approx(vae, rel=0.01)
    assert got_text == pytest.approx(text, rel=0.05)
