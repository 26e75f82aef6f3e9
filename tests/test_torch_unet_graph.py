"""The UNet pass's CUDA-graph cache (utils/graphs.py) on the CPU: its key,
when a call engages, the warm-up, eviction, new weights and the launch
counters' credit.

A CUDA graph cannot be captured here, so :class:`CpuGraphs` stands a plain
re-run in for one: its capture runs the pass once under the same gathering
a CUDA capture uses (launches recorded, not counted), and its "replay"
runs it again with the counters off, so what the cache credits is all that
counts.  The GPU tests (tests/test_torch_unet_graph_gpu.py) hold real
replays against eager passes on the card.
"""

import collections

import pytest
import torch
from torch import nn

from stable_diffusion_tpu_torch.models import layers
from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
from stable_diffusion_tpu_torch.ops import conv, flash_attention, groupnorm
from stable_diffusion_tpu_torch.utils import device, graphs
from stable_diffusion_tpu_torch.utils.device import SPANS
from stable_diffusion_tpu_torch.utils.weights import build, init_random_
from tests.torch_threads import one_thread  # noqa: F401

TINY = UNetConfig(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
                  cross_attention_dim=24, t_embed_dim=16)


@pytest.fixture(scope="module")
def unet():
    return init_random_(build(UNet, TINY, device="cpu", dtype=torch.float32), 0)


def _inputs(b=2, hw=8, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, hw, hw, 4, generator=g).to(dtype), torch.tensor([500]),
            torch.randn(b, 77, 24, generator=g).to(dtype))


class _CpuGraph:
    """A CUDA graph's stand-in: ``replay`` runs the pass again on the static
    inputs into the static output, gathering (so not counting) its launches
    as a graph launches them without a wrapper."""

    def __init__(self, run, static, out):
        self.run, self.static, self.out = run, static, out

    def replay(self):
        with device.graph_capture():
            self.out.copy_(self.run(*self.static))


class CpuGraphs(graphs.GraphCache):
    def __init__(self):
        super().__init__("unet_replay")
        self.captures = 0

    def _capture(self, run, inputs):
        self.captures += 1
        static = [t.clone() for t in inputs]
        with device.graph_capture() as gathered:
            out = run(*static)
        return graphs._Graph(_CpuGraph(run, static, out), static, out,
                             graphs._credits(gathered.launches), gathered.tensors_read())


def _pass(unet, counted=()):
    """The UNet's eager pass on the plain path, launching ``counted``
    (counter, key) pairs as a kernel wrapper would."""
    def run(x, t, cond):
        for counter, key in counted:
            counter.launched(key)
        return unet._full(x, t, cond, impl="torch", gradient_checkpointing=False,
                          added_cond=None)[0]
    return run


@pytest.mark.parametrize("change", ["shape", "dtype", "impl", "version", "replaced", "stride"])
def test_the_key_changes_with(unet, change):
    cache = CpuGraphs()
    x, t, cond = _inputs()
    def key(inputs, extra):
        return cache.signature(inputs, extra), cache.stamp_of(cache.tensors(unet))

    sig, stamp = key((x, t, cond), ("cuda",))
    extra = ("cuda",)
    w = unet.encoder.conv_in.weight
    if change == "shape":
        x = _inputs(b=4)[0]
    elif change == "dtype":
        x = x.bfloat16()
    elif change == "impl":
        extra = ("auto",)
    elif change == "version":
        with torch.no_grad():
            w.add_(0.0)
    elif change == "replaced":
        old = unet.output["2"].bias
        unet.output["2"].bias = nn.Parameter(old.detach().clone())
    else:
        x = x.permute(0, 2, 1, 3)
    sig2, stamp2 = key((x, t, cond), extra)
    assert (sig2, stamp2) != (sig, stamp)
    if change in ("version", "replaced"):
        assert sig2 == sig and stamp2 != stamp
    else:
        assert sig2 != sig and stamp2 == stamp


def test_the_first_call_runs_eagerly_and_captures_later_calls_replay(unet):
    cache = CpuGraphs()
    inputs = _inputs()
    ref = _pass(unet)(*inputs)
    SPANS.record()
    try:
        with torch.no_grad():
            outs = [cache(unet, _pass(unet), inputs) for _ in range(4)]
    finally:
        calls = SPANS.stop_recording()
    assert cache.captures == 1 and len(cache.graphs) == 1
    assert calls["unet_replay"] == 3  # the first call's output is its eager pass's
    for out in outs:
        assert torch.equal(out, ref)


def test_eviction_keeps_the_most_recent_signatures(unet):
    cache = CpuGraphs()
    sizes = [8 * (i + 1) for i in range(graphs.MAX_GRAPHS + 1)]

    def kept():
        return [s[0][0][0][1] for s in cache.graphs]

    with torch.no_grad():
        for hw in sizes:
            cache(unet, _pass(unet), _inputs(hw=hw))
        assert kept() == sizes[1:]  # the first evicted
        cache(unet, _pass(unet), _inputs(hw=sizes[1]))  # a replay: now the most recent
        cache(unet, _pass(unet), _inputs(hw=sizes[0]))  # captured again, evicting sizes[2]
    assert kept() == sizes[3:] + sizes[1::-1]
    assert cache.captures == len(sizes) + 1


def test_replays_credit_the_counters_as_eager_passes(unet):
    counted = [(conv.K2, (2, 8, 8, 32, 32, True))] * 3 + [
        (flash_attention.K3, (2, 64, 64, 2, 16)),
        (flash_attention.K3_BY_BODY["ring"], (2, 64, 64, 2, 16)),
        (groupnorm.K1, ("stats", 2, 64, 32, torch.float32, 1e-5))]
    counters = {c for c, _ in counted}

    def counts(fn, n):
        before = {c: c.launches for c in counters}
        for c in counters:
            c.record()
        with torch.no_grad():
            for _ in range(n):
                fn()
        return {c.name: (c.launches - before[c], c.stop_recording()) for c in counters}

    inputs = _inputs()
    cache = CpuGraphs()
    eager = counts(lambda: _pass(unet, counted)(*inputs), 5)
    replayed = counts(lambda: cache(unet, _pass(unet, counted), inputs), 5)
    assert cache.captures == 1
    assert replayed == eager
    assert eager["K2"] == (15, collections.Counter({(2, 8, 8, 32, 32, True): 15}))


def test_new_weights_drop_every_graph_and_recapture(unet):
    cache = CpuGraphs()
    inputs = _inputs()
    w = unet.decoder.up["3"].block["2"]["0"].conv_2.weight
    with torch.no_grad():
        for _ in range(3):
            cache(unet, _pass(unet), inputs)
        assert cache.captures == 1
        saved = w.clone()
        try:
            w.mul_(2.0)  # an in-place change, as a LoRA merge makes
            ref = _pass(unet)(*inputs)
            outs = [cache(unet, _pass(unet), inputs) for _ in range(3)]
        finally:
            w.copy_(saved)
    assert cache.captures == 2
    for out in outs:
        assert torch.equal(out, ref)


def test_a_returned_output_survives_the_next_call(unet):
    cache = CpuGraphs()
    a, b = _inputs(seed=1), _inputs(seed=2)
    with torch.no_grad():
        for _ in range(2):
            cache(unet, _pass(unet), a)
        out_a = cache(unet, _pass(unet), a)
        kept = out_a.clone()
        out_b = cache(unet, _pass(unet), b)
    assert torch.equal(out_a, kept) and not torch.equal(out_a, out_b)


@pytest.mark.parametrize("case", ["grad", "row_parallel", "plain"])
def test_what_the_module_lets_engage(case):
    unet = init_random_(build(UNet, TINY, device="cpu", dtype=torch.float32), 0)
    inputs = _inputs()
    cache = CpuGraphs()
    if case == "row_parallel":  # a shard's mark (parallel/mesh.shard_module_)
        unet.bottleneck["1"].transformer_block.attn1.out_proj._sdtk_row_mesh = object()
    with torch.no_grad():
        assert cache.engages(cache.tensors(unet), inputs) == (case != "row_parallel")
    grad = cache.engages(cache.tensors(unet), inputs)  # grad on, parameters that require it
    assert not grad
    for p in unet.parameters():
        p.requires_grad_(False)
    assert cache.engages(cache.tensors(unet), inputs) == (case != "row_parallel")
    if case == "grad":
        x = inputs[0].clone().requires_grad_(True)
        assert not cache.engages(cache.tensors(unet), (x, *inputs[1:]))


def test_a_shard_made_after_the_first_call_stops_replay():
    """Sharding swaps parameters in (a registration), so the module list is
    walked again and the shard's mark seen."""
    unet = init_random_(build(UNet, TINY, device="cpu", dtype=torch.float32), 0)
    cache = CpuGraphs()
    inputs = _inputs()
    with torch.no_grad():
        assert cache.engages(cache.tensors(unet), inputs)
        proj = unet.bottleneck["1"].transformer_block.attn1.out_proj
        proj.weight = nn.Parameter(proj.weight.detach()[:, :32].clone())
        proj._sdtk_row_mesh = object()
        assert not cache.engages(cache.tensors(unet), inputs)


@pytest.mark.parametrize("impl", ["auto", "torch", "cuda"])
@pytest.mark.parametrize("checkpointing", [False, True])
def test_a_cpu_tensor_never_replays(impl, checkpointing):
    assert not graphs.replays(torch.zeros(1), impl, checkpointing)


@pytest.mark.parametrize("mode", ["no_grad", "grad", "calibration"])
def test_a_cpu_forward_makes_no_graphs(mode):
    unet = init_random_(build(UNet, TINY, device="cpu", dtype=torch.float32), 0)
    x, t, cond = _inputs()
    ref = unet._full(x, t, cond, impl="torch", gradient_checkpointing=False, added_cond=None)[0]
    saved = layers.CAPTURE
    try:
        if mode == "calibration":
            layers.CAPTURE = layers.Capture("linear")
        with torch.set_grad_enabled(mode == "grad"):
            for _ in range(3):
                out = unet(x, t, cond)
    finally:
        layers.CAPTURE = saved
    assert unet not in graphs.CACHES
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_capture_gathers_launches_and_cached_values_without_counting():
    counter = device.LaunchCounter("Ktest")
    owner = type("Owner", (), {})()
    weight = torch.ones(3)
    with device.graph_capture() as gathered:
        counter.launched(("a", 1))
        counter.launched(("a", 1))
        value = device.cached(owner, "_t", [weight], lambda: weight * 2)
        with pytest.raises(RuntimeError):
            with device.graph_capture():
                pass
    assert counter.launches == 0
    assert gathered.launches == [(counter, ("a", 1))] * 2
    assert any(v is value for v in gathered.tensors_read())
    ws = [v for table in device.WORKSPACES for v in table.values()]
    assert all(any(v is w for v in gathered.tensors_read()) for w in ws)
    counter.record()
    for c, n, keys in graphs._credits(gathered.launches):
        c.credit(n, keys)
    assert counter.launches == 2 and counter.stop_recording() == {("a", 1): 2}
