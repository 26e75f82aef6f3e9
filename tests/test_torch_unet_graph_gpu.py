"""The UNet pass replayed as a CUDA graph (utils/graphs.py) against its
eager pass, on a CUDA card.

Every test here needs the card and skips without one.  Like
tests/test_torch_gpu.py it imports no JAX; run it with the repository's
conftest left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_unet_graph_gpu.py

The eager pass is ``UNet._full`` on the same inputs: a replay launches the
same kernels on the same values in the same order, so it must equal the
eager pass bit for bit.
"""

import collections

import pytest
import torch

from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
from stable_diffusion_tpu_torch.ops import conv, ffn, flash_attention, groupnorm, linear, winograd
from stable_diffusion_tpu_torch.utils import graphs
from stable_diffusion_tpu_torch.utils.device import SPANS
from stable_diffusion_tpu_torch.utils.weights import build, init_random_

pytestmark = pytest.mark.gpu

TINY = UNetConfig(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
                  cross_attention_dim=24, t_embed_dim=16)
TINY_SDXL = UNetConfig(block_out_channels=(32, 64, 64), attention_head_dim=(2, 4, 4),
                       cross_attention_dim=64,
                       down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                                         "CrossAttnDownBlock2D"),
                       transformer_layers_per_block=(1, 2, 3), t_embed_dim=16,
                       addition_embed_type="text_time", addition_time_embed_dim=8,
                       projection_class_embeddings_input_dim=32 + 6 * 8)
COUNTERS = {"K1": groupnorm.K1, "K2": conv.K2, "K3": flash_attention.K3, "K4": ffn.K4,
            "K7": conv.K7, "K8": linear.K8, "K9": ffn.K9, "K10": linear.K10, "K11": linear.K11,
            "K12": winograd.K12,
            **{f"K3:{b}": c for b, c in flash_attention.K3_BY_BODY.items()}}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.fixture(scope="module")
def sd15():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return init_random_(build(UNet, UNetConfig.sd15(), device="cuda", dtype=torch.bfloat16), 0)


def _tiny(cfg=TINY, seed=0):
    return init_random_(build(UNet, cfg, device="cuda", dtype=torch.bfloat16), seed)


def _rn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").bfloat16()


def _eager(unet, x, t, cond, added=None):
    with torch.no_grad():
        return unet._full(x, t, cond, impl="cuda", gradient_checkpointing=False,
                          added_cond=added)[0]


def _calls(unet, args, n, added=None):
    """``n`` calls of the UNet; the span counts of ``sd.unet_replay`` beside."""
    SPANS.record()
    try:
        with torch.no_grad():
            outs = [unet(*args, impl="cuda", added_cond=added) for _ in range(n)]
        torch.cuda.synchronize()
    finally:
        calls = SPANS.stop_recording()
    return outs, calls["unet_replay"]


def _assert_replays_equal_eager(unet, args, added=None):
    ref = _eager(unet, *args, added)
    outs, replays = _calls(unet, args, 4, added)
    assert replays == 3  # the first call runs eagerly, then captures
    for out in outs:
        assert torch.equal(out, ref)


@pytest.mark.parametrize("batch", [2, 8])
def test_replay_equals_eager_at_sd15_full_width(gen, sd15, batch):
    """SD1.5's UNet at 512^2 (64^2 latents), UNet batch 2 (b1 under CFG)
    and 8 (b4)."""
    args = (_rn(gen, batch, 64, 64, 4), torch.tensor([500], device="cuda"),
            _rn(gen, batch, 77, 768))
    _assert_replays_equal_eager(sd15, args)


def test_replay_equals_eager_on_a_tiny_sdxl_unet(gen):
    """SDXL's structure (three stages, stacks of 1-3 blocks) with its
    text-time conditioning, the time ids an expanded view as the pipeline
    passes them."""
    unet = _tiny(TINY_SDXL)
    ids = torch.tensor([[128.0, 128.0, 0.0, 0.0, 128.0, 128.0]], device="cuda").expand(2, 6)
    added = {"text_embeds": _rn(gen, 2, 32), "time_ids": ids}
    args = (_rn(gen, 2, 16, 16, 4), torch.tensor([500], device="cuda"), _rn(gen, 2, 77, 64))
    _assert_replays_equal_eager(unet, args, added)


def test_w8a8_unet_replays_equal_eager_and_leave_workspaces_zero(gen, sd15):
    """The static-W8A8 UNet (K7, K8, K9 and the cached fused projections)
    at UNet batch 2: replays equal the eager pass, and K7's and K8's
    workspaces (split-K sums, tickets) are left zero."""
    import copy

    from stable_diffusion_tpu_torch.utils import quantize_model as QM

    args = (_rn(gen, 2, 64, 64, 4), torch.tensor([500], device="cuda"), _rn(gen, 2, 77, 768))

    def apply(m, b):
        with torch.no_grad():
            m(*b, impl="cuda")

    unet = QM.quantize_unet_static(copy.deepcopy(sd15), [args], impl="cuda")
    QM.quantize_convs(QM.calibrate_static_conv_activations(apply, unet, [args]))
    assert unet not in graphs.CACHES or not graphs.CACHES[unet].graphs  # calibration is eager
    before = conv.K7.launches, linear.K8.launches
    _assert_replays_equal_eager(unet, args)
    assert conv.K7.launches > before[0] and linear.K8.launches > before[1]
    dev = torch.cuda.current_device()
    for table in (conv._Q_WS, linear._LQ_WS):
        assert int(table[dev].abs().sum()) == 0


def test_replays_count_as_eager_passes(gen):
    """N calls (a warm-up, a capture, replays) leave every launch counter's
    launches and shape keys as N eager passes do."""
    unet = _tiny()
    args = (_rn(gen, 2, 32, 32, 4), torch.tensor([500], device="cuda"), _rn(gen, 2, 77, 24))

    def counted(fn, n):
        before = {k: c.launches for k, c in COUNTERS.items()}
        for c in COUNTERS.values():
            c.record()
        try:
            with torch.no_grad():
                for _ in range(n):
                    fn()
            torch.cuda.synchronize()
        finally:
            shapes = {k: c.stop_recording() for k, c in COUNTERS.items()}
        return {k: (c.launches - before[k], shapes[k]) for k, c in COUNTERS.items()}

    eager = counted(lambda: _eager(unet, *args), 5)
    replayed = counted(lambda: unet(*args, impl="cuda"), 5)
    assert len(graphs.CACHES[unet].graphs) == 1
    assert replayed == eager
    assert eager["K2"][0] > 0 and eager["K3"][0] > 0 and eager["K4"][0] > 0


def test_replays_leave_k1s_tickets_at_zero(gen, sd15):
    """Replays of two signatures in turn (as two request sizes), then the
    eager pass: every K1 ticket back at 0, and the replays equal to it."""
    argss = [(_rn(gen, b, 64, 64, 4), torch.tensor([999], device="cuda"), _rn(gen, b, 77, 768))
             for b in (2, 4)]
    with torch.no_grad():
        outs = [[sd15(*a, impl="cuda") for a in argss] for _ in range(3)]
    refs = [_eager(sd15, *a) for a in argss]
    torch.cuda.synchronize()
    for row in outs:
        for out, ref in zip(row, refs):
            assert torch.equal(out, ref)
    _, count, _ = groupnorm._WORKSPACE[torch.cuda.current_device()]
    assert int(count.abs().sum()) == 0


def test_a_weight_changed_in_place_recaptures(gen):
    """An in-place change of one weight (as a LoRA merge into the UNet
    makes) drops the graph: the next call runs eagerly and captures anew,
    and every call gives the new weights' output."""
    unet = _tiny()
    args = (_rn(gen, 2, 32, 32, 4), torch.tensor([500], device="cuda"), _rn(gen, 2, 77, 24))
    _calls(unet, args, 3)
    first = next(iter(graphs.CACHES[unet].graphs.values()))
    old = _eager(unet, *args)
    with torch.no_grad():
        unet.encoder.down["1"].block["0"]["1"].transformer_block.attn1.q_proj.weight.mul_(1.5)
    ref = _eager(unet, *args)
    assert not torch.equal(ref, old)
    outs, replays = _calls(unet, args, 3)
    assert replays == 2
    assert next(iter(graphs.CACHES[unet].graphs.values())) is not first
    for out in outs:
        assert torch.equal(out, ref)


def test_a_call_with_grad_enabled_never_replays(gen):
    unet = _tiny()
    args = (_rn(gen, 2, 32, 32, 4), torch.tensor([500], device="cuda"), _rn(gen, 2, 77, 24))
    SPANS.record()
    try:
        outs = [unet(*args, impl="cuda") for _ in range(3)]
        outs[-1].float().square().mean().backward()
        torch.cuda.synchronize()
    finally:
        calls = SPANS.stop_recording()
    assert calls["unet_replay"] == 0 and calls["unet"] == 3
    assert all(o.grad_fn is not None for o in outs)
    assert unet not in graphs.CACHES or not graphs.CACHES[unet].graphs
    assert unet.encoder.conv_in.weight.grad is not None


def test_the_returned_tensor_survives_the_next_call(gen):
    unet = _tiny()
    t = torch.tensor([500], device="cuda")
    a = (_rn(gen, 2, 32, 32, 4), t, _rn(gen, 2, 77, 24))
    b = (_rn(gen, 2, 32, 32, 4), t, _rn(gen, 2, 77, 24))
    _calls(unet, a, 2)
    with torch.no_grad():
        out_a = unet(*a, impl="cuda")
        kept = out_a.clone()
        out_b = unet(*b, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(out_a, kept) and not torch.equal(out_a, out_b)
    assert torch.equal(out_b, _eager(unet, *b))


def test_eviction_bounds_the_graphs(gen):
    """Six signatures, each called twice: at most MAX_GRAPHS graphs kept,
    the last ones, each still replaying its own pass."""
    unet = _tiny()
    t = torch.tensor([500], device="cuda")
    argss = [(_rn(gen, 2, hw, hw, 4), t, _rn(gen, 2, 77, 24)) for hw in (8, 16, 24, 32, 40, 48)]
    with torch.no_grad():
        for a in argss:
            unet(*a, impl="cuda")
            unet(*a, impl="cuda")
    cache = graphs.CACHES[unet]
    assert len(cache.graphs) == graphs.MAX_GRAPHS
    kept = collections.Counter(s[0][0][0] for s in cache.graphs)
    assert kept == collections.Counter((2, hw, hw, 4) for hw in (24, 32, 40, 48))
    outs, replays = _calls(unet, argss[-1], 1)
    assert replays == 1 and torch.equal(outs[0], _eager(unet, *argss[-1]))
