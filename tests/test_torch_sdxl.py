"""SDXL base on the port's plain path (``impl="torch"``) against the plain
reference ``portbench/reference/sdxl.py`` at tiny widths on the CPU, in
float64, with the tolerances of ``portbench/test_portbench_reference.py``:
both text towers (the context of their penultimate states side by side, the
pooled and projected EOS state), the UNet with 1-, 2- and 3-deep transformer
stacks with and without the text-time conditioning, a 2-step CFG txt2img,
the diffusers-named state dicts of the UNet and the second tower through the
loader and ``from_pretrained``, the spans of the stacks and of the added
conditioning, and the benchmark's new readers (K4's work function, the
transformer stacks' device time) on hand-counted inputs."""

import collections
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drivers import serve_sdxl
from portbench.lib import inputs
from portbench.lib.trace import Trace
from portbench.reference import nets, sampling, sdxl
from stable_diffusion_tpu_torch.models.unet import Transformer, UNet, UNetConfig
from stable_diffusion_tpu_torch.pipeline import StableDiffusion
from stable_diffusion_tpu_torch.utils import model_converter as mc
from stable_diffusion_tpu_torch.utils.device import SPANS
from stable_diffusion_tpu_torch.utils.weights import build
from tests import torch_checkpoints as C
from tests.torch_threads import one_thread  # noqa: F401

SEED = 2 ** 31 + 4242
CPU = torch.device("cpu")
F64 = torch.float64
TOL = 1e-6
TOL_IMAGES = 1e-4
DOWN = ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"]


def tiny(added: bool = True) -> dict:
    """SDXL's structure at tiny widths: three stages, no attention at the
    first, depths (1, 2, 3), towers of 24 and 32 (a 56-wide context), the
    text-time conditioning at its published structure (pooled 32 + 6 x 8)."""
    unet = {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64, 64],
            "attention_head_dim": [2, 4, 4], "cross_attention_dim": 56, "down_block_types": DOWN,
            "layers_per_block": 2, "transformer_layers_per_block": [1, 2, 3],
            "norm_num_groups": 32, "norm_eps": 1e-5, "t_embed_dim": 16}
    if added:
        unet.update(addition_embed_type="text_time", addition_time_embed_dim=8,
                    projection_class_embeddings_input_dim=32 + 6 * 8)
    tower = {"vocab_size": 49408, "max_position_embeddings": 77, "num_hidden_layers": 3,
             "num_attention_heads": 4, "layer_norm_eps": 1e-5, "hidden_state": "penultimate"}
    return {"unet": unet,
            "text": {**tower, "hidden_size": 24, "intermediate_size": 48,
                     "hidden_act": "quick_gelu"},
            "text_2": {**tower, "hidden_size": 32, "intermediate_size": 64, "hidden_act": "gelu",
                       "projection_dim": 32},
            "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
                    "base_channels": 32, "ch_mult": [1, 1, 1, 1], "norm_eps": 1e-6,
                    "scaling_factor": 0.13025},
            "prediction_type": "epsilon", "resolution": 64, "dtype": "float32"}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def models():
    cfg = tiny()
    pipe = serve_sdxl.build_pipeline(cfg, SEED, device=CPU, dtype=F64, impl="torch")
    weights = {net: {k: v.double() for k, v in w.items()}
               for net, w in serve_sdxl.reference_weights(cfg, SEED, CPU, torch.float32).items()}
    return cfg, pipe, weights


def _params(w):
    return {k: nets.Params(v) for k, v in w.items()}


def test_text_context_and_pooled(models):
    cfg, pipe, w = models
    cond, _ = inputs.request_ids(SEED, 0, 3)
    ctx, pooled = pipe.encode_text(cond, return_pooled=True)
    P = _params(w)
    rctx, rpooled = sdxl.encode_text(P["text_encoder"], P["text_encoder_2"], cfg,
                                     torch.as_tensor(cond), nets.Ops())
    assert ctx.shape == (3, 77, 56) and pooled.shape == (3, 32)
    assert rel(ctx, rctx) < TOL and rel(pooled, rpooled) < TOL
    # the context alone, as SD's callers take it
    assert torch.equal(pipe.encode_text(cond), ctx)


def _unet_inputs(n=2):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((n, 8, 8, 4), generator=g, dtype=F64)
    ctx = torch.randn((n, 77, 56), generator=g, dtype=F64)
    pooled = torch.randn((n, 32), generator=g, dtype=F64)
    return x, torch.tensor([10, 900][:n]), ctx, sdxl.added_cond(pooled, (64, 48))


@pytest.mark.parametrize("added", [True, False], ids=["text_time", "no_added_cond"])
def test_unet(models, added):
    cfg, pipe, w = models
    x, t, ctx, cond = _unet_inputs()
    ucfg = cfg["unet"] if added else tiny(added=False)["unet"]
    unet = pipe.unet
    if not added:  # the same stacks and weights without add_embedding
        unet = build(UNet, UNetConfig.from_dict(ucfg), device=CPU, dtype=F64)
        unet.load_state_dict({k: v for k, v in pipe.unet.state_dict().items()
                              if not k.startswith("add_embedding.")})
        cond = None
    with torch.no_grad():
        port = unet(x, t, ctx, added_cond=cond, impl="torch")
    P = nets.Params(w["unet"])
    ref = sdxl.unet(P, ucfg, x.permute(0, 3, 1, 2), t, ctx, cond, nets.Ops()).permute(0, 2, 3, 1)
    assert rel(port, ref) < TOL
    if added:  # the comparison sees the added conditioning: without it, it fails
        bare = sdxl.unet(P, tiny(added=False)["unet"], x.permute(0, 3, 1, 2), t, ctx, None,
                         nets.Ops()).permute(0, 2, 3, 1)
        assert rel(bare, ref) > 1e3 * TOL


def test_unet_takes_added_cond_exactly_when_it_has_the_embedding(models):
    cfg, pipe, _ = models
    x, t, ctx, cond = _unet_inputs()
    with torch.no_grad(), pytest.raises(ValueError, match="added_cond"):
        pipe.unet(x, t, ctx, impl="torch")
    plain = build(UNet, UNetConfig.from_dict(tiny(added=False)["unet"]), device="meta")
    with pytest.raises(ValueError, match="added_cond"):
        plain.time_embedding_apply(torch.zeros(1, device="meta"), torch.float32, "torch", cond)


def test_txt2img_cfg_two_steps(models):
    cfg, pipe, w = models
    cond, uncond = inputs.request_ids(SEED, 3, 2)
    lat = inputs.request_latents(SEED, 3, (2, 8, 8, 4), CPU, F64)
    port = pipe.generate(cond, uncond, img_size=(64, 64), inference_steps=2, cfg_scale=5.0,
                         initial_latents=lat)
    dec = sdxl.txt2img(w, cfg, cond, uncond, lat, steps=2, cfg_scale=5.0, ops=nets.Ops())
    ref = ((dec + 1.0) / 2.0).permute(0, 2, 3, 1)
    assert port.shape == (2, 64, 64, 3)
    assert rel(port, ref) < TOL_IMAGES


def _record(fn):
    SPANS.record()
    try:
        fn()
    finally:
        counts = SPANS.stop_recording()
    return counts


def test_spans_of_the_stacks_and_the_added_conditioning(models):
    _, pipe, _ = models
    x, t, ctx, cond = _unet_inputs()
    stacks = sum(isinstance(m, Transformer) for m in pipe.unet.modules())
    assert stacks == 2 * 2 + 3 * 2 + 1  # the encoder's and decoder's stages 1-2, the bottleneck
    with torch.no_grad():
        counts = _record(lambda: pipe.unet(x, t, ctx, added_cond=cond, impl="torch"))
    assert counts["unet"] == 1 and counts["add_embed"] == 1 and counts["transformer"] == stacks
    # img2img goes through the same denoise loop, the conditioning with it
    lat0 = inputs.request_latents(SEED, 5, (1, 8, 8, 4), CPU, F64)
    counts = _record(lambda: pipe.generate([[49406] + [7] * 5 + [49407] * 71], img_size=(64, 64),
                                           input_latents=lat0, strength=0.5, inference_steps=4,
                                           uncond_ids=[[49406] + [49407] * 76]))
    assert counts["unet"] == counts["add_embed"] == 2 and counts["text"] == 1


def test_inpaint_passes_the_added_conditioning(models):
    _, pipe, _ = models
    img = np.full((64, 64, 3), 128, np.uint8)
    mask = np.zeros((64, 64), np.uint8)
    mask[16:48, 16:48] = 255
    counts = _record(lambda: pipe.inpaint([[49406, 9, 49407] + [49407] * 74],
                                          [[49406] + [49407] * 76], img, mask, img_size=(64, 64),
                                          inference_steps=4, strength=0.5, sampler="ddim"))
    assert counts["add_embed"] == counts["unet"] == 2


@pytest.mark.parametrize("added", [True, False], ids=["sdxl", "depth1"])
def test_diffusers_unet_state_dict_maps_to_the_port(added):
    ucfg = tiny()["unet"] if added else dict(tiny(added=False)["unet"],
                                               transformer_layers_per_block=1)
    unet = build(UNet, UNetConfig.from_dict(ucfg), device=CPU)
    state = C.distinct(unet.state_dict())
    hf = C.to_diffusers_unet(state, linear_proj=True)
    assert any(".transformer_blocks.2." in k for k in hf) == added
    assert ("add_embedding.linear_1.weight" in hf) == added
    got = mc.convert_unet_diffusers(hf)
    assert got.keys() == state.keys()
    assert all(torch.equal(got[k], state[k]) for k in state)
    mc.load_into(unet, got)


def test_diffusers_text_encoder_2_maps_to_the_port(models):
    _, pipe, _ = models
    state = C.distinct(pipe.text_encoder_2.state_dict())
    hf = C.to_diffusers_text_2(state)
    assert "text_projection.weight" in hf and "text_model.final_layer_norm.weight" in hf
    got = mc.convert_text_encoder_diffusers(hf)
    assert got.keys() == state.keys() and all(torch.equal(got[k], state[k]) for k in state)


def test_from_pretrained_sdxl_directory(models, tmp_path):
    cfg, pipe, _ = models
    text, text_2 = ({k: v for k, v in cfg[n].items() if k != "hidden_state"}
                    for n in ("text", "text_2"))
    C.write_diffusers_dir(str(tmp_path), pipe.unet.state_dict(), pipe.text_encoder.state_dict(),
                          pipe.vae.state_dict(), unet_config=cfg["unet"], text_config=text,
                          vae_config={"block_out_channels": [32] * 4, "scaling_factor": 0.13025},
                          linear_proj=True, text_2=pipe.text_encoder_2.state_dict(),
                          text_config_2=text_2)
    loaded = StableDiffusion.from_pretrained(str(tmp_path), device=CPU, dtype=F64, impl="torch")
    assert loaded.text_encoder.cfg.hidden_state == loaded.text_encoder_2.cfg.hidden_state \
        == "penultimate"
    assert loaded.vae.cfg.scaling_factor == 0.13025
    cond, uncond = inputs.request_ids(SEED, 6, 1)
    lat = inputs.request_latents(SEED, 6, (1, 8, 8, 4), CPU, F64)
    kw = dict(img_size=(64, 64), inference_steps=2, cfg_scale=5.0, initial_latents=lat)
    np.testing.assert_array_equal(loaded.generate(cond, uncond, **kw),
                                  pipe.generate(cond, uncond, **kw))


def test_published_widths_on_meta():
    """configs/sdxl.json builds SDXL base at its published sizes, and the
    port holds every parameter the reference reads, at the same shape."""
    with open(harness.BENCH / "configs" / "sdxl.json") as f:
        cfg = json.load(f)
    from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig
    from stable_diffusion_tpu_torch.models.vae import VAEConfig

    pipe = StableDiffusion.build(UNetConfig.from_dict(cfg["unet"]),
                                 CLIPTextConfig.from_dict(cfg["text"]),
                                 VAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                                              for k, v in cfg["vae"].items()}),
                                 text_config_2=CLIPTextConfig.from_dict(cfg["text_2"]),
                                 device="meta")
    assert pipe.unet.cfg == UNetConfig.sdxl()
    assert (pipe.text_encoder.cfg, pipe.text_encoder_2.cfg) == CLIPTextConfig.sdxl_pair()
    assert pipe.vae.cfg == VAEConfig.sdxl()
    own = StableDiffusion.sdxl(device="meta")
    assert (own.unet.cfg, own.text_encoder_2.cfg, own.vae.cfg) == (
        pipe.unet.cfg, pipe.text_encoder_2.cfg, pipe.vae.cfg)
    assert own.make_schedule().alphas_hat.tolist() == pytest.approx(
        sampling.alphas_hat().tolist(), rel=1e-6)
    count = {n: sum(p.numel() for p in getattr(pipe, n).parameters())
             for n in ("unet", "text_encoder", "text_encoder_2")}
    assert count["unet"] == 2_567_463_684
    assert count["text_encoder"] == 123_060_480 and count["text_encoder_2"] == 694_659_840
    shapes = sdxl.param_shapes(cfg)
    for net, want in shapes.items():
        have = {k: tuple(v.shape) for k, v in getattr(pipe, net).state_dict().items()}
        assert all(have[k] == s for k, s in want.items()), net
    unused = serve_sdxl._unused(cfg)
    for net, want in shapes.items():
        left = [k for k in getattr(pipe, net).state_dict() if k not in want
                and not k.startswith(unused.get(net, ("-",)))]
        assert not left, (net, left[:3])


def _reader(name):
    return harness.load_file(harness.reader_path(name))


def test_ffn_work_hand_counted():
    ffn = _reader("ffn_roofline.serve")
    m, c, h = 4096, 640, 2560
    w = ffn.ffn_work((m, c))
    # G1: 4096 x 640 by 5120 (value and gate); G2: 4096 x 2560 by 640
    assert w["flops"] == 2 * 4096 * 640 * 5120 + 2 * 4096 * 2560 * 640 == 40_265_318_400
    # x, y: 4096 x 640 each; W1 5120 x 640 and b1 5120; W2 640 x 2560 and b2 640; bf16
    assert w["nbytes"] == 2 * (2 * 4096 * 640 + 5120 * 640 + 5120 + 640 * 2560 + 640) == 20_327_680
    assert ffn.ffn_work((m, c, 2 * c)) == dict(flops=3 * 2 * m * c * 2 * c,
                                               nbytes=2 * (2 * m * c + 3 * 2 * c * c + 2 * 2 * c + c))
    # at 989 TFLOP/s and 3.35 TB/s the FFN above is bound by its FLOPs
    assert h == 4 * c


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_transformer_ms_and_ffn_roofline_read_a_synthetic_trace():
    """Two UNet passes (0-40, 50-90 us), each with one stack (5-25, 55-75):
    kernels launched inside the stacks count once each, one outside does not."""
    stacks = [_ev("user_annotation", "sd.transformer", 5, 20),
              _ev("user_annotation", "sd.transformer", 55, 20)]
    rest = [
        _ev("user_annotation", "portbench.window", 0, 100),
        _ev("user_annotation", "sd.unet", 0, 40), _ev("user_annotation", "sd.unet", 50, 40),
        _ev("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 30, 1, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 56, 1, correlation=3),
        _ev("kernel", "ffn_up_kernel<128, 2, 0>", 10, 8, correlation=1),
        _ev("kernel", "conv3x3_kernel", 32, 5, correlation=2),
        _ev("kernel", "ffn_down_kernel<64, 160, 3, 0>", 60, 4, correlation=3),
    ]
    trace = Trace(stacks + rest)
    key = (4096, 640)
    view = SimpleNamespace(trace=trace, shapes={"spans": collections.Counter(unet=2),
                                                "K4": collections.Counter({key: 2})},
                           untraced=None, exps_per_s=0.0)
    assert _reader("transformer_ms.serve").read(view) == pytest.approx(12e-3 / 2)
    ffn = _reader("ffn_roofline.serve")
    w = ffn.ffn_work(key)
    least = 2 * max(w["flops"] / 989e12, w["nbytes"] / 3.35e12)
    assert ffn.read(view) == pytest.approx(100 * least / 12e-6)
    # a program without the stacks' span (the parent of this metric) reads nothing
    bare = SimpleNamespace(trace=Trace(rest), shapes=view.shapes)
    assert _reader("transformer_ms.serve").read(bare) is None
    unrecorded = SimpleNamespace(trace=trace, shapes={})
    assert _reader("transformer_ms.serve").read(unrecorded) is None


def test_benchmark_entries_of_the_new_cells():
    with open(harness.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    for cell in ("sdxl-txt2img-b2", "sd15-txt2img-b1"):
        spec = harness.cell_spec(cell)
        names = {m["name"] for m in spec.per_layer}
        assert {m["name"] for m in spec.end_to_end} == {"img_per_s", "setup_s"}
        assert {"transformer_ms.serve", "ffn_roofline.serve", "unet_ms.serve", "mfu.serve",
                "idle_share.serve", "launches_per_step.serve"} <= names
        assert spec.chips == 1 and spec.traffic["rate"] is None
    assert harness.cell_spec("sdxl-txt2img-b2").traffic["batch"] == 2
    assert next(c for c in bench["configs"] if c["name"] == "sdxl")["reduced"] == []


def test_check_is_the_gap_over_the_bf16_references():
    """``serve_sdxl.check``: the served images' RMS gap from the f32
    reference over the bf16 reference's; the bf16 reference's own images
    read 1, the float8 control's more."""
    cfg = tiny()
    tr = {"entry": "txt2img", "batch": 1, "steps": 2, "cfg_scale": 5.0, "check_requests": 1}
    notes = []
    ctx = SimpleNamespace(config=cfg, traffic=tr, seed=SEED, device=CPU, dtype=torch.bfloat16,
                          note=notes.append)
    refs = serve_sdxl.references(ctx, [0], control=True)[0]
    assert refs["f32"].dtype == np.float32 and refs["bf16"].dtype == np.uint8
    assert serve_sdxl.check(ctx, [(0, refs["bf16"])]) == 1.0
    fp8 = serve_sdxl.check(ctx, [(0, refs["fp8"])])
    gap = float(np.sqrt(np.mean((refs["fp8"] / 255.0 - refs["f32"]) ** 2)))
    floor = float(np.sqrt(np.mean((refs["bf16"] / 255.0 - refs["f32"]) ** 2)))
    assert fp8 == pytest.approx(gap / floor) and fp8 > 1.5
    assert serve_sdxl.check(ctx, []) == float("inf")
