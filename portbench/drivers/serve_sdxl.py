"""The serving generator of SDXL base: requests of a fixed batch to the
port's ``generate`` (DDIM txt2img under CFG), served one at a time in
arrival order, as ``serve.py`` serves SD, whose window, model
ranges, inputs and pixel comparison it reuses unchanged
(``serve.serve_window``, ``serve.Ranges``, ``serve.request``,
``serve.image_rms``): the request is the same call, since the port takes
SDXL's ids through the same signature.  What differs is what SDXL has and
SD has not: the second text tower, the pooled and size conditioning, the
VAE's scaling factor.  So the pipeline is built from the configuration's
``text_2`` as well, the weights are drawn over ``reference/sdxl.py``'s
parameters, the FLOPs are counted on meta over that reference, and
``correct`` compares with it.

Correctness (``image_rms_over_bf16_ref``): the worst kept request's RMS
pixel gap from ``reference/sdxl.txt2img`` in f32 with TF32 off, over the
gap of the same reference held in bf16 (its weights, activations and
products) on the same weights and inputs.  The absolute gap of sound runs
follows the seed: it spread 3.5x over seeds, and the reference's own bf16
run follows it, since the seed's weights set how far 50 guided steps carry
bf16's rounding.  The ratio holds the program to bf16 rounding on the
seed's own weights.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Mapping

import numpy as np
import torch

from portbench.drivers import serve
from portbench.lib import inputs, program, stats, work
from portbench.lib.trace import union_length
from portbench.reference import nets, sampling, sdxl

NETS = ("unet", "text_encoder", "text_encoder_2", "vae")


def _unused(cfg: Mapping) -> dict:
    """Parameters the served path never reads, by network: the VAE's
    encoder, and the first tower's last layer and final LayerNorm (SDXL
    takes its penultimate state)."""
    last = cfg["text"]["num_hidden_layers"] - 1
    return {"vae": ("encoder.", "quant_conv."),
            "text_encoder": (f"encoder.layers.{last}.", "final_layer_norm.")}


def build_pipeline(cfg: Mapping, seed: int, *, device, dtype, impl: str):
    """The port's SDXL pipeline of ``cfg`` with the weights of ``seed``."""
    from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig
    from stable_diffusion_tpu_torch.models.vae import VAEConfig
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion

    vae = VAEConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["vae"].items()})
    pipe = StableDiffusion.build(program.unet_config(cfg),
                                 CLIPTextConfig.from_dict(dict(cfg["text"])), vae,
                                 text_config_2=CLIPTextConfig.from_dict(dict(cfg["text_2"])),
                                 device=device, dtype=dtype, impl=impl,
                                 scheduler_config=program.scheduler_config(cfg))
    load_pipeline_weights(pipe, cfg, seed)
    return pipe


def load_pipeline_weights(pipe, cfg: Mapping, seed: int) -> None:
    w = inputs.make_weights(sdxl.param_shapes(cfg), seed, pipe.device, pipe.dtype)
    unused = _unused(cfg)
    for net in NETS:
        program.load(getattr(pipe, net), w.pop(net), unused_prefixes=unused.get(net, ()))


def reference_weights(cfg: Mapping, seed: int, device, served_dtype):
    """The weights of ``seed`` as the program holds them, in f32."""
    w = inputs.make_weights(sdxl.param_shapes(cfg), seed, device, served_dtype)
    return {n: {k: v.float() for k, v in t.items()} for n, t in w.items()}


def reference_images(weights, cfg: Mapping, tr: Mapping, seed: int, index: int, device,
                     served_dtype, ops: nets.Ops) -> np.ndarray:
    """The reference's (B, H, W, 3) images in [0, 1] for request ``index``."""
    cond, uncond = inputs.request_ids(seed, index, tr["batch"], cfg["text"]["vocab_size"])
    lat = inputs.request_latents(seed, index, serve.latent_shape(cfg, tr), device, served_dtype)
    dec = sdxl.txt2img(weights, cfg, cond, uncond, lat, steps=tr["steps"],
                       cfg_scale=tr["cfg_scale"], ops=ops)
    return sampling.to_unit(dec)


def as_served(unit: np.ndarray) -> np.ndarray:
    """Images in [0, 1] rounded to uint8, as the program serves them."""
    return (unit * 255.0).round().clip(0, 255).astype(np.uint8)


def references(ctx, indices, control: bool = False) -> dict:
    """{index: {"f32": images in [0, 1], "bf16": uint8 images[, "fp8": uint8
    images]}}: each request of ``indices`` through the reference on the
    weights of ``ctx.seed``, in f32 with TF32 off, held in bf16, and with
    ``control`` in f32 with float8 product inputs (``nets.Ops("fp8")``)."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    out = {i: {} for i in indices}
    with nets.f32_products():
        held = inputs.make_weights(sdxl.param_shapes(cfg), ctx.seed, dev, ctx.dtype)
        runs = [("f32", torch.float32, nets.Ops()), ("bf16", torch.bfloat16, nets.Ops())]
        if control:
            runs.append(("fp8", torch.float32, nets.Ops("fp8")))
        for name, dtype, ops in runs:
            t0 = time.perf_counter()
            w = {n: {k: v.to(dtype) for k, v in p.items()} for n, p in held.items()}
            for i in indices:
                img = reference_images(w, cfg, tr, ctx.seed, i, dev, ctx.dtype, ops)
                out[i][name] = img if name == "f32" else as_served(img)
            del w
            ctx.note(f"reference {name}: {time.perf_counter() - t0:.1f} s")
    return out


def request(pipe, cfg: Mapping, tr: Mapping, seed: int, index: int) -> np.ndarray:
    """Request ``index``: ``serve``'s, the same call for SDXL."""
    return serve.request(pipe, cfg, tr, seed, index)


def request_flops(cfg: Mapping, tr: Mapping) -> float:
    """Model FLOPs of one request, counted on the meta device over the
    reference: both text towers (CFG's doubled batch), the UNet at each
    step (the doubled batch, the added conditioning included) and the decode."""
    b, h, w, c = serve.latent_shape(cfg, tr)
    ops, P = nets.Ops(), nets.Params.recording()
    ids = torch.zeros((2 * b, 77), dtype=torch.long, device="meta")
    text = work.model_flops(lambda: sdxl.encode_text(P, nets.Params.recording(), cfg, ids, ops))
    u = cfg["unet"]
    dctx = u["cross_attention_dim"]
    added = {"text_embeds": work.meta_randn(2 * b, cfg["text_2"]["projection_dim"]),
             "time_ids": work.meta_randn(2 * b, 6)}
    unet = work.model_flops(lambda: sdxl.unet(
        P, u, work.meta_randn(2 * b, c, h, w),
        torch.zeros((2 * b,), dtype=torch.long, device="meta"),
        work.meta_randn(2 * b, 77, dctx), added, ops))
    vae = work.model_flops(lambda: sdxl.vae_decode(P, cfg["vae"], work.meta_randn(b, c, h, w),
                                                   ops))
    return text + tr["steps"] * unet + vae


def run(ctx) -> dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    if tr["entry"] != "txt2img":
        raise ValueError(f"serve_sdxl serves txt2img, not {tr['entry']!r}")
    split = {"imports": time.perf_counter() - ctx.t0}
    t = time.perf_counter()
    import stable_diffusion_tpu_torch  # noqa: F401  (the program's import, timed)
    from stable_diffusion_tpu_torch.ops import _cuda

    split["import_program"] = time.perf_counter() - t
    t = time.perf_counter()
    torch.zeros(1, device=dev)
    ctx.sync()
    split["device_init"] = time.perf_counter() - t
    t = time.perf_counter()
    pipe = build_pipeline(cfg, ctx.seed, device=dev, dtype=ctx.dtype, impl=ctx.impl)
    ctx.sync()
    split["weights"] = time.perf_counter() - t
    t = time.perf_counter()
    flops = request_flops(cfg, tr)
    split["flop_count"] = time.perf_counter() - t
    t = time.perf_counter()
    for w in range(tr["warmup_requests"]):
        request(pipe, cfg, tr, ctx.seed, -1 - w)
    ctx.sync()
    split["warmup"] = time.perf_counter() - t
    split["kernel_build"] = getattr(_cuda, "build_seconds", None)
    setup_s = time.perf_counter() - ctx.t0
    ctx.note("setup split (s): " + ", ".join(f"{k} {v}" for k, v in split.items()))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    untraced = None
    if ctx.trace:
        n = tr["trace_requests"]
        spans0, service0, lat0, fail0, _ = serve.serve_window(ctx, pipe, ctx.seconds, 0, n)
        if spans0:
            untraced = (flops * len(spans0), union_length(service0))
        ranges = serve.Ranges(ctx, pipe)
        spans, _, latencies, failures, kept = ctx.profiled(
            lambda: serve.serve_window(ctx, pipe, ctx.seconds, n, n))
        for h in ranges.handles:
            h.remove()
        latencies, failures = lat0 + latencies, fail0 + failures
    else:
        with ctx.host_load():
            spans, _, latencies, failures, kept = serve.serve_window(ctx, pipe, ctx.seconds, 0)
    ctx.sync()
    metrics = {}
    if spans:
        metrics["img_per_s"] = stats.rate(len(spans) * tr["batch"], spans)
    metrics["request_p95_s"] = stats.p95(latencies)
    ctx.note(f"window: {len(latencies)} requests, {failures} failed, "
             f"median latency {float(np.median(latencies)):.4f} s, metrics {metrics}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del pipe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    name = "image_rms_over_bf16_ref"
    checks = {name: {"value": check(ctx, kept), "limit": ctx.limits[name]}}
    return {"attempted": len(latencies), "failed": failures, "setup_s": setup_s,
            "metrics": metrics, "memory_peak_bytes": peak, "checks": checks,
            "untraced": untraced}


def check(ctx, kept) -> float:
    """The worst kept request's RMS pixel gap from the f32 reference over
    the bf16 reference's gap from it (see the module's docstring)."""
    if not kept:
        return math.inf
    refs = references(ctx, [i for i, _ in kept])
    worst = 0.0
    for index, imgs in kept:
        ref = refs[index]
        gap, floor = serve.image_rms(imgs, ref["f32"]), serve.image_rms(ref["bf16"], ref["f32"])
        ctx.note(f"request {index}: image_rms {gap!r}, the bf16 reference's {floor!r}")
        worst = max(worst, gap / floor)
    return worst
