"""The serving generator: requests of a fixed batch to ``generate`` (DDIM
txt2img under CFG) or ``generate_in_one_step``, served one at a time in
arrival order.

The traffic file sets the entry, the batch, the steps and guidance, and
the arrivals: ``"rate": null`` is a backlog (every request due at the
window's start, so the system is never idle for want of work: its end to
end metric is the images completed a second), a number is requests a
second at even spacing (an open loop: a request's latency counts from its
due time, so a stall delays those behind it).  Each request's token ids
and starting latents come from (seed, request index).  The window starts
requests until ``--seconds`` have passed and ends when the last one
completes; the images come back to the host as uint8.

Correctness: a sample of the finished requests drawn from the seed
(``check_requests`` of them), each run again by the plain f32 reference on
the same ids and latents and weights; the number compared is the worst
request's root-mean-square pixel difference in [0, 1] units.
"""

from __future__ import annotations

import gc
import math
import random
import time
from typing import Mapping

import numpy as np
import torch

from portbench.lib import inputs, program, stats, work
from portbench.lib.trace import union_length
from portbench.reference import nets, sampling


def latent_shape(cfg: Mapping, tr: Mapping) -> tuple:
    r = cfg["resolution"] // 8
    return (tr["batch"], r, r, cfg["unet"]["in_channels"])


def request(pipe, cfg: Mapping, tr: Mapping, seed: int, index: int) -> np.ndarray:
    """Request ``index``: (B, H, W, 3) uint8 images on the host."""
    cond, uncond = inputs.request_ids(seed, index, tr["batch"], cfg["text"]["vocab_size"])
    lat = inputs.request_latents(seed, index, latent_shape(cfg, tr), pipe.device, pipe.dtype)
    size = (cfg["resolution"], cfg["resolution"])
    if tr["entry"] == "txt2img":
        return pipe.generate(cond, uncond, img_size=size, inference_steps=tr["steps"],
                             cfg_scale=tr["cfg_scale"], sampler="ddim", eta=0.0,
                             initial_latents=lat, output_dtype="uint8")
    if tr["entry"] == "one_step":
        return pipe.generate_in_one_step(cond, img_size=size, initial_latents=lat,
                                         output_dtype="uint8")
    raise ValueError(f"unknown serving entry {tr['entry']!r}")


def reference_images(weights, cfg: Mapping, tr: Mapping, seed: int, index: int, device,
                     served_dtype, ops: nets.Ops) -> np.ndarray:
    """The reference's (B, H, W, 3) images in [0, 1] for request ``index``."""
    cond, uncond = inputs.request_ids(seed, index, tr["batch"], cfg["text"]["vocab_size"])
    lat = inputs.request_latents(seed, index, latent_shape(cfg, tr), device, served_dtype)
    if tr["entry"] == "txt2img":
        dec = sampling.txt2img(weights, cfg, cond, uncond, lat, steps=tr["steps"],
                               cfg_scale=tr["cfg_scale"], ops=ops)
    else:
        dec = sampling.one_step(weights, cfg, cond, lat, ops=ops)
    return sampling.to_unit(dec)


def image_rms(served_uint8: np.ndarray, ref_unit: np.ndarray) -> float:
    return float(np.sqrt(np.mean((served_uint8.astype(np.float64) / 255.0 - ref_unit) ** 2)))


def request_flops(cfg: Mapping, tr: Mapping) -> float:
    """Model FLOPs of one request, counted on the meta device over the
    reference: the text tower, the UNet at each step (CFG's doubled batch)
    and the decode."""
    b, h, w, c = latent_shape(cfg, tr)
    cfg_mult = 2 if tr["entry"] == "txt2img" else 1
    steps = tr["steps"] if tr["entry"] == "txt2img" else 1
    ops, P = nets.Ops(), nets.Params.recording()
    dctx = cfg["text"]["hidden_size"]
    ids = torch.zeros((cfg_mult * b, 77), dtype=torch.long, device="meta")
    text = work.model_flops(lambda: nets.text_encoder(P, cfg["text"], ids, ops))
    unet = work.model_flops(lambda: nets.unet(
        P, cfg["unet"], work.meta_randn(cfg_mult * b, c, h, w),
        torch.zeros((cfg_mult * b,), dtype=torch.long, device="meta"),
        work.meta_randn(cfg_mult * b, 77, dctx), ops))
    vae = work.model_flops(lambda: nets.vae_decode(P, cfg["vae"], work.meta_randn(b, c, h, w),
                                                   ops))
    return text + steps * unet + vae


class Ranges:
    """The benchmark's profiler ranges around the program's text tower, UNet
    and VAE decode (forward hooks, and a wrapper on ``vae.decode``)."""

    def __init__(self, ctx, pipe):
        self.handles, self.open = [], []
        for name, mod in (("text", pipe.text_encoder), ("unet", pipe.unet)):
            self.handles.append(mod.register_forward_pre_hook(
                lambda m, a, name=name: self._enter(ctx, name)))
            self.handles.append(mod.register_forward_hook(lambda m, a, o: self._exit()))
        decode = pipe.vae.decode

        def ranged(*a, **k):
            with ctx.range("vae_decode"):
                return decode(*a, **k)

        pipe.vae.decode = ranged

    def _enter(self, ctx, name):
        r = ctx.range(name)
        r.__enter__()
        self.open.append(r)

    def _exit(self):
        self.open.pop().__exit__(None, None, None)


def serve_window(ctx, pipe, seconds: float, first_index: int, max_requests=None):
    """Requests from ``first_index`` until ``seconds`` have passed (or
    ``max_requests`` are served); returns (spans, service, latencies,
    failures, kept): ``spans`` from each finished request's due time (its
    start in a backlog) to its end, ``service`` from its start to its end,
    ``kept`` the seeded sample of finished requests' images."""
    cfg, tr = ctx.config, ctx.traffic
    rate = tr.get("rate")
    keep_n = tr["check_requests"]
    rng = random.Random(inputs.sub_seed(ctx.seed, "sample"))
    spans, service, latencies, kept, failures, finished = [], [], [], [], 0, 0
    start = time.perf_counter()
    i = 0
    while max_requests is None or i < max_requests:
        due = start if rate is None else start + i / rate
        now = time.perf_counter()
        if max_requests is None and (now if rate is None else due) >= start + seconds:
            break
        if now < due:
            time.sleep(due - now)
        began = time.perf_counter()
        try:
            imgs = request(pipe, cfg, tr, ctx.seed, first_index + i)
        except (FloatingPointError, RuntimeError) as e:  # a request that fails counts as such
            print(f"request {first_index + i} failed: {e!r}", flush=True)
            failures += 1
            latencies.append(math.inf)
            i += 1
            continue
        end = time.perf_counter()
        spans.append((due if rate is not None else began, end))
        service.append((began, end))
        latencies.append(end - due)
        finished += 1
        if len(kept) < keep_n:  # reservoir sample of the finished requests
            kept.append((first_index + i, imgs))
        else:
            j = rng.randrange(finished)
            if j < keep_n:
                kept[j] = (first_index + i, imgs)
        i += 1
    return spans, service, latencies, failures, kept


def run(ctx) -> dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
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
    pipe = program.build_pipeline(cfg, ctx.seed, device=dev, dtype=ctx.dtype, impl=ctx.impl)
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
        # the same work untraced first: the host's time, free of the profiler's,
        # over the requests' service alone (an open loop's arrival gaps left out)
        n = tr["trace_requests"]
        spans0, service0, lat0, fail0, _ = serve_window(ctx, pipe, ctx.seconds, 0, n)
        if spans0:
            untraced = (flops * len(spans0), union_length(service0))
        ranges = Ranges(ctx, pipe)
        spans, _, latencies, failures, kept = ctx.profiled(
            lambda: serve_window(ctx, pipe, ctx.seconds, n, n))
        for h in ranges.handles:
            h.remove()
        latencies, failures = lat0 + latencies, fail0 + failures
    else:
        with ctx.host_load():
            spans, _, latencies, failures, kept = serve_window(ctx, pipe, ctx.seconds, 0)
    ctx.sync()
    n_ok = len(spans)
    metrics = {}
    if n_ok:
        metrics["img_per_s"] = stats.rate(n_ok * tr["batch"], spans)
    metrics["request_p95_s"] = stats.p95(latencies)
    ctx.note(f"window: {len(latencies)} requests, {failures} failed, "
             f"median latency {float(np.median(latencies)):.4f} s, metrics {metrics}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del pipe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = {"image_rms": {"value": check(ctx, kept), "limit": ctx.limits["image_rms"]}}
    return {"attempted": len(latencies), "failed": failures, "setup_s": setup_s,
            "metrics": metrics, "memory_peak_bytes": peak, "checks": checks,
            "untraced": untraced}


def check(ctx, kept) -> float:
    """The worst kept request's RMS pixel difference from the reference."""
    if not kept:
        return math.inf
    with nets.f32_products():
        w = program.reference_weights(ctx.config, ctx.seed, ctx.device, ctx.dtype)
        worst = 0.0
        for index, imgs in kept:
            ref = reference_images(w, ctx.config, ctx.traffic, ctx.seed, index, ctx.device,
                                   ctx.dtype, nets.Ops())
            worst = max(worst, image_rms(imgs, ref))
    return worst
