"""The training generator: the port's LoRA DreamBooth step
(``training.make_train_step``) on cached encoders, one micro-step a call.

The traffic file sets the micro-batch ([instance; prior] halves), the LoRA
rank, alpha and targets, and the optimizer (AdamW with clipping and
gradient accumulation) and EMA.  The benchmark draws the UNet's weights and
the LoRA tree from the seed and builds the step's state from them; each
micro-step's batch (latent moments, VAE noise, noise, text embeddings,
timesteps) comes from (seed, micro-step index) on the device.  Set-up
drives that state through its first ``check_steps`` micro-steps (both the
accumulating and the updating branch), then the window goes on with the
same state until ``--seconds`` have passed; the losses stay on the device
until it ends.

Correctness: the plain f32 reference follows the first ``check_steps``
micro-steps from the same weights, LoRA tree and batches.  Compared: the
worst leaf's gap between the norms of the first gradient as the optimizer
holds it (its accumulator after one micro-step); the worst leaf's gap
between the norms of the parameters' change after the last of those
steps, and the same of the EMA's change.  Each step's loss gap is printed
beside them (see :func:`loss_gap`).  A leaf's gap is taken against the
larger of the reference's norm of that leaf and of the median leaf; leaves
whose reference gradient is under a thousandth of the median leaf's move
by rounding alone and are left out.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Mapping

import torch

from portbench.lib import inputs, program, work
from portbench.reference import nets
from portbench.reference import train as ref_train

EXCLUDE_BELOW = 1e-3  # a leaf's first gradient under this share of the median leaf's


def hyper(tr: Mapping) -> ref_train.Hyper:
    return ref_train.Hyper(learning_rate=tr["learning_rate"], weight_decay=tr["weight_decay"],
                           max_grad_norm=tr["max_grad_norm"],
                           grad_accum_steps=tr["grad_accum_steps"],
                           prior_loss_weight=tr["prior_loss_weight"], ema_beta=tr["ema_beta"],
                           ema_start=tr["ema_start"])


def batch(ctx, index: int, dtype) -> dict:
    cfg, tr = ctx.config, ctx.traffic
    r = cfg["resolution"] // 8
    ctx_dim = cfg["unet"]["cross_attention_dim"]
    ctx_dim = ctx_dim if isinstance(ctx_dim, int) else ctx_dim[0]
    return inputs.train_batch(ctx.seed, index, tr["batch"], (r, r), ctx_dim, ctx.device, dtype)


def step_flops(ctx) -> float:
    """Model FLOPs of one micro-step: the reference's forward and backward
    (to the LoRA leaves), counted on the meta device.  Counted at 2 and 4
    rows (each half one row block, so the LoRA merge runs twice in both):
    the difference gives a row's FLOPs, the rest the merge's, and the step
    is one merge and ``batch`` rows, as the program runs it."""
    cfg, tr = ctx.config, ctx.traffic
    shapes = nets.param_shapes(cfg)["unet"]
    P = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
    lora = inputs.lora_tree(0, shapes, tr["targets"], tr["rank"], tr["alpha"], "meta")
    r = cfg["resolution"] // 8
    d = cfg["unet"]["cross_attention_dim"]

    def count(n: int) -> float:
        meta_batch = {k: work.meta_randn(n, r, r, 4)
                      for k in ("latent_mean", "latent_std", "vae_noise", "noise")}
        meta_batch["text_emb"] = work.meta_randn(n, 77, d)
        meta_batch["t"] = torch.zeros((n,), dtype=torch.long, device="meta")
        return work.model_flops(lambda: ref_train.loss_and_grad(
            P, cfg["unet"], lora, meta_batch, hp=hyper(tr),
            prediction_type=cfg["prediction_type"], ops=nets.Ops()))

    f2, f4 = count(2), count(4)
    row = (f4 - f2) / 2
    merge = (f2 - 2 * row) / 2
    return merge + tr["batch"] * row


def norms(flat) -> dict:
    return {k: float(v.double().norm()) for k, v in flat.items()}


def train_config(tr: Mapping):
    from stable_diffusion_tpu_torch import training as T

    return T.TrainConfig(learning_rate=tr["learning_rate"], weight_decay=tr["weight_decay"],
                         rank=tr["rank"], alpha=float(tr["alpha"]),
                         prior_loss_weight=tr["prior_loss_weight"],
                         grad_accum_steps=tr["grad_accum_steps"], use_ema=tr["use_ema"],
                         ema_beta=tr["ema_beta"], ema_start=tr["ema_start"],
                         max_grad_norm=tr["max_grad_norm"], lora_targets=tuple(tr["targets"]))


def first_steps(ctx, unet, lora0):
    """The program's state built from ``lora0`` and driven through the first
    ``check_steps`` micro-steps: (readings, state, step function)."""
    from stable_diffusion_tpu_torch import training as T
    from stable_diffusion_tpu_torch.models import ema as ema_m
    from stable_diffusion_tpu_torch.schedulers import schedule as S
    from stable_diffusion_tpu_torch.utils.tree import tree_map

    cfg, tr = ctx.config, ctx.traffic
    tc = train_config(tr)
    lora = {"unet": tree_map(lambda x: x.clone(), lora0)}
    state = {"lora": lora, "opt_state": T.make_optimizer(tc).init(lora),
             "ema": ema_m.ema_init(lora) if tc.use_ema else lora, "step": 0}
    schedule = S.make_schedule(prediction_type=cfg["prediction_type"])
    step_fn = T.make_train_step({"unet": unet}, schedule=schedule, train_cfg=tc, impl=ctx.impl)
    losses, first_grads = [], None
    for i in range(tr["check_steps"]):
        state, m = step_fn(state, batch(ctx, i, ctx.dtype))
        losses.append(m["loss"])
        if i == 0:
            first_grads = norms(ref_train.leaves(state["opt_state"]["acc"]["unet"]))
    ctx.sync()
    prog = {"losses": [float(x) for x in losses], "grad_norms": first_grads,
            "change_norms": ref_train.change_norms(lora0,
                                                   ref_train.leaves(state["lora"]["unet"])),
            "ema_change_norms": ref_train.change_norms(lora0,
                                                       ref_train.leaves(state["ema"]["unet"]))}
    return prog, state, step_fn


def run(ctx) -> dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    split = {"imports": time.perf_counter() - ctx.t0}
    t = time.perf_counter()
    torch.zeros(1, device=dev)
    ctx.sync()
    split["device_init"] = time.perf_counter() - t
    t = time.perf_counter()
    unet = program.build_unet(cfg, ctx.seed, device=dev, dtype=ctx.dtype)
    lora0 = inputs.lora_tree(ctx.seed, nets.param_shapes(cfg)["unet"], tr["targets"], tr["rank"],
                             tr["alpha"], dev)
    ctx.sync()
    split["weights"] = time.perf_counter() - t
    t = time.perf_counter()
    flops = step_flops(ctx)
    split["flop_count"] = time.perf_counter() - t
    # the first micro-steps: warm-up (both branches) and the steps the reference follows
    t = time.perf_counter()
    prog, state, step_fn = first_steps(ctx, unet, lora0)
    split["first_steps"] = time.perf_counter() - t
    setup_s = time.perf_counter() - ctx.t0
    ctx.note("setup split (s): " + ", ".join(f"{k} {v}" for k, v in split.items()))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def window(first: int, max_steps=None):
        nonlocal state
        done, window_losses = 0, []
        t0 = time.perf_counter()
        while (max_steps is None and time.perf_counter() - t0 < ctx.seconds) or \
                (max_steps is not None and done < max_steps):
            state, m = step_fn(state, batch(ctx, first + done, ctx.dtype))
            window_losses.append(m["loss"])
            done += 1
        ctx.sync()
        return done, time.perf_counter() - t0, window_losses

    untraced = None
    first = tr["check_steps"]
    if ctx.trace:  # the same work untraced first: the host's time, free of the profiler's
        n = tr["trace_steps"]
        done0, secs0, losses0 = window(first, n)
        untraced = (flops * done0, secs0)
        done, secs, window_losses = ctx.profiled(lambda: window(first + n, n))
        attempted, window_losses = done0 + done, losses0 + window_losses
    else:
        with ctx.host_load():
            done, secs, window_losses = window(first)
        attempted = done
    failed = int(sum(not math.isfinite(float(x)) for x in window_losses))
    metrics = {"train_img_per_s": done * tr["batch"] / secs}
    ctx.note(f"window{' (traced)' if ctx.trace else ''}: {done} micro-steps in {secs:.4f} s, "
             f"{failed} non-finite losses of {attempted}, metrics {metrics}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del unet, state, step_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(ctx, lora0)
    ctx.note(f"loss gap (not compared): {loss_gap(prog, ref)!r}")
    checks = {name: {"value": value, "limit": ctx.limits[name]}
              for name, value in compare(prog, ref).items()}
    return {"attempted": attempted, "failed": failed, "setup_s": setup_s, "metrics": metrics,
            "memory_peak_bytes": peak, "checks": checks, "untraced": untraced}


def reference(ctx, lora0, ops=None, rows=None) -> dict:
    """The reference's readings over the first ``check_steps`` micro-steps
    (``rows``: a function that cuts each batch, for a planted fault)."""
    cfg, tr = ctx.config, ctx.traffic
    with nets.f32_products():
        w = program.reference_weights(cfg, ctx.seed, ctx.device, ctx.dtype, ("unet",))["unet"]
        batches = []
        for i in range(tr["check_steps"]):
            b = {k: v.float() if v.is_floating_point() else v
                 for k, v in batch(ctx, i, ctx.dtype).items()}
            batches.append(rows(b) if rows else b)
        return ref_train.follow(w, cfg["unet"], lora0, batches, hp=hyper(tr),
                                prediction_type=cfg["prediction_type"], ops=ops or nets.Ops())


def half_rows(b: dict) -> dict:
    """The fault "half of the batch left out, the mean taken over the rest":
    the first half of each of the instance and prior halves."""
    n = b["t"].shape[0]
    keep = torch.cat([torch.arange(0, n // 4), torch.arange(n // 2, n // 2 + n // 4)])
    return {k: v[keep.to(v.device)] for k, v in b.items()}


def loss_gap(prog: dict, ref: dict) -> float:
    """The largest relative gap of a step's loss.  Not compared: the
    program's loss is a bfloat16 value, whose rounding (~4e-3) reads as high
    as the float8 control does, and half of the batch reads under ten times
    it (PERF.md gives the readings)."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared, each a worst leaf's relative gap."""
    med = sorted(ref["grad_norms"].values())[len(ref["grad_norms"]) // 2]
    keep = {k for k, g in ref["grad_norms"].items() if g >= EXCLUDE_BELOW * med}
    return {"grad_norm_gap": ref_train.worst_leaf_gap(prog["grad_norms"], ref["grad_norms"], keep),
            "change_norm_gap": ref_train.worst_leaf_gap(prog["change_norms"],
                                                        ref["change_norms"], keep),
            "ema_change_norm_gap": ref_train.worst_leaf_gap(prog["ema_change_norms"],
                                                            ref["ema_change_norms"], keep)}
