"""Drive the PyTorch port (stable_diffusion_tpu_torch) once on an NVIDIA GPU.

    python3 chip_smoke.py

Five phases, one line each (plus detail lines); any failure exits non-zero
and the final line is printed only when every phase passed:

  1. device   -- needs torch.cuda; prints nvidia-smi's name and power limit.
  2. build    -- compiles the CUDA kernels (nvcc, sm_90a) and the Triton
                 kernel from this checkout's sources; prints the seconds.
  3. kernels  -- runs the SD1.5 txt2img main path once at 512^2 to record
                 the shape each of K1-K4 gets there, then runs every kernel
                 at every such shape in bf16 against its plain PyTorch
                 version in f32 on the same inputs, and times kernel and
                 plain (bf16) with CUDA events.
  4. golden   -- rebuilds tests/golden/full_sd15_ddim2.npz's inputs with
                 numpy alone and runs the full SD1.5 UNet for DDIM-2: plain
                 f32 (TF32 off) against the golden, then the kernels in bf16
                 against that f32 result.
  5. serving  -- StableDiffusion.generate at 512^2, batch 1, CFG 7.5, DDIM
                 50 steps, full ViT-L / UNet / VAE width on seeded random
                 weights, two requests with their own token ids and seeds;
                 checks the images and that each kernel was launched.

Imports nothing of JAX.  Writes nothing outside ``build/`` (kernel builds).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances and their reasons.
# Kernels take bf16 inputs and return bf16; the plain reference runs in f32
# on the same (bf16-valued) inputs.  A bf16 result carries 2^-9 relative
# rounding, and the GN+SiLU prologue, the attention probabilities and the
# GeGLU intermediate are rounded to bf16 once more before a product, as the
# JAX kernels do: allow max|kernel - plain| <= 2e-2 * max|plain|.
KERNEL_REL_TOL = 2e-2
# Plain f32 UNet (TF32 off) vs the CPU-made JAX golden: the same f32 maths
# summed in another order; expect about 1e-3 absolute after two DDIM steps.
GOLDEN_ATOL = 2e-3
# bf16 kernels vs the f32 plain UNet: bf16 weights and activations through
# ~100 layers and two DDIM steps; relative L2 of the latents.
GOLDEN_BF16_REL_L2 = 5e-2
SERVE_STEPS = 50
SERVE_REQUESTS = 2

KERNELS = {
    "K1": dict(route="triton", source="stable_diffusion_tpu_torch/ops/groupnorm.py",
               replaces="stable_diffusion_tpu/ops/groupnorm.py:30",
               replaces_all=["stable_diffusion_tpu/ops/groupnorm.py:30 _stats_kernel",
                             "stable_diffusion_tpu/ops/groupnorm.py:71 _norm_kernel"]),
    "K2": dict(route="cuda", source="stable_diffusion_tpu_torch/csrc/conv3x3.cu",
               replaces="stable_diffusion_tpu/ops/conv.py:36",
               replaces_all=["stable_diffusion_tpu/ops/conv.py:36 _conv3x3_kernel"]),
    "K3": dict(route="cuda", source="stable_diffusion_tpu_torch/csrc/attention.cu",
               replaces="stable_diffusion_tpu/ops/flash_attention.py:213",
               replaces_all=["stable_diffusion_tpu/ops/flash_attention.py:213 _single_pass_kernel",
                             "stable_diffusion_tpu/ops/flash_attention.py:135 _flash_kernel",
                             "stable_diffusion_tpu/ops/flash_attention.py:317 _cross_kernel"]),
    "K4": dict(route="cuda", source="stable_diffusion_tpu_torch/csrc/ffn.cu",
               replaces="stable_diffusion_tpu/ops/ffn.py:67",
               replaces_all=["stable_diffusion_tpu/ops/ffn.py:67 _make_kernel"]),
}


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, rounds: int = 3, warmup: int = 3) -> float:
    """Milliseconds per call: CUDA events around ``reps`` back-to-back calls
    (so a short kernel is not timed as its host launch), median of
    ``rounds``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def build_pipeline(dtype, impl, seed=0):
    from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig
    from stable_diffusion_tpu_torch.models.unet import UNetConfig
    from stable_diffusion_tpu_torch.models.vae import VAEConfig
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion
    from stable_diffusion_tpu_torch.utils.weights import init_random_

    pipe = StableDiffusion.build(UNetConfig.sd15(), CLIPTextConfig.vit_l(), VAEConfig(),
                                 device="cuda", dtype=dtype, impl=impl)
    for i, m in enumerate((pipe.unet, pipe.text_encoder, pipe.vae)):
        init_random_(m, seed + i)
    return pipe


def request_ids(seed: int):
    rng = np.random.default_rng(seed)
    cond = rng.integers(0, 49408, (1, 77))
    uncond = np.zeros((1, 77), np.int64)
    return cond, uncond


# ---------------------------------------------------------------------------
# Phase 3: every kernel at every main-path shape vs its plain version
# ---------------------------------------------------------------------------


def _inputs_and_fns(kernel: str, key, gen):
    """(kernel fn, plain bf16 fn, plain f32 fn) on random inputs of one
    recorded shape key."""
    from stable_diffusion_tpu_torch.ops import conv, ffn, flash_attention, groupnorm

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).bfloat16()

    f32 = lambda ts: [t.float() for t in ts]  # noqa: E731
    if kernel == "K1":
        kind, b, hw, c = key[:4]
        eps = key[5]
        x = rn(b, hw, 1, c, scale=2.0) + 0.5
        w, bias = 1 + rn(c, scale=0.1), rn(c, scale=0.1)
        if kind == "stats":
            def run(x, w, bias, impl):
                return groupnorm.gn_scale_shift(x, w, bias, eps=eps, impl=impl)
        else:
            silu = key[6]

            def run(x, w, bias, impl):
                return groupnorm.group_norm_silu(x, w, bias, eps=eps, silu=silu, impl=impl)
        args = [x, w, bias]
    elif kernel == "K2":
        b, h, w_, cin, cout, prologue = key
        x = rn(b, h, w_, cin)
        wt, bias = rn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5), rn(cout, scale=0.1)
        if prologue:
            gw, gb = 1 + rn(cin, scale=0.1), rn(cin, scale=0.1)

            def run(x, gw, gb, wt, bias, impl):
                return conv.gn_silu_conv3x3(x, gw, gb, wt, bias, impl=impl)
            args = [x, gw, gb, wt, bias]
        else:
            def run(x, wt, bias, impl):
                return conv.conv3x3(x, wt, bias, impl=impl)
            args = [x, wt, bias]
    elif kernel == "K3":
        b, sq, sk, h, d = key
        args = [rn(b, sq, h, d), rn(b, sk, h, d), rn(b, sk, h, d)]

        def run(q, k, v, impl):
            return flash_attention.attention(q, k, v, impl=impl)
    else:
        m, c = key
        args = [rn(m, c), 1 + rn(c, scale=0.1), rn(c, scale=0.1), rn(8 * c, c, scale=c ** -0.5),
                rn(8 * c, scale=0.1), rn(c, 4 * c, scale=(4 * c) ** -0.5), rn(c, scale=0.1),
                rn(m, c)]

        def run(*a, impl):
            return ffn.geglu_ffn(*a[:7], a[7], impl=impl)
    return (lambda: run(*args, impl="cuda"), lambda: run(*args, impl="torch"),
            lambda: run(*f32(args), impl="torch"))


def phase_kernels(shapes):
    gen = torch.Generator(device="cuda").manual_seed(1234)
    summary = {}
    ok = True
    for kernel in ("K1", "K2", "K3", "K4"):
        keys = sorted(shapes[kernel], key=str)
        if not keys:
            raise RuntimeError(f"{kernel}: the main path gave it no shape")
        rows = []
        for key in keys:
            k_fn, p_fn, ref_fn = _inputs_and_fns(kernel, key, gen)
            got = k_fn().float()
            ref = ref_fn().float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            rel = err / max(ref.abs().max().item(), 1e-30)
            good = bool(torch.isfinite(got).all().item()) and rel <= KERNEL_REL_TOL
            ok &= good
            k_ms, p_ms = cuda_ms(k_fn), cuda_ms(p_fn)
            rows.append((err, rel, k_ms, p_ms))
            shown = tuple(str(s).replace("torch.", "") for s in key)
            say(f"  {kernel} {'ok ' if good else 'BAD'} shape={shown} calls/pass="
                f"{shapes[kernel][key]} max_abs_err={err:.3e} rel={rel:.3e} "
                f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}")
        summary[kernel] = dict(
            shapes=len(rows), max_abs_err=max(r[0] for r in rows),
            max_rel_err=max(r[1] for r in rows),
            ms_per_pass=sum(r[2] * shapes[kernel][k] for r, k in zip(rows, keys)),
            plain_ms_per_pass=sum(r[3] * shapes[kernel][k] for r, k in zip(rows, keys)))
    return ok, summary


def record_main_path_shapes(pipe, counters):
    """Run the main path once (1 DDIM step: every step gives the kernels the
    same shapes) with per-shape launch counting on."""
    for c in counters.values():
        c.record()
    cond, uncond = request_ids(99)
    pipe.generate(cond, uncond, inference_steps=1, seed=99, output_dtype="uint8")
    torch.cuda.synchronize()
    return {k: c.stop_recording() for k, c in counters.items()}


# ---------------------------------------------------------------------------
# Phase 4: full-size golden
# ---------------------------------------------------------------------------


def phase_golden():
    from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
    from stable_diffusion_tpu_torch.schedulers import schedule as S
    from stable_diffusion_tpu_torch.utils import weights as W

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want = np.load(os.path.join(REPO, "tests", "golden", "full_sd15_ddim2.npz"))["latents"]
    unet = W.build(UNet, UNetConfig.sd15(), device="cuda", dtype=torch.float32)
    params = W.philox_jax_params(unet, seed=7)
    unet.load_state_dict(W.from_jax_params(W.unflatten(params)), strict=True)
    del params
    rng = np.random.Generator(np.random.Philox(11))
    lat0 = rng.standard_normal((1, 64, 64, 4), dtype=np.float32)
    ctx = rng.standard_normal((1, 77, 768), dtype=np.float32) * 0.1
    sched = S.make_schedule()
    ts = S.inference_timesteps(sched, 2, kind="ddim")
    prev = ts - sched.num_train_timesteps // 2
    table = torch.as_tensor(sched.alphas_hat, device="cuda")

    def denoise(model, dtype, impl):
        lat = torch.tensor(lat0, device="cuda", dtype=dtype)
        c = torch.tensor(ctx, device="cuda", dtype=dtype)
        with torch.no_grad():
            for t, pt in zip(ts.tolist(), prev.tolist()):
                eps = model(lat, torch.full((1,), t, device="cuda"), c, impl=impl)
                lat = S.ddim_step(table, lat, t, pt, eps)
        return lat.float().cpu().numpy()

    got = denoise(unet, torch.float32, "torch")
    err = float(np.abs(got - want).max())
    say(f"  golden f32 plain: max_abs_err={err:.3e} (tol {GOLDEN_ATOL}) "
        f"latent std={float(want.std()):.4f}")
    unet = unet.to(torch.bfloat16)
    got16 = denoise(unet, torch.bfloat16, "cuda")
    rel = float(np.linalg.norm(got16 - got) / np.linalg.norm(got))
    say(f"  golden bf16 kernels vs f32 plain: rel_l2={rel:.3e} (tol {GOLDEN_BF16_REL_L2}) "
        f"max_abs_err={float(np.abs(got16 - got).max()):.3e}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del unet
    torch.cuda.empty_cache()
    return (err <= GOLDEN_ATOL and rel <= GOLDEN_BF16_REL_L2 and np.isfinite(got16).all()), err, rel


# ---------------------------------------------------------------------------
# Phase 5: serving
# ---------------------------------------------------------------------------


def phase_serving(pipe, counters):
    secs, ok = [], True
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    for r in range(SERVE_REQUESTS):
        cond, uncond = request_ids(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = pipe.generate(cond, uncond, img_size=(512, 512), cfg_scale=7.5,
                            inference_steps=SERVE_STEPS, seed=1000 + r, output_dtype="uint8")
        secs.append(time.perf_counter() - t0)
        good = (img.shape == (1, 512, 512, 3) and img.dtype == np.uint8
                and int(img.max()) > int(img.min()))
        ok &= good
        say(f"  request {r}: {secs[-1]:.3f} s shape={img.shape} dtype={img.dtype} "
            f"min={int(img.min())} max={int(img.max())} mean={float(img.mean()):.2f} "
            f"{'ok' if good else 'BAD'}")
    launches = {k: c.launches for k, c in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    return ok, secs, launches, peak_gib


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        say("phase 1 device: FAIL, torch.cuda.is_available() is false")
        return 2
    card = card_line()
    say(card)
    say(f"phase 1 device: ok, {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    from stable_diffusion_tpu_torch.ops import _cuda, conv, ffn, flash_attention, groupnorm

    counters = {"K1": groupnorm.K1, "K2": conv.K2, "K3": flash_attention.K3, "K4": ffn.K4}

    # 2. build
    t0 = time.perf_counter()
    _cuda.library()
    nvcc_s = _cuda.build_seconds
    x = torch.randn(1, 8, 8, 64, device="cuda").bfloat16()
    groupnorm.group_norm_silu(x, torch.ones(64, device="cuda"), torch.zeros(64, device="cuda"),
                              impl="cuda")  # compiles the three Triton kernels
    torch.cuda.synchronize()
    say(f"phase 2 build: ok, {time.perf_counter() - t0:.2f} s "
        f"(nvcc {'cached' if nvcc_s is None else f'{nvcc_s:.2f} s'}, Triton JIT included)")

    # 3. kernels vs plain at the main path's shapes
    pipe = build_pipeline(torch.bfloat16, "cuda")
    shapes = record_main_path_shapes(pipe, counters)
    ok3, summary = phase_kernels(shapes)
    say(f"phase 3 kernels: {'ok' if ok3 else 'FAIL'}, " + ", ".join(
        f"{k} {s['shapes']} shapes max_rel={s['max_rel_err']:.2e} "
        f"kernel {s['ms_per_pass']:.2f} ms vs plain {s['plain_ms_per_pass']:.2f} ms per pass"
        for k, s in summary.items())
        + " (a pass: text encode + one CFG UNet step + VAE decode)")
    if not ok3:
        return 1

    # 4. golden
    ok4, g_err, g_rel = phase_golden()
    say(f"phase 4 golden: {'ok' if ok4 else 'FAIL'}, f32 max_abs_err={g_err:.3e}, "
        f"bf16 rel_l2={g_rel:.3e}")
    if not ok4:
        return 1

    # 5. serving
    ok5, secs, launches, peak = phase_serving(pipe, counters)
    ok5 &= all(n > 0 for n in launches.values())
    say(f"phase 5 serving: {'ok' if ok5 else 'FAIL'}, {SERVE_REQUESTS} requests at 512^2, "
        f"DDIM {SERVE_STEPS} steps, CFG 7.5: s/request={[round(s, 3) for s in secs]} "
        f"launches={launches} peak_mem={peak:.2f} GiB")
    if not ok5:
        return 1

    # For the record: the same request through the plain versions.
    pipe.impl = "torch"
    cond, uncond = request_ids(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.generate(cond, uncond, inference_steps=SERVE_STEPS, seed=1000, output_dtype="uint8")
    say(f"  plain impl='torch' bf16, same request: {time.perf_counter() - t0:.3f} s")

    # ms / plain_ms: milliseconds per pass (each main-path shape's median
    # time times its calls in one text encode + CFG UNet step + VAE decode)
    kernels = [dict(name=k, route=KERNELS[k]["route"], source=KERNELS[k]["source"],
                    replaces=KERNELS[k]["replaces"], launches=launches[k],
                    max_abs_err=summary[k]["max_abs_err"], ms=summary[k]["ms_per_pass"],
                    plain_ms=summary[k]["plain_ms_per_pass"],
                    max_rel_err=summary[k]["max_rel_err"],
                    shapes=summary[k]["shapes"], replaces_all=KERNELS[k]["replaces_all"])
               for k in ("K1", "K2", "K3", "K4")]
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # any phase's failure: report it and exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
