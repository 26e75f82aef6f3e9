"""Drive the PyTorch port (stable_diffusion_tpu_torch) once on an NVIDIA GPU.

    python3 chip_smoke.py                  # the sixteen phases below
    python3 chip_smoke.py --img2img        # phases 1-2 and 9 (no contract line)
    python3 chip_smoke.py --cli            # phases 1-2 and 10 (no contract line)
    python3 chip_smoke.py --deepcache      # phases 1-2 and 11 (no contract line)
    python3 chip_smoke.py --trainer        # phases 1-2 and 12 (no contract line)
    python3 chip_smoke.py --training       # phases 1-2 and 7 (no contract line)
    python3 chip_smoke.py --evaluation     # phases 1-2 and 13 (no contract line)
    python3 chip_smoke.py --demo           # phases 1-2 and 14 (no contract line)
    python3 chip_smoke.py --sharded        # phases 1-2 and 15 (no contract line)
    python3 chip_smoke.py --sharded-train  # phases 1-2 and 16 (no contract line)
    python3 chip_smoke.py --only-sd21      # phases 1-2 and 8 (no contract line)
    python3 chip_smoke.py --k2-device      # phases 1-2, then K2's host and device
                                           # time at the serving pass's shapes
    python3 chip_smoke.py --k3-sweep       # phases 1-2, then K3's general body beside
                                           # every variant of the planner's body at the
                                           # self-, cross- and VAE attention shapes
    python3 chip_smoke.py --k56-sweep      # phases 1-2, then K5 and K6's ring and first
                                           # bodies at the train step's ring shapes
    python3 chip_smoke.py --k4-sweep       # phases 1-2, then every K4 G1 and G2 variant
                                           # at the serve, SD2.1 and train shapes
    python3 chip_smoke.py --k8-sweep       # phases 1-2, then every K8 variant at the
                                           # W8A8 path's shapes, beside torch._int_mm
    python3 chip_smoke.py --w8a8-sweep [--root DIR]
                                           # phases 1-2, then K7 and K9 at the W8A8
                                           # path's shapes: every variant, beside the
                                           # K2 / K4 routes and torch._int_mm
    python3 chip_smoke.py --k12-sweep      # phases 1-2, then K12 at every region shape at
                                           # the switched SD2.1 shapes, beside the K2 route
    python3 chip_smoke.py --k10-sweep      # phases 1-2, then every K10/K11 variant at the
                                           # switched SD2.1 shapes, beside F.linear
    python3 chip_smoke.py --k1-host [--root DIR]
                                           # phase 1, then K1 by kind at the serving
                                           # pass's shapes: device ms and host us a call;
                                           # K2's host us a call, spans off and on
    (--root DIR imports stable_diffusion_tpu_torch from another checkout, e.g.
    the parent commit's, so two versions are measured by one script.)

Sixteen phases, one line each (plus detail lines); any failure exits non-zero
and the final line is printed only when every phase passed:

  1. device   -- needs torch.cuda; prints nvidia-smi's name and power limit,
                 the SM count and the maximum SM clock.
  2. build    -- compiles the CUDA kernels (nvcc, sm_90a) from this
                 checkout's sources; prints the seconds and each K1, K2, K3,
                 K4, K7, K8, K9, K10/K11 and K12 variant's registers,
                 spills, shared bytes and blocks per SM.
  3. kernels  -- runs the SD1.5 txt2img main path once at 512^2 to record
                 the shape each of K1-K4 gets there, then runs every kernel
                 at every such shape in bf16 against its plain PyTorch
                 version in f32 on the same inputs, and times kernel, plain
                 (bf16) and the library call computing the same function
                 with CUDA events, beside the bound from bytes, FLOPs and
                 (K3) exponentials (K1's lines name each shape's plan and
                 kind, statistics or normalize, and K1's summary groups
                 them with the host us a call at each kind's smallest
                 shape; K2's lines name each shape's tile plan; K3's its
                 body (ring, cross or wide) and the body's tile and splits,
                 q/k/v of a self-attention are views of one fused QKV, every
                 shape also times the general body, the first design, as
                 general_ms, and K3's groups are its bodies; the recorded
                 path must launch the general body at no shape, as phases
                 5-8's runs must not either; K4's name its plan and time its two
                 GEMMs apart as g1_ms and g2_ms, beside the bound of the
                 design's own bytes).
  4. golden   -- rebuilds tests/golden/full_sd15_ddim2.npz's inputs with
                 numpy alone and runs the full SD1.5 UNet for DDIM-2: plain
                 f32 (TF32 off) against the golden, then the kernels in bf16
                 against that f32 result.
  5. serving  -- StableDiffusion.generate at 512^2, batch 1, CFG 7.5, DDIM
                 50 steps, full ViT-L / UNet / VAE width on seeded random
                 weights, two requests with their own token ids and seeds;
                 checks the images and that each kernel was launched.
  6. w8a8     -- static-W8A8 serving (bench.py's BENCH_INT8=full UNet, with
                 calibrated scales): calibrates a copy of phase 5's UNet on
                 forward_process latents at t = 999/749/499/249 with a text
                 context at UNet batch 8, quantizes its linears and 3x3 convs;
                 records the shapes K1-K3 and K7-K9 get in one b4 DDIM step
                 and checks and times each kernel there (K7-K9 beside their
                 bf16 counterparts and the product-only torch._int_mm
                 yardstick: K7's on an explicit int8 im2col, K8's rows
                 zero-padded to 32 where M <= 16, K9's two products; their
                 lines name each shape's plan and the bound of the design's
                 own bytes);
                 holds one CFG
                 UNet step against the plain W8A8 path in f32, below the
                 distance of the unquantized bf16 UNet from it, beside the
                 plain W8A8 path in bf16 as a witness, and reports it against
                 the bf16 UNet (gated, and shown to catch scales left at
                 1.0); serves two
                 b4 512^2 DDIM-50 requests, which must launch K7, K8 and K9 and
                 not K4, beside one bf16 b4 request with the same ids and seed.
  7. training -- the LoRA DreamBooth train step (training.make_train_step)
                 on the full SD1.5 UNet in bf16: b4 (2 instance + 2 prior)
                 cached 64^2 latent moments and text embeddings, rank 128,
                 alpha 128 on q/k/v/out_proj, EMA, gradient accumulation 2,
                 no remat.  Records the shapes of one step and checks and
                 times every kernel at them (K5/K6, the attention backward,
                 included, with each shape's plan and occupancy, the first
                 (general) body timed beside a ring-body shape, and the
                 pair's bound and library time); holds one micro-step's
                 LoRA gradients on the
                 same b4 batch against the plain f32 path; times TRAIN_STEPS
                 steps, which must launch every one of K1-K6.
  8. sd21     -- SD2.1 768^2 v-prediction txt2img (StableDiffusion.for_version
                 "2.1": OpenCLIP ViT-H, UNetConfig.sd21(), full width, seeded
                 random weights) with the JAX package's kernel switches
                 SD_TPU_FUSED_MM and SD_TPU_WINOGRAD off and on: records the
                 shapes of one b1 CFG DDIM step each way, checks K1-K4 at
                 SD2.1's shapes and K10-K12 at every shape of the switched
                 step against their plain f32 versions (K12 also within 2.5x
                 of K2's error against the f32 direct conv; K10's, K11's
                 and K12's lines name each shape's plan; K11's also time its
                 launch alone, without K1's statistics), and times each
                 beside its bound, its library call and the route it
                 replaces; holds the full SD2.1 UNet to
                 tests/golden/full_sd21_ddim2.npz (plain f32, then the
                 kernels in bf16 with the switches off and on); serves two
                 768^2 DDIM-50 CFG-7.5 requests with the switches off (K1-K4
                 launched, K10-K12 not) and one with them on (K1-K4 and K10-K12
                 launched), same ids and seed, and reports the image drift.
  9. img2img  -- SD1.5 img2img and inpaint at 512^2 (BASELINE config 2:
                 DDPM on the cosine schedule, strength 0.8 of 50 steps, CFG
                 7.5): holds the full-width VAE encoder to
                 tests/golden/full_vae_encode.npz (plain f32, then the
                 kernels in bf16 against it); runs DDPM-4 at strength 0.5
                 (2 steps) at b4 on injected noise, the kernels in bf16
                 against the plain f32 path; records the shapes K1-K4 get
                 in one img2img b4 pass (the encoder at b1, one CFG UNet
                 step at batch 8, the decoder at b4) and checks and times
                 each kernel there; serves two img2img b4 requests (one
                 numpy image each, their own ids and seeds) and one b1
                 inpaint request (a rectangle mask), which must launch
                 K1-K4 and no other kernel; repeats request 0 for the same
                 uint8 image; times one 512^2 encode.
 10. cli      -- the user's entry, inference_torch.py, at full SD1.5 width:
                 writes seeded f16 weights under build/cli as a diffusers
                 directory and as one LDM .ckpt (tests/torch_checkpoints.py),
                 a synthesized CLIP vocabulary and a rank-4 kohya file;
                 loads both checkpoints in bf16 on the card (bit for bit the
                 source cast to bf16; the load seconds); records the shapes
                 K1-K4 get in one b1 no-CFG DDPM step, one b1 and one b4
                 one-step pass (the UNet at batch 1 and 4) and checks and
                 times each kernel there; holds a one-step b1 image against
                 the plain f32 path; serves two requests of each CLI run
                 (the defaults: DDPM 50, no CFG, b1; DDIM 50 with CFG 7.5;
                 one-step b1; one-step b4), each once through
                 inference_torch.main (its own load; img_0_*.jpg, where PIL
                 is present) and twice, timed, through inference on the
                 loaded model, then the defaults again with the kohya file
                 (the merged weights held against W + delta in f32 within
                 bf16's rounding bound); K1-K4 launched in every run, K5-K12
                 and K3's general body never.
 11. deepcache -- generate(deepcache_interval=k) at full SD1.5 width: records
                 one full step through forward_split (the shapes of forward)
                 and one cached step at UNet batch 2 (bf16) and 8 (W8A8):
                 the cached step launches only shapes of the full step, fewer
                 K2/K3/K4 (K3/K7/K8/K9 at W8A8), K3's general body never;
                 checks every kernel at the cached step's shapes; serves one
                 512^2 b1 DDIM-50 CFG-7.5 request without the argument and
                 one at each k = 1, 2, 3 (k = 1 must give the same uint8
                 image; each k's launches counted from 0; the drift from
                 k = 1 printed beside the TPU's p99), then W8A8 b4 at k = 1
                 and k = 2 (K7/K8/K9 launched, K4 not).
 12. trainer  -- train_lora_dreambooth_torch.main at full SD1.5 width: the
                 f16 diffusers directory of phase 10 and a DreamBooth
                 directory of 4 instance and 4 prior 512^2 PNGs; 2 updates
                 of b2+2 with accumulation 2, EMA, rank 128, on the cached
                 encoders (launches of K1-K6 counted from 0, K7-K12 none),
                 then uncached on the same seed (its shapes recorded, every
                 kernel checked there; the end states compared), a resume
                 from the epoch checkpoint, and the checkpoint served by
                 inference_torch --lora_ckpt (one-step b1: the same image as
                 a manual merge_lora_, the merged weights within bf16's
                 rounding bound of W + delta); s/step, peak memory and the
                 checkpoint's bytes.
 13. evaluation -- the evaluation path at full width on seeded weights:
                 writes an HF-layout CLIP ViT-L/14 CLIPModel directory (the
                 port's writer, f16); records K3's shapes in the vision
                 tower at b1 and b8 (s = 257, 16 heads of 64, the ring body)
                 and checks and times them; holds the CLIP score (b8) of the
                 bf16 kernels against plain f32 (each embedding's relative
                 L2, the derived score bound); calibrates and quantizes the
                 ViT-L text tower (quantize_text_encoder_static): K8 at every
                 linear of a b1 and a b2 forward, counted from 0 and checked
                 at each shape, the output against the plain W8A8 path in
                 f32 and the unquantized bf16 tower; calibrate_cond_encoder
                 over the default prompts and calibrate_unet on a short
                 SD1.5 denoise; class2img at 512^2 b1 (a ClassEncoder
                 embedding as a one-token context: K3's cross body on one
                 key, checked at its 4 shapes; two timed requests); a
                 VQ-VAE round trip at 512^2 b1 (K1-K3 checked at its shapes)
                 and one EMA codebook update; Inception pool3 at b8 and the
                 FID of two seeded sets; evaluation_torch.main on phase 10's
                 f16 directory with two COCO-style images, the CLIP score
                 and CLIP-FID (one config, one scale: JAX's results keys;
                 K1-K4 launched, K5-K12 never).  Writes under build/eval and
                 build/cli, removed at the end.
 14. demo     -- the Gradio demo, demo/app_torch.py, at full SD1.5 width:
                 tests/gradio_stub.py (loaded by file) stands in for gradio;
                 phase 10's f16 directory and vocabulary loaded by
                 initialize_model(device="cuda"); the three recorded click
                 handlers (txt2img, img2img, inpaint) at DDIM 50 CFG 7.5, b1
                 and b2, each with a gr.Progress that must end at 1.0 (K1-K4
                 launched, K5-K12 and K3's general body never); the b1
                 txt2img request again as one call: the same launches, the
                 image within DEMO_SEGMENT_REL_L2 of the segmented one.
 15. sharded  -- StableDiffusion.shard on a torch.distributed mesh: two
                 ranks (this script with --shard-rank, tcp://localhost) share
                 the card over gloo as a (1, 2) tensor-parallel mesh, then one
                 rank runs over NCCL as a 1x1 mesh; SD1.5 512^2 b1 DDIM
                 SHARD_STEPS CFG 7.5 on seeded weights: the tp=2 image within
                 SHARD_IMAGE_REL_L2 of rank 0's unsharded image (the two
                 ranks' equal; the 1x1 image the unsharded one); the shapes
                 K3 (4 of 8 heads) and K4 (hidden 640 / 1280 / 2560) get on a
                 shard, each checked and timed there; seconds a request a
                 mesh.  Writes under build/shard, removed at the end.
 16. sharded-train -- the LoRA train step across a mesh (the collectives in
                 the autograd graph, make_train_step(mesh=...)): two ranks
                 (this script with --train-rank) share the card over gloo,
                 first as a (1, 2) mesh, then as a (2, 1) mesh, then one
                 rank runs a 1x1 mesh over NCCL; each runs phase 7's step
                 (full SD1.5 UNet in bf16, b4 cached 64^2 latents, rank 128
                 on q/k/v/out_proj, EMA, accumulation 2) for
                 SHARD_TRAIN_CALLS micro-steps from one LoRA tree and
                 batch set after rank 0's unsharded run of the same: the
                 first micro-step's LoRA gradients within TRAIN_GRAD_REL_L2
                 and the tree after two updates by phase 12's rule, the
                 ranks' equal, the 1x1 mesh the unsharded run bit for bit;
                 every micro-step timed with its sums (count, MiB, seconds),
                 peak memory a rank; K1-K6 at a tp = 2 rank's shapes (K5/K6
                 on 4 of 8 heads, K4 at hidden 4C / 2), each checked and
                 timed there; then train_lora_dreambooth_torch.main for one
                 update on phase 12's data under one rank and under two at
                 --mesh_model_axis 2 (--train-cli-rank, the launcher's
                 variables set): the checkpoints compared, only rank 0
                 writing.  Writes under build/shard_train and build/cli,
                 removed at the end.

Imports nothing of JAX.  Writes nothing outside ``build/`` (kernel builds,
and phases 10-16's checkpoints, data and logs, removed when each ends).
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances and their reasons.
# Kernels take bf16 inputs and return bf16; the plain reference runs in f32
# on the same (bf16-valued) inputs.  A bf16 result carries 2^-9 relative
# rounding, and the GN+SiLU prologue, the attention probabilities, dS and
# the GeGLU intermediate are rounded to bf16 once more before a product, as
# the JAX kernels do: allow max|kernel - plain| <= 2e-2 * max|plain|.
KERNEL_REL_TOL = 2e-2
# Plain f32 UNet (TF32 off) vs the CPU-made JAX golden: the same f32 maths
# summed in another order; expect about 1e-3 absolute after two DDIM steps.
GOLDEN_ATOL = 2e-3
# bf16 kernels vs the f32 plain UNet: bf16 weights and activations through
# ~100 layers and two DDIM steps; relative L2 of the latents.
GOLDEN_BF16_REL_L2 = 5e-2
# One micro-step's LoRA gradients, bf16 kernels vs plain f32: the same
# bf16 rounding through the forward and back through the backward; relative
# L2 over the whole gradient tree.
TRAIN_GRAD_REL_L2 = 5e-2
# The W8A8 UNet step, bf16 kernels vs the plain W8A8 path in f32 (TF32 off)
# on the same int8 weights and scales: every int8 product is exact in both,
# so they differ by the bf16 rounding of the activations between quantizers
# and by the codes that rounding moves across a half step; relative L2.  On
# an H100 (PERF.md, Findings) the plain W8A8 path run in bf16 reads
# 3.46e-2 from the f32 one (the cost of bf16 activations alone) and the
# unquantized bf16 UNet 4.12e-2 (one quantization's worth): the tolerance
# sits between the two, and the step check fails if it is not below the
# second.
W8A8_STEP_REL_L2 = 3.8e-2
# The W8A8 step vs the unquantized bf16 UNet on the same inputs: calibrated
# per-layer activation scales and per-channel weight scales cost each of the
# ~140 int8 products about 1% (8 bits over the calibrated range), adding in
# quadrature through the UNet; scales left at attach_act_scales' 1.0 clip
# nearly every activation and land far above this bound.
W8A8_VS_BF16_REL_L2 = 0.2
W8A8_BATCH = 4          # requests per batch: the UNet runs at 8 with CFG
W8A8_CAL_T = (999, 749, 499, 249)
SERVE_STEPS = 50
SERVE_REQUESTS = 2
TRAIN_BATCH = 4         # 2 instance + 2 prior, as bench.py's train config
TRAIN_STEPS = 12        # timed, after two warm-up steps
TRAIN_TARGETS = ("q_proj", "k_proj", "v_proj", "out_proj")
SD21_SIZE = (768, 768)
IMG2IMG_BATCH = 4       # BASELINE config 2: img2img b4 (UNet batch 8 with CFG)
IMG2IMG_STRENGTH = 0.8  # 40 of 50 DDPM steps run
# The full-width VAE encoder, plain f32 (TF32 off), against the CPU-made JAX
# golden: the same f32 maths summed in another order through ~30 layers at
# activations below 1; the golden's mean spreads 1.0e-2 about its channel
# averages and its std is 0.994 +- 0.011, so 2e-5 is 0.2% of that spread.
VAE_GOLDEN_ATOL = 2e-5
# K12 against the f32 direct conv (TF32 off), relative max: within this
# factor of K2's own error on the same inputs (tests/test_winograd.py's
# bar: V and U are rounded to bf16 after transforms that grow magnitudes).
WINOGRAD_VS_DIRECT = 2.5
# The JAX package's kernel switches, read at call time; phase 8 sets and
# restores them.
SWITCHES_ON = {"SD_TPU_FUSED_MM": "all", "SD_TPU_WINOGRAD": "1"}

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a call is the
# larger of its bytes over HBM bandwidth and its FLOPs over the peak of
# their type.
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
INT8_TC_OPS = 1979e12
F32_FLOPS = 67e12
# K3 computes one exponential per logit on the special-function units: 16
# ex2 a clock per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0).  Phase 1 sets the rate from the
# card's SM count and its maximum SM clock (nvidia-smi clocks.max.sm).
EX2_PER_CLOCK_PER_SM = 16
EXP_RATE = None  # exponentials a second

KERNELS = {
    "K1": dict(route="cuda", source="stable_diffusion_tpu_torch/csrc/groupnorm.cu",
               replaces="stable_diffusion_tpu/ops/groupnorm.py:30",
               replaces_all=["stable_diffusion_tpu/ops/groupnorm.py:30 _stats_kernel",
                             "stable_diffusion_tpu/ops/groupnorm.py:71 _norm_kernel"],
               library="F.group_norm + F.silu (norm shapes), torch.var_mean (stats shapes)"),
    "K2": dict(route="cuda", source="stable_diffusion_tpu_torch/csrc/conv3x3.cu",
               replaces="stable_diffusion_tpu/ops/conv.py:36",
               replaces_all=["stable_diffusion_tpu/ops/conv.py:36 _conv3x3_kernel"],
               library="F.conv2d channels-last (the GN+SiLU prologue not included)"),
    "K3": dict(route="cuda", source="stable_diffusion_tpu_torch/csrc/attention.cu",
               replaces="stable_diffusion_tpu/ops/flash_attention.py:213",
               replaces_all=["stable_diffusion_tpu/ops/flash_attention.py:213 _single_pass_kernel",
                             "stable_diffusion_tpu/ops/flash_attention.py:135 _flash_kernel",
                             "stable_diffusion_tpu/ops/flash_attention.py:317 _cross_kernel"],
               library="F.scaled_dot_product_attention"),
    "K4": dict(route="cuda", source="stable_diffusion_tpu_torch/csrc/ffn.cu",
               replaces="stable_diffusion_tpu/ops/ffn.py:67",
               replaces_all=["stable_diffusion_tpu/ops/ffn.py:67 _make_kernel"],
               library=None),  # no one PyTorch call computes LN -> GeGLU -> FFN
    "K5": dict(route="cuda", source="stable_diffusion_tpu_torch/csrc/attention_bwd.cu",
               replaces="stable_diffusion_tpu/ops/flash_attention.py:558",
               replaces_all=["stable_diffusion_tpu/ops/flash_attention.py:558 _bwd_dq_kernel"],
               library=None),  # no one call computes dq alone; see attention_bwd_pair
    "K6": dict(route="cuda", source="stable_diffusion_tpu_torch/csrc/attention_bwd.cu",
               replaces="stable_diffusion_tpu/ops/flash_attention.py:607",
               replaces_all=["stable_diffusion_tpu/ops/flash_attention.py:607 _bwd_dkv_kernel"],
               library=None),
    "K7": dict(route="cuda", source="stable_diffusion_tpu_torch/csrc/conv3x3_q.cu",
               replaces="stable_diffusion_tpu/ops/conv.py:333",
               replaces_all=["stable_diffusion_tpu/ops/conv.py:333 _conv3x3_q_kernel"],
               library="torch._int_mm on an explicit int8 im2col (M x 9 Cin) of the codes (the "
                       "product only: no GN+SiLU, quantize, im2col or dequantize)",
               bf16="K2 with the GN+SiLU prologue (gn_silu_conv3x3) on the bf16 weight"),
    "K8": dict(route="cuda", source="stable_diffusion_tpu_torch/csrc/linear_q.cu",
               replaces="stable_diffusion_tpu/ops/linear.py:400",
               replaces_all=["stable_diffusion_tpu/ops/linear.py:400 _make_q_kernel"],
               library="torch._int_mm on the int8 operands (the product only: no LN, quantize "
                       "or dequantize; rows zero-padded to 32 where M <= 16)",
               bf16="layer_norm_plain (LN shapes) -> F.linear on the bf16 weight (+ residual)"),
    "K9": dict(route="cuda", source="stable_diffusion_tpu_torch/csrc/ffn_q.cu",
               replaces="stable_diffusion_tpu/ops/ffn.py:319",
               replaces_all=["stable_diffusion_tpu/ops/ffn.py:319 _make_q_kernel"],
               library="the two torch._int_mm products on int8 operands (x W1^T, h W2^T: no "
                       "LN, quantize, GeGLU or dequantize)",
               bf16="K4 (geglu_ffn) on the bf16 weights"),
}
KERNELS.update({
    "K10": dict(route="cuda", source="stable_diffusion_tpu_torch/csrc/linear.cu",
                replaces="stable_diffusion_tpu/ops/linear.py:45",
                replaces_all=["stable_diffusion_tpu/ops/linear.py:45 _make_kernel"],
                library="F.linear (the product and bias: no LayerNorm, no residual)",
                bf16="the unswitched route: layer_norm_plain -> F.linear (LN sites), "
                     "F.linear + add (residual sites)"),
    "K11": dict(route="cuda", source="stable_diffusion_tpu_torch/csrc/linear.cu",
                replaces="stable_diffusion_tpu/ops/linear.py:283",
                replaces_all=["stable_diffusion_tpu/ops/linear.py:283 _gn_mm_kernel"],
                library="F.linear (the product and bias: no GroupNorm)",
                bf16="the unswitched route: K1 (stats + normalize) -> F.linear"),
    "K12": dict(route="cuda", source="stable_diffusion_tpu_torch/csrc/winograd.cu",
                replaces="stable_diffusion_tpu/ops/winograd.py:81",
                replaces_all=["stable_diffusion_tpu/ops/winograd.py:81 _wino_kernel"],
                library="F.conv2d channels-last (the GN+SiLU prologue not included)",
                bf16="the unswitched route: K2 (with its GN+SiLU prologue where K12 has it)"),
})
SERVING_KERNELS = ("K1", "K2", "K3", "K4")
K3_BODY_NAMES = ("ring", "cross", "wide", "general")  # flash_attention.K3_BODIES
SWITCHED_KERNELS = ("K10", "K11", "K12")
W8A8_KERNELS = ("K7", "K8", "K9")
W8A8_PATH_KERNELS = ("K1", "K2", "K3", *W8A8_KERNELS)  # K4 is not on the W8A8 path
TRAIN_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6")


def set_exp_rate():
    """EXP_RATE from the card's SM count and maximum SM clock: (SMs, MHz)."""
    global EXP_RATE
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_mhz()
    EXP_RATE = EX2_PER_CLOCK_PER_SM * sms * clock * 1e6
    return sms, clock


def kernel_counters() -> dict:
    """Every kernel's launch counter by name, and K3's by body (``K3:ring``, ...)."""
    from stable_diffusion_tpu_torch.ops import conv, ffn, flash_attention, groupnorm, linear, winograd

    counters = {"K1": groupnorm.K1, "K2": conv.K2, "K3": flash_attention.K3, "K4": ffn.K4,
                "K5": flash_attention.K5, "K6": flash_attention.K6, "K7": conv.K7,
                "K8": linear.K8, "K9": ffn.K9, "K10": linear.K10, "K11": linear.K11,
                "K12": winograd.K12}
    counters.update({f"K3:{body}": c for body, c in flash_attention.K3_BY_BODY.items()})
    return counters


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


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds a call: ``calls`` back-to-back launches timed on
    the host clock without a synchronize (at a shape whose device time is
    below the launch's, so the queue never fills)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def max_sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def bound_ms(flops: float, nbytes: float, flop_rate: float, exps: float = 0.0):
    """(ms, "bytes" | "operations"): the least time for the work: the larger
    of its bytes over HBM bandwidth, its FLOPs over the peak of their type
    and its exponentials over the SFUs' rate."""
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / flop_rate, exps / EXP_RATE if exps else 0.0)
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def build_pipeline(dtype, impl, seed=0, version="1.5"):
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion
    from stable_diffusion_tpu_torch.utils.weights import init_random_

    pipe = StableDiffusion.for_version(version, device="cuda", dtype=dtype, impl=impl)
    for i, m in enumerate((pipe.unet, pipe.text_encoder, pipe.vae)):
        init_random_(m, seed + i)
    return pipe


class switches:
    """The JAX package's kernel switches (SD_TPU_FUSED_MM, SD_TPU_WINOGRAD)
    set on or off inside the block, and restored after it."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in SWITCHES_ON}
        for k, v in SWITCHES_ON.items():
            os.environ[k] = v if self.on else "0"

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def request_ids(seed: int, batch: int = 1):
    rng = np.random.default_rng(seed)
    cond = rng.integers(0, 49408, (batch, 77))
    uncond = np.zeros((batch, 77), np.int64)
    return cond, uncond


# ---------------------------------------------------------------------------
# Phases 3 and 6: every kernel at every main-path shape vs its plain version
# ---------------------------------------------------------------------------


def _w8a8_case(kernel: str, key, gen):
    """``_case`` for K7-K9: int8 codes and scales of seeded N(0, 1/fan_in)
    weights, the activation range calibrated on the case's own input, the
    bf16 counterpart at the same shape on the same weights dequantized
    (``bf16``), and ``plain_once``: the plain version's int8 products run in
    f64 for exactness, so it is timed over one call."""
    from stable_diffusion_tpu_torch.ops import conv, ffn, linear
    from stable_diffusion_tpu_torch.ops.groupnorm import gn_scale_shift_plain
    from stable_diffusion_tpu_torch.ops.quantize import act_step, quantize_act, quantize_tensor

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).bfloat16()

    def q8(n, k):  # codes, scales, and the dequantized bf16 weight
        q, sc = quantize_tensor(torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5,
                                axis=1)
        return q, sc.reshape(-1), (q.float() * sc).bfloat16()

    def f32(t):
        return t.float() if t is not None and t.dtype == torch.bfloat16 else t

    library = None
    if kernel == "K7":
        b, h, w_, cin, cout, prologue = key
        assert prologue, "the W8A8 path runs K7 with its GroupNorm+SiLU prologue"
        x = rn(b, h, w_, cin)
        q, sc, wd = q8(cout, 9 * cin)
        wq, wd = (t.reshape(cout, 3, 3, cin).permute(0, 3, 1, 2).contiguous() for t in (q, wd))
        gw, gb, bias = 1 + rn(cin, scale=0.1), rn(cin, scale=0.1), rn(cout, scale=0.1)
        act = conv.gn_silu_prologue(x.float(), gn_scale_shift_plain(x, gw, gb)).abs().amax()
        args = [x, gw, gb, wq, sc, act, bias]

        def run(*a, impl):
            return conv.gn_silu_conv3x3_w8a8(*a, impl=impl)

        def bf16():
            return conv.gn_silu_conv3x3(x, gw, gb, wd, bias, impl="cuda")
        px = b * h * w_
        # the product-only yardstick: the codes' im2col (M x 9 Cin, tap-major
        # as the weight's (Cout, 3, 3, Cin) rows) times the weight, on int32
        xq = quantize_act(conv.gn_silu_prologue(x, gn_scale_shift_plain(x, gw, gb)),
                          act_step(act, floor=True))
        xp = F.pad(xq.view(torch.uint8), (0, 0, 1, 1, 1, 1)).view(torch.int8)
        cols = torch.stack([xp[:, ky:ky + h, kx:kx + w_] for ky in range(3) for kx in range(3)],
                           dim=3).reshape(px, 9 * cin)
        wmat = q.reshape(cout, 9 * cin)
        del xq, xp

        def library():
            return torch._int_mm(cols, wmat.t())
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = conv.conv3x3_q_plan(b, h, w_, cin, cout, sms) if hasattr(conv, "conv3x3_q_plan") else None
        work = dict(flops=2 * px * cin * cout * 9,
                    bytes=2 * px * (cin + cout) + 9 * cin * cout + 6 * cout + b * 2 * cin * 4)
        if plan is not None:
            tiles, cols_n, _ = plan.grid(b, h, w_, cout)
            # the design's own traffic: x read and its codes written once,
            # each tile's halo of codes read per column block, the weight
            # streamed by every tile, y written once, split-K sums added by
            # each part and read back once
            work.update(design_bytes=3 * px * cin + tiles * cols_n * (plan.th + 2) * (plan.tw + 2) * cin
                        + 9 * cin * cout * tiles + 2 * px * cout + 6 * cout
                        + (4 * px * cout * (plan.ksplit + 2) if plan.ksplit > 1 else 0),
                        note=f"plan=({plan.th}x{plan.tw}, bm {plan.bm}, bn {plan.bn}, stages "
                             f"{plan.stages}) ksplit={plan.ksplit} smem={plan.smem}")
    elif kernel == "K8":
        m, k, n, ln, res = key
        x = rn(m, k, scale=2.0)
        q, sc, wd = q8(n, k)
        bias = rn(n, scale=0.1)
        lw, lb = (1 + rn(k, scale=0.1), rn(k, scale=0.1)) if ln else (None, None)
        r = rn(m, n) if res else None
        h = linear.layer_norm_plain(x, lw, lb) if ln else x
        act = h.float().abs().amax()
        args = [x, q, sc, act, bias, r, lw, lb]

        def run(x, q, sc, act, bias, r, lw, lb, impl):
            if lw is None:
                return linear.matmul_w8a8(x, q, sc, act, bias, residual=r, impl=impl)
            return linear.ln_matmul_w8a8(lw, lb, x, q, sc, act, bias, residual=r, impl=impl)

        def bf16():  # the bf16 path's LN (layers.layer_norm) included, as in K8
            y = F.linear(linear.layer_norm_plain(x, lw, lb) if ln else x, wd, bias)
            return y if r is None else y + r
        # torch._int_mm takes M > 16 only: the time embeddings' rows are
        # zero-padded to 32 for it
        xq = quantize_act(h, act_step(act))
        if m <= 16:
            xq = torch.cat([xq, xq.new_zeros(32 - m, k)])

        def library():
            return torch._int_mm(xq, q.t())
        plan = linear.linear_q_plan(m, k, n, torch.cuda.get_device_properties(0).multi_processor_count)
        rb = -(-m // plan.bm)
        work = dict(flops=2 * m * k * n,
                    bytes=2 * m * k + n * k + 2 * m * n * (2 if res else 1) + 6 * n
                    + (4 * k if ln else 0),
                    # the design's own traffic: x read once and its int8 rows
                    # written once, those read by each N split, the weight by
                    # each row block, y (and the residual) once, split-K sums
                    # added by each part and read back once
                    design_bytes=3 * m * k + m * k * plan.nsplit
                    + n * k * rb + 2 * m * n * (2 if res else 1) + 6 * n
                    + (4 * m * n * (plan.ksplit + 2) if plan.ksplit > 1 else 0),
                    note=f"plan={plan.variant} nsplit={plan.nsplit} ksplit={plan.ksplit} "
                         f"smem={plan.smem}")
    else:  # K9
        m, c, hidden, ln, res = key
        assert ln and res, "the W8A8 path runs K9 with its LayerNorm and residual"
        x = rn(m, c)
        lw, lb = 1 + rn(c, scale=0.1), rn(c, scale=0.1)
        q1, s1, w1d = q8(2 * hidden, c)
        q2, s2, w2d = q8(c, hidden)
        b1, b2, r = rn(2 * hidden, scale=0.1), rn(c, scale=0.1), rn(m, c)
        hn = linear.layer_norm_plain(x.float(), lw.float(), lb.float())
        act1 = hn.abs().amax()
        hh = linear.matmul_w8a8_plain(hn, q1, s1, act1, b1.float())
        act2 = (hh[:, :hidden] * F.gelu(hh[:, hidden:])).abs().amax()
        del hn, hh
        args = [x, lw, lb, q1, s1, b1, act1, q2, s2, b2, act2, r]

        def run(*a, impl):
            return ffn.geglu_ffn_w8a8(*a, impl=impl)

        def bf16():
            return ffn.geglu_ffn(x, lw, lb, w1d, b1, w2d, b2, r, impl="cuda")
        # the product-only yardstick: both int8 products on seeded codes
        xq = torch.randint(-127, 128, (m, c), generator=gen, device="cuda", dtype=torch.int8)
        hq = torch.randint(-127, 128, (m, hidden), generator=gen, device="cuda", dtype=torch.int8)

        def library():
            torch._int_mm(xq, q1.t())
            return torch._int_mm(hq, q2.t())
        work = dict(flops=6 * m * c * hidden, bytes=6 * m * c + 3 * c * hidden + 12 * hidden + 10 * c)
        if hasattr(ffn, "ffn_q_plan"):
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            plan = ffn.ffn_q_plan(m, c, hidden, sms)
            cols2, rows2 = plan.grid2(m, c)
            # the design's own traffic: x read and its codes written once,
            # read by each G1 split; W1 by each row block; h written once,
            # read by each G2 column block; W2 by each G2 row block; out and
            # the residual once
            work.update(design_bytes=3 * m * c + m * c * plan.nsplit1
                        + 2 * hidden * c * -(-m // plan.g1[0]) + m * hidden * (1 + cols2)
                        + c * hidden * rows2 + 4 * m * c + 12 * hidden + 10 * c,
                        note=f"plan=G1 {plan.g1} nsplit1={plan.nsplit1} G2 {plan.g2}")
    return dict(kernel=lambda: run(*args, impl="cuda"), plain=lambda: run(*args, impl="torch"),
                ref=lambda: run(*map(f32, args), impl="torch"), library=library, bf16=bf16,
                plain_once=True, rate=INT8_TC_OPS, args=args, **work)


def _switched_case(kernel: str, key, gen):
    """``_case`` for K10-K12, the kernels behind the JAX package's switches:
    the caller holds the switches on; ``bf16`` runs the same entry with them
    off (the route the kernel replaces).  K12 also carries ``bar``: its error
    against the f32 direct conv (TF32 off) within WINOGRAD_VS_DIRECT of
    K2's on the same inputs."""
    from stable_diffusion_tpu_torch.ops import conv, groupnorm, linear, winograd

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).bfloat16()

    def f32(t):
        return t.float() if t is not None else t

    def unswitched(fn):
        def run():
            with switches(False):
                return fn()
        return run

    bar = None
    if kernel == "K10":
        m, k, n, ln, res = key
        x, w, bias = rn(m, k, scale=2.0), rn(n, k, scale=k ** -0.5), rn(n, scale=0.1)
        lw, lb = (1 + rn(k, scale=0.1), rn(k, scale=0.1)) if ln else (None, None)
        r = rn(m, n) if res else None
        args = [x, w, bias, r, lw, lb]

        def run(x, w, bias, r, lw, lb, impl):
            if lw is not None:
                return linear.ln_matmul(lw, lb, x, w, bias, impl=impl)
            return linear.matmul_residual(x, w, bias, r, impl=impl)

        def library():
            return F.linear(x, w, bias)
        plan = linear.linear_plan(m, k, n, "ln" if ln else "none",
                                  torch.cuda.get_device_properties(0).multi_processor_count)
        work = dict(note=plan_note(plan),
                    flops=2 * m * k * n, bytes=2 * (m * k + n * k + m * n * (2 if res else 1) + n)
                    + (4 * k if ln else 0))
    elif kernel == "K11":
        b, rows, k, n = key
        x = rn(b, rows, 1, k, scale=2.0) + 0.5
        gw, gb = 1 + rn(k, scale=0.1), rn(k, scale=0.1)
        w, bias = rn(n, k, scale=k ** -0.5), rn(n, scale=0.1)
        args = [x, gw, gb, w, bias]

        def run(x, gw, gb, w, bias, impl):
            return linear.gn_matmul(x, gw, gb, w, bias, eps=1e-6, impl=impl)

        def library():
            return F.linear(x, w, bias)
        m = b * rows
        ss = groupnorm.gn_scale_shift(x, gw, gb, eps=1e-6, impl="cuda")
        plan = linear.linear_plan(m, k, n, "gn", torch.cuda.get_device_properties(0).multi_processor_count)
        # the K11 launch alone, on K1's statistics taken once (the entry
        # point's time includes that launch)
        work = dict(note=plan_note(plan), also=dict(k11_launch=lambda: linear.linear_kernel(
                        x, w, bias, scale_shift=ss)),
                    flops=2 * m * k * n, bytes=2 * (m * k + n * k + m * n + n + 2 * k))
    else:  # K12
        b, h, w_, cin, cout, prologue = key
        x = rn(b, h, w_, cin)
        wt, bias = rn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5), rn(cout, scale=0.1)
        gw, gb = 1 + rn(cin, scale=0.1), rn(cin, scale=0.1)
        if prologue:
            def run(x, gw, gb, wt, bias, impl):
                return conv.gn_silu_conv3x3(x, gw, gb, wt, bias, impl=impl)
            args = [x, gw, gb, wt, bias]
        else:
            def run(x, wt, bias, impl):
                return conv.conv3x3(x, wt, bias, impl=impl)
            args = [x, wt, bias]

        def library():
            return F.conv2d(x.permute(0, 3, 1, 2), wt, bias, padding=1)

        def bar(got):
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                xin = (conv.gn_silu_prologue(x.float(), groupnorm.gn_scale_shift_plain(
                    x, gw, gb)) if prologue else x.float())
                truth = conv.conv3x3_plain(xin, wt.float(), bias.float())
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            with switches(False):
                direct = run(*args, impl="cuda").float()
            scale = truth.abs().max()
            e12 = ((got - truth).abs().max() / scale).item()
            e2 = ((direct - truth).abs().max() / scale).item()
            return e12 <= WINOGRAD_VS_DIRECT * max(e2, 1e-4), f"vs f32 direct {e12:.3e}, K2 {e2:.3e}"
        px = b * h * w_
        plan = winograd.winograd_plan(b, h, w_, cin, cout)
        # Winograd's own operations (JAX's cost estimate): 16 products per 4 outputs
        regions, cblocks = plan.grid
        halo = (2 * plan.region[0] + 2) * (2 * plan.region[1] + 2)
        work = dict(note=f"region={plan.region} grid={plan.grid} chunks={plan.chunks}",
                    flops=2 * px * 4 * cin * cout,
                    bytes=2 * (px * (cin + cout) + 16 * cin * cout + cout)
                    + (b * 2 * cin * 4 if prologue else 0),
                    # the design's own traffic: each block reads its region's
                    # halo at every input channel (and the scale/shift) and
                    # its 64 channels of U, and writes its outputs once
                    design_bytes=regions * cblocks * (2 * halo * cin + (2 * cin * 4 if prologue else 0))
                    + regions * 2 * 16 * cin * cout + 2 * px * cout + 2 * cout * regions,
                    plain_once=px * max(cin, cout) >= 2 ** 25)  # the VAE's 768^2 stages
    return dict(kernel=lambda: run(*args, impl="cuda"), plain=lambda: run(*args, impl="torch"),
                ref=lambda: run(*map(f32, args), impl="torch"), library=library,
                bf16=unswitched(lambda: run(*args, impl="cuda")), bar=bar, rate=BF16_TC_FLOPS,
                args=args, **work)


def k3_note(plan) -> str:
    """A K3 plan as phase 3's and --k3-sweep's lines name it: its body and
    the body's own parameters."""
    extra = {"ring": "", "general": f" passes={plan.passes}",
             "cross": f" nk={plan.nk} tiles={plan.tiles}",
             "wide": f" splits={plan.splits}"}[plan.body]
    return f"body={plan.body} bq={plan.bq}{extra}"


def k3_bodies(counters) -> dict:
    """K3's launches by body (the K3:<body> counters)."""
    return {k.split(":", 1)[1]: c.launches for k, c in counters.items() if k.startswith("K3:")}


def no_general_body(shapes_or_launches, label: str) -> bool:
    """Every K3 call of a path took the ring, cross or wide body: the
    general body's recorded shapes (a Counter) or launches (an int) are
    none; says so either way."""
    n = shapes_or_launches.get("K3:general", 0)
    n = sum(n.values()) if hasattr(n, "values") else n
    say(f"  {label}: K3 general-body launches {n} ({'ok' if n == 0 else 'BAD: a path took it'})")
    return n == 0


def plan_note(plan) -> str:
    """A K10/K11 plan as phase 8's and --k10-sweep's lines name it."""
    return (f"plan={plan.schedule}(bm={plan.bm},bn={plan.bn},stages={plan.variant[3]}) "
            f"nsplit={plan.nsplit} ksplit={plan.ksplit}")


def _case(kernel: str, key, gen):
    """A dict for one recorded shape key: ``kernel``, ``plain`` (bf16) and
    ``ref`` (plain on f32 copies) callables on the same random inputs,
    ``library`` (one PyTorch call computing the same function, or None),
    and the work: ``flops``, ``bytes`` and the peak ``rate`` of the FLOPs'
    type."""
    from stable_diffusion_tpu_torch.ops import conv, ffn, flash_attention as fa, groupnorm

    if kernel in W8A8_KERNELS:
        return _w8a8_case(kernel, key, gen)
    if kernel in SWITCHED_KERNELS:
        return _switched_case(kernel, key, gen)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).bfloat16()

    f32 = lambda ts: [t.float() for t in ts]  # noqa: E731
    library = None
    if kernel == "K1" and key[0] == "bwd":
        return _k1_bwd_case(key, rn)
    if kernel == "K1":
        kind, b, hw, c = key[:4]
        eps = key[5]
        x = rn(b, hw, 1, c, scale=2.0) + 0.5
        w, bias = 1 + rn(c, scale=0.1), rn(c, scale=0.1)
        nx = b * hw * c
        plan = groupnorm.gn_plan(b, hw, c, 32, torch.cuda.get_device_properties(0)
                                 .multi_processor_count)
        if kind == "stats":
            def run(x, w, bias, impl):
                return groupnorm.gn_scale_shift(x, w, bias, eps=eps, impl=impl)

            def library():
                return torch.var_mean(x.view(b, hw, 32, c // 32), dim=(1, 3))

            def raw():
                return groupnorm.gn_scale_shift_kernel(x, w, bias, eps=eps)
            work = dict(flops=3 * nx, bytes=nx * 2 + b * 2 * c * 4 + 4 * c, rate=F32_FLOPS)
        else:
            silu = key[6]

            def run(x, w, bias, impl):
                return groupnorm.group_norm_silu(x, w, bias, eps=eps, silu=silu, impl=impl)

            def library():
                y = F.group_norm(x.view(b, hw, c).transpose(1, 2), 32, w, bias, eps)
                return F.silu(y) if silu else y

            def raw():
                return groupnorm.group_norm_silu_kernel(x, w, bias, eps=eps, silu=silu)
            work = dict(flops=(9 if silu else 5) * nx, bytes=2 * nx * 2 + 4 * c, rate=F32_FLOPS)
        args = [x, w, bias]
        work.update(group=kind, host=raw, note=f"plan=vec{plan.vec} gs{plan.gs} r{plan.r} "
                    f"tiles{plan.tiles} chunks={plan.nchunks}")
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

        def library():
            return F.conv2d(x.permute(0, 3, 1, 2), wt, bias, padding=1)
        px = b * h * w_
        plan = conv.conv3x3_plan(b, h, w_, cin, cout,
                                 torch.cuda.get_device_properties(0).multi_processor_count)
        work = dict(flops=2 * px * cin * cout * 9,
                    bytes=2 * (px * (cin + cout) + 9 * cin * cout + cout)
                    + (b * 2 * cin * 4 if prologue else 0), rate=BF16_TC_FLOPS,
                    note=f"plan={plan.th}x{plan.tw} bn={plan.bn} ksplit={plan.ksplit}")
    elif kernel == "K3":
        b, sq, sk, h, d = key
        if sq == sk:  # the self-attention layout: q, k, v views of one fused QKV projection
            qkv = rn(b, sq, 3 * h * d)
            args = [t.reshape(b, sq, h, d) for t in qkv.split(h * d, dim=-1)]
        else:
            args = [rn(b, sq, h, d), rn(b, sk, h, d), rn(b, sk, h, d)]
        plan = fa.attention_plan(b, sq, sk, h, d, torch.cuda.get_device_properties(0)
                                 .multi_processor_count)

        def run(q, k, v, impl):
            return fa.attention(q, k, v, impl=impl)

        def library():
            return F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in args))
        # the general body (the first design) timed beside every shape
        first = fa.general_plan(d)
        also = {"general": lambda: fa.attention_kernel(*args, _plan=first)}
        # device time (CUDA-graph replay, no host launch cost): the small
        # shapes' eager times are the host's
        device = {"kernel": lambda: fa.attention_kernel(*args), "general": also["general"],
                  "sdpa": library}
        group = f"wide d={d}" if plan.body == "wide" else plan.body
        # the plain version materializes B*H*Sq*Sk f32 scores: one call at s = 9216
        work = dict(flops=4 * b * h * sq * sk * d, bytes=2 * b * h * d * (2 * sq + 2 * sk),
                    exps=b * h * sq * sk, rate=BF16_TC_FLOPS, plain_once=sq * sk > 4096 * 4096,
                    also=also, device=device, group=group,
                    note=f"{k3_note(plan)} exps={b * h * sq * sk}")
    elif kernel == "K4":
        m, c = key[:2]
        hid = key[2] if len(key) > 2 else 4 * c  # a tensor-parallel shard's hidden width
        args = [rn(m, c), 1 + rn(c, scale=0.1), rn(c, scale=0.1), rn(2 * hid, c, scale=c ** -0.5),
                rn(2 * hid, scale=0.1), rn(c, hid, scale=hid ** -0.5), rn(c, scale=0.1),
                rn(m, c)]

        def run(*a, impl):
            return ffn.geglu_ffn(*a[:7], a[7], hidden=hid, impl=impl)
        plan = ffn.ffn_plan(m, c, torch.cuda.get_device_properties(0).multi_processor_count,
                            hidden=hid)
        nbytes = 2 * (3 * m * c + 3 * c * hid + 2 * hid + 3 * c)
        # the design's own device-memory bytes: the function's, h (M x H
        # bf16) written and read back, and the split-K partials (f32)
        design = nbytes + 2 * 2 * m * hid + (2 * 4 * plan.ksplit2 * m * c if plan.ksplit2 > 1 else 0)
        work = dict(flops=6 * m * c * hid, bytes=nbytes, rate=BF16_TC_FLOPS,
                    also={"g1": lambda: ffn.geglu_ffn_kernel(*args, hidden=hid, _parts=1),
                          "g2": lambda: ffn.geglu_ffn_kernel(*args, hidden=hid, _parts=2)},
                    note=f"plan=G1 {plan.g1} nsplit{plan.nsplit1} G2 {plan.g2} "
                         f"ksplit{plan.ksplit2} design_bytes={design} "
                         f"design_bound_ms={design / HBM_BYTES_PER_S * 1e3:.4f}")
    else:  # K5 / K6: the self-attention backward, q/k/v strided as the fused QKV's split
        b, s, h, d = key
        qkv = rn(b, s, 3 * h * d)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        do = rn(b, s, h, d)
        with torch.no_grad():
            o, lse2 = fa.attention_kernel(q, k, v, return_lse=True)
            _, lse, delta = fa.attention_bwd_dq_plain(q, k, v, o, do)
            _, delta_k = fa.attention_bwd_dq_kernel(q, k, v, o, lse2, do)
        plan = fa.attention_bwd_plan(b, s, h, d, torch.cuda.get_device_properties(0)
                                     .multi_processor_count)
        first = fa.AttentionBwdPlan("general", plan.dp)  # the first design, timed beside
        nbhsd = b * h * s * d
        # The gradient's least work (five S x S x D products; q, k, v, o, dO
        # read and dq, dk, dv written once) split between the two kernels:
        # K5 the five reads, S, dP, dQ and dq; K6 dK, dV, dk and dv.  The
        # recomputed S and dP of the two-kernel design are the kernels' cost.
        if kernel == "K5":
            args = [q, k, v, o, do]

            def kern(plan=None):
                return fa.attention_bwd_dq_kernel(q, k, v, o, lse2, do, _plan=plan)[0]

            def plain_fn(*a):
                return fa.attention_bwd_dq_plain(*a)[0]
            work = dict(flops=6 * nbhsd * s, bytes=2 * 6 * nbhsd, rate=BF16_TC_FLOPS,
                        note=f"body={plan.body} rows={plan.q_rows} tile={plan.k_tile}")
        else:
            args = [q, k, v, do, lse, delta]

            def kern(plan=None):
                return torch.stack(fa.attention_bwd_dkv_kernel(q, k, v, lse2, delta_k, do,
                                                               _plan=plan))

            def plain_fn(*a):
                return torch.stack(fa.attention_bwd_dkv_plain(*a))
            work = dict(flops=4 * nbhsd * s, bytes=2 * 2 * nbhsd, rate=BF16_TC_FLOPS,
                        note=f"body={plan.body} rows={plan.k_rows} tile={plan.q_tile}")
        if plan.body == "ring":
            work["also"] = {"general": lambda: kern(first)}
        return dict(kernel=kern, plain=lambda: plain_fn(*args),
                    ref=lambda: plain_fn(*(t.float() for t in args)), library=None, **work)
    return dict(kernel=lambda: run(*args, impl="cuda"), plain=lambda: run(*args, impl="torch"),
                ref=lambda: run(*f32(args), impl="torch"), library=library, **work)


def _k1_bwd_case(key, rn):
    """``_case`` for K1's backward (a ("bwd", b, hw, c, dtype, groups, silu,
    affine) key): dx (and dgamma, dbeta when ``affine``) on the statistics
    K1's forward kept; plain: the VJP of ``group_norm_plain`` by autograd
    (the route the kernel replaced); library: the backward of
    ``F.group_norm`` (+ ``F.silu``) on an NCHW copy, its forward taken once.
    Bytes: x and dy read and dx written once; the design's own: x and dy
    read twice."""
    from stable_diffusion_tpu_torch.ops import groupnorm

    _, b, hw, c, _, groups, silu, affine = key
    x = rn(b, hw, 1, c, scale=2.0) + 0.5
    w, bias = 1 + rn(c, scale=0.1), rn(c, scale=0.1)
    dy = rn(b, hw, 1, c)
    _, stats = groupnorm.KERNEL_OPS.norm(x, w, bias, groups, 1e-5, silu)
    need = (True, affine, affine)

    def vjp(x, w, bias, dy):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip((x, w, bias), need)]
            y = groupnorm.group_norm_plain(*ins, groups, 1e-5, silu)
            return torch.autograd.grad(y, [t for t in ins if t.requires_grad], dy)[0]

    nchw = [t.view(b, hw, c).transpose(1, 2).contiguous() for t in (x, dy)]
    with torch.enable_grad():
        lib_in = [nchw[0].requires_grad_(), w.detach().requires_grad_(affine),
                  bias.detach().requires_grad_(affine)]
        y = F.group_norm(lib_in[0], groups, lib_in[1], lib_in[2], 1e-5)
        y = F.silu(y) if silu else y

    def library():
        return torch.autograd.grad(y, [t for t in lib_in if t.requires_grad], nchw[1],
                                   retain_graph=True)

    def kernel():
        return groupnorm.group_norm_bwd_kernel(x, dy, w, bias, stats, num_groups=groups, silu=silu,
                                               affine=affine)[0]
    nx = b * hw * c
    plan = groupnorm.gn_bwd_plan(b, hw, c, groups, torch.cuda.get_device_properties(0)
                                 .multi_processor_count)
    return dict(kernel=kernel, plain=lambda: vjp(x, w, bias, dy),
                ref=lambda: vjp(x.float(), w.float(), bias.float(), dy.float()), library=library,
                flops=(20 if silu else 10) * nx, bytes=3 * 2 * nx + 4 * c,
                design_bytes=5 * 2 * nx + 4 * c, rate=F32_FLOPS, group="bwd", host=kernel,
                note=f"plan=vec{plan.vec} gs{plan.gs} chunk{plan.chunk} chunks={plan.nchunks} "
                     f"silu={silu} affine={affine}")


def check_kernels(shapes, kernels, label: str):
    """Each kernel at each recorded shape: error against plain f32, and the
    kernel, plain, library and bound times.  Totals are per pass: each
    shape's time per call times its calls in the recorded run."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    summary, ok = {}, True
    for kernel in kernels:
        keys = sorted(shapes[kernel], key=str)
        if not keys:
            raise RuntimeError(f"{kernel}: the {label} path gave it no shape")
        tot = dict(err=0.0, rel=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   bf16_ms=0.0, ms_at_library_shapes=0.0)
        lib_shapes = 0
        by = {"bytes": 0.0, "operations": 0.0}
        tot_also, groups = {}, {}
        # host microseconds a call (kernels with a raw launcher, K1): at each
        # group's smallest shape, where the device is quickest
        smallest = {}
        for key in keys:
            size = int(np.prod([v for v in key if type(v) is int]))
            grp = key[0]
            if grp not in smallest or size < smallest[grp][0]:
                smallest[grp] = (size, key)
        for key in keys:
            case = _case(kernel, key, gen)
            got = case["kernel"]().float()
            ref = case["ref"]().float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            rel = err / max(ref.abs().max().item(), 1e-30)
            good = bool(torch.isfinite(got).all().item()) and rel <= KERNEL_REL_TOL
            bar_msg = ""
            if case.get("bar") is not None:
                bar_ok, bar_msg = case["bar"](got)
                good &= bar_ok
                bar_msg += " "
            ok &= good
            del got, ref
            note = f"{case['note']} " if case.get("note") else ""
            n = shapes[kernel][key]
            k_ms = cuda_ms(case["kernel"])
            p_ms = cuda_ms(case["plain"], **(dict(reps=1, rounds=1, warmup=1)
                                             if case.get("plain_once") else {}))
            lib_ms = cuda_ms(case["library"]) if case["library"] is not None else None
            bf_ms = cuda_ms(case["bf16"]) if case.get("bf16") is not None else None
            also = {name: cuda_ms(fn) for name, fn in case.get("also", {}).items()}
            also.update({f"{name}_dev": graph_ms(fn) for name, fn in case.get("device", {}).items()})
            h_us = (host_us(case["host"]) if case.get("host") is not None
                    and smallest[key[0]][1] == key else None)
            b_ms, b_by = bound_ms(case["flops"], case["bytes"], case["rate"], case.get("exps", 0))
            d_ms = (bound_ms(case["flops"], case["design_bytes"], case["rate"])[0]
                    if case.get("design_bytes") is not None else None)
            tot["err"], tot["rel"] = max(tot["err"], err), max(tot["rel"], rel)
            tot["ms"] += n * k_ms
            tot["plain_ms"] += n * p_ms
            tot["bound_ms"] += n * b_ms
            by[b_by] += n * b_ms
            if d_ms is not None:
                tot["design_bound_ms"] = tot.get("design_bound_ms", 0.0) + n * d_ms
            if lib_ms is not None:
                tot["library_ms"] += n * lib_ms
                tot["ms_at_library_shapes"] += n * k_ms
                lib_shapes += 1
            tot["bf16_ms"] += n * (bf_ms or 0.0)
            for name, ms in also.items():
                tot_also[name] = tot_also.get(name, 0.0) + n * ms
            if case.get("group"):
                grp = groups.setdefault(case["group"], dict(shapes=0, calls=0, ms=0.0, plain_ms=0.0,
                                                            library_ms=0.0, bound_ms=0.0))
                grp["shapes"] += 1
                grp["calls"] += n
                grp["ms"] += n * k_ms
                grp["plain_ms"] += n * p_ms
                grp["library_ms"] += n * (lib_ms or 0.0)
                grp["bound_ms"] += n * b_ms
                if h_us is not None:
                    grp["host_us"] = h_us
                for name, ms in also.items():
                    grp[f"{name}_ms"] = grp.get(f"{name}_ms", 0.0) + n * ms
            del case
            shown = tuple(str(s).replace("torch.", "") for s in key)
            say(f"  {label} {kernel} {'ok ' if good else 'BAD'} shape={shown} {note}calls={n} "
                f"max_abs_err={err:.3e} rel={rel:.3e} {bar_msg}kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                f"library_ms={'-' if lib_ms is None else f'{lib_ms:.4f}'} "
                + ("" if bf_ms is None else f"bf16_ms={bf_ms:.4f} ")
                + "".join(f"{name}_ms={ms:.4f} " for name, ms in also.items())
                + ("" if h_us is None else f"host_us={h_us:.2f} ")
                + f"bound_ms={b_ms:.4f} ({b_by})"
                + ("" if d_ms is None else f" design_bound_ms={d_ms:.4f}"))
        summary[kernel] = dict(
            shapes=len(keys), max_abs_err=tot["err"], max_rel_err=tot["rel"], ms=tot["ms"],
            plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by=max(by, key=by.get),
            library_ms=tot["library_ms"] if KERNELS[kernel]["library"] else None)
        if KERNELS[kernel].get("bf16"):
            summary[kernel]["bf16_ms"] = tot["bf16_ms"]
        if "design_bound_ms" in tot:
            # computed from the plan's own bytes, not measured: text only
            summary[kernel]["design_bound_ms"] = tot["design_bound_ms"]
            say(f"  {label} {kernel} design_bound_ms per pass (computed) = "
                f"{tot['design_bound_ms']:.4f}")
        if tot_also:
            summary[kernel]["also_ms"] = tot_also
        if groups:
            summary[kernel]["groups"] = groups
            say(f"  {label} {kernel} by kind, per pass: " + "; ".join(
                f"{name} {g['calls']} calls {g['ms']:.3f} ms (plain {g['plain_ms']:.3f}, library "
                f"{g['library_ms']:.3f}, bound {g['bound_ms']:.3f})"
                + (f", host {g['host_us']:.2f} us a call"
                                                 if "host_us" in g else "")
                for name, g in groups.items()))
        if KERNELS[kernel]["library"] and lib_shapes < len(keys):
            summary[kernel].update(library_shapes=lib_shapes,
                                   ms_at_library_shapes=tot["ms_at_library_shapes"])
    return ok, summary


def attention_bwd_pair(shapes, gen):
    """K5 + K6 as the one function they compute, per train pass: the bound
    of the whole self-attention gradient (10 B H S^2 D FLOP; q, k, v, o, dO
    read and dq, dk, dv written once) and the time of the library call for
    it, the backward of F.scaled_dot_product_attention; each shape's figure
    times its calls."""
    pair_bound = pair_lib = 0.0
    for key, n in sorted(shapes["K5"].items(), key=str):
        b, s, h, d = key
        nbhsd = b * h * s * d
        b_ms = bound_ms(10 * nbhsd * s, 2 * 8 * nbhsd, BF16_TC_FLOPS)[0]
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda").bfloat16()
                   .requires_grad_() for _ in range(3))
        out = F.scaled_dot_product_attention(q, k, v)
        g = torch.randn_like(out)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True))
        pair_bound += n * b_ms
        pair_lib += n * lib_ms
        say(f"  train K5+K6 shape={key} calls={n} bound_ms={b_ms:.4f} sdpa_backward_ms={lib_ms:.4f}")
        del q, k, v, out, g
    return pair_bound, pair_lib


def record_main_path_shapes(pipe, counters, batch: int = 1, img_size=(512, 512)):
    """Run the main path once (1 DDIM step: every step gives the kernels the
    same shapes) with per-shape launch counting on."""
    for c in counters.values():
        c.record()
    cond, uncond = request_ids(99, batch)
    pipe.generate(cond, uncond, img_size=img_size, inference_steps=1, seed=99,
                  output_dtype="uint8")
    torch.cuda.synchronize()
    return {k: c.stop_recording() for k, c in counters.items()}


# ---------------------------------------------------------------------------
# Phase 4: full-size golden
# ---------------------------------------------------------------------------


def phase_golden(version="1.5", variants=(("bf16 kernels", False),)):
    """The full UNet of ``version`` against its CPU-made JAX golden: plain
    f32 (TF32 off), then each variant (the kernels in bf16, with the
    switches off or on) against that f32 result.  SD1.5:
    tests/golden/full_sd15_ddim2.npz, 64^2 latents, epsilon; SD2.1:
    tests/golden/full_sd21_ddim2.npz, 96^2 latents, v-prediction."""
    from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
    from stable_diffusion_tpu_torch.pipeline import scheduler_config_for
    from stable_diffusion_tpu_torch.schedulers import schedule as S
    from stable_diffusion_tpu_torch.utils import weights as W

    v1 = version.startswith("1")
    cfg, name, hw, ctx_dim = ((UNetConfig.sd15(), "full_sd15_ddim2.npz", 64, 768) if v1
                              else (UNetConfig.sd21(), "full_sd21_ddim2.npz", 96, 1024))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want = np.load(os.path.join(REPO, "tests", "golden", name))["latents"]
    unet = W.build(UNet, cfg, device="cuda", dtype=torch.float32)
    params = W.philox_jax_params(unet, seed=7)
    unet.load_state_dict(W.from_jax_params(W.unflatten(params)), strict=True)
    del params
    rng = np.random.Generator(np.random.Philox(11))
    lat0 = rng.standard_normal((1, hw, hw, 4), dtype=np.float32)
    ctx = rng.standard_normal((1, 77, ctx_dim), dtype=np.float32) * 0.1
    sched = S.make_schedule(prediction_type=scheduler_config_for(version)["prediction_type"])
    ts = S.inference_timesteps(sched, 2, kind="ddim")
    prev = ts - sched.num_train_timesteps // 2
    table = torch.as_tensor(sched.alphas_hat, device="cuda")

    def denoise(model, dtype, impl):
        lat = torch.tensor(lat0, device="cuda", dtype=dtype)
        c = torch.tensor(ctx, device="cuda", dtype=dtype)
        with torch.no_grad():
            for t, pt in zip(ts.tolist(), prev.tolist()):
                out = model(lat, torch.full((1,), t, device="cuda"), c, impl=impl)
                lat = S.ddim_step(table, lat, t, pt, out, prediction_type=sched.prediction_type)
        return lat.float().cpu().numpy()

    got = denoise(unet, torch.float32, "torch")
    err = float(np.abs(got - want).max())
    say(f"  golden SD{version} f32 plain: max_abs_err={err:.3e} (tol {GOLDEN_ATOL}) "
        f"latent std={float(want.std()):.4f}")
    unet = unet.to(torch.bfloat16)
    ok, rels = err <= GOLDEN_ATOL, {}
    for label, on in variants:
        with switches(on):
            got16 = denoise(unet, torch.bfloat16, "cuda")
        rel = float(np.linalg.norm(got16 - got) / np.linalg.norm(got))
        rels[label] = rel
        ok &= rel <= GOLDEN_BF16_REL_L2 and bool(np.isfinite(got16).all())
        say(f"  golden SD{version} {label} vs f32 plain: rel_l2={rel:.3e} "
            f"(tol {GOLDEN_BF16_REL_L2}) max_abs_err={float(np.abs(got16 - got).max()):.3e}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del unet
    torch.cuda.empty_cache()
    return ok, err, rels


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


# ---------------------------------------------------------------------------
# Phase 6: static-W8A8 serving
# ---------------------------------------------------------------------------


def w8a8_pipeline(pipe):
    """A W8A8 copy of ``pipe``'s UNet, calibrated and quantized as bench.py's
    BENCH_INT8=full (linears and 3x3 convs), beside the bf16 text tower and
    VAE; and the calibration batches."""
    import copy

    from stable_diffusion_tpu_torch.models import layers
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion
    from stable_diffusion_tpu_torch.schedulers import schedule as S
    from stable_diffusion_tpu_torch.utils import quantize_model as QM

    gen = torch.Generator(device="cuda").manual_seed(77)
    cond, uncond = request_ids(77, W8A8_BATCH)
    table = torch.as_tensor(S.make_schedule().alphas_hat, device="cuda")
    with torch.no_grad():
        ids = torch.as_tensor(np.concatenate([uncond, cond]), device="cuda")
        ctx = pipe.text_encoder(ids, impl="cuda")
        batches = []
        for t in W8A8_CAL_T:
            x0, noise = (torch.randn((2 * W8A8_BATCH, 64, 64, 4), generator=gen, device="cuda")
                         .bfloat16() for _ in range(2))
            batches.append((S.forward_process(table, x0, t, noise),
                            torch.full((1,), t, dtype=torch.long, device="cuda"), ctx))

    def apply(m, b):
        with torch.no_grad():
            m(*b, impl="cuda")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unet = QM.quantize_unet_static(copy.deepcopy(pipe.unet), batches, impl="cuda")
    QM.quantize_convs(QM.calibrate_static_conv_activations(apply, unet, batches))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_lin = sum(isinstance(m, layers.QLinear) and m.w8a8 for m in unet.modules())
    n_conv = sum(isinstance(m, layers.QConv2d) and m.w8a8 for m in unet.modules())
    n_wo = sum(isinstance(m, layers.QConv2d) and not m.w8a8 for m in unet.modules())
    errs = QM.quantization_error(pipe.unet, unet)
    worst = max(errs, key=errs.get)
    say(f"  w8a8 calibration: {len(batches)} batches of UNet batch {2 * W8A8_BATCH} at t="
        f"{list(W8A8_CAL_T)}, {secs:.2f} s; act scales attached to {n_lin} linears and {n_conv} "
        f"resblock convs ({n_wo} weight-only 3x3 convs); quantization_error worst "
        f"{worst} {errs[worst]:.3e}, median {statistics.median(errs.values()):.3e} over "
        f"{len(errs)} layers")
    return StableDiffusion(unet, pipe.text_encoder, pipe.vae, impl="cuda"), batches


def check_w8a8_step(pipe, qpipe, batch):
    """One CFG UNet step (UNet batch 8) of the W8A8 kernels: against the
    plain W8A8 path in f32 (TF32 off) on the same int8 weights and scales,
    and against the unquantized bf16 UNet, as the same step with every act
    scale left at attach_act_scales' 1.0 is too.  Two witnesses place the
    first tolerance: the plain W8A8 path in bf16 against the same f32
    result (what bf16 activations alone cost), and the unquantized bf16
    UNet against it (one quantization's worth, which the tolerance must
    stay below)."""
    import copy

    from stable_diffusion_tpu_torch.utils import quantize_model as QM

    xt, t, ctx = batch
    rel = lambda a, b: (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()  # noqa: E731
    with torch.no_grad():
        got = qpipe.unet(xt, t, ctx, impl="cuda").float()
        bf16 = pipe.unet(xt, t, ctx, impl="cuda").float()
        plain16 = qpipe.unet(xt, t, ctx, impl="torch").float()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    q32 = copy.deepcopy(qpipe.unet).float()
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = q32(xt.float(), t, ctx.float(), impl="torch")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del q32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    unc = QM.attach_act_scales(copy.deepcopy(qpipe.unet), 1.0, convs=True)
    with torch.no_grad():
        got_unc = unc(xt, t, ctx, impl="cuda").float()
    del unc
    torch.cuda.empty_cache()
    r_plain, r_bf16, r_unc = rel(got, ref), rel(got, bf16), rel(got_unc, bf16)
    r_plain16, r_quant, r_k_p16 = rel(plain16, ref), rel(bf16, ref), rel(got, plain16)
    ok = (bool(torch.isfinite(got).all()) and r_plain <= W8A8_STEP_REL_L2 < r_quant
          and r_bf16 <= W8A8_VS_BF16_REL_L2 < r_unc)
    say(f"  w8a8 step (UNet batch {xt.shape[0]}, t={t.item()}): kernels vs plain f32 W8A8 "
        f"rel_l2={r_plain:.3e} (tol {W8A8_STEP_REL_L2}; plain f32 step {plain_s:.2f} s); "
        f"witnesses vs plain f32 W8A8: plain bf16 W8A8 {r_plain16:.3e}, unquantized bf16 UNet "
        f"{r_quant:.3e} (must exceed the tol); kernels vs plain bf16 W8A8 {r_k_p16:.3e}; vs bf16 "
        f"UNet rel_l2={r_bf16:.3e} (gate {W8A8_VS_BF16_REL_L2}); act scales at 1.0 vs bf16 "
        f"rel_l2={r_unc:.3e} (must exceed the gate) {'ok' if ok else 'BAD'}")
    return ok, dict(rel_plain=r_plain, rel_bf16=r_bf16, rel_uncalibrated=r_unc,
                    rel_plain_bf16=r_plain16, rel_quant=r_quant, rel_kernels_plain_bf16=r_k_p16)


def phase_w8a8(pipe, counters):
    qpipe, batches = w8a8_pipeline(pipe)
    # 1. every kernel of the path at the shapes of one b4 DDIM step (K1-K3
    # at UNet batch 8 and in the b4 VAE decode, K7-K9), against plain f32
    shapes = record_main_path_shapes(qpipe, counters, W8A8_BATCH)
    say("  w8a8 step shapes: " + ", ".join(f"{k} {len(shapes[k])} shapes {sum(shapes[k].values())} "
                                            f"calls" for k in (*W8A8_PATH_KERNELS, "K4")))
    ok_sg = no_general_body(shapes, "w8a8 path (one b4 DDIM step)")
    ok_k, summary = check_kernels(shapes, W8A8_PATH_KERNELS, "w8a8")
    ok_k &= ok_sg
    # 2. one CFG UNet step against the plain W8A8 path and the bf16 UNet
    ok_s, step = check_w8a8_step(pipe, qpipe, batches[1])
    # 3. two b4 requests through the W8A8 UNet, then one bf16 request
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    secs, imgs, ok_r = [], [], True
    for r in range(SERVE_REQUESTS):
        cond, uncond = request_ids(r, W8A8_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = qpipe.generate(cond, uncond, img_size=(512, 512), cfg_scale=7.5,
                             inference_steps=SERVE_STEPS, seed=2000 + r, output_dtype="uint8")
        secs.append(time.perf_counter() - t0)
        good = (img.shape == (W8A8_BATCH, 512, 512, 3) and img.dtype == np.uint8
                and int(img.max()) > int(img.min()))
        ok_r &= good
        imgs.append(img)
        say(f"  w8a8 request {r}: {secs[-1]:.3f} s shape={img.shape} dtype={img.dtype} "
            f"min={int(img.min())} max={int(img.max())} mean={float(img.mean()):.2f} "
            f"{'ok' if good else 'BAD'}")
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ok_r &= (all(launches[k] > 0 for k in W8A8_KERNELS) and launches["K4"] == 0
             and no_general_body(launches, "phase 6 requests"))
    torch.cuda.reset_peak_memory_stats()
    cond, uncond = request_ids(0, W8A8_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img16 = pipe.generate(cond, uncond, img_size=(512, 512), cfg_scale=7.5,
                          inference_steps=SERVE_STEPS, seed=2000, output_dtype="uint8")
    bf16_s = time.perf_counter() - t0
    peak16 = torch.cuda.max_memory_allocated() / 2 ** 30
    drift = np.abs(imgs[0].astype(np.float32) - img16.astype(np.float32)) / 255.0
    say(f"  bf16 b{W8A8_BATCH} request, request 0's ids and seed: {bf16_s:.3f} s, peak_mem "
        f"{peak16:.2f} GiB; W8A8 vs bf16 image drift |d| on [0, 1]: p50 "
        f"{np.percentile(drift, 50):.4f} p99 {np.percentile(drift, 99):.4f} max {drift.max():.4f}")
    del qpipe
    torch.cuda.empty_cache()
    ok = ok_k and ok_s and ok_r
    return ok, dict(summary=summary, launches=launches, secs=secs, peak_gib=peak, bf16_s=bf16_s,
                    bf16_peak_gib=peak16, drift_p99=float(np.percentile(drift, 99)), **step)


# ---------------------------------------------------------------------------
# Phase 7: training
# ---------------------------------------------------------------------------


def training_line(ok: bool, train) -> str:
    ts, tsum = train["secs"], train["summary"]
    return (f"phase 7 training: {'ok' if ok else 'FAIL'}, SD1.5 LoRA r128 DreamBooth "
            f"b{TRAIN_BATCH} 512^2, accumulation 2, EMA: s/step median {statistics.median(ts):.4f} "
            f"(min {min(ts):.4f}, max {max(ts):.4f}, {len(ts)} steps) "
            f"peak_mem={train['peak_gib']:.2f} GiB launches={train['launches']} "
            f"grad rel_l2={train['grad_rel']:.3e}; K5+K6 "
            f"{tsum['K5']['ms'] + tsum['K6']['ms']:.3f} ms "
            f"vs plain {tsum['K5']['plain_ms'] + tsum['K6']['plain_ms']:.3f}, SDPA backward "
            f"{train['pair_library_ms']:.3f}, bound {train['pair_bound_ms']:.3f} "
            f"(K5's {tsum['K5']['bound_ms']:.3f} + K6's {tsum['K6']['bound_ms']:.3f}) ms per step")


def train_setup(unet):
    """bench.py's train config on ``unet``: (step_fn, state, batch maker)."""
    from stable_diffusion_tpu_torch import training as T
    from stable_diffusion_tpu_torch.schedulers import schedule as S

    cfg = T.TrainConfig(rank=128, alpha=128.0, use_ema=True, gradient_checkpointing=False,
                        grad_accum_steps=2, lora_targets=TRAIN_TARGETS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = {"unet": unet}
    state = T.init_train_state(gen, base, cfg)
    step_fn = T.make_train_step(base, schedule=S.make_schedule(), train_cfg=cfg, impl="cuda")
    b = TRAIN_BATCH
    # the cached frozen encoders' outputs: constants of the instance/prior set
    fixed = {"latent_mean": torch.randn((b, 64, 64, 4), generator=gen, device="cuda").bfloat16(),
             "latent_std": F.softplus(torch.randn((b, 64, 64, 4), generator=gen,
                                                  device="cuda")).bfloat16(),
             "text_emb": torch.randn((b, 77, 768), generator=gen, device="cuda").bfloat16()}

    def batch():  # fresh t and noise every step
        t, noise, vnoise = T.sample_noise_for_latents(gen, (b, 64, 64, 4), dtype=torch.bfloat16)
        return {**fixed, "t": t, "noise": noise, "vae_noise": vnoise}

    return cfg, step_fn, state, batch


def check_train_grads(unet, cfg, batch):
    """One micro-step's LoRA gradients, kernels in bf16 against the plain
    f32 path (TF32 off) on the same weights, LoRA tree and (whole) batch."""
    from stable_diffusion_tpu_torch import training as T
    from stable_diffusion_tpu_torch.models import lora as L
    from stable_diffusion_tpu_torch.models.unet import UNet
    from stable_diffusion_tpu_torch.schedulers import schedule as S
    from stable_diffusion_tpu_torch.utils import weights as W
    from stable_diffusion_tpu_torch.utils.tree import tree_leaves

    gen = torch.Generator(device="cuda").manual_seed(5)
    lora = {"unet": L.init_lora(gen, unet, rank=cfg.rank, alpha=cfg.alpha,
                                targets=cfg.lora_targets)}
    for e in lora["unet"].values():  # B != 0, so A and alpha get gradients too
        e["lora_B"] = torch.randn(e["lora_B"].shape, generator=gen, device="cuda") * 1e-4
    table = torch.as_tensor(S.make_schedule().alphas_hat, device="cuda")
    loss16, g16 = T.loss_and_grad(lora, {"unet": unet}, batch, alphas_hat=table, train_cfg=cfg,
                                  impl="cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    unet32 = W.build(UNet, unet.cfg, device="cuda", dtype=torch.float32)
    unet32.load_state_dict(unet.state_dict())
    batch32 = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
    loss32, g32 = T.loss_and_grad(lora, {"unet": unet32}, batch32, alphas_hat=table,
                                  train_cfg=cfg, impl="torch")
    peak32 = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    a, b = tree_leaves(g16), tree_leaves(g32)
    num = sum(((x.float() - y) ** 2).sum() for x, y in zip(a, b)).sqrt().item()
    den = sum((y ** 2).sum() for y in b).sqrt().item()
    finite = all(bool(torch.isfinite(x).all()) for x in a)
    del unet32, g16, g32
    torch.cuda.empty_cache()
    rel = num / max(den, 1e-30)
    say(f"  train grads bf16 kernels vs f32 plain (b{len(batch['t'])}, {len(a)} leaves): "
        f"rel_l2={rel:.3e} (tol {TRAIN_GRAD_REL_L2}) loss {loss16.item():.5f} vs "
        f"{loss32.item():.5f}; f32 peak_mem={peak32:.2f} GiB")
    return finite and rel <= TRAIN_GRAD_REL_L2, rel


def _lora_checksum(lora) -> float:
    from stable_diffusion_tpu_torch.utils.tree import tree_leaves

    return float(sum(x.double().sum() for x in tree_leaves(lora)).item())


def phase_training(unet, counters):
    from stable_diffusion_tpu_torch.ops import flash_attention as fa

    cfg, step_fn, state, batch = train_setup(unet)
    # 1. the shapes of one step (the first warm-up)
    for c in counters.values():
        c.record()
    b0 = batch()
    state, _ = step_fn(state, b0)
    torch.cuda.synchronize()
    shapes = {k: c.stop_recording() for k, c in counters.items()}
    say("  train step shapes: " + ", ".join(f"{k} {len(shapes[k])} shapes "
                                            f"{sum(shapes[k].values())} calls" for k in TRAIN_KERNELS))
    # 2-3. every kernel at the step's shapes; K5/K6's occupancy and the pair
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for key in sorted(shapes["K5"], key=str):
        plan = fa.attention_bwd_plan(*key, sms)
        occ = fa.attention_bwd_occupancy(plan)
        say(f"  K5/K6 shape={key} plan={tuple(plan)} occupancy: " + "; ".join(
            f"{k} {o['registers']} registers, {o['spill_bytes']} spill bytes, "
            f"{o['smem_bytes']} smem bytes, {o['blocks_per_sm']} blocks/SM"
            for k, o in occ.items()))
    ok_sg = no_general_body(shapes, "train step")
    ok_k, summary = check_kernels(shapes, TRAIN_KERNELS, "train")
    ok_k &= ok_sg
    pair_bound, pair_lib = attention_bwd_pair(shapes, torch.Generator(device="cuda").manual_seed(7))
    # 4. gradients against the plain f32 path
    ok_g, grad_rel = check_train_grads(unet, cfg, b0)
    # 5. timed steps
    state, _ = step_fn(state, batch())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    secs, ok_s = [], True
    for i in range(TRAIN_STEPS):
        updates = state["opt_state"]["mini_step"] == cfg.grad_accum_steps - 1
        before = _lora_checksum(state["lora"])
        bt = batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, bt)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        changed = _lora_checksum(state["lora"]) != before
        good = np.isfinite(loss) and np.isfinite(gnorm) and changed == updates
        ok_s &= good
        say(f"  train step {i}: {secs[-1]:.4f} s loss={loss:.5f} grad_norm={gnorm:.4f} "
            f"lora {'updated' if changed else 'unchanged'} {'ok' if good else 'BAD'}")
    launches = {k: counters[k].launches for k in TRAIN_KERNELS}
    bodies = k3_bodies(counters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ok = (ok_k and ok_g and ok_s and all(n > 0 for n in launches.values())
          and no_general_body({"K3:general": bodies["general"]}, "phase 7 steps"))
    launches.update({f"K3:{b}": n for b, n in bodies.items()})
    return ok, dict(summary=summary, secs=secs, launches=launches, peak_gib=peak,
                    grad_rel=grad_rel, shapes=shapes, pair_bound_ms=pair_bound,
                    pair_library_ms=pair_lib)


# ---------------------------------------------------------------------------
# Phase 8: SD2.1 768^2, the kernel switches off and on
# ---------------------------------------------------------------------------


def _serve_sd21(pipe, counters, on: bool, requests: int):
    """``requests`` 768^2 b1 DDIM-50 CFG-7.5 requests (ids and seeds of
    requests 0, 1, ...) with the switches ``on``: seconds, images, launches."""
    for c in counters.values():
        c.reset()
    secs, imgs, ok = [], [], True
    with switches(on):
        for r in range(requests):
            cond, uncond = request_ids(r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = pipe.generate(cond, uncond, img_size=SD21_SIZE, cfg_scale=7.5,
                                inference_steps=SERVE_STEPS, seed=3000 + r, output_dtype="uint8")
            secs.append(time.perf_counter() - t0)
            good = (img.shape == (1, *SD21_SIZE, 3) and img.dtype == np.uint8
                    and int(img.max()) > int(img.min()))
            ok &= good
            imgs.append(img)
            say(f"  sd21 request {r} switches {'on' if on else 'off'}: {secs[-1]:.3f} s "
                f"shape={img.shape} min={int(img.min())} max={int(img.max())} "
                f"mean={float(img.mean()):.2f} {'ok' if good else 'BAD'}")
    return ok, secs, imgs, {k: c.launches for k, c in counters.items()}


def phase_sd21(counters):
    pipe = build_pipeline(torch.bfloat16, "cuda", seed=10, version="2.1")
    # (a) the shapes of one b1 CFG DDIM step, switches off and on
    with switches(False):
        off = record_main_path_shapes(pipe, counters, img_size=SD21_SIZE)
    with switches(True):
        on = record_main_path_shapes(pipe, counters, img_size=SD21_SIZE)
    for label, shapes in (("off", off), ("on", on)):
        say(f"  sd21 step shapes, switches {label}: " + ", ".join(
            f"{k} {len(v)} shapes {sum(v.values())} calls" for k, v in shapes.items() if v))
    # (b) K1-K4 at SD2.1's shapes; K10-K12 at every shape of the switched step
    ok_sg = no_general_body(off, "sd21 path, switches off") & no_general_body(on, "sd21 path, switches on")
    ok_k, summary = check_kernels(off, SERVING_KERNELS, "sd21")
    ok_k &= ok_sg
    with switches(True):
        ok_s, switched = check_kernels(on, SWITCHED_KERNELS, "sd21-switched")
    # (c) the SD2.1 golden
    ok_g, g_err, g_rels = phase_golden("2.1", (("bf16 kernels, switches off", False),
                                               ("bf16 kernels, switches on", True)))
    # (d) serving: two requests switches off, one on with request 0's ids and seed
    torch.cuda.reset_peak_memory_stats()
    ok_off, secs_off, imgs_off, launches_off = _serve_sd21(pipe, counters, False, SERVE_REQUESTS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ok_on, secs_on, imgs_on, launches_on = _serve_sd21(pipe, counters, True, 1)
    ok_off &= (all(launches_off[k] > 0 for k in SERVING_KERNELS)
               and all(launches_off[k] == 0 for k in SWITCHED_KERNELS))
    # switched on, K2 keeps the 12^2 stage (W < 16) and K1, K3, K4 run as before
    ok_on &= all(launches_on[k] > 0 for k in (*SERVING_KERNELS, *SWITCHED_KERNELS))
    ok_off &= no_general_body(launches_off, "phase 8 requests, switches off")
    ok_on &= no_general_body(launches_on, "phase 8 request, switches on")
    drift = np.abs(imgs_on[0].astype(np.float32) - imgs_off[0].astype(np.float32)) / 255.0
    say(f"  sd21 launches switches off {launches_off}; on {launches_on}; switched vs unswitched "
        f"image drift |d| on [0, 1]: p50 {np.percentile(drift, 50):.4f} p99 "
        f"{np.percentile(drift, 99):.4f} max {drift.max():.4f}; peak_mem {peak:.2f} GiB")
    del pipe
    torch.cuda.empty_cache()
    ok = ok_k and ok_s and ok_g and ok_off and ok_on
    return ok, dict(summary=summary, switched=switched, golden_err=g_err, golden_rels=g_rels,
                    secs_off=secs_off, secs_on=secs_on, launches_off=launches_off,
                    launches_on=launches_on, drift_p99=float(np.percentile(drift, 99)),
                    peak_gib=peak)


# ---------------------------------------------------------------------------
# Phase 9: img2img and inpaint (BASELINE config 2)
# ---------------------------------------------------------------------------


def request_image(seed: int) -> np.ndarray:
    """A (512, 512, 3) uint8 input image: smooth colour fields, two
    hard-edged rectangles and a little noise, from ``seed``."""
    rng = np.random.default_rng(seed)
    h = w = 512
    yy, xx = np.mgrid[0:h, 0:w] / np.float32(h)
    img = np.stack([128 + 100 * np.sin(6 * xx + seed), 128 + 100 * np.cos(5 * yy),
                    255 * xx * yy], axis=-1)
    for _ in range(2):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        img[y0:y0 + h // 3, x0:x0 + w // 4] = rng.integers(0, 256, 3)
    img += rng.standard_normal(img.shape) * 8
    return np.clip(img, 0, 255).astype(np.uint8)


def request_mask() -> np.ndarray:
    """A 200 x 250 rectangle to regenerate, (512, 512) uint8."""
    mask = np.zeros((512, 512), np.uint8)
    mask[150:350, 130:380] = 255
    return mask


def phase_vae_golden():
    """The full-width VAE encoder against tests/golden/full_vae_encode.npz
    (the JAX package's encode_moments on the CPU): plain f32 (TF32 off),
    then the kernels in bf16 against that f32 result (mean and std)."""
    from stable_diffusion_tpu_torch.models.vae import VAE, VAEConfig
    from stable_diffusion_tpu_torch.utils import weights as W

    g = np.load(os.path.join(REPO, "tests", "golden", "full_vae_encode.npz"))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vae = W.build(VAE, VAEConfig(), device="cuda", dtype=torch.float32)
    vae.load_state_dict(W.from_jax_params(W.unflatten(W.philox_jax_params(vae, seed=7))),
                        strict=True)
    rng = np.random.Generator(np.random.Philox(11))
    x = rng.random((1, 256, 256, 3), dtype=np.float32) * 2 - 1
    ok = bool(np.array_equal(x[0, 0, :8], g["image_head"]))
    xt = torch.tensor(x, device="cuda")
    with torch.no_grad():
        m, s = (t.float().cpu().numpy() for t in vae.encode_moments(xt, impl="torch"))
        vae = vae.to(torch.bfloat16)
        m16, s16 = (t.float().cpu().numpy() for t in vae.encode_moments(xt.bfloat16(), impl="cuda"))
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    err = max(float(np.abs(m - g["mean"]).max()), float(np.abs(s - g["std"]).max()))
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    centre = lambda a: a - a.mean(axis=(0, 1, 2))  # noqa: E731  the part the image drives
    rels = {"mean": rel(m16, m), "std": rel(s16, s), "mean_centred": rel(centre(m16), centre(m))}
    ok &= (err <= VAE_GOLDEN_ATOL and rels["mean"] <= GOLDEN_BF16_REL_L2
           and rels["std"] <= GOLDEN_BF16_REL_L2 and bool(np.isfinite(m16).all())
           and bool(np.isfinite(s16).all()))
    say(f"  golden VAE encoder f32 plain: max_abs_err={err:.3e} (tol {VAE_GOLDEN_ATOL}; golden mean "
        f"spread {float(g['mean'].std()):.4f}, std {float(g['std'].mean()):.4f} +- "
        f"{float(g['std'].std()):.4f}); bf16 kernels vs f32 plain: rel_l2 mean {rels['mean']:.3e}, "
        f"std {rels['std']:.3e} (tol {GOLDEN_BF16_REL_L2}), mean about its channel averages "
        f"{rels['mean_centred']:.3e} (not gated)")
    del vae
    torch.cuda.empty_cache()
    return ok, err, rels


def img2img_kwargs(**kw):
    """BASELINE config 2: 512^2, DDPM on the cosine schedule, strength 0.8 of
    50 steps, CFG 7.5."""
    return dict(dict(img_size=(512, 512), cfg_scale=7.5, strength=IMG2IMG_STRENGTH,
                     inference_steps=SERVE_STEPS, sampler="ddpm", use_cosine_schedule=True), **kw)


def check_img2img_short(pipe):
    """DDPM-4 at strength 0.5 (2 steps) at b4 on injected noise: the kernels
    in bf16 against the plain f32 path (TF32 off) on the same weights,
    relative L2 of the final latents.  ``pipe`` is f32 and leaves in bf16."""
    rng = np.random.default_rng(77)
    lat = (IMG2IMG_BATCH, 64, 64, 4)
    draws = dict(encode_noise=rng.standard_normal((1, *lat[1:]), dtype=np.float32),
                 latent_noise=rng.standard_normal(lat, dtype=np.float32),
                 step_noise=rng.standard_normal((2, *lat), dtype=np.float32))
    cond, uncond = request_ids(40, IMG2IMG_BATCH)
    kw = img2img_kwargs(input_image=request_image(40), inference_steps=4, strength=0.5,
                        return_latents=True, **draws)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe.impl = "torch"
    want = pipe.generate(cond, uncond, **kw)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    for m in (pipe.unet, pipe.text_encoder, pipe.vae):
        m.to(torch.bfloat16)
    pipe.impl = "cuda"
    got = pipe.generate(cond, uncond, **kw)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    ok = rel <= GOLDEN_BF16_REL_L2 and bool(np.isfinite(got).all())
    say(f"  img2img DDPM-4 strength 0.5 (2 steps) b{IMG2IMG_BATCH}, bf16 kernels vs plain f32: "
        f"rel_l2={rel:.3e} (tol {GOLDEN_BF16_REL_L2}) max_abs_err={float(np.abs(got - want).max()):.3e} "
        f"latent std={float(want.std()):.4f}")
    return ok, rel


def record_img2img_shapes(pipe, counters):
    """One img2img b4 pass with per-shape launch counting on: the text
    encode, the encoder at b1, one CFG UNet step at batch 8 (2 steps at
    strength 0.5: one runs), the decoder at b4."""
    for c in counters.values():
        c.record()
    cond, uncond = request_ids(98, IMG2IMG_BATCH)
    pipe.generate(cond, uncond, **img2img_kwargs(input_image=request_image(98), inference_steps=2,
                                                 strength=0.5, seed=98, output_dtype="uint8"))
    torch.cuda.synchronize()
    return {k: c.stop_recording() for k, c in counters.items()}


def phase_img2img(counters, card: str):
    from stable_diffusion_tpu_torch.pipeline import preprocess_mask

    ok_g, g_err, g_rels = phase_vae_golden()
    pipe = build_pipeline(torch.float32, "torch", seed=20)
    ok_short, short_rel = check_img2img_short(pipe)   # leaves pipe in bf16, impl "cuda"
    # (a) every K1-K4 shape of one img2img b4 pass, against plain f32
    shapes = record_img2img_shapes(pipe, counters)
    say("  img2img pass shapes: " + ", ".join(
        f"{k} {len(v)} shapes {sum(v.values())} calls" for k, v in shapes.items() if v))
    ok_k = no_general_body(shapes, "img2img path (one b4 pass)")
    ok_c, summary = check_kernels(shapes, SERVING_KERNELS, "img2img")
    ok_k &= ok_c
    # (b) the main path: two img2img b4 requests and one inpaint request
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    secs, imgs, ok_r = [], [], True
    for r in range(SERVE_REQUESTS):
        cond, uncond = request_ids(r, IMG2IMG_BATCH)
        image = request_image(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = pipe.generate(cond, uncond, **img2img_kwargs(input_image=image, seed=4000 + r,
                                                           output_dtype="uint8"))
        secs.append(time.perf_counter() - t0)
        good = (img.shape == (IMG2IMG_BATCH, 512, 512, 3) and img.dtype == np.uint8
                and int(img.max()) > int(img.min()))
        ok_r &= good
        imgs.append(img)
        say(f"  img2img request {r}: {secs[-1]:.3f} s shape={img.shape} min={int(img.min())} "
            f"max={int(img.max())} mean={float(img.mean()):.2f} {'ok' if good else 'BAD'}")
    cond, uncond = request_ids(7)
    image, mask = request_image(7), request_mask()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    painted = pipe.inpaint(cond, uncond, image, mask, **img2img_kwargs(seed=4100))
    inpaint_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    good = (painted.shape == (512, 512, 3) and painted.dtype == np.uint8
            and int(painted.max()) > int(painted.min()))
    # the latent cells outside the dilated mask keep the image's content
    # through the blend, so the output differs from the input most inside
    cells = preprocess_mask(mask, mask.shape)[0, :, :, 0]
    keep = np.repeat(np.repeat(~cells, 8, axis=0), 8, axis=1)
    d = np.abs(painted.astype(np.float32) - image.astype(np.float32))
    say(f"  inpaint request: {inpaint_s:.3f} s shape={painted.shape} min={int(painted.min())} "
        f"max={int(painted.max())}; |output - input| mean inside the mask's cells "
        f"{float(d[~keep].mean()):.2f}, outside {float(d[keep].mean()):.2f} {'ok' if good else 'BAD'}")
    ok_r &= good and all(launches[k] > 0 for k in SERVING_KERNELS) and all(
        launches[k] == 0 for k in KERNELS if k not in SERVING_KERNELS)
    ok_r &= no_general_body(launches, "phase 9 requests")
    say(f"  img2img launches over the requests: {launches}")
    # (c) repeatable: request 0 again, same ids, image and seed
    cond, uncond = request_ids(0, IMG2IMG_BATCH)
    again = pipe.generate(cond, uncond, **img2img_kwargs(input_image=request_image(0), seed=4000,
                                                         output_dtype="uint8"))
    same = bool(np.array_equal(again, imgs[0]))
    ok_r &= same
    say(f"  img2img request 0 repeated: {'the same uint8 image' if same else 'BAD: another image'}")
    # (d) one encode: the 512^2 b1 image to its latent (K1, K2, K3 and plain convs)
    x = torch.tensor(request_image(5)[None], device="cuda").bfloat16() / 127.5 - 1
    noise = torch.randn((1, 64, 64, 4), device="cuda").bfloat16()
    with torch.no_grad():
        encode_ms = cuda_ms(lambda: pipe.vae.encode(x, noise=noise, impl="cuda"), reps=3)
    say(f"  {card}: img2img b{IMG2IMG_BATCH} s/request {[round(t, 3) for t in secs]}, inpaint b1 "
        f"{inpaint_s:.3f} s, encode 512^2 b1 {encode_ms:.3f} ms, peak_mem {peak:.2f} GiB")
    del pipe
    torch.cuda.empty_cache()
    ok = ok_g and ok_short and ok_k and ok_r
    return ok, dict(summary=summary, launches=launches, secs=secs, inpaint_s=inpaint_s,
                    encode_ms=encode_ms, golden_err=g_err, golden_rels=g_rels,
                    short_rel=short_rel, peak_gib=peak)


def img2img_line(i2) -> str:
    return (f"512^2 DDPM cosine strength {IMG2IMG_STRENGTH} of {SERVE_STEPS}, CFG 7.5: b"
            f"{IMG2IMG_BATCH} s/request {[round(x, 3) for x in i2['secs']]}, inpaint b1 "
            f"{i2['inpaint_s']:.3f} s, encode {i2['encode_ms']:.3f} ms; encoder golden f32 "
            f"max_abs_err={i2['golden_err']:.3e}, bf16 rel_l2 mean {i2['golden_rels']['mean']:.3e} "
            f"std {i2['golden_rels']['std']:.3e}; short run rel_l2={i2['short_rel']:.3e}; "
            + ", ".join(f"{k} {v['shapes']} shapes max_rel={v['max_rel_err']:.2e} kernel "
                        f"{v['ms']:.2f} ms, bound {v['bound_ms']:.2f}"
                        for k, v in i2["summary"].items())
            + f" per pass; peak_mem {i2['peak_gib']:.2f} GiB")


# ---------------------------------------------------------------------------
# Phase 10: the inference CLI (inference_torch.py) at full SD1.5 width
# ---------------------------------------------------------------------------

CLI_DIR = os.path.join(REPO, "build", "cli")
CLI_PROMPT = "a photo of an astronaut riding a horse on the moon, highly detailed, trending on artstation"
# (label, flags, lanes a request): the CLI's defaults, DDIM with CFG, one-step b1 and b4
CLI_RUNS = (("ddpm 50, no CFG, b1", [], 1),
            ("ddim 50, CFG 7.5, b1", ["--sampler", "ddim", "--do_cfg", "--cfg_scale", "7.5"], 1),
            ("one-step b1", ["--one_step"], 1),
            ("one-step b4", ["--one_step", "--batch_size", "4"], 4))
# the kohya file's targets: linears and a 1x1 conv of the UNet, the text tower's linears
CLI_LORA = {"unet": ["encoder.down.0.block.0.1.transformer_block.attn1.q_proj",
                     "encoder.down.1.block.1.1.transformer_block.attn2.k_proj",
                     "bottleneck.1.conv_input", "bottleneck.1.transformer_block.ffn.0.proj",
                     "decoder.up.3.block.2.1.transformer_block.attn1.out_proj",
                     "decoder.up.2.block.0.1.conv_output"],
            "text_encoder": ["encoder.layers.0.self_attn.q_proj", "encoder.layers.11.mlp.fc1"]}
# The merged bf16 weight against W + delta in f32, element by element: the
# bf16 roundings of W (an f16 value), of the delta and of their sum, each
# within u = 2^-8 (bf16's unit roundoff) of its value, so |merged - (W +
# delta)| <= u (2 + u) (|W| + |delta|).
BF16_U = 2.0 ** -8
SD15_JSON = dict(
    unet={"_class_name": "UNet2DConditionModel", "block_out_channels": [320, 640, 1280, 1280],
          "attention_head_dim": 8, "cross_attention_dim": 768, "layers_per_block": 2,
          "in_channels": 4, "out_channels": 4, "sample_size": 64},
    text_encoder={"architectures": ["CLIPTextModel"], "hidden_size": 768, "intermediate_size": 3072,
                  "num_hidden_layers": 12, "num_attention_heads": 12, "hidden_act": "quick_gelu",
                  "vocab_size": 49408, "max_position_embeddings": 77},
    vae={"_class_name": "AutoencoderKL", "block_out_channels": [128, 256, 512, 512],
         "layers_per_block": 2, "norm_num_groups": 32, "latent_channels": 4})
CLI_MODELS = ("unet", "text_encoder", "vae")


def tests_module(name: str):
    """tests/<name>.py loaded from its file (an installed package named
    ``tests`` may shadow the repository's)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_cli_checkpoints(ldm_and_kohya: bool = True):
    """Full-width SD1.5 from a seed (init_random_ in f16 on the card), written
    under build/cli as a diffusers directory and (``ldm_and_kohya``) as one
    LDM .ckpt, with a synthesized CLIP vocabulary and (``ldm_and_kohya``) a
    rank-4 kohya file.  Returns the f16 source tensors (host) by model."""
    from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
    from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
    from stable_diffusion_tpu_torch.pipeline import scheduler_config_for
    from stable_diffusion_tpu_torch.utils import safetensors_io
    from stable_diffusion_tpu_torch.utils.weights import build

    TC = tests_module("torch_checkpoints")
    t0 = time.perf_counter()
    pipe = build_pipeline(torch.float16, "cuda", seed=30)
    src = {n: {k: v.cpu() for k, v in getattr(pipe, n).state_dict().items()} for n in CLI_MODELS}
    del pipe
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    TC.write_diffusers_dir(os.path.join(CLI_DIR, "sd15"), src["unet"], src["text_encoder"], src["vae"],
                           unet_config=SD15_JSON["unet"], text_config=SD15_JSON["text_encoder"],
                           vae_config=SD15_JSON["vae"], scheduler_config=scheduler_config_for("1.5"))
    t2 = time.perf_counter()
    if ldm_and_kohya:
        torch.save({"state_dict": TC.to_ldm(src["unet"], src["vae"], src["text_encoder"],
                                            version="1.5")}, os.path.join(CLI_DIR, "sd15.ckpt"))
    t3 = time.perf_counter()
    merges = TC.write_vocab(os.path.join(CLI_DIR, "tokenizer"))
    if ldm_and_kohya:
        modules = {"unet": build(UNet, UNetConfig.sd15(), device="meta"),
                   "text_encoder": build(CLIPTextModel, CLIPTextConfig.vit_l(), device="meta")}
        safetensors_io.save_file(TC.kohya_state(modules, CLI_LORA, rank=4, alpha=4.0, seed=31),
                                 os.path.join(CLI_DIR, "lora.safetensors"))
    n = sum(v.numel() for sd in src.values() for v in sd.values())
    say(f"  wrote SD1.5 in f16 ({n / 1e9:.3f} B parameters, {2 * n / 2 ** 30:.2f} GiB): seeded "
        f"weights {t1 - t0:.1f} s, diffusers directory {t2 - t1:.1f} s"
        + (f", LDM .ckpt (torch.save) {t3 - t2:.1f} s" if ldm_and_kohya else "")
        + f"; tokenizer of {len(merges)} merges"
        + (f"; kohya rank-4 file over {sum(map(len, CLI_LORA.values()))} targets"
           if ldm_and_kohya else ""))
    return src


def same_bits(pipe, src, label: str) -> bool:
    """Every tensor of the loaded bf16 modules equals its f16 source cast to
    bf16, bit for bit, and the key sets are the source's."""
    bad, n = [], 0
    for name in CLI_MODELS:
        sd = getattr(pipe, name).state_dict()
        if sorted(sd) != sorted(src[name]):
            bad.append(f"{name}: key sets differ")
            continue
        for k, v in sd.items():
            n += v.numel()
            if v.dtype != torch.bfloat16 or not torch.equal(v, src[name][k].to(v.device).to(v.dtype)):
                bad.append(f"{name}.{k}")
    say(f"  {label}: {n / 1e9:.3f} B parameters on {pipe.device} in bf16, "
        + ("bit for bit the source cast to bf16" if not bad else f"BAD: {len(bad)} differ, e.g. {bad[:3]}"))
    return not bad


def record_cli_shapes(model, counters):
    """K1-K4's shapes in one b1 no-CFG DDPM step (+ decode), one b1 and one
    b4 one-step pass: the UNet at batch 1 and 4."""
    for c in counters.values():
        c.record()
    ids = model.tokenize([CLI_PROMPT])
    model.generate(ids, None, do_cfg=False, img_size=(512, 512), inference_steps=1, sampler="ddpm",
                   seed=97, output_dtype="uint8")
    model.generate_in_one_step(ids, seed=97, output_dtype="uint8")
    model.generate_in_one_step(ids, batch_size=4, seed=98, output_dtype="uint8")
    torch.cuda.synchronize()
    return {k: c.stop_recording() for k, c in counters.items()}


def check_one_step(model, src):
    """One one-step b1 image, bf16 kernels against the plain f32 path on the
    same weights (the f16 source in f32) and latents, TF32 off: relative L2
    of the decodes in [-1, 1]."""
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion
    from stable_diffusion_tpu_torch.utils import model_converter as mc

    ref = StableDiffusion.for_version("1.5", device="cuda", dtype=torch.float32, impl="torch")
    for name in CLI_MODELS:
        mc.load_into(getattr(ref, name), src[name])
    ids = model.tokenize([CLI_PROMPT])
    lat = np.random.default_rng(61).standard_normal((1, 64, 64, 4), dtype=np.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want = ref.generate_in_one_step(ids, initial_latents=lat) * 2 - 1
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del ref
    torch.cuda.empty_cache()
    got = model.generate_in_one_step(ids, initial_latents=lat) * 2 - 1
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    ok = rel <= GOLDEN_BF16_REL_L2 and bool(np.isfinite(got).all())
    say(f"  one-step b1, bf16 kernels vs plain f32 on the same latents: rel_l2={rel:.3e} (tol "
        f"{GOLDEN_BF16_REL_L2}) max_abs_err={float(np.abs(got - want).max()):.3e} image std "
        f"{float(want.std()):.4f} {'ok' if ok else 'BAD'}")
    return ok, rel


def check_lora_merge(model, src, lora, label: str = "kohya merge"):
    """The merged bf16 weights against W + delta in f32 (W the f16 source),
    element by element in units of the rounding bound u (|W| + |delta|)
    (at most 2 + u), beside the unmerged W's distance in the same units
    (the delta the merge adds) and the largest error relative to
    max|W + delta|.  ``lora``: {"unet": {path: entry}[, "text_encoder": ...]}."""
    from stable_diffusion_tpu_torch.models.lora import lora_delta

    worst, weakest, rel, ok = 0.0, float("inf"), 0.0, True
    for target, entries in lora.items():
        params = dict(getattr(model, target).named_parameters())
        for path, entry in entries.items():
            w = params[f"{path}.weight"]
            base = src[target][f"{path}.weight"].to(w.device).float()
            delta = lora_delta({k: v.to(w.device).float() for k, v in entry.items()}).reshape(base.shape)
            ref = base + delta
            unit = BF16_U * (base.abs() + delta.abs()) + 1e-30
            err = ((w.float() - ref).abs() / unit).max().item()
            unmerged = ((base - ref).abs() / unit).max().item()
            rel = max(rel, (w.float() - ref).abs().max().item() / ref.abs().max().item())
            worst, weakest = max(worst, err), min(weakest, unmerged)
            ok &= err <= 2 + BF16_U < unmerged
    say(f"  {label}, {sum(map(len, lora.values()))} targets: max |merged - (W + delta)| / "
        f"(u (|W| + |delta|)) = {worst:.3f} (bound {2 + BF16_U:.4f}, u = 2^-8), the unmerged W's "
        f">= {weakest:.1f}; max|merged - (W + delta)| / max|W + delta| = {rel:.3e} "
        f"{'ok' if ok else 'BAD'}")
    return ok, rel


def _good_images(imgs, batch: int) -> bool:
    return len(imgs) == batch and all(a.shape == (512, 512, 3) and a.dtype == np.uint8
                                      and int(a.max()) > int(a.min()) for a in imgs)


def cli_requests(model, argv, batch: int, counters, label: str, card: str, seed: int):
    """One CLI run: ``inference_torch.main`` once (its own load, one request
    of ``batch`` lanes, img_0_*.jpg written) where PIL is present, then two
    timed requests through ``inference`` on the loaded ``model`` (one a
    call, their own seeds; arrays only without PIL).  K1-K4 must launch
    and no other kernel (nor K3's general body)."""
    import importlib.util
    import shutil

    import inference_torch as cli

    have_pil = importlib.util.find_spec("PIL") is not None
    for c in counters.values():
        c.reset()
    ok, out = True, os.path.join(CLI_DIR, "out")
    if have_pil:
        shutil.rmtree(out, ignore_errors=True)
        imgs = cli.main(argv + ["--n_samples", str(batch), "--seed", str(seed - 1)])
        files = sorted(os.listdir(out))
        ok &= _good_images(imgs, batch) and files == [f"img_0_{j}.jpg" for j in range(batch)]
    secs = []
    for r in range(SERVE_REQUESTS):
        args = cli.parse_args(argv + ["--n_samples", str(batch), "--seed", str(seed + r)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = cli.inference(args, model, save=False)
        secs.append(time.perf_counter() - t0)
        ok &= _good_images(imgs, batch)
    launches = {k: c.launches for k, c in counters.items()}
    ok &= all(launches[k] > 0 for k in SERVING_KERNELS) and all(
        launches[k] == 0 for k in KERNELS if k not in SERVING_KERNELS)
    ok &= no_general_body(launches, f"CLI {label}")
    say(f"  {card}: CLI {label}: s/request {[round(s, 3) for s in secs]} "
        + (f"(main(): {files} written; " if have_pil else "(no PIL on this machine: load_model + "
           "inference up to the arrays, no file written; ")
        + f"launches {{{', '.join(f'{k}: {launches[k]}' for k in KERNELS)}}}) {'ok' if ok else 'BAD'}")
    return ok, secs, launches


def phase_cli(counters, card: str):
    import shutil

    import inference_torch as cli
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion
    from stable_diffusion_tpu_torch.utils import model_converter as mc

    import importlib.util

    say("  on this machine: " + ", ".join(
        f"{m} {'present' if importlib.util.find_spec(m) else 'absent'}"
        for m in ("PIL", "safetensors", "transformers", "regex", "ftfy")))
    src = write_cli_checkpoints()
    argv = ["--model_path", os.path.join(CLI_DIR, "sd15"), "--tokenizer_dir",
            os.path.join(CLI_DIR, "tokenizer"), "--prompt", CLI_PROMPT, "--device", "cuda",
            "--output_dir", os.path.join(CLI_DIR, "out")]
    # (a) both checkpoints loaded on the card, bit for bit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = cli.load_model(cli.parse_args(argv))
    torch.cuda.synchronize()
    load_s = {"diffusers": time.perf_counter() - t0}
    ok_bits = same_bits(model, src, f"diffusers directory loaded by the CLI in {load_s['diffusers']:.2f} s")
    t0 = time.perf_counter()
    ldm = StableDiffusion.from_pretrained(os.path.join(CLI_DIR, "sd15.ckpt"), sd_version="1.5",
                                          dtype=torch.bfloat16, impl="cuda", device="cuda")
    torch.cuda.synchronize()
    load_s["ldm"] = time.perf_counter() - t0
    ok_bits &= same_bits(ldm, src, f"LDM .ckpt loaded in {load_s['ldm']:.2f} s")
    del ldm
    torch.cuda.empty_cache()
    # (b) K1-K4 at the batch-1 and batch-4 UNet's shapes
    shapes = record_cli_shapes(model, counters)
    say("  CLI pass shapes (b1 DDPM step + decode, one-step b1, one-step b4): " + ", ".join(
        f"{k} {len(v)} shapes {sum(v.values())} calls" for k, v in shapes.items() if v))
    ok_k = no_general_body(shapes, "CLI passes")
    ok_c, summary = check_kernels(shapes, SERVING_KERNELS, "cli")
    ok_k &= ok_c
    # (c) the one-step image against the plain f32 path
    ok_one, one_rel = check_one_step(model, src)
    # (d) the CLI's runs
    ok_r, secs, total = True, {}, {k: 0 for k in counters}
    for i, (label, extra, batch) in enumerate(CLI_RUNS):
        good, secs[label], launches = cli_requests(model, argv + extra, batch, counters, label, card,
                                                   seed=5000 + 10 * i)
        ok_r &= good
        total = {k: total[k] + launches[k] for k in total}
    del model
    torch.cuda.empty_cache()
    # (e) the kohya LoRA merged at load, then the defaults once more
    lora_argv = argv + ["--lora_ckpt", os.path.join(CLI_DIR, "lora.safetensors")]
    t0 = time.perf_counter()
    model = cli.load_model(cli.parse_args(lora_argv))
    torch.cuda.synchronize()
    load_s["diffusers + kohya"] = time.perf_counter() - t0
    ok_lora, lora_err = check_lora_merge(
        model, src, mc.load_lora_kohya(os.path.join(CLI_DIR, "lora.safetensors")))
    good, secs["ddpm 50, no CFG, b1, kohya LoRA"], launches = cli_requests(
        model, lora_argv, 1, counters, "ddpm 50, no CFG, b1, kohya LoRA", card, seed=5100)
    ok_r &= good
    total = {k: total[k] + launches[k] for k in total}
    del model
    torch.cuda.empty_cache()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    say(f"  {card}: load s {', '.join(f'{k} {v:.2f}' for k, v in load_s.items())}")
    ok = ok_bits and ok_k and ok_one and ok_r and ok_lora
    return ok, dict(summary=summary, launches=total, secs=secs, load_s=load_s, one_rel=one_rel,
                    lora_err=lora_err)


def cli_line(cl) -> str:
    return ("SD1.5 512^2 through inference_torch: load s "
            + ", ".join(f"{k} {v:.2f}" for k, v in cl["load_s"].items()) + "; s/request "
            + "; ".join(f"{k} {[round(x, 3) for x in v]}" for k, v in cl["secs"].items())
            + f"; one-step rel_l2={cl['one_rel']:.3e}; kohya merge max rel={cl['lora_err']:.3e}; "
            + ", ".join(f"{k} {v['shapes']} shapes max_rel={v['max_rel_err']:.2e} kernel "
                        f"{v['ms']:.2f} ms, bound {v['bound_ms']:.2f}" for k, v in cl["summary"].items())
            + " per pass set")


# ---------------------------------------------------------------------------
# Phase 11: DeepCache (generate(deepcache_interval=k)), bf16 and W8A8
# ---------------------------------------------------------------------------

DEEPCACHE_KS = (1, 2, 3)
DEEPCACHE_W8A8_K = 2    # the JAX package's deployed serving setup: b4 W8A8 + DeepCache k = 2
# bench.py:440 noted this p99 of |image(k = 2) - image(k = 1)| on [0, 1] on
# the TPU: printed beside the card's, not gated (another chip, other weights)
DEEPCACHE_TPU_P99 = 0.064


def record_split_step_shapes(unet, counters, batch: int, ctx_dim: int = 768):
    """The launch shapes of one full step through the split UNet
    (``forward_split`` at t = 500) and of one cached step on its deep feature
    (``forward_cached`` at t = 480), at UNet batch ``batch`` on 64^2
    latents; and whether the full step's shapes are ``forward``'s."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    x = torch.randn((batch, 64, 64, 4), generator=gen, device="cuda").bfloat16()
    cond = torch.randn((batch, 77, ctx_dim), generator=gen, device="cuda").bfloat16()

    def recorded(fn):
        for c in counters.values():
            c.record()
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        return out, {k: c.stop_recording() for k, c in counters.items()}

    t = lambda v: torch.tensor([v], device="cuda")  # noqa: E731
    _, plain = recorded(lambda: unet(x, t(500), cond, impl="cuda"))
    (_, deep), full = recorded(lambda: unet.forward_split(x, t(500), cond, impl="cuda"))
    _, cached = recorded(lambda: unet.forward_cached(x, t(480), cond, deep, impl="cuda"))
    return full, cached, full == plain


def cached_within_full(full, cached, kernels, fewer, label: str) -> bool:
    """A cached step launches only shapes of the full step, fewer of each
    kernel in ``fewer``, and K3's general body never."""
    ok = True
    for k in kernels:
        extra = set(cached[k]) - set(full[k])
        nf, nc = sum(full[k].values()), sum(cached[k].values())
        good = not extra and (nc < nf if k in fewer else nc <= nf)
        ok &= good
        say(f"  {label} {k}: full step {len(full[k])} shapes {nf} launches, cached step "
            f"{len(cached[k])} shapes {nc} launches, shapes outside the full step's "
            f"{sorted(extra, key=str)} {'ok' if good else 'BAD'}")
    return ok & no_general_body(full, f"{label} full step") & no_general_body(cached, f"{label} cached step")


def deepcache_requests(pipe, counters, ks, batch: int, label: str, card: str):
    """One 512^2 DDIM-50 CFG-7.5 request of ``batch`` lanes a k (the same ids
    and seed; k None: the call without the argument), the launches of each
    counted from 0: {k: (uint8 images, seconds, launches)}."""
    out = {}
    cond, uncond = request_ids(11, batch)
    for k in ks:
        for c in counters.values():
            c.reset()
        kw = {} if k is None else {"deepcache_interval": k}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = pipe.generate(cond, uncond, img_size=(512, 512), cfg_scale=7.5,
                            inference_steps=SERVE_STEPS, seed=6000, output_dtype="uint8", **kw)
        secs = time.perf_counter() - t0
        out[k] = (img, secs, {n: c.launches for n, c in counters.items()})
        good = img.shape == (batch, 512, 512, 3) and int(img.max()) > int(img.min())
        say(f"  {card}: {label} b{batch} k={'none' if k is None else k}: {secs:.3f} s "
            f"launches {{{', '.join(f'{n}: {v}' for n, v in out[k][2].items() if v)}}} "
            f"{'ok' if good else 'BAD'}")
        if not good:
            raise RuntimeError(f"{label} k={k}: a degenerate image")
    return out


def drift(img, ref):
    d = np.abs(img.astype(np.float32) - ref.astype(np.float32)) / 255.0
    return float(d.mean()), float(np.percentile(d, 99))


def phase_deepcache(counters, card: str):
    pipe = build_pipeline(torch.bfloat16, "cuda", seed=40)
    # (a) the split UNet's shapes at UNet batch 2 (CFG b1): a full and a cached step
    full, cached, same = record_split_step_shapes(pipe.unet, counters, 2)
    say(f"  deepcache full step through forward_split: the shapes of forward "
        f"{'(the same)' if same else 'BAD: other shapes'}")
    ok_s = same and cached_within_full(full, cached, SERVING_KERNELS, ("K2", "K3", "K4"),
                                       "deepcache bf16")
    ok_k, summary = check_kernels(cached, SERVING_KERNELS, "deepcache")
    # (b) requests: the call without the argument, then k = 1, 2, 3
    runs = deepcache_requests(pipe, counters, (None, *DEEPCACHE_KS), 1, "deepcache", card)
    same1 = bool(np.array_equal(runs[1][0], runs[None][0]))
    ok_r = same1
    say(f"  deepcache k=1 vs the request without the argument: "
        f"{'the same uint8 image' if same1 else 'BAD: another image'}")
    for k in DEEPCACHE_KS[1:]:
        mean, p99 = drift(runs[k][0], runs[1][0])
        fewer = all(runs[k][2][n] < runs[1][2][n] for n in ("K2", "K3", "K4"))
        ok_r &= fewer and runs[k][2]["K3:general"] == 0
        say(f"  deepcache k={k} vs k=1: |d| on [0, 1] mean {mean:.4f} p99 {p99:.4f} (TPU record, "
            f"bench.py:440: p99 {DEEPCACHE_TPU_P99}); K2/K3/K4 launches {runs[k][2]['K2']}/"
            f"{runs[k][2]['K3']}/{runs[k][2]['K4']} vs {runs[1][2]['K2']}/{runs[1][2]['K3']}/"
            f"{runs[1][2]['K4']} {'ok' if fewer else 'BAD'}")
    # (c) W8A8 b4 (UNet batch 8) with k = 2: the cached step's shapes and a request
    qpipe, _ = w8a8_pipeline(pipe)
    qfull, qcached, qsame = record_split_step_shapes(qpipe.unet, counters, 2 * W8A8_BATCH)
    ok_s &= qsame and cached_within_full(qfull, qcached, W8A8_PATH_KERNELS, ("K3", *W8A8_KERNELS),
                                         "deepcache w8a8")
    have = tuple(k for k in W8A8_PATH_KERNELS if qcached[k])
    ok_q, qsummary = check_kernels(qcached, have, "deepcache-w8a8")
    ok_k &= ok_q
    qruns = deepcache_requests(qpipe, counters, (1, DEEPCACHE_W8A8_K), W8A8_BATCH,
                               "deepcache w8a8", card)
    qk = qruns[DEEPCACHE_W8A8_K][2]
    ok_r &= (all(qk[k] > 0 for k in W8A8_KERNELS) and qk["K4"] == 0 and qk["K3:general"] == 0
             and all(qk[k] < qruns[1][2][k] for k in W8A8_KERNELS))
    mean, p99 = drift(qruns[DEEPCACHE_W8A8_K][0], qruns[1][0])
    say(f"  deepcache w8a8 k={DEEPCACHE_W8A8_K} vs k=1: |d| on [0, 1] mean {mean:.4f} p99 {p99:.4f}")
    del qpipe, pipe
    torch.cuda.empty_cache()
    secs = {f"b1 k={'none' if k is None else k}": v[1] for k, v in runs.items()}
    secs.update({f"w8a8 b{W8A8_BATCH} k={k}": v[1] for k, v in qruns.items()})
    ok = ok_s and ok_k and ok_r
    return ok, dict(summary=summary, w8a8_summary=qsummary, secs=secs,
                    launches={k: v[2] for k, v in runs.items()},
                    w8a8_launches={k: v[2] for k, v in qruns.items()},
                    p99={k: drift(runs[k][0], runs[1][0])[1] for k in DEEPCACHE_KS[1:]},
                    w8a8_p99=p99)


def deepcache_line(dc) -> str:
    return ("512^2 DDIM 50 CFG 7.5: s/request " + ", ".join(f"{k} {v:.3f}" for k, v in dc["secs"].items())
            + "; image p99 vs k=1 " + ", ".join(f"k={k} {v:.4f}" for k, v in dc["p99"].items())
            + f", w8a8 k={DEEPCACHE_W8A8_K} {dc['w8a8_p99']:.4f}"
            + "".join(f"; {label} cached step " + ", ".join(
                f"{k} {v['shapes']} shapes max_rel={v['max_rel_err']:.2e} kernel {v['ms']:.2f} ms, "
                f"bound {v['bound_ms']:.2f}" for k, v in dc[key].items())
                for label, key in (("bf16", "summary"), ("w8a8", "w8a8_summary"))))


# ---------------------------------------------------------------------------
# Phase 12: the trainer CLI (train_lora_dreambooth_torch.py) at full SD1.5 width
# ---------------------------------------------------------------------------

TRAINER_DIR = os.path.join(REPO, "build", "trainer")
TRAINER_IMAGES = 4      # instance images, and as many prior images
TRAINER_ARGS = ["--img_size", "512", "--batch_size", "2", "--gradient_accumulation_steps", "2",
                "--max_train_steps", "2", "--use_ema", "--lr", "1e-4", "--seed", "0",
                "--device", "cuda"]
# Cached and uncached runs on one seed see the same batches and noise; they
# differ by the bf16 rounding of the text tower run at batch 2 (the two
# prompts, cached) or 4 (uncached).  The first step's loss comes before any
# update: within bf16's rounding of a loss.  An Adam update is about
# lr * sign(g), so an element whose gradient lies within that rounding of 0
# may move 2 lr the other way: at most this share of the LoRA elements may
# differ by more than lr / 2 (tests/test_train_cli.py's rule for the JAX CLI).
TRAINER_LOSS_REL = 2e-2
TRAINER_GROSS_SHARE = 0.02


class timed_train_steps:
    """``training.make_train_step`` wrapped inside the block: each step the
    CLI takes is timed (synchronized) and its loss kept."""

    def __enter__(self):
        from stable_diffusion_tpu_torch import training as T

        self.T, self.orig, self.secs, self.losses = T, T.make_train_step, [], []

        def make(*a, **kw):
            fn = self.orig(*a, **kw)

            def step(state, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = fn(state, batch)
                self.losses.append(float(m["loss"]))
                self.secs.append(time.perf_counter() - t0)
                return state, m
            return step

        T.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.T.make_train_step = self.orig


def write_dreambooth_data(root: str):
    """4 instance and 4 prior 512^2 PNGs (request_image's fields), each set
    with its label.txt."""
    from PIL import Image

    for d, label, seed in (("instance_data", "a photo of sks dog", 70),
                           ("class_prior_data", "a photo of a dog", 80)):
        os.makedirs(os.path.join(root, d), exist_ok=True)
        for i in range(TRAINER_IMAGES):
            Image.fromarray(request_image(seed + i)).save(os.path.join(root, d, f"{i}.png"))
        with open(os.path.join(root, d, "label.txt"), "w") as f:
            f.write(label)


def trainer_run(argv, counters, label: str, card: str, record: bool = False):
    """``train_lora_dreambooth_torch.main(argv)`` with the launches counted
    from 0 (and their shapes with ``record``): (state, steps, launches,
    shapes, seconds, peak GiB)."""
    import train_lora_dreambooth_torch as tcli

    for c in counters.values():
        c.reset()
        if record:
            c.record()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timed_train_steps() as steps:
        state = tcli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k: c.launches for k, c in counters.items()}
    shapes = {k: c.stop_recording() for k, c in counters.items()} if record else None
    say(f"  {card}: trainer {label}: {secs:.2f} s of main(), s/step "
        f"{[round(x, 4) for x in steps.secs]}, losses {[round(x, 5) for x in steps.losses]}, peak_mem "
        f"{peak:.2f} GiB, launches {{{', '.join(f'{k}: {launches[k]}' for k in KERNELS)}}}")
    return state, steps, launches, shapes, secs, peak


def gross_apart(got, want, lr: float):
    """(elements more than lr / 2 apart, elements, max |d|) of two leaf lists."""
    gross = total = 0
    worst = 0.0
    for x, y in zip(got, want, strict=True):
        d = (x.float() - y.float()).abs()
        total += d.numel()
        gross += int((d > 0.5 * lr).sum())
        worst = max(worst, d.max().item())
    return gross, total, worst


def compare_end_states(a, b, losses_a, losses_b, lr: float,
                       label: str = "trainer cached vs uncached") -> bool:
    """Two runs' LoRA trees and EMAs (see TRAINER_GROSS_SHARE): the cached
    and uncached runs, or (phase 16) two ranks' run and one rank's."""
    from stable_diffusion_tpu_torch.utils.tree import tree_leaves

    trees = [{"lora": t["lora"], "ema": t["ema"]} for t in (a, b)]
    gross, total, worst = gross_apart(*map(tree_leaves, trees), lr)
    rel0 = abs(losses_a[0] - losses_b[0]) / max(abs(losses_b[0]), 1e-30)
    ok = (a["step"] == b["step"] and rel0 <= TRAINER_LOSS_REL
          and gross <= TRAINER_GROSS_SHARE * total)
    say(f"  {label}: steps {a['step']} / {b['step']}; first loss {losses_a[0]:.5f} "
        f"vs {losses_b[0]:.5f} (rel {rel0:.2e}, tol {TRAINER_LOSS_REL}); {gross} of {total} LoRA + "
        f"EMA elements differ by more than lr/2 ({gross / total:.2e}, tol {TRAINER_GROSS_SHARE}); "
        f"max |d| {worst:.3e} {'ok' if ok else 'BAD'}")
    return ok


def phase_trainer(counters, card: str):
    import shutil

    import inference_torch as cli
    from stable_diffusion_tpu_torch.models.lora import merge_lora_
    from stable_diffusion_tpu_torch.utils.checkpoint import load_train_checkpoint

    src = write_cli_checkpoints()
    write_dreambooth_data(os.path.join(TRAINER_DIR, "data"))
    base = ["--model_path", os.path.join(CLI_DIR, "sd15"), "--tokenizer_dir",
            os.path.join(CLI_DIR, "tokenizer"), "--data_dir", os.path.join(TRAINER_DIR, "data"),
            "--log_dir", os.path.join(TRAINER_DIR, "logs"), *TRAINER_ARGS]
    lr = float(TRAINER_ARGS[TRAINER_ARGS.index("--lr") + 1])
    run = lambda name, *extra: base + ["--checkpoint_dir", os.path.join(TRAINER_DIR, name), *extra]  # noqa: E731
    # (a) the main path: the CLI on the cached encoders, every launch counted
    cached, st_c, launches, _, secs_c, peak = trainer_run(run("cached"), counters, "cached", card)
    ok_l = all(launches[k] > 0 for k in TRAIN_KERNELS) and all(
        launches[k] == 0 for k in KERNELS if k not in TRAIN_KERNELS)
    ok_l &= no_general_body(launches, "trainer cached run")
    ckpt_path = os.path.join(TRAINER_DIR, "cached", "epoch-1.ckpt")
    ckpt_bytes = os.path.getsize(ckpt_path)
    # (b) uncached, the same seed: the shapes of the whole run, and the end states
    plain, st_u, launches_u, shapes, secs_u, peak_u = trainer_run(
        run("uncached", "--no-cache_latents"), counters, "uncached", card, record=True)
    ok_l &= all(launches_u[k] > 0 for k in TRAIN_KERNELS)
    ok_e = compare_end_states(cached, plain, st_c.losses, st_u.losses, lr)
    say("  trainer uncached run shapes: " + ", ".join(
        f"{k} {len(shapes[k])} shapes {sum(shapes[k].values())} calls" for k in TRAIN_KERNELS))
    ok_k = no_general_body(shapes, "trainer uncached run")
    ok_c, summary = check_kernels(shapes, TRAIN_KERNELS, "trainer")
    ok_k &= ok_c
    # (c) resume from the cached run's last checkpoint
    resumed, _, _, _, secs_r, _ = trainer_run(run("cached", "--pretrained_path", ckpt_path),
                                              counters, "resumed", card)
    written = sorted(f for f in os.listdir(os.path.join(TRAINER_DIR, "cached")) if f.endswith(".ckpt"))
    ok_resume = resumed["step"] == 2 * cached["step"] and written == [f"epoch-{i}.ckpt" for i in range(4)]
    say(f"  trainer resume from epoch-1.ckpt: step {cached['step']} -> {resumed['step']}, "
        f"checkpoints {written} {'ok' if ok_resume else 'BAD'}")
    del cached, plain, resumed
    torch.cuda.empty_cache()
    # (d) the checkpoint served: inference_torch --lora_ckpt, one-step b1
    argv = ["--model_path", os.path.join(CLI_DIR, "sd15"), "--tokenizer_dir",
            os.path.join(CLI_DIR, "tokenizer"), "--prompt", "a photo of sks dog", "--device", "cuda",
            "--one_step", "--n_samples", "1", "--seed", "7", "--output_dir", os.path.join(TRAINER_DIR, "out")]
    lora_argv = argv + ["--lora_ckpt", ckpt_path]
    for c in counters.values():
        c.reset()
    imgs_main = cli.main(lora_argv)
    ok_srv = os.listdir(os.path.join(TRAINER_DIR, "out")) == ["img_0_0.jpg"]
    lora = load_train_checkpoint(ckpt_path)["state"]["lora"]
    model = cli.load_model(cli.parse_args(lora_argv))
    ok_merge, merge_err = check_lora_merge(model, src, lora, "trained LoRA merged by --lora_ckpt")
    del model
    manual = cli.load_model(cli.parse_args(argv))
    merge_lora_(manual.unet, lora["unet"])
    imgs_manual = cli.inference(cli.parse_args(lora_argv), manual, save=False)
    unmerged = cli.inference(cli.parse_args(argv), cli.load_model(cli.parse_args(argv)), save=False)
    same = bool(np.array_equal(imgs_main[0], imgs_manual[0]))
    moved = drift(imgs_main[0], unmerged[0])
    ok_srv &= same and moved[1] > 0
    say(f"  trainer checkpoint served (one-step b1): inference_torch --lora_ckpt vs a manual "
        f"merge_lora_ of the same tree: {'the same uint8 image' if same else 'BAD: another image'}; "
        f"vs the unmerged model |d| mean {moved[0]:.4f} p99 {moved[1]:.4f} "
        f"{'ok' if ok_srv else 'BAD'}")
    del manual
    torch.cuda.empty_cache()
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    ok = ok_l and ok_e and ok_k and ok_resume and ok_srv and ok_merge
    say(f"  {card}: trainer s/step (cached run) median {statistics.median(st_c.secs):.4f}, "
        f"main() {secs_c:.2f} s cached, {secs_u:.2f} s uncached, {secs_r:.2f} s resumed; peak_mem "
        f"{peak:.2f} GiB cached, {peak_u:.2f} uncached; checkpoint {ckpt_bytes} bytes")
    return ok, dict(summary=summary, launches=launches, secs=st_c.secs, main_s=secs_c,
                    peak_gib=peak, ckpt_bytes=ckpt_bytes, merge_err=merge_err)


def trainer_line(tr) -> str:
    return (f"SD1.5 LoRA r128 DreamBooth 512^2 b2+2 through train_lora_dreambooth_torch: s/step "
            f"median {statistics.median(tr['secs']):.4f} ({len(tr['secs'])} steps), main() "
            f"{tr['main_s']:.2f} s, peak_mem {tr['peak_gib']:.2f} GiB, checkpoint {tr['ckpt_bytes']} "
            f"bytes, merge max rel={tr['merge_err']:.3e}; "
            + ", ".join(f"{k} {v['shapes']} shapes max_rel={v['max_rel_err']:.2e} kernel "
                        f"{v['ms']:.2f} ms, bound {v['bound_ms']:.2f}" for k, v in tr["summary"].items())
            + " per run")


# ---------------------------------------------------------------------------
# Phase 13: the evaluation path (evaluation_torch.py) at full width
# ---------------------------------------------------------------------------

EVAL_DIR = os.path.join(REPO, "build", "eval")
# The CLIP score, bf16 kernels against plain f32 (TF32 off) on the same
# weights: each projected embedding within CLIP_EMBED_REL_L2 in relative L2
# (bf16 through 24 and 12 pre-LN layers: the golden's bound for a deep bf16
# stack).  Unit vectors moved by relative eps_a and eps_b move their cosine
# by at most 2 (eps_a + eps_b), so the score (100 cos, clamped at 0) moves
# by at most 100 * 2 * 2 * CLIP_EMBED_REL_L2 points.
CLIP_EMBED_REL_L2 = 5e-2
CLIP_SCORE_ATOL = 100 * 2 * 2 * CLIP_EMBED_REL_L2
# The W8A8 ViT-L text tower on K8 (bf16) against the plain W8A8 path in f32
# (TF32 off) on the same int8 weights and scales: as phase 6's step, the
# bf16 rounding of the activations between quantizers and the codes it
# moves across a half step; relative L2 of the last hidden state.
TEXT_W8A8_REL_L2 = 5e-2
TEXT_W8A8_LINEARS = 12 * 4  # a layer's fused QKV, out projection, fc1 and fc2
EVAL_STEPS = 4              # DDIM steps of the class2img requests and evaluation_torch.main
EVAL_FID_BATCH = 8
CLASS2IMG_CLASSES = 1000
CLIP_VIT_L14 = {
    "architectures": ["CLIPModel"], "projection_dim": 768,
    "text_config": {"hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 12,
                    "num_attention_heads": 12, "max_position_embeddings": 77,
                    "vocab_size": 49408, "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5,
                    "projection_dim": 768},
    "vision_config": {"hidden_size": 1024, "intermediate_size": 4096, "num_hidden_layers": 24,
                      "num_attention_heads": 16, "image_size": 224, "patch_size": 14,
                      "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5, "projection_dim": 768}}


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


class no_tf32:
    """TF32 off inside the block (the plain f32 references)."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def recorded(counters, fn):
    """Run ``fn`` with every launch counted from 0 and its shape recorded:
    (result, launches, shapes)."""
    for c in counters.values():
        c.reset()
        c.record()
    out = fn()
    torch.cuda.synchronize()
    return (out, {k: c.launches for k, c in counters.items()},
            {k: c.stop_recording() for k, c in counters.items()})


def write_clip_dir(root: str) -> float:
    """An HF-layout CLIP ViT-L/14 ``CLIPModel`` directory (config.json and an
    f16 model.safetensors, the port's writer) from a seed; returns seconds."""
    from stable_diffusion_tpu_torch.models import clip as clip_m
    from stable_diffusion_tpu_torch.utils import safetensors_io

    t0 = time.perf_counter()
    cfg = CLIP_VIT_L14
    model = clip_m.init_clip_model(50, clip_m.CLIPTextConfig.from_dict(cfg["text_config"]),
                                   clip_m.CLIPVisionConfig.from_dict(cfg["vision_config"]),
                                   cfg["projection_dim"], device="cuda", dtype=torch.float16)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    os.makedirs(root, exist_ok=True)
    safetensors_io.save_file(state, os.path.join(root, "model.safetensors"))
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(cfg, f)
    n = sum(v.numel() for v in state.values())
    secs = time.perf_counter() - t0
    say(f"  wrote CLIP ViT-L/14 (vision 24x1024, 16 heads, 224/14; text 12x768; projection 768) "
        f"in f16: {n / 1e6:.1f} M parameters, {secs:.1f} s")
    return secs


def median_s(fn, n: int = 5) -> float:
    secs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs)


def eval_clip(counters, clip_dir: str):
    """(2) K3 in the vision tower at b1 and b8; (3) the CLIP score, bf16
    kernels against plain f32."""
    import evaluation_torch
    from stable_diffusion_tpu_torch import fid as fid_m
    from stable_diffusion_tpu_torch.models import clip as clip_m

    model = fid_m.load_clip_model(clip_dir, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(51)
    px = {b: torch.rand((b, 224, 224, 3), generator=gen, device="cuda") * 255 for b in (1, 8)}
    ids = {b: torch.randint(0, 49408, (b, 77), generator=gen, device="cuda") for b in (1, 8)}
    mean = torch.tensor(clip_m.CLIP_MEAN, device="cuda")
    std = torch.tensor(clip_m.CLIP_STD, device="cuda")
    norm = lambda p: (p / 255.0 - mean) / std  # noqa: E731

    def both():
        with torch.no_grad():
            for b in (1, 8):
                clip_m.clip_image_embed(model, norm(px[b]), impl="cuda")

    _, launches, shapes = recorded(counters, both)
    want = {(b, 257, 257, 16, 64) for b in (1, 8)}
    ok = set(shapes["K3"]) == want and launches["K3:ring"] == launches["K3"] == 2 * 24
    say(f"  eval vision tower K3 shapes {sorted(shapes['K3'])} (want {sorted(want)}), launches "
        f"{launches['K3']} (ring {launches['K3:ring']}) {'ok' if ok else 'BAD'}")
    ok_k, summary = check_kernels(shapes, ("K3",), "eval-vision")
    ok &= ok_k

    with torch.no_grad():
        ei, et = (clip_m.clip_image_embed(model, norm(px[8]), impl="cuda").float(),
                  clip_m.clip_text_embed(model, ids[8], impl="cuda").float())
        score = clip_m.clip_score(model, px[8], ids[8], impl="cuda")
        del model
        ref = fid_m.load_clip_model(clip_dir, device="cuda", dtype=torch.float32)
        with no_tf32():
            ri, rt = (clip_m.clip_image_embed(ref, norm(px[8]), impl="torch"),
                      clip_m.clip_text_embed(ref, ids[8], impl="torch"))
            rscore = clip_m.clip_score(ref, px[8], ids[8], impl="torch")
        del ref
    cos = torch.nn.functional.cosine_similarity
    d_score = float((score - rscore).abs().max())
    d_cos = float((cos(ei, et) - cos(ri, rt)).abs().max())
    rel_i, rel_t = rel_l2(ei, ri), rel_l2(et, rt)
    ok_s = (rel_i <= CLIP_EMBED_REL_L2 and rel_t <= CLIP_EMBED_REL_L2
            and d_score <= CLIP_SCORE_ATOL and bool(torch.isfinite(score).all()))
    say(f"  eval clip_score b8 bf16 kernels vs plain f32: image embed rel_l2 {rel_i:.3e}, text embed "
        f"{rel_t:.3e} (<= {CLIP_EMBED_REL_L2}), cosine max |d| {d_cos:.3e}, score max |d| "
        f"{d_score:.3f} (<= {CLIP_SCORE_ATOL}); scores {[round(float(x), 3) for x in score]}, "
        f"plain {[round(float(x), 3) for x in rscore]}, cosines "
        f"{[round(float(x), 4) for x in cos(ri, rt)]} {'ok' if ok_s else 'BAD'}")
    scorer = evaluation_torch.load_clip_scorer(clip_dir, device="cuda", impl="cuda")
    img_np = px[1].cpu().numpy()
    ids_np = ids[1].cpu().numpy()
    s_score = median_s(lambda: scorer(img_np, ids_np))
    return ok and ok_s, dict(vision=summary, vision_launches=launches, s_per_score=s_score,
                             score_rel=(rel_i, rel_t), score_d=d_score)


def eval_text_w8a8(counters, clip_dir: str):
    """(4) the W8A8 ViT-L text tower: calibrated, quantized, K8 at every
    linear; (5) calibrate_cond_encoder over the default prompts."""
    import copy

    from stable_diffusion_tpu_torch import fid as fid_m
    from stable_diffusion_tpu_torch.tokenizer import load_tokenizer
    from stable_diffusion_tpu_torch.utils import quantize_model as QM

    text = fid_m.load_clip_model(clip_dir, device="cuda").text_model
    rng = np.random.default_rng(56)
    batches = [rng.integers(0, 49408, (2, 77)) for _ in range(4)]
    t0 = time.perf_counter()
    qtext = QM.quantize_text_encoder_static(copy.deepcopy(text), batches, impl="cuda")
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    n_w8a8 = sum(1 for m in qtext.modules() if getattr(m, "w8a8", False))
    ids = {b: torch.as_tensor(rng.integers(0, 49408, (b, 77)), device="cuda") for b in (1, 2)}

    def forward():
        with torch.no_grad():
            return {b: qtext(ids[b], impl="cuda") for b in (1, 2)}

    outs, launches, shapes = recorded(counters, forward)
    ok = (n_w8a8 == 6 * 12 and launches["K8"] == 2 * TEXT_W8A8_LINEARS
          and all(launches[k] == 0 for k in KERNELS if k != "K8"))
    want_shapes = {(m, k, n, False, False) for m in (77, 154)
                   for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768))}
    ok &= set(shapes["K8"]) == want_shapes
    say(f"  eval text W8A8: {n_w8a8} W8A8 linears calibrated in {cal_s:.2f} s; one b1 and one b2 "
        f"forward launch K8 {launches['K8']} times (want {2 * TEXT_W8A8_LINEARS}), shapes "
        f"{sorted(shapes['K8'])}, other kernels {sum(launches[k] for k in KERNELS if k != 'K8')} "
        f"{'ok' if ok else 'BAD'}")
    q_scales = {float(l.self_attn.q_proj.act_scale) == float(l.self_attn.k_proj.act_scale)
                == float(l.self_attn.v_proj.act_scale) for l in qtext.encoder.layers.values()}
    ok &= q_scales == {True}
    ok_k, summary = check_kernels(shapes, ("K8",), "eval-text-w8a8")
    ok &= ok_k
    with torch.no_grad(), no_tf32():
        plain16 = qtext(ids[2], impl="torch")  # the plain W8A8 path in bf16: a witness
        q32 = copy.deepcopy(qtext).float()
        ref = q32(ids[2], impl="torch")
        base = text(ids[2], impl="cuda")
        del q32
    rel_q, rel_b, rel_w = rel_l2(outs[2], ref), rel_l2(base, ref), rel_l2(plain16, ref)
    ok_t = rel_q <= TEXT_W8A8_REL_L2
    ok &= ok_t
    say(f"  eval text W8A8 b2 last hidden state: rel_l2 {rel_q:.3e} from the plain W8A8 path in f32 "
        f"(<= {TEXT_W8A8_REL_L2}); the plain W8A8 path in bf16 {rel_w:.3e} and the unquantized "
        f"bf16 tower {rel_b:.3e} from it {'ok' if ok_t else 'BAD'}")
    TC = tests_module("torch_checkpoints")
    TC.write_vocab(os.path.join(EVAL_DIR, "tokenizer"))
    tok = load_tokenizer(os.path.join(EVAL_DIR, "tokenizer"))
    t0 = time.perf_counter()
    cond = QM.calibrate_cond_encoder(lambda m, i: m(i, impl="cuda"), text, tok)
    torch.cuda.synchronize()
    cond_s = time.perf_counter() - t0
    ok_c = cond["n_prompts"] == len(QM.DEFAULT_CALIBRATION_PROMPTS) and np.isfinite(
        cond["activation_absmax"]) and cond["activation_absmax"] > 0
    say(f"  eval calibrate_cond_encoder over {cond['n_prompts']} prompts: activation_absmax "
        f"{cond['activation_absmax']:.4f} in {cond_s:.2f} s {'ok' if ok_c else 'BAD'}")
    del text, qtext
    torch.cuda.empty_cache()
    return ok and ok_c, dict(text=summary, text_launches=launches,
                             text_rel=(rel_q, rel_b, rel_w), cond=cond)


def eval_sd15(counters, card: str):
    """(5) calibrate_unet with a short SD1.5 denoise; (6) class2img at 512^2
    b1: a class embedding as a one-token context, K3's cross body on one key."""
    from stable_diffusion_tpu_torch.models import clip as clip_m
    from stable_diffusion_tpu_torch.utils import quantize_model as QM

    pipe = build_pipeline(torch.bfloat16, "cuda", seed=52)
    cond, uncond = request_ids(57)
    t0 = time.perf_counter()
    cal = QM.calibrate_unet(
        lambda lat, gen: pipe.generate(cond, uncond, initial_latents=lat, inference_steps=EVAL_STEPS,
                                       seed=57, return_latents=True),
        latent_shape=(1, 64, 64, 4), steps=EVAL_STEPS, seed=57, device="cuda")
    cal_s = time.perf_counter() - t0
    ok = bool(np.isfinite(cal["latent_absmax"])) and cal["latent_absmax"] > 0
    say(f"  eval calibrate_unet (SD1.5 512^2, DDIM {EVAL_STEPS}, CFG 7.5): latent_absmax "
        f"{cal['latent_absmax']:.4f} in {cal_s:.2f} s {'ok' if ok else 'BAD'}")

    enc = clip_m.init_class_encoder(53, CLASS2IMG_CLASSES, 768, device="cuda", dtype=torch.bfloat16)

    def context(label):  # [uncond (the extra row); cond]
        with torch.no_grad():
            return enc(torch.tensor([CLASS2IMG_CLASSES, label], device="cuda"))

    _, launches1, shapes = recorded(counters, lambda: pipe.generate(
        context=context(207), img_size=(512, 512), inference_steps=1, seed=58, output_dtype="uint8"))
    one_key = {k: n for k, n in shapes["K3"].items() if k[2] == 1}
    ok_c = (sorted(one_key) == [(2, 64, 1, 8, 160), (2, 256, 1, 8, 160), (2, 1024, 1, 8, 80),
                                (2, 4096, 1, 8, 40)]
            and not any(k[2] == 77 for k in shapes["K3"]) and launches1["K3:cross"] == 16
            and launches1["K3:general"] == 0)
    say(f"  eval class2img one step: K3 one-key shapes {sorted(one_key)} (cross body launches "
        f"{launches1['K3:cross']}, no 77-key shape) {'ok' if ok_c else 'BAD'}")
    ok_k, summary = check_kernels({"K3": collections.Counter(one_key)}, ("K3",), "eval-class2img")
    secs, imgs = [], []
    for i, label in enumerate((207, 417)):
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs.append(pipe.generate(context=context(label), img_size=(512, 512),
                                  inference_steps=EVAL_STEPS, seed=59 + i, output_dtype="uint8"))
        secs.append(time.perf_counter() - t0)
        launches = {k: c.launches for k, c in counters.items()}
    ok_r = (all(im.shape == (1, 512, 512, 3) and im.max() > im.min() for im in imgs)
            and all(launches[k] > 0 for k in SERVING_KERNELS)
            and all(launches[k] == 0 for k in KERNELS if k not in SERVING_KERNELS)
            and launches["K3:general"] == 0)
    say(f"  {card}: eval class2img 512^2 b1 DDIM {EVAL_STEPS} CFG 7.5: s/image "
        f"{[round(s, 3) for s in secs]}, launches {{{', '.join(f'{k}: {launches[k]}' for k in KERNELS)}}} "
        f"{'ok' if ok_r else 'BAD'}")
    del pipe, enc
    torch.cuda.empty_cache()
    return ok and ok_c and ok_k and ok_r, dict(class2img=summary, class2img_launches=launches,
                                               class2img_s=secs, cal_unet=cal)


def eval_vqvae_inception(counters, card: str):
    """(7) a VQ-VAE round trip at 512^2 b1 and one EMA update; (8) Inception
    pool3 at b8 and the FID of two seeded sets."""
    from stable_diffusion_tpu_torch import fid as fid_m
    from stable_diffusion_tpu_torch.models import inception as inc_m
    from stable_diffusion_tpu_torch.models import vae as vae_m

    vq = vae_m.init_vqvae(54, vae_m.VAEConfig(), 1024, device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(54)
    x = (torch.rand((1, 512, 512, 3), generator=gen, device="cuda") * 2 - 1).bfloat16()

    def round_trip():
        with torch.no_grad():
            quant, loss, idx = vae_m.vqvae_encode(vq, x, impl="cuda")
            return quant, loss, idx, vae_m.vqvae_decode(vq, quant, impl="cuda")

    (quant, loss, idx, img), launches, shapes = recorded(counters, round_trip)
    ok = (tuple(vq.decoder.conv_in.weight.shape) == (512, 8, 3, 3) and quant.shape == (1, 64, 64, 8)
          and img.shape == (1, 512, 512, 3) and bool(torch.isfinite(img.float()).all())
          and bool(torch.isfinite(loss)) and all(launches[k] > 0 for k in ("K1", "K2", "K3"))
          and launches["K3:wide"] == 2 and launches["K3:general"] == 0)
    codes = int(torch.unique(idx).numel())
    say(f"  eval vqvae 512^2 b1: latent {tuple(quant.shape)}, {codes} codes used, loss "
        f"{float(loss):.4f}, decoder conv_in {tuple(vq.decoder.conv_in.weight.shape)}, launches "
        f"K1 {launches['K1']} K2 {launches['K2']} K3 {launches['K3']} (wide {launches['K3:wide']}) "
        f"{'ok' if ok else 'BAD'}")
    ok_k, summary = check_kernels(shapes, ("K1", "K2", "K3"), "eval-vqvae")
    rt_s = median_s(round_trip, 3)
    book = vq.quant_embedding.weight.detach().float().clone()
    state = {"N": torch.ones(1024, device="cuda"), "M": book.clone()}
    _, state = vae_m.vqvae_ema_codebook_update(vq, state, idx, quant, beta=0.99)
    moved = int((vq.quant_embedding.weight.float() != book).any(dim=1).sum())
    ok_e = bool(torch.isfinite(vq.quant_embedding.weight.float()).all()) and 0 < moved <= 1024
    say(f"  eval vqvae round trip {rt_s:.4f} s; one EMA codebook update: {moved} of 1024 codes "
        f"changed {'ok' if ok_e else 'BAD'}")
    del vq, quant, img, x
    torch.cuda.empty_cache()

    inc = inc_m.init_inception(55, device="cuda")
    sets = [torch.rand((EVAL_FID_BATCH, 512, 512, 3), generator=gen, device="cuda") for _ in range(2)]
    with torch.no_grad():
        feats = [inc_m.pool3_features(inc, s).cpu().numpy() for s in sets]
        pool_s = median_s(lambda: inc_m.pool3_features(inc, sets[0]), 3)
    t0 = time.perf_counter()
    fid = fid_m.fid_from_features(feats[0], feats[1])
    fid_s = time.perf_counter() - t0
    ok_f = all(f.shape == (EVAL_FID_BATCH, 2048) and np.isfinite(f).all() for f in feats) and bool(
        np.isfinite(fid)) and fid > 0
    say(f"  {card}: eval inception pool3 b{EVAL_FID_BATCH} from 512^2: {pool_s:.4f} s; FID of two "
        f"seeded sets of {EVAL_FID_BATCH}: {fid:.4f} in {fid_s:.2f} s (host, scipy) "
        f"{'ok' if ok_f else 'BAD'}")
    del inc
    torch.cuda.empty_cache()
    return ok and ok_k and ok_e and ok_f, dict(vqvae=summary, vqvae_launches=launches,
                                               vqvae_s=rt_s, pool3_s=pool_s, fid=fid, fid_s=fid_s)


def eval_cli(counters, clip_dir: str, card: str):
    """(9) evaluation_torch.main on an f16 diffusers directory, two synthetic
    COCO-style images, the CLIP score and CLIP-FID; one config, one scale."""
    import evaluation_torch as ev
    from PIL import Image

    write_cli_checkpoints(ldm_and_kohya=False)
    imgs_dir = os.path.join(EVAL_DIR, "coco")
    os.makedirs(imgs_dir, exist_ok=True)
    rng = np.random.default_rng(60)
    for i in (1, 2):
        Image.fromarray(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)).save(
            os.path.join(imgs_dir, f"{i}.jpg"))
    label = {"images": [{"id": i, "file_name": f"{i}.jpg"} for i in (1, 2)],
             "annotations": [{"image_id": 1, "id": 10, "caption": "a photo of a cat on a sofa"},
                             {"image_id": 2, "id": 20, "caption": "a red bus in the street"}]}
    with open(os.path.join(EVAL_DIR, "captions.json"), "w") as f:
        json.dump(label, f)
    argv = ["--model_path", os.path.join(CLI_DIR, "sd15"), "--tokenizer_dir",
            os.path.join(CLI_DIR, "tokenizer"), "--device", "cuda", "--do_cfg", "--sampler", "ddim",
            "--num_inference_steps", str(EVAL_STEPS), "--original_imgs_dir", imgs_dir,
            "--label_file", os.path.join(EVAL_DIR, "captions.json"), "--clip_model_dir", clip_dir,
            "--fid_backbone", "clip", "--num_samples", "2", "--save_dir",
            os.path.join(EVAL_DIR, "out"), "--seed", "0"]
    saved = ev.TEST_CONFIGS, ev.CFG_SCALES, os.getcwd()
    ev.TEST_CONFIGS, ev.CFG_SCALES = [{"sampler": "ddim", "use_cosine_schedule": False}], [7.5]
    os.chdir(EVAL_DIR)  # TensorBoard's ./runs, where it is installed
    try:
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = ev.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        ev.TEST_CONFIGS, ev.CFG_SCALES = saved[:2]
        os.chdir(saved[2])
    launches = {k: c.launches for k, c in counters.items()}
    tag = "7.5_ddim_linearSchedule"
    ok = (sorted(results) == [tag, f"{tag}/fid"] and all(np.isfinite(v) for v in results.values())
          and all(launches[k] > 0 for k in SERVING_KERNELS)
          and all(launches[k] == 0 for k in KERNELS if k not in SERVING_KERNELS)
          and launches["K3:general"] == 0
          and all(os.path.exists(os.path.join(EVAL_DIR, "out", "fake", tag, f"{s}.jpg"))
                  for s in ("1_10", "2_20")))
    say(f"  {card}: eval evaluation_torch.main (f16 SD1.5 directory, 2 COCO-style images, DDIM "
        f"{EVAL_STEPS}, CFG 7.5, CLIP score and CLIP-FID): {secs:.2f} s, results {results}, launches "
        f"{{{', '.join(f'{k}: {launches[k]}' for k in KERNELS)}}} {'ok' if ok else 'BAD'}")
    return ok, dict(results=results, main_s=secs, main_launches=launches)


def phase_evaluation(counters, card: str):
    import shutil

    clip_dir = os.path.join(EVAL_DIR, "clip")
    try:
        write_clip_dir(clip_dir)
        ok1, clip = eval_clip(counters, clip_dir)
        ok2, text = eval_text_w8a8(counters, clip_dir)
        ok3, sd = eval_sd15(counters, card)
        ok4, vq = eval_vqvae_inception(counters, card)
        ok5, cli = eval_cli(counters, clip_dir, card)
    finally:
        shutil.rmtree(EVAL_DIR, ignore_errors=True)
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    out = dict(clip, **text, **sd, **vq, **cli)
    return ok1 and ok2 and ok3 and ok4 and ok5, out


def evaluation_line(ev) -> str:
    return (f"s/score {ev['s_per_score']:.4f} (b1, host arrays), class2img s/image "
            f"{[round(s, 3) for s in ev['class2img_s']]}, VQ-VAE round trip {ev['vqvae_s']:.4f} s, "
            f"pool3 b{EVAL_FID_BATCH} {ev['pool3_s']:.4f} s, FID {ev['fid_s']:.2f} s, "
            f"evaluation_torch.main {ev['main_s']:.2f} s {ev['results']}; text W8A8 rel_l2 "
            f"{ev['text_rel'][0]:.3e} (plain bf16 {ev['text_rel'][2]:.3e}, unquantized "
            f"{ev['text_rel'][1]:.3e}); "
            + ", ".join(f"{label} {k} {v['shapes']} shapes max_rel={v['max_rel_err']:.2e} kernel "
                        f"{v['ms']:.3f} ms, bound {v['bound_ms']:.3f}"
                        for label in ("vision", "text", "class2img", "vqvae")
                        for k, v in ev[label].items()))


# ---------------------------------------------------------------------------
# Phase 14: the Gradio demo (demo/app_torch.py) at full SD1.5 width
# ---------------------------------------------------------------------------

DEMO_STEPS = 50
DEMO_SAMPLES = (1, 2)
# A segmented request (the demo's gr.Progress) against the one call: the same
# kernels in the same order on the same draws, so equal bit for bit where
# every launch is deterministic; bf16's rounding through 50 steps otherwise
# (the golden's bf16 bound, relative L2 of the [0, 1] images).
DEMO_SEGMENT_REL_L2 = 5e-2


def load_demo_app():
    """demo/app_torch.py loaded from its file, with tests/gradio_stub.py
    (loaded by file too) standing in for gradio: (app, stub)."""
    import importlib.util

    stub = tests_module("gradio_stub")
    spec = importlib.util.spec_from_file_location("app_torch",
                                                  os.path.join(REPO, "demo", "app_torch.py"))
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    return app, stub


def phase_demo(counters, card: str):
    """The demo's three recorded click handlers at DDIM 50, b1 and b2, each
    with a gr.Progress, on the f16 directory phase 10 writes, loaded by
    ``initialize_model(device="cuda")``; then the b1 txt2img request as one
    call, its image and launches against the segmented request's."""
    import shutil

    from PIL import Image

    saved = sys.modules.get("gradio")
    app, stub = load_demo_app()
    sys.modules["gradio"] = stub
    try:
        write_cli_checkpoints(ldm_and_kohya=False)
        t0 = time.perf_counter()
        pipe, _ = app.initialize_model(os.path.join(CLI_DIR, "sd15"),
                                       os.path.join(CLI_DIR, "tokenizer"), device="cuda")
        load_s = time.perf_counter() - t0
        events = {e["tab"]: e for e in app.build_demo().events}
        ok = sorted(events) == ["img2img", "inpaint", "txt2img"] and pipe.impl == "cuda"
        image = Image.fromarray(request_image(90))
        layer = np.zeros((512, 512, 4), np.uint8)
        layer[..., 3] = request_mask()
        payload = {"background": image, "layers": [Image.fromarray(layer, "RGBA")]}
        inputs = {"txt2img": (), "img2img": (image,), "inpaint": (payload,)}
        pipe.generate(prompt=CLI_PROMPT, inference_steps=1, img_size=app.IMG_SIZE)  # warm-up
        secs, runs = {}, {}
        for tab in ("txt2img", "img2img", "inpaint"):
            for n in DEMO_SAMPLES:
                progress = stub.Progress()
                for c in counters.values():
                    c.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = events[tab]["fn"](*inputs[tab], CLI_PROMPT, "", n, False, 7.5, 0.8,
                                        DEMO_STEPS, "ddim", progress=progress)
                torch.cuda.synchronize()
                s = time.perf_counter() - t0
                launches = {k: c.launches for k, c in counters.items()}
                fracs = [f for f, _ in progress.calls]
                # one bar a request (inpaint runs one a sample), each from 0 to 1.0
                bars = np.split(np.asarray(fracs), np.flatnonzero(np.asarray(fracs) == 0.0)[1:])
                arrs = [np.asarray(o) for o in out]
                good = (len(out) == n and all(a.shape == (512, 512, 3) and a.max() > a.min()
                                              for a in arrs)
                        and len(bars) == (n if tab == "inpaint" else 1)
                        and all(b[0] == 0.0 and b[-1] == 1.0 and (np.diff(b) > 0).all()
                                for b in bars)
                        and all(launches[k] > 0 for k in SERVING_KERNELS)
                        and all(launches[k] == 0 for k in KERNELS if k not in SERVING_KERNELS)
                        and launches["K3:general"] == 0)
                ok &= good
                secs[f"{tab} b{n}"] = s
                runs[(tab, n)] = (arrs, launches)
                say(f"  {card}: demo {tab} n_samples={n} DDIM {DEMO_STEPS} CFG 7.5 through the "
                    f"click handler: {s:.3f} s, {len(progress.calls)} progress calls ending at "
                    f"{fracs[-1]:.3f}, launches {{{', '.join(f'{k}: {v}' for k, v in launches.items() if v)}}} "
                    f"{'ok' if good else 'BAD'}")
        # the b1 txt2img request as one call (no progress callback)
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = pipe.generate(prompt=CLI_PROMPT, uncond_prompt="", batch_size=1, cfg_scale=7.5,
                            strength=0.8, inference_steps=DEMO_STEPS, sampler="ddim",
                            img_size=app.IMG_SIZE)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        one_launches = {k: c.launches for k, c in counters.items()}
        one_u8 = (np.clip(one, 0, 1) * 255).round().astype(np.uint8)
        seg_u8, seg_launches = runs[("txt2img", 1)][0][0], runs[("txt2img", 1)][1]
        rel = rel_l2(torch.tensor(seg_u8), torch.tensor(one_u8[0]))
        same = bool(np.array_equal(seg_u8, one_u8[0]))
        good = rel <= DEMO_SEGMENT_REL_L2 and one_launches == seg_launches
        ok &= good
        say(f"  {card}: demo txt2img b1 as one call: {one_s:.3f} s, launches equal to the "
            f"segmented request's: {one_launches == seg_launches}; image rel_l2 {rel:.3e} "
            f"({'bit for bit' if same else 'not bit for bit'}) {'ok' if good else 'BAD'}")
    finally:
        if saved is None:
            sys.modules.pop("gradio", None)
        else:
            sys.modules["gradio"] = saved
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    del pipe
    torch.cuda.empty_cache()
    return ok, dict(load_s=load_s, secs=secs, one_s=one_s, rel=rel, same=same,
                    launches=runs[("txt2img", 1)][1])


def demo_line(dm) -> str:
    return (f"f16 SD1.5 directory loaded in {dm['load_s']:.2f} s; DDIM {DEMO_STEPS} CFG 7.5 s/request "
            + ", ".join(f"{k} {v:.3f}" for k, v in dm["secs"].items())
            + f"; txt2img b1 one call {dm['one_s']:.3f} s, image rel_l2 to the segmented "
            f"{dm['rel']:.3e}{' (bit for bit)' if dm['same'] else ''}")


# ---------------------------------------------------------------------------
# Phase 15: sharded serving (parallel/mesh.py, StableDiffusion.shard)
# ---------------------------------------------------------------------------

SHARD_DIR = os.path.join(REPO, "build", "shard")
SHARD_SIZE = (512, 512)
SHARD_STEPS = 10        # DDIM steps a request (cut from 50: gloo moves each sum through the host)
SHARD_SEED = 50         # the weights: init_random_ from this seed, the same on every rank
SHARD_TIMEOUT = 420     # seconds a world may take
# The tensor-parallel image against the unsharded one: the row-parallel
# products summed over two ranks in f32 on the host, then rounded to bf16,
# where the unsharded kernels round one product: bf16's rounding through
# the steps (the golden's bf16 bound, relative L2 of the uint8 images).
SHARD_IMAGE_REL_L2 = 5e-2


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _CollectiveTimer:
    """While entered, times each sum that crosses ranks (``Mesh._sum``, which
    ``Mesh.all_reduce``, the autograd pair and ``Mesh.sum_flat`` call; the
    card synchronised on entry and exit, so the rank's own queued work is
    not counted) and, inside it, the ``dist.all_reduce`` call alone; the
    rest is the host copies and the f32 casts of a gloo mesh.  ``read``
    returns the sums since the last read."""

    def __init__(self, pmesh):
        self.pmesh, self.sums = pmesh, dict(calls=0, all_reduce_s=0.0, wire_s=0.0, mib=0.0)

    def __enter__(self):
        import torch.distributed as dist

        mesh_cls, sums = self.pmesh.Mesh, self.sums
        inner_mesh, inner_dist = mesh_cls._sum, dist.all_reduce

        def wire(t, *a, **k):
            t0 = time.perf_counter()
            r = inner_dist(t, *a, **k)
            sums["wire_s"] += time.perf_counter() - t0
            sums["mib"] += t.numel() * t.element_size() / 2 ** 20
            return r

        def summed(mesh, t, axis):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = inner_mesh(mesh, t, axis)
            torch.cuda.synchronize()
            sums["all_reduce_s"] += time.perf_counter() - t0
            sums["calls"] += 1
            return r

        self._undo = (inner_mesh, inner_dist)
        mesh_cls._sum, dist.all_reduce = summed, wire
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        self.pmesh.Mesh._sum, dist.all_reduce = self._undo

    def read(self):
        out = dict(self.sums)
        self.sums.update(calls=0, all_reduce_s=0.0, wire_s=0.0, mib=0.0)
        return out


def shard_rank_main(argv) -> int:
    """One rank of phase 15 (``--shard-rank RANK WORLD PORT DATA MODEL``): the
    seeded SD1.5 pipeline on the card, rank 0's unsharded request (before
    the mesh), the mesh and ``shard``, the kernel shapes of one sharded
    step, then SERVE_REQUESTS timed requests; rank 0 writes its results
    under SHARD_DIR."""
    import torch.distributed as dist

    from stable_diffusion_tpu_torch.parallel import mesh as pmesh

    rank, world, port, data, model = map(int, argv[:5])
    counters = kernel_counters()
    device = pmesh.init_distributed(rank, world, f"tcp://localhost:{port}", device="cuda")
    tag = f"{data}x{model}"
    try:
        pipe = build_pipeline(torch.bfloat16, "cuda", seed=SHARD_SEED)
        cond, uncond = request_ids(70)
        kw = dict(img_size=SHARD_SIZE, cfg_scale=7.5, inference_steps=SHARD_STEPS, seed=7000,
                  output_dtype="uint8")
        out = {"backend": dist.get_backend(), "device": str(device)}
        pipe.generate(cond, uncond, **dict(kw, inference_steps=1))  # warm-up
        if rank == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            np.save(os.path.join(SHARD_DIR, f"unsharded_{tag}.npy"), pipe.generate(cond, uncond, **kw))
            out["unsharded_s"] = time.perf_counter() - t0
        dist.barrier()
        mesh = pmesh.make_mesh(data, model)
        pipe.shard(mesh)
        _, _, shapes = recorded(counters, lambda: pipe.generate(cond, uncond,
                                                                **dict(kw, inference_steps=1)))
        secs, comm = [], []
        timer = _CollectiveTimer(pmesh)
        for _ in range(SERVE_REQUESTS):
            for c in counters.values():
                c.reset()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with timer:
                img = pipe.generate(cond, uncond, **kw)
                torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            comm.append(timer.read())
        np.save(os.path.join(SHARD_DIR, f"rank{rank}_{tag}.npy"), img)
        out.update(secs=secs, comm=comm, launches={k: c.launches for k, c in counters.items()},
                   shapes={k: [[list(key), n] for key, n in shapes[k].items()] for k in ("K3", "K4")},
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        with open(os.path.join(SHARD_DIR, f"rank{rank}_{tag}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def _run_world(world: int, role: str, args, label: str, timeout: float = SHARD_TIMEOUT):
    """Start ``world`` ranks of this script (``role`` RANK WORLD PORT
    ``args``) and wait for them (every one stopped on a timeout): (ok, each
    rank's output); a failed rank's tail goes to the log."""
    env = dict(os.environ)
    if os.path.isdir("/sys/class/net/lo"):  # the collectives' bootstrap stays on loopback
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), role, str(r), str(world),
                               str(port), *map(str, args)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    ok, logs, deadline = True, [], time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            try:
                log, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                log, _ = p.communicate()
                log += f"\n(killed after {timeout} s)"
            logs.append(log)
            if p.returncode != 0:
                ok = False
                say(f"  {label} rank {r}: exit {p.returncode}\n" + log[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return ok, logs


def phase_sharded(counters, card: str):
    """SD1.5 512^2 b1 DDIM (SHARD_STEPS) CFG 7.5 on a tensor-parallel mesh
    (1, 2): two ranks sharing the card over gloo; then one rank over NCCL
    as a 1x1 mesh.  The sharded image against rank 0's unsharded one; K3
    and K4 at the shapes a shard gives them (4 of 8 heads; hidden 4C / 2),
    checked there against their plain versions; seconds a request a mesh."""
    import shutil

    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    os.makedirs(SHARD_DIR)
    torch.cuda.empty_cache()
    try:
        ok = (_run_world(2, "--shard-rank", (1, 2), "shard tp=2 gloo")[0]
              and _run_world(1, "--shard-rank", (1, 1), "shard 1x1 nccl")[0])
        if not ok:
            return False, {}
        res = {}
        for tag, world in (("1x2", 2), ("1x1", 1)):
            res[tag] = [json.load(open(os.path.join(SHARD_DIR, f"rank{r}_{tag}.json")))
                        for r in range(world)]
            for r in range(world):
                res[tag][r]["img"] = np.load(os.path.join(SHARD_DIR, f"rank{r}_{tag}.npy"))
        base = np.load(os.path.join(SHARD_DIR, "unsharded_1x2.npy"))
        base_nccl = np.load(os.path.join(SHARD_DIR, "unsharded_1x1.npy"))
    finally:
        shutil.rmtree(SHARD_DIR, ignore_errors=True)
    tp, one = res["1x2"], res["1x1"][0]
    rel = rel_l2(torch.from_numpy(tp[0]["img"]), torch.from_numpy(base))
    ranks_equal = bool(np.array_equal(tp[0]["img"], tp[1]["img"]))
    one_equal = bool(np.array_equal(one["img"], base_nccl)) and bool(np.array_equal(base, base_nccl))
    shapes = {k: collections.Counter({tuple(key): n for key, n in tp[0]["shapes"][k]})
              for k in ("K3", "K4")}
    hidden = sorted({key[2] for key in shapes["K4"] if len(key) == 3})
    heads = sorted({key[3] for key in shapes["K3"]})
    launches = tp[0]["launches"]
    good = (rel <= SHARD_IMAGE_REL_L2 and ranks_equal and one_equal
            and tp[0]["backend"] == "gloo" and one["backend"] == "nccl"
            and hidden == [640, 1280, 2560] and all(len(key) == 3 for key in shapes["K4"])
            and 4 in heads and 8 not in heads
            and all(launches[k] > 0 for k in SERVING_KERNELS) and launches["K3:general"] == 0
            and all(launches[k] == 0 for k in KERNELS if k not in SERVING_KERNELS))
    say(f"  {card}: shard tp=2 (two ranks on one card, {tp[0]['backend']}): image rel_l2 to the "
        f"unsharded {rel:.3e}, ranks' images equal: {ranks_equal}; 1x1 ({one['backend']}) equal "
        f"to the unsharded: {one_equal}; K4 hidden widths {hidden}, K3 heads {heads}; launches "
        f"{{{', '.join(f'{k}: {v}' for k, v in launches.items() if v)}}} {'ok' if good else 'BAD'}")
    ok_k, summary = check_kernels(shapes, ("K3", "K4"), "shard")
    secs = {"unsharded": tp[0]["unsharded_s"], "1x2 gloo": tp[0]["secs"],
            "1x1 nccl": one["secs"]}
    for r, rank in enumerate(tp):
        for i, (s, c) in enumerate(zip(rank["secs"], rank["comm"])):
            say(f"  {card}: shard tp=2 rank {r} request {i}: {s:.3f} s, {c['calls']} all-reduces "
                f"of {c['mib']:.1f} MiB in all: {c['all_reduce_s']:.3f} s inside Mesh.all_reduce, "
                f"of which {c['wire_s']:.3f} s in gloo's all_reduce and "
                f"{c['all_reduce_s'] - c['wire_s']:.3f} s in host copies and casts; "
                f"{s - c['all_reduce_s']:.3f} s outside the collectives")
    return good and ok_k, dict(summary=summary, secs=secs, rel=rel, launches=launches,
                               peak_gib=[r["peak_gib"] for r in tp], comm=tp[0]["comm"])


def sharded_line(sh) -> str:
    s = sh["secs"]
    return (f"{SHARD_SIZE[0]}^2 b1 DDIM {SHARD_STEPS} CFG 7.5: s/request unsharded {s['unsharded']:.3f}, "
            f"tp=2 gloo {[round(v, 3) for v in s['1x2 gloo']]}, 1x1 nccl "
            f"{[round(v, 3) for v in s['1x1 nccl']]}; image rel_l2 {sh['rel']:.3e}; peak GiB a rank "
            f"{[round(v, 2) for v in sh['peak_gib']]}; "
            + ", ".join(f"{k} {v['shapes']} shapes max_rel={v['max_rel_err']:.2e} kernel "
                        f"{v['ms']:.2f} ms, plain {v['plain_ms']:.2f}, bound {v['bound_ms']:.2f}"
                        for k, v in sh["summary"].items()) + " per sharded pass")


# ---------------------------------------------------------------------------
# Phase 16: sharded training (the collectives in the autograd graph,
# training.make_train_step(mesh=...), the trainer CLI's --mesh_model_axis)
# ---------------------------------------------------------------------------

SHARD_TRAIN_DIR = os.path.join(REPO, "build", "shard_train")
SHARD_TRAIN_SEED = 60     # the UNet's weights: init_random_ from this seed on every rank
SHARD_TRAIN_CALLS = 4     # micro-steps a mesh: two updates at accumulation 2
SHARD_TRAIN_MESHES = "1x2,2x1"
SHARD_TRAIN_TIMEOUT = 600  # seconds a world may take
# The trainer CLI under two ranks at --mesh_model_axis 2 and on one: phase
# 12's cached run, cut to one update (two micro-steps).
SHARD_TRAIN_CLI_ARGS = [*TRAINER_ARGS, "--max_train_steps", "1"]
# Bounds, sharded against rank 0's unsharded bf16 step on the same batches:
# one micro-step's LoRA gradients within TRAIN_GRAD_REL_L2 (relative L2
# over the tree; the row-parallel partials, or the batch halves, summed in
# f32 on the host, then rounded to bf16, where the unsharded step rounds
# one product); the LoRA trees after two updates, and the CLI's checkpoint
# against the one-rank run's, by phase 12's rule (compare_end_states: an
# Adam element whose gradient lies within that rounding of 0 may move the
# other way); the two ranks of a mesh equal bit for bit; the 1x1 mesh the
# unsharded step bit for bit (its sums are of one rank: the same launches).


def shard_train_inputs(unet):
    """The LoRA tree (rank 128, alpha 128 on TRAIN_TARGETS, drawn on the
    whole UNet; B != 0, as check_train_grads's, so that A and alpha get
    gradients) and SHARD_TRAIN_CALLS b4 batches (phase 7's: cached 64^2
    latent moments and text embeddings, fresh t and noise each), from one
    seed: the same on every rank."""
    from stable_diffusion_tpu_torch import training as T
    from stable_diffusion_tpu_torch.models import lora as L

    gen = torch.Generator(device="cuda").manual_seed(5)
    lora = {"unet": L.init_lora(gen, unet, rank=128, alpha=128.0, targets=TRAIN_TARGETS)}
    for e in lora["unet"].values():
        e["lora_B"] = torch.randn(e["lora_B"].shape, generator=gen, device="cuda") * 1e-4
    b = TRAIN_BATCH
    fixed = {"latent_mean": torch.randn((b, 64, 64, 4), generator=gen, device="cuda").bfloat16(),
             "latent_std": F.softplus(torch.randn((b, 64, 64, 4), generator=gen,
                                                  device="cuda")).bfloat16(),
             "text_emb": torch.randn((b, 77, 768), generator=gen, device="cuda").bfloat16()}
    batches = []
    for _ in range(SHARD_TRAIN_CALLS):
        t, noise, vnoise = T.sample_noise_for_latents(gen, (b, 64, 64, 4), dtype=torch.bfloat16)
        batches.append({**fixed, "t": t, "noise": noise, "vae_noise": vnoise})
    return lora, batches


def shard_train_run(unet, mesh, lora, batches, counters, timer, path: str):
    """SHARD_TRAIN_CALLS calls of phase 7's train step (accumulation 2, EMA)
    on ``unet`` (sharded on ``mesh``, or whole with None), every launch
    counted from 0 and the first call's shapes recorded, each call timed with
    its sums; the first call's gradients (the accumulator after it) and the
    last LoRA tree saved to ``path``.  -> (figures, shapes)."""
    import torch.distributed as dist

    from stable_diffusion_tpu_torch import training as T
    from stable_diffusion_tpu_torch.models import ema
    from stable_diffusion_tpu_torch.schedulers import schedule as S
    from stable_diffusion_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = T.TrainConfig(rank=128, alpha=128.0, use_ema=True, grad_accum_steps=2,
                        lora_targets=TRAIN_TARGETS)
    lora = tree_map(torch.clone, lora)
    state = {"lora": lora, "opt_state": T.make_optimizer(cfg).init(lora),
             "ema": ema.ema_init(lora), "step": 0}
    step = T.make_train_step({"unet": unet}, schedule=S.make_schedule(), train_cfg=cfg,
                             impl="cuda", mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
        c.record()
    secs, comm, losses = [], [], []
    for i, batch in enumerate(batches):
        if mesh is not None:
            dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timer:
            state, m = step(state, batch)
            losses.append(m["loss"].item())
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        comm.append(timer.read())
        if i == 0:
            shapes = {k: c.stop_recording() for k, c in counters.items()}
            grads = [t.float().cpu() for t in tree_leaves(state["opt_state"]["acc"])]
    torch.save({"grads": grads, "lora": [t.cpu() for t in tree_leaves(state["lora"])]}, path)
    return dict(secs=secs, comm=comm, losses=losses, lr=cfg.learning_rate,
                launches={k: c.launches for k, c in counters.items()},
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30), shapes


def shard_train_rank_main(argv) -> int:
    """One rank of phase 16 (``--train-rank RANK WORLD PORT MESHES CHECK``):
    the seeded SD1.5 UNet in bf16 on the card and shard_train_inputs; rank
    0's unsharded run first, then for each mesh of MESHES ("1x2,2x1") a
    fresh UNet sharded on it and shard_train_run; with CHECK ("check"),
    rank 0 then checks and times every kernel at the first mesh's shapes
    while the other ranks wait.  Writes under SHARD_TRAIN_DIR."""
    import torch.distributed as dist

    from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
    from stable_diffusion_tpu_torch.parallel import mesh as pmesh
    from stable_diffusion_tpu_torch.utils import weights as W
    from stable_diffusion_tpu_torch.utils.tree import tree_leaves

    rank, world, port = map(int, argv[:3])
    tag, check = argv[3], argv[4] == "check"
    counters = kernel_counters()
    pmesh.init_distributed(rank, world, f"tcp://localhost:{port}", device="cuda")
    try:
        unet = W.build(UNet, UNetConfig.sd15(), device="cuda", dtype=torch.bfloat16)
        W.init_random_(unet, SHARD_TRAIN_SEED)
        unet.requires_grad_(False)
        lora, batches = shard_train_inputs(unet)
        if rank == 0:
            torch.save([t.cpu() for t in tree_leaves(lora)],
                       os.path.join(SHARD_TRAIN_DIR, f"init_{tag}.pt"))
        whole = unet.state_dict()
        timer = _CollectiveTimer(pmesh)
        out, first = {"backend": dist.get_backend(), "runs": {}}, None
        if rank == 0:
            out["runs"]["unsharded"], _ = shard_train_run(
                unet, None, lora, batches, counters, timer,
                os.path.join(SHARD_TRAIN_DIR, f"unsharded_{tag}.pt"))
        dist.barrier()
        for m in tag.split(","):
            data, model = map(int, m.split("x"))
            mesh = pmesh.make_mesh(data, model)
            local = W.build(UNet, UNetConfig.sd15(), device="cuda", dtype=torch.bfloat16)
            local.load_state_dict(whole)
            local.requires_grad_(False)
            pmesh.shard_module_(local, mesh)
            out["runs"][m], shapes = shard_train_run(
                local, mesh, lora, batches, counters, timer,
                os.path.join(SHARD_TRAIN_DIR, f"{m}_rank{rank}.pt"))
            first = first or shapes
            del local
            torch.cuda.empty_cache()
        del unet, whole
        torch.cuda.empty_cache()
        dist.barrier()
        if check and rank == 0:  # the card to itself: the kernels at the first mesh's shapes
            set_exp_rate()
            say("  shard_train step shapes: " + ", ".join(
                f"{k} {len(first[k])} shapes {sum(first[k].values())} calls" for k in TRAIN_KERNELS))
            ok_k, summary = check_kernels(first, TRAIN_KERNELS, "shard_train")
            ok_k &= no_general_body(first, "sharded train step")
            pair = attention_bwd_pair(first, torch.Generator(device="cuda").manual_seed(7))
            out.update(kernels_ok=ok_k, summary=summary, pair_bound_ms=pair[0],
                       pair_library_ms=pair[1], k5_heads=sorted({key[2] for key in first["K5"]}),
                       k4_hidden=sorted({key[2] for key in first["K4"] if len(key) == 3}),
                       k4_keys=sorted(len(key) for key in first["K4"]))
        dist.barrier()
        with open(os.path.join(SHARD_TRAIN_DIR, f"{tag}_rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def train_cli_rank_main(argv) -> int:
    """One rank of phase 16's trainer run (``--train-cli-rank RANK WORLD PORT
    ARGV_JSON``): the launcher's variables set as ``python -m
    torch.distributed.run`` sets them, then ``train_lora_dreambooth_torch.main``
    with its steps timed and its checkpoint writes counted.  Writes
    SHARD_TRAIN_DIR/cli_rank{RANK}.json."""
    rank, world, port = map(int, argv[:3])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import train_lora_dreambooth_torch as tcli
    from stable_diffusion_tpu_torch.utils import checkpoint as ckpt

    counters = kernel_counters()
    for c in counters.values():
        c.reset()
    saved, save = [], ckpt.save_train_checkpoint
    ckpt.save_train_checkpoint = lambda path, tree: saved.append(path) or save(path, tree)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed_train_steps() as steps:
        tcli.main(json.loads(argv[3]))
    torch.cuda.synchronize()
    with open(os.path.join(SHARD_TRAIN_DIR, f"cli_rank{rank}.json"), "w") as f:
        json.dump(dict(losses=steps.losses, secs=steps.secs, main_s=time.perf_counter() - t0,
                       saved=saved, launches={k: c.launches for k, c in counters.items()},
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30), f)
    return 0


def _tree_rel_l2(got, want) -> float:
    num = sum(float(((g.float() - w.float()) ** 2).sum()) for g, w in zip(got, want, strict=True))
    return (num / max(sum(float((w.float() ** 2).sum()) for w in want), 1e-30)) ** 0.5


def _trees_agree(got, want, init, lr: float, label: str) -> bool:
    """Two LoRA trees after the same updates (phase 12's rule): at most
    TRAINER_GROSS_SHARE of the elements apart by more than lr / 2; the
    relative L2 of the two updates (the trees less ``init``) printed."""
    gross, total, _ = gross_apart(got, want, lr)
    upd = _tree_rel_l2([g - i for g, i in zip(got, init)], [w - i for w, i in zip(want, init)])
    ok = gross <= TRAINER_GROSS_SHARE * total
    say(f"  {label}: {gross} of {total} LoRA elements apart by more than lr/2 "
        f"({gross / total:.2e}, tol {TRAINER_GROSS_SHARE}); the updates' rel_l2 {upd:.3e} "
        f"{'ok' if ok else 'BAD'}")
    return ok


def shard_train_cli(card: str):
    """train_lora_dreambooth_torch.main for one update on phase 12's data and
    phase 10's f16 directory: one rank in this process, then two ranks at
    --mesh_model_axis 2 (a (1, 2) mesh over gloo on the card).  The two-rank
    checkpoint against the one-rank one (compare_end_states); only rank 0
    writes it."""
    import train_lora_dreambooth_torch as tcli
    from stable_diffusion_tpu_torch.utils.checkpoint import load_train_checkpoint

    write_cli_checkpoints(ldm_and_kohya=False)
    data = os.path.join(SHARD_TRAIN_DIR, "data")
    write_dreambooth_data(data)

    def argv(name, *extra):
        return ["--model_path", os.path.join(CLI_DIR, "sd15"), "--tokenizer_dir",
                os.path.join(CLI_DIR, "tokenizer"), "--data_dir", data, "--checkpoint_dir",
                os.path.join(SHARD_TRAIN_DIR, name), "--log_dir",
                os.path.join(SHARD_TRAIN_DIR, name, "logs"), *SHARD_TRAIN_CLI_ARGS, *extra]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timed_train_steps() as one_steps:
        tcli.main(argv("one"))
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    ok, _ = _run_world(2, "--train-cli-rank", (json.dumps(argv("tp2", "--mesh_model_axis", "2")),),
                       "trainer tp=2", SHARD_TRAIN_TIMEOUT)
    if not ok:
        return False, {}
    ranks = [json.load(open(os.path.join(SHARD_TRAIN_DIR, f"cli_rank{r}.json"))) for r in range(2)]
    one = load_train_checkpoint(os.path.join(SHARD_TRAIN_DIR, "one", "epoch-0.ckpt"))["state"]
    tp2 = load_train_checkpoint(os.path.join(SHARD_TRAIN_DIR, "tp2", "epoch-0.ckpt"))["state"]
    lr = float(TRAINER_ARGS[TRAINER_ARGS.index("--lr") + 1])
    ok_e = compare_end_states(tp2, one, ranks[0]["losses"], one_steps.losses, lr,
                              "trainer two ranks at --mesh_model_axis 2 vs one rank")
    written = sorted(f for f in os.listdir(os.path.join(SHARD_TRAIN_DIR, "tp2")) if f.endswith(".ckpt"))
    ok_w = (ranks[0]["saved"] == [os.path.join(SHARD_TRAIN_DIR, "tp2", "epoch-0")]
            and ranks[1]["saved"] == [] and written == ["epoch-0.ckpt"])
    launches = ranks[0]["launches"]
    ok_l = (all(launches[k] > 0 for k in TRAIN_KERNELS) and launches["K3:general"] == 0
            and all(launches[k] == 0 for k in KERNELS if k not in TRAIN_KERNELS))
    say(f"  {card}: trainer CLI one update b2+2 512^2: one rank {one_s:.2f} s of main(), s/step "
        f"{[round(x, 4) for x in one_steps.secs]}; two ranks at --mesh_model_axis 2 "
        f"{[round(r['main_s'], 2) for r in ranks]} s of main(), s/step "
        f"{[round(x, 4) for x in ranks[0]['secs']]}, losses {[round(x, 5) for x in ranks[0]['losses']]} "
        f"vs {[round(x, 5) for x in one_steps.losses]}, peak GiB a rank "
        f"{[round(r['peak_gib'], 2) for r in ranks]}; only rank 0 wrote ({written}): {ok_w}; "
        f"launches {{{', '.join(f'{k}: {v}' for k, v in launches.items() if v)}}} "
        f"{'ok' if ok_l else 'BAD'}")
    return ok_e and ok_w and ok_l, dict(one_s=one_s, secs=ranks[0]["secs"],
                                        main_s=[r["main_s"] for r in ranks],
                                        one_secs=one_steps.secs)


def phase_sharded_train(counters, card: str):
    """The LoRA train step on meshes (1, 2) and (2, 1) of two ranks sharing
    the card over gloo, then a 1x1 mesh of one rank over NCCL, each against
    rank 0's unsharded step; K1-K6 at a tp = 2 rank's shapes; the trainer
    CLI under two ranks at --mesh_model_axis 2."""
    import shutil

    shutil.rmtree(SHARD_TRAIN_DIR, ignore_errors=True)
    os.makedirs(SHARD_TRAIN_DIR)
    torch.cuda.empty_cache()
    try:
        ok_a, logs = _run_world(2, "--train-rank", (SHARD_TRAIN_MESHES, "check"), "train gloo",
                                SHARD_TRAIN_TIMEOUT)
        if ok_a:
            for line in logs[0].splitlines():
                say(line)
        ok_b, _ = _run_world(1, "--train-rank", ("1x1", "-"), "train 1x1 nccl", SHARD_TRAIN_TIMEOUT)
        if not (ok_a and ok_b):
            return False, {}
        tags = {SHARD_TRAIN_MESHES: 2, "1x1": 1}
        res = {tag: [json.load(open(os.path.join(SHARD_TRAIN_DIR, f"{tag}_rank{r}.json")))
                     for r in range(n)] for tag, n in tags.items()}
        load = lambda name: torch.load(os.path.join(SHARD_TRAIN_DIR, name))  # noqa: E731
        base, base1 = load(f"unsharded_{SHARD_TRAIN_MESHES}.pt"), load("unsharded_1x1.pt")
        init = load(f"init_{SHARD_TRAIN_MESHES}.pt")
        lr = res[SHARD_TRAIN_MESHES][0]["runs"]["unsharded"]["lr"]
        ok, rel = True, {}
        for m in SHARD_TRAIN_MESHES.split(","):
            ranks = [load(f"{m}_rank{r}.pt") for r in range(2)]
            rel[m] = _tree_rel_l2(ranks[0]["grads"], base["grads"])
            equal = all(torch.equal(a, b) for key in ("grads", "lora")
                        for a, b in zip(ranks[0][key], ranks[1][key]))
            good = rel[m] <= TRAIN_GRAD_REL_L2 and equal
            say(f"  shard_train {m}: one micro-step's LoRA gradients rel_l2 to the unsharded "
                f"{rel[m]:.3e} (tol {TRAIN_GRAD_REL_L2}); the two ranks' gradients and trees equal: "
                f"{equal} {'ok' if good else 'BAD'}")
            ok &= good and _trees_agree(ranks[0]["lora"], base["lora"], init, lr,
                                        f"shard_train {m} LoRA tree after two updates")
        one = load("1x1_rank0.pt")
        same = all(torch.equal(a, b) for key in ("grads", "lora") for a, b in zip(one[key], base1[key]))
        ok &= same and res["1x1"][0]["backend"] == "nccl" and res[SHARD_TRAIN_MESHES][0]["backend"] == "gloo"
        say(f"  shard_train 1x1 ({res['1x1'][0]['backend']}): the unsharded step's gradients and tree "
            f"bit for bit: {same}")
        a0 = res[SHARD_TRAIN_MESHES][0]
        ok &= bool(a0["kernels_ok"]) and a0["k5_heads"] == [4] and a0["k4_hidden"] == [640, 1280, 2560]
        runs = {m: [r["runs"][m] for r in res[SHARD_TRAIN_MESHES]] for m in SHARD_TRAIN_MESHES.split(",")}
        runs["1x1"] = [res["1x1"][0]["runs"]["1x1"]]
        runs["unsharded"] = [a0["runs"]["unsharded"]]
        for m, rs in runs.items():
            for r, run in enumerate(rs):
                la = run["launches"]
                good = (all(la[k] > 0 for k in TRAIN_KERNELS) and la["K3:general"] == 0
                        and all(la[k] == 0 for k in KERNELS if k not in TRAIN_KERNELS)
                        and all(np.isfinite(run["losses"])))
                ok &= good
                for i, (sec, c) in enumerate(zip(run["secs"], run["comm"])):
                    say(f"  {card}: shard_train {m} rank {r} micro-step {i}: {sec:.3f} s, loss "
                        f"{run['losses'][i]:.5f}, {c['calls']} sums of {c['mib']:.1f} MiB in all: "
                        f"{c['all_reduce_s']:.3f} s in the sums ({c['wire_s']:.3f} s in gloo's or "
                        f"NCCL's call), {sec - c['all_reduce_s']:.3f} s outside")
                say(f"  shard_train {m} rank {r}: peak {run['peak_gib']:.2f} GiB, launches "
                    f"{{{', '.join(f'{k}: {v}' for k, v in la.items() if v)}}} {'ok' if good else 'BAD'}")
        ok_c, cli = shard_train_cli(card)
    finally:
        shutil.rmtree(SHARD_TRAIN_DIR, ignore_errors=True)
        shutil.rmtree(CLI_DIR, ignore_errors=True)

    def median_after_first(run):
        return statistics.median(run["secs"][1:])

    figures = {m: dict(s=median_after_first(rs[0]),
                       share=sum(c["all_reduce_s"] for c in rs[0]["comm"][1:])
                       / sum(rs[0]["secs"][1:]),
                       calls=rs[0]["comm"][1]["calls"], mib=rs[0]["comm"][1]["mib"],
                       peak=[r["peak_gib"] for r in rs]) for m, rs in runs.items()}
    return ok and ok_c, dict(summary=a0["summary"], launches=runs["1x2"][0]["launches"],
                             figures=figures, rel=rel, cli=cli,
                             pair_bound_ms=a0["pair_bound_ms"], pair_library_ms=a0["pair_library_ms"])


def sharded_train_line(st) -> str:
    f = st["figures"]
    return (f"SD1.5 LoRA r128 b4 512^2 accumulation 2 on a mesh: s/micro-step (median of calls 2-4) "
            + ", ".join(f"{m} {v['s']:.3f} ({100 * v['share']:.1f}% in {v['calls']} sums of "
                        f"{v['mib']:.1f} MiB; peak GiB a rank {[round(x, 2) for x in v['peak']]})"
                        for m, v in f.items())
            + "; grads rel_l2 " + ", ".join(f"{m} {v:.3e}" for m, v in st["rel"].items())
            + f"; trainer CLI two ranks s/step {[round(x, 3) for x in st['cli']['secs']]} vs one "
              f"{[round(x, 3) for x in st['cli']['one_secs']]}; "
            + ", ".join(f"{k} {v['shapes']} shapes max_rel={v['max_rel_err']:.2e} kernel "
                        f"{v['ms']:.2f} ms, plain {v['plain_ms']:.2f}, bound {v['bound_ms']:.2f}"
                        for k, v in st["summary"].items()) + " per tp=2 rank micro-step")


def k1_host(pipe, counters):
    """K1 by kind at the serving pass's shapes, through the raw kernel
    wrappers of whichever package was imported (``--root``): device ms a
    pass (CUDA events, as phase 3) and host us a call at each kind's
    smallest shape (1000 calls, no synchronize), beside the library call;
    then :func:`k2_host`."""
    from stable_diffusion_tpu_torch.ops import groupnorm

    shapes = record_main_path_shapes(pipe, {"K1": counters["K1"]})["K1"]
    gen = torch.Generator(device="cuda").manual_seed(1234)
    tot = {}
    for key, n in sorted(shapes.items(), key=lambda kv: (kv[0][0], kv[0][1] * kv[0][2] * kv[0][3])):
        kind, b, hw, c = key[:4]
        eps = key[5]
        x = (torch.randn((b, hw, 1, c), generator=gen, device="cuda") * 2 + 0.5).bfloat16()
        w = (1 + 0.1 * torch.randn(c, generator=gen, device="cuda")).bfloat16()
        bias = (0.1 * torch.randn(c, generator=gen, device="cuda")).bfloat16()
        if kind == "stats":
            def raw():
                return groupnorm.gn_scale_shift_kernel(x, w, bias, eps=eps)

            def lib():
                return torch.var_mean(x.view(b, hw, 32, c // 32), dim=(1, 3))
        else:
            def raw():
                return groupnorm.group_norm_silu_kernel(x, w, bias, eps=eps, silu=key[6])

            def lib():
                y = F.group_norm(x.view(b, hw, c).transpose(1, 2), 32, w, bias, eps)
                return F.silu(y) if key[6] else y
        t = tot.setdefault(kind, dict(calls=0, ms=0.0, library_ms=0.0))
        k_ms, l_ms = cuda_ms(raw), cuda_ms(lib)
        t["calls"] += n
        t["ms"] += n * k_ms
        t["library_ms"] += n * l_ms
        if "host_us" not in t:  # the kind's smallest shape comes first
            t["host_us"] = host_us(raw)
            t["host_shape"] = (b, hw, c)
        say(f"  k1 {kind} shape={(b, hw, c)} calls={n} kernel_ms={k_ms:.4f} library_ms={l_ms:.4f}")
    say("k1 per serving pass, " + os.path.dirname(groupnorm.__file__) + ": " + "; ".join(
        f"{kind} {t['calls']} calls {t['ms']:.3f} ms (library {t['library_ms']:.3f}), host "
        f"{t['host_us']:.2f} us a call at {t['host_shape']}" for kind, t in tot.items())
        + f"; total {sum(t['ms'] for t in tot.values()):.3f} ms")
    k2_host()


def k2_host(key=(1, 8, 8, 64, 64, False)):
    """K2's raw wrapper at a shape whose device time (a few us) lies far
    below its host time, so the host is what is timed (the serving pass's
    smallest shape, 2 x 8^2 x 1280, keeps the device busier than the host):
    host us a call (median of 5 rounds of :func:`host_us`) with the
    package's spans off and, where it has them, recorded (no profiler
    running); and, where it has spans, the host us of an unrecorded span
    alone (a million empty ``with K2.span()`` blocks), the price every
    launch pays when off."""
    from stable_diffusion_tpu_torch.ops import conv
    from stable_diffusion_tpu_torch.utils import device

    b, h, w, cin, cout, prologue = key
    gen = torch.Generator(device="cuda").manual_seed(1234)
    x = torch.randn((b, h, w, cin), generator=gen, device="cuda").bfloat16()
    wt = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") * (9 * cin) ** -0.5).bfloat16()
    ss = torch.randn((b, 2, cin), generator=gen, device="cuda") if prologue else None

    def raw():
        return conv.conv3x3_kernel(x, wt, None, ss)

    def median_us():
        return statistics.median(host_us(raw) for _ in range(5))

    line = f"k2 host us a call at {key}, {os.path.dirname(conv.__file__)}: spans off {median_us():.3f}"
    spans = getattr(device, "SPANS", None)
    if spans is not None:
        spans.record()
        line += f", spans recorded {median_us():.3f}"
        spans.stop_recording()
        n = 1_000_000
        t0 = time.perf_counter()
        for _ in range(n):
            with conv.K2.span():
                pass
        line += f"; an unrecorded span alone {(time.perf_counter() - t0) / n * 1e6:.4f}"
    say(line)


def graph_ms(fn, reps: int = 10) -> float:
    """Device milliseconds per call: ``reps`` calls captured in a CUDA graph
    and replayed, so no host launch cost is timed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay) / reps


def k2_device(pipe, counters):
    """K2 at every shape of the serving pass, host and device apart: the
    entry point as phase 3 times it (K1's statistics launches, both
    wrappers' host work and the kernel), the raw kernel launched eagerly,
    the raw kernel and F.conv2d replayed from CUDA graphs (device time),
    and the plain version; per shape and per pass."""
    from stable_diffusion_tpu_torch.ops import conv

    shapes = record_main_path_shapes(pipe, counters)["K2"]
    gen = torch.Generator(device="cuda").manual_seed(1234)
    tot = dict(entry=0.0, raw=0.0, device=0.0, library_device=0.0, plain=0.0)
    for key, n in sorted(shapes.items(), key=str):
        b, h, w, cin, cout, prologue = key
        case = _case("K2", key, gen)
        x = torch.randn((b, h, w, cin), generator=gen, device="cuda").bfloat16()
        wt = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") * (9 * cin) ** -0.5).bfloat16()
        ss = torch.randn((b, 2, cin), generator=gen, device="cuda") if prologue else None

        def raw():
            return conv.conv3x3_kernel(x, wt, None, ss)
        row = dict(entry=cuda_ms(case["kernel"]), raw=cuda_ms(raw), device=graph_ms(raw),
                   library_device=graph_ms(case["library"]), plain=cuda_ms(case["plain"]))
        for k, v in row.items():
            tot[k] += n * v
        say(f"  k2 shape={key[:5]} prologue={prologue} {case['note']} calls={n} "
            + " ".join(f"{k}_ms={v:.4f}" for k, v in row.items()))
    say("k2 per serving pass (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in tot.items()))


# K3's shapes on the four paths, (b, sq, sk, h, d): the UNet's
# self-attention (the ring body) for SD1.5 serving (CFG batch 2) at 64^2 and
# 32^2 latents, SD2.1 at 96^2, 48^2 and 24^2, W8A8 serving (UNet batch 8)
# and training (batch 4); the 77-token cross-attention (the cross body) at
# every SD1.5 and SD2.1 serving level and SD1.5's first level at batch 8;
# SD1.5's d = 160 self-attention and the VAE's d = 512 head (the wide body).
K3_SWEEP_SHAPES = [(2, 4096, 4096, 8, 40), (2, 1024, 1024, 8, 80), (2, 9216, 9216, 5, 64),
                   (2, 2304, 2304, 10, 64), (2, 576, 576, 20, 64), (8, 4096, 4096, 8, 40),
                   (8, 1024, 1024, 8, 80), (4, 4096, 4096, 8, 40), (4, 1024, 1024, 8, 80),
                   (2, 4096, 77, 8, 40), (2, 1024, 77, 8, 80), (2, 256, 77, 8, 160),
                   (2, 64, 77, 8, 160), (2, 9216, 77, 5, 64), (2, 2304, 77, 10, 64),
                   (2, 576, 77, 20, 64), (2, 144, 77, 20, 64), (8, 4096, 77, 8, 40),
                   (8, 1024, 77, 8, 80), (4, 1024, 77, 8, 80), (4, 4096, 77, 8, 40),
                   (2, 256, 256, 8, 160), (2, 64, 64, 8, 160), (4, 256, 256, 8, 160),
                   (1, 4096, 4096, 1, 512), (4, 4096, 4096, 1, 512), (1, 9216, 9216, 1, 512)]


def k3_sweep() -> bool:
    """K3 at each shape of K3_SWEEP_SHAPES (q/k/v of a self-attention as the
    fused QKV's views) through the raw kernel: the general body (the first
    design) beside every compiled variant of the body the planner picks (the
    ring's tiles; the cross body's query tiles a block; the wide body's key
    splits 1-8), beside SDPA and the bound, with each
    one's error against the plain f32 version; eager CUDA-event ms (the
    host's launch cost included) and device ms (CUDA-graph replay); marks
    the planner's choice."""
    from stable_diffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1234)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True
    for b, sq, sk, h, d in K3_SWEEP_SHAPES:
        if sq == sk:
            qkv = (torch.randn((b, sq, 3 * h * d), generator=gen, device="cuda")).bfloat16()
            q, k, v = (t.reshape(b, sq, h, d) for t in qkv.split(h * d, dim=-1))
        else:
            q, k, v = ((torch.randn((b, n, h, d), generator=gen, device="cuda")).bfloat16()
                       for n in (sq, sk, sk))
        ref = fa.attention_plain(q.float(), k.float(), v.float())
        refmax = ref.abs().max().item()
        chosen = fa.attention_plan(b, sq, sk, h, d, sms)
        dp = chosen.dp
        plans = [fa.general_plan(d)]
        if chosen.body == "ring":
            plans += [fa.AttentionPlan("ring", dp, bq) for vdp, bq in fa.K3_RING if vdp == dp]
        elif chosen.body == "cross":
            plans += sorted({chosen, *(chosen._replace(tiles=t) for t in (1, 2, 3, 4, 6)
                                       if t <= -(-sq // 64))})
        elif chosen.body == "wide":
            plans += sorted({chosen, *(chosen._replace(splits=n)
                                       for n in range(1, min(fa.WIDE_MAX_SPLITS, -(-sk // 64)) + 1))})
        b_ms, _ = bound_ms(4 * b * h * sq * sk * d, 2 * b * h * d * (2 * sq + 2 * sk), BF16_TC_FLOPS)
        e_ms = b * h * sq * sk / EXP_RATE * 1e3
        def sdpa():
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        say(f"  k3 shape={(b, sq, sk, h, d)} sdpa_ms={cuda_ms(sdpa):.4f} sdpa_dev_ms={graph_ms(sdpa):.4f} "
            f"bound_ms={max(b_ms, e_ms):.4f} (bytes/products {b_ms:.4f}, exponentials {e_ms:.4f})")
        for plan in plans:
            def run(plan=plan):
                return fa.attention_kernel(q, k, v, _plan=plan)
            got = run().float()
            torch.cuda.synchronize()
            rel = (got - ref).abs().max().item() / refmax
            good = bool(torch.isfinite(got).all().item()) and rel <= KERNEL_REL_TOL
            ok &= good
            say(f"    {k3_note(plan):40s} {'ok ' if good else 'BAD'} rel={rel:.3e} "
                f"ms={cuda_ms(run, reps=30, rounds=5):.4f} dev_ms={graph_ms(run):.4f}"
                + (" <- plan" if plan == chosen else ""))
            del got
        del q, k, v, ref
        torch.cuda.empty_cache()
    return ok


# (b, s, h, d) of the train step's K5/K6 ring-body shapes (SD1.5 b4), and an
# SD2.1 d = 64 self-attention shape for the planner's d = 64 tiles.
K56_SWEEP_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80), (2, 2304, 10, 64)]


def k56_sweep() -> bool:
    """K5 and K6 at each ring-body shape of the train step, q/k/v as the
    fused QKV's views: the planned ring body and the first (general) body
    through ``_plan``, each kernel with its registers, spills and blocks an
    SM and its error against the plain f32 backward (K5's dq and delta; K6
    on the plain f32 delta), each pair also through the entry point, beside
    SDPA's backward and the pair's bound (with its exponential term: one a
    logit, two in the split design)."""
    from stable_diffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1234)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True
    for b, s, h, d in K56_SWEEP_SHAPES:
        qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").bfloat16()
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        do = torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
        with torch.no_grad():
            o, lse2 = fa.attention_kernel(q, k, v, return_lse=True)
            f32 = [t.float() for t in (q, k, v, o, do)]
            want_dq, lse, delta = fa.attention_bwd_dq_plain(*f32)
            want_dk, want_dv = fa.attention_bwd_dkv_plain(f32[0], f32[1], f32[2], f32[4], lse, delta)
            delta = delta.contiguous()
            del lse, f32
        chosen = fa.attention_bwd_plan(b, s, h, d, sms)
        nbhsd = b * h * s * d
        b_ms, _ = bound_ms(10 * nbhsd * s, 2 * 8 * nbhsd, BF16_TC_FLOPS)
        e_ms = b * h * s * s / EXP_RATE * 1e3
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt)
        g = do.transpose(1, 2)
        lib = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), g, retain_graph=True),
                      reps=20, rounds=5)
        del out, qt, kt, vt, g
        say(f"  k56 shape={(b, s, h, d)} plan={tuple(chosen)} sdpa_backward_ms={lib:.4f} "
            f"bound_ms={max(b_ms, e_ms):.4f} (bytes/products {b_ms:.4f}, exponentials "
            f"{e_ms:.4f}; split design {2 * e_ms:.4f})")
        ms = {}  # (body, kernel) -> ms a call
        for plan in fa.attention_bwd_variants(chosen.dp):  # the first (general) body, the ring
            for kernel in ("K5", "K6"):
                if kernel == "K5":
                    def run(plan=plan):
                        return fa.attention_bwd_dq_kernel(q, k, v, o, lse2, do, _plan=plan)
                    pairs = list(zip(run(), (want_dq, delta)))
                else:
                    def run(plan=plan):
                        return fa.attention_bwd_dkv_kernel(q, k, v, lse2, delta, do, _plan=plan)
                    pairs = list(zip(run(), (want_dk, want_dv)))
                torch.cuda.synchronize()
                rel = max((x.float() - w).abs().max().item() / w.abs().max().item()
                          for x, w in pairs)
                good = all(bool(torch.isfinite(x).all().item()) for x, _ in pairs)
                good &= rel <= KERNEL_REL_TOL
                ok &= good
                del pairs
                ms[plan.body, kernel] = cuda_ms(run, reps=20, rounds=5)
                occ = fa.attention_bwd_occupancy(plan)[kernel]
                _, rows, tile = getattr(plan, kernel.lower())
                say(f"    {kernel} {plan.body:7s} rows={rows:3d} tile={tile:2d} "
                    f"{'ok ' if good else 'BAD'} rel={rel:.3e} ms={ms[plan.body, kernel]:.4f} "
                    f"registers={occ['registers']} spill_bytes={occ['spill_bytes']} "
                    f"blocks/SM={occ['blocks_per_sm']}" + (" <- plan" if plan == chosen else ""))
        # each body's pair as the train step calls it (K5 then K6, one entry)
        entry = {plan.body: cuda_ms(lambda plan=plan: fa.attention_bwd_kernel(
            q, k, v, o, lse2, do, _plan=plan), reps=20, rounds=5)
                 for plan in fa.attention_bwd_variants(chosen.dp)}
        say(f"  k56 shape={(b, s, h, d)} pair, ms a call: " + "; ".join(
            f"{body} K5 {ms[body, 'K5']:.4f} + K6 {ms[body, 'K6']:.4f}, through "
            f"attention_bwd_kernel {entry[body]:.4f}" for body in entry)
            + f"; sdpa backward {lib:.4f}")
        del q, k, v, o, do, qkv, want_dq, want_dk, want_dv, delta, lse2
        torch.cuda.empty_cache()
    return ok


# (m, c) of K4 at every shape of the serve (SD1.5 b1), SD2.1 and train (b4)
# passes, with its calls a pass.
K4_SWEEP_SHAPES = {"serve": [((8192, 320), 5), ((2048, 640), 5), ((512, 1280), 5), ((128, 1280), 1)],
                   "sd21": [((18432, 320), 5), ((4608, 640), 5), ((1152, 1280), 5),
                            ((288, 1280), 1)],
                   "train": [((16384, 320), 5), ((4096, 640), 5), ((1024, 1280), 5),
                             ((256, 1280), 1)]}


def k4_sweep() -> bool:
    """K4 at each (m, c) of the three passes: every compiled G1 variant with
    the planner's G2, and every G2 variant with the planner's G1 (each with
    the planner's splits for it), each checked through the whole block
    against the plain f32 version and timed alone (G1 or G2), beside the
    planner's choice through the entry point; per-pass sums by variant."""
    from stable_diffusion_tpu_torch.ops import ffn

    gen = torch.Generator(device="cuda").manual_seed(1234)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True
    for pas, shapes in K4_SWEEP_SHAPES.items():
        per_pass = {}
        for (m, c), calls in shapes:
            rn = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
                                            * scale).bfloat16()
            args = [rn(m, c), 1 + rn(c, scale=0.1), rn(c, scale=0.1), rn(8 * c, c, scale=c ** -0.5),
                    rn(8 * c, scale=0.1), rn(c, 4 * c, scale=(4 * c) ** -0.5), rn(c, scale=0.1),
                    rn(m, c)]
            ref = ffn.geglu_ffn_plain(*(t.float() for t in args))
            refmax = ref.abs().max().item()
            chosen = ffn.ffn_plan(m, c, sms)
            entry = cuda_ms(lambda: ffn.geglu_ffn(*args, impl="cuda"))
            say(f"  k4 {pas} shape={(m, c)} calls={calls} plan={tuple(chosen)[:4]} entry_ms={entry:.4f}")
            per_pass.setdefault("entry", 0.0)
            per_pass["entry"] += calls * entry
            variants = [("G1", v, dict(g1=v)) for v in ffn.FFN_G1_VARIANTS
                        if ffn._up_smem(v[0], v[1], c) <= ffn.SMEM_BLOCK]
            variants += [("G2", v, dict(g2=v)) for v in ffn.FFN_G2_VARIANTS]
            for part, v, kw in variants:
                plan = ffn.ffn_plan(m, c, sms, **kw)
                got = ffn.geglu_ffn_kernel(*args, _plan=plan).float()
                torch.cuda.synchronize()
                rel = (got - ref).abs().max().item() / refmax
                good = bool(torch.isfinite(got).all().item()) and rel <= KERNEL_REL_TOL
                ok &= good
                ms = cuda_ms(lambda: ffn.geglu_ffn_kernel(*args, _plan=plan,
                                                          _parts=1 if part == "G1" else 2))
                per_pass[(part, v)] = per_pass.get((part, v), 0.0) + calls * ms
                split = plan.nsplit1 if part == "G1" else plan.ksplit2
                mark = " <- plan" if (plan.g1 if part == "G1" else plan.g2) == (
                    chosen.g1 if part == "G1" else chosen.g2) else ""
                say(f"    {part} {v} split={split} {'ok ' if good else 'BAD'} rel={rel:.3e} "
                    f"ms={ms:.4f}{mark}")
            del args, ref
            torch.cuda.empty_cache()
        say(f"k4 {pas} per pass (ms): " + "; ".join(
            f"{k if isinstance(k, str) else k[0] + ' ' + str(k[1])} {v:.3f}"
            for k, v in per_pass.items()))
    return ok


# (M, K, N, LN, residual) of phase 6's K8 shapes and their calls in one
# W8A8 b4 pass (one b4 DDIM step at UNet batch 8).
K8_SWEEP_SHAPES = [((1, 1280, 1280, False, False), 13), ((1, 1280, 320, False, False), 5),
                   ((1, 1280, 640, False, False), 5), ((1, 320, 1280, False, False), 1),
                   ((32768, 320, 320, False, True), 10), ((32768, 320, 320, True, False), 5),
                   ((32768, 320, 960, True, False), 5), ((8192, 640, 640, False, True), 10),
                   ((8192, 640, 640, True, False), 5), ((8192, 640, 1920, True, False), 5),
                   ((2048, 1280, 1280, False, True), 10), ((2048, 1280, 1280, True, False), 5),
                   ((2048, 1280, 3840, True, False), 5), ((512, 1280, 1280, False, True), 2),
                   ((512, 1280, 1280, True, False), 1), ((512, 1280, 3840, True, False), 1),
                   ((616, 768, 320, False, False), 10), ((616, 768, 640, False, False), 10),
                   ((616, 768, 1280, False, False), 12)]


def k8_sweep() -> bool:
    """K8 at each W8A8 path shape: every compiled variant with the
    planner's splits for it, each checked against the plain f32 version and
    timed on the device (CUDA-graph replay), beside the planner's choice
    through the entry point (CUDA events as phase 6 times it, the device
    time, and the host us a call) and torch._int_mm (rows zero-padded to 32
    where M <= 16); per-pass sums."""
    from stable_diffusion_tpu_torch.ops import linear
    from stable_diffusion_tpu_torch.ops.quantize import folded_scales

    gen = torch.Generator(device="cuda").manual_seed(1234)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok, per_pass = True, {}
    for key, calls in K8_SWEEP_SHAPES:
        m, k, n, ln, res = key
        case = _w8a8_case("K8", key, gen)
        ref = case["ref"]().float()
        refmax = ref.abs().max().item()
        entry = cuda_ms(case["kernel"])
        device = graph_ms(case["kernel"])
        h_us = host_us(case["kernel"], calls=300)
        lib = cuda_ms(case["library"])
        lib_dev = graph_ms(case["library"])
        chosen = linear.linear_q_plan(m, k, n, sms)
        say(f"  k8 shape={key} calls={calls} plan={chosen.variant} nsplit={chosen.nsplit} "
            f"ksplit={chosen.ksplit} entry_ms={entry:.4f} device_ms={device:.4f} host_us={h_us:.2f} "
            f"int_mm_ms={lib:.4f} int_mm_device_ms={lib_dev:.4f}")
        for name, ms in (("entry", entry), ("device", device), ("int_mm", lib),
                         ("int_mm device", lib_dev)):
            per_pass[name] = per_pass.get(name, 0.0) + calls * ms
        x, q, sc, act, bias, r, lw, lb = case["args"]
        s_x, oscale = folded_scales(sc, act)
        for v in linear.LQ_VARIANTS:
            try:
                plan = linear.linear_q_plan(m, k, n, sms, variant=v)
            except ValueError:
                continue  # the variant's rows do not fit at any split
            run = lambda plan=plan: linear.matmul_w8a8_kernel(  # noqa: E731
                x, q, s_x, oscale, bias, r, lw, lb, _plan=plan)
            got = run().float()
            torch.cuda.synchronize()
            rel = (got - ref).abs().max().item() / refmax
            good = bool(torch.isfinite(got).all().item()) and rel <= KERNEL_REL_TOL
            ok &= good
            ms = graph_ms(run)
            per_pass[v] = per_pass.get(v, 0.0) + calls * ms
            say(f"    {v} nsplit={plan.nsplit} ksplit={plan.ksplit} {'ok ' if good else 'BAD'} "
                f"rel={rel:.3e} device_ms={ms:.4f}" + (" <- plan" if plan == chosen else ""))
        del case, ref
        torch.cuda.empty_cache()
    say("k8 per W8A8 pass (ms): " + "; ".join(f"{k} {v:.3f}" for k, v in per_pass.items()))
    return ok


# (B, H, W, Cin, Cout, prologue) of phase 6's K7 shapes and (M, C, H, LN,
# residual) of its K9 shapes, with their calls in one W8A8 b4 pass (one b4
# DDIM step at UNet batch 8: the SD1.5 UNet's 44 GN+SiLU resblock convs and
# 16 transformer FFNs).
K7_SWEEP_SHAPES = [((8, 64, 64, 320, 320, True), 7), ((8, 64, 64, 640, 320, True), 2),
                   ((8, 64, 64, 960, 320, True), 1), ((8, 32, 32, 320, 640, True), 1),
                   ((8, 32, 32, 640, 640, True), 6), ((8, 32, 32, 960, 640, True), 1),
                   ((8, 32, 32, 1280, 640, True), 1), ((8, 32, 32, 1920, 640, True), 1),
                   ((8, 16, 16, 640, 1280, True), 1), ((8, 16, 16, 1280, 1280, True), 6),
                   ((8, 16, 16, 1920, 1280, True), 1), ((8, 16, 16, 2560, 1280, True), 2),
                   ((8, 8, 8, 1280, 1280, True), 11), ((8, 8, 8, 2560, 1280, True), 3)]
K9_SWEEP_SHAPES = [((32768, 320, 1280, True, True), 5), ((8192, 640, 2560, True, True), 5),
                   ((2048, 1280, 5120, True, True), 5), ((512, 1280, 5120, True, True), 1)]


def w8a8_sweep() -> bool:
    """K7 and K9 at each W8A8 path shape: the entry point (CUDA events, and
    the host us a call), the raw kernel's device time (CUDA-graph replay),
    the bf16 route each stands in for (K2 with its prologue, K4) and the
    product-only torch._int_mm yardstick, device times; then, where the
    package has the planners (not a --root checkout of the first design),
    K7's codes launch and GEMM apart and its GEMM at every other column
    width and K split, K9's quantize, G1 and each G2 variant, each checked
    through the whole function against plain f32 and timed alone on the
    device.  Per-pass sums (a variant's over the shapes it runs).  The H100
    sweep also timed K7's fused form and K8's GEMM as K9's G2 (PERF.md):
    they lost at every path shape and are not built."""
    from stable_diffusion_tpu_torch.ops import conv, ffn
    from stable_diffusion_tpu_torch.ops.groupnorm import gn_scale_shift_kernel
    from stable_diffusion_tpu_torch.ops.quantize import folded_scales

    gen = torch.Generator(device="cuda").manual_seed(1234)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"  package: {os.path.dirname(os.path.dirname(conv.__file__))}")
    ok = True
    for kernel, table in (("K7", K7_SWEEP_SHAPES), ("K9", K9_SWEEP_SHAPES)):
        per_pass = {}

        def add(name, calls, ms):
            per_pass[name] = per_pass.get(name, 0.0) + calls * ms

        for key, calls in table:
            case = _w8a8_case(kernel, key, gen)
            ref = case["ref"]().float()
            refmax = ref.abs().max().item()
            got = case["kernel"]().float()
            torch.cuda.synchronize()
            rel = (got - ref).abs().max().item() / refmax
            good = bool(torch.isfinite(got).all().item()) and rel <= KERNEL_REL_TOL
            ok &= good
            del got
            if kernel == "K7":
                x, gw, gb, wq, sc, act, bias = case["args"]
                ss = gn_scale_shift_kernel(x, gw, gb)
                s_x, oscale = folded_scales(sc, act, floor=True)

                def raw(**kw):
                    return conv.conv3x3_w8a8_kernel(x, wq, s_x, oscale, bias, ss, **kw)
            else:
                x, lw, lb, q1, s1, b1, act1, q2, s2, b2, act2, r = case["args"]
                f1, f2 = folded_scales(s1, act1), folded_scales(s2, act2)

                def raw(**kw):
                    return ffn.geglu_ffn_w8a8_kernel(x, lw, lb, q1, f1[0], f1[1], b1, q2, f2[0],
                                                     f2[1], b2, r, **kw)
            entry = cuda_ms(case["kernel"])
            h_us = host_us(case["kernel"], calls=200)
            device = graph_ms(raw)
            route = graph_ms(case["bf16"])
            lib = graph_ms(case["library"])
            b_ms, b_by = bound_ms(case["flops"], case["bytes"], case["rate"])
            d_ms = (bound_ms(case["flops"], case["design_bytes"], case["rate"])[0]
                    if case.get("design_bytes") is not None else None)
            say(f"  {kernel.lower()} shape={key} calls={calls} {'ok ' if good else 'BAD'} rel={rel:.3e} "
                f"{case.get('note', '')} entry_ms={entry:.4f} host_us={h_us:.2f} device_ms={device:.4f} "
                f"route_device_ms={route:.4f} int_mm_device_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by})"
                + ("" if d_ms is None else f" design_bound_ms={d_ms:.4f}"))
            for name, ms in (("entry", entry), ("device", device), ("route device", route),
                             ("int_mm device", lib), ("bound", b_ms)):
                add(name, calls, ms)
            if d_ms is not None:
                add("design bound", calls, d_ms)
            variants = []
            if kernel == "K7" and hasattr(conv, "conv3x3_q_plan"):
                b, h, w, cin, cout, _ = key
                chosen = conv.conv3x3_q_plan(b, h, w, cin, cout, sms)
                variants.append(("codes", dict(_plan=chosen, _parts=1), None))
                variants.append(("gemm", dict(_plan=chosen, _parts=2), None))
                # the planner's GEMM at other column widths and K splits
                for bn in (64, 128, 160):
                    if (chosen.bm, bn) in conv.K7_VARIANTS and bn != chosen.bn:
                        plan = conv.conv3x3_q_plan(b, h, w, cin, cout, sms, bn=bn)
                        variants.append((f"gemm bn {bn} ksplit {plan.ksplit}",
                                         dict(_plan=plan, _parts=2), plan))
                for ks in range(1, min(-(-cin // conv.K7_CHUNK), 8) + 1):
                    if ks != chosen.ksplit:
                        plan = conv.conv3x3_q_plan(b, h, w, cin, cout, sms, ksplit=ks)
                        variants.append((f"gemm ksplit {ks}", dict(_plan=plan, _parts=2), plan))
            elif kernel == "K9" and hasattr(ffn, "ffn_q_plan"):
                m, c, hidden = key[:3]
                chosen = ffn.ffn_q_plan(m, c, hidden, sms)
                variants.append(("quantize", dict(_plan=chosen, _parts=1), None))
                variants.append((f"G1 {chosen.g1} nsplit {chosen.nsplit1}",
                                 dict(_plan=chosen, _parts=2), None))
                for v in ffn.FFN_Q_G2_VARIANTS:
                    plan = ffn.ffn_q_plan(m, c, hidden, sms, g2=v)
                    variants.append((f"G2 {v}", dict(_plan=plan, _parts=4), plan))
            for name, kw, plan in variants:
                if plan is not None:  # the whole function under this plan, against plain f32
                    full = {k: v for k, v in kw.items() if k != "_parts"}
                    got = raw(**full).float()
                    torch.cuda.synchronize()
                    vrel = (got - ref).abs().max().item() / refmax
                    vgood = bool(torch.isfinite(got).all().item()) and vrel <= KERNEL_REL_TOL
                    ok &= vgood
                    del got
                else:
                    vrel, vgood = float("nan"), True
                raw(**{k: v for k, v in kw.items() if k != "_parts"})  # the scratch this part reads
                ms = graph_ms(lambda: raw(**kw))
                add(name if kernel == "K7" else name.split(" nsplit")[0], calls, ms)
                say(f"    {name} {'ok ' if vgood else 'BAD'} rel={vrel:.3e} device_ms={ms:.4f}")
            del case, ref
            torch.cuda.empty_cache()
        say(f"{kernel.lower()} per W8A8 pass (ms): " + "; ".join(f"{k} {v:.3f}" for k, v in per_pass.items()))
    return ok


# (M, K, N, LN, residual) of phase 8's K10 shapes and (B, rows an image, K,
# N) of its K11 shapes, with their calls in one switched SD2.1 768^2 CFG
# step (tests/test_torch_linear_tiles.py enumerates the same from the
# UNet's configuration).
K10_SWEEP_SHAPES = [
    ((18432, 320, 320, True, False), 5), ((18432, 320, 320, False, True), 15),
    ((18432, 320, 960, True, False), 5), ((18432, 640, 320, False, True), 2),
    ((18432, 960, 320, False, True), 1), ((4608, 320, 640, False, True), 1),
    ((4608, 640, 640, True, False), 5), ((4608, 640, 640, False, True), 15),
    ((4608, 640, 1920, True, False), 5), ((4608, 960, 640, False, True), 1),
    ((4608, 1280, 640, False, True), 1), ((4608, 1920, 640, False, True), 1),
    ((1152, 640, 1280, False, True), 1), ((1152, 1280, 1280, True, False), 5),
    ((1152, 1280, 1280, False, True), 15), ((1152, 1280, 3840, True, False), 5),
    ((1152, 1920, 1280, False, True), 1), ((1152, 2560, 1280, False, True), 2),
    ((288, 1280, 1280, True, False), 1), ((288, 1280, 1280, False, True), 3),
    ((288, 1280, 3840, True, False), 1), ((288, 2560, 1280, False, True), 3)]
K11_SWEEP_SHAPES = [((2, 9216, 320, 320), 5), ((2, 2304, 640, 640), 5), ((2, 576, 1280, 1280), 5),
                    ((2, 144, 1280, 1280), 1)]


def k10_sweep() -> bool:
    """K10 and K11 at each shape of phase 8's switched SD2.1 step: every
    compiled variant that takes the shape (the planner's splits for it),
    checked against the plain f32 version and timed on the device
    (CUDA-graph replay), beside the planner's choice through the entry
    point (CUDA events, as phase 8 times it), F.linear (events and device)
    and the unswitched route, and the entry's host us a call (unsynchronized
    calls); K11's raw launches on K1's statistics taken once.  Per-pass
    sums."""
    from stable_diffusion_tpu_torch.ops import groupnorm, linear

    gen = torch.Generator(device="cuda").manual_seed(1234)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok, per_pass = True, {}
    for kernel, shapes in (("K10", K10_SWEEP_SHAPES), ("K11", K11_SWEEP_SHAPES)):
        for key, calls in shapes:
            with switches(True):
                case = _switched_case(kernel, key, gen)
                ref = case["ref"]().float()
                entry = cuda_ms(case["kernel"])
            refmax = ref.abs().max().item()
            with switches(True):
                h_us = host_us(case["kernel"], calls=200)
            lib, lib_dev, route = cuda_ms(case["library"]), graph_ms(case["library"]), cuda_ms(case["bf16"])
            if kernel == "K10":
                x, w, bias, r, lw, lb = case["args"]
                m, k, n, ln, _ = key
                pro = "ln" if ln else "none"
                run = lambda plan: linear.linear_kernel(x, w, bias, r, lw, lb, _plan=plan)  # noqa: E731
            else:
                x, gw, gb, w, bias = case["args"]
                m, k, n, pro = key[0] * key[1], key[2], key[3], "gn"
                ss = groupnorm.gn_scale_shift(x, gw, gb, eps=1e-6, impl="cuda")
                run = lambda plan: linear.linear_kernel(x, w, bias, scale_shift=ss, _plan=plan)  # noqa: E731
            chosen = linear.linear_plan(m, k, n, pro, sms)
            say(f"  k10 {kernel} shape={key} calls={calls} {plan_note(chosen)} entry_ms={entry:.4f} "
                f"host_us={h_us:.2f} linear_ms={lib:.4f} linear_device_ms={lib_dev:.4f} route_ms={route:.4f}")
            for name, ms in ((f"{kernel} entry", entry), (f"{kernel} F.linear", lib),
                             (f"{kernel} F.linear device", lib_dev), (f"{kernel} route", route)):
                per_pass[name] = per_pass.get(name, 0.0) + calls * ms
            for v in linear.LIN_VARIANTS:
                if v[0] and pro == "none":
                    continue
                try:
                    plan = linear.linear_plan(m, k, n, pro, sms, variant=v)
                except ValueError:
                    continue  # the variant's rows do not fit shared memory at this K
                got = run(plan).float()
                torch.cuda.synchronize()
                rel = (got - ref).abs().max().item() / refmax
                good = bool(torch.isfinite(got).all().item()) and rel <= KERNEL_REL_TOL
                ok &= good
                ms = graph_ms(lambda plan=plan: run(plan))
                name = f"{kernel} {v}"
                per_pass[name] = per_pass.get(name, 0.0) + calls * ms
                if plan == chosen:
                    per_pass[f"{kernel} plan device"] = per_pass.get(f"{kernel} plan device", 0.0) + calls * ms
                say(f"    {v} nsplit={plan.nsplit} ksplit={plan.ksplit} {'ok ' if good else 'BAD'} "
                    f"rel={rel:.3e} device_ms={ms:.4f}" + (" <- plan" if plan == chosen else ""))
            # the planner's variant at other splits (R: N splits; S: K splits)
            ntiles = -(-n // chosen.bn)
            for split in range(1, (min(ntiles, 8) if chosen.schedule == "R" else 4) + 1):
                other = (chosen._replace(nsplit=split) if chosen.schedule == "R"
                         else chosen._replace(ksplit=split))
                if other == chosen or (chosen.schedule == "S" and split > -(-k // linear.LIN_KC)):
                    continue
                ms = graph_ms(lambda plan=other: run(plan))
                say(f"    split {chosen.variant} nsplit={other.nsplit} ksplit={other.ksplit} device_ms={ms:.4f}")
            del case, ref
            torch.cuda.empty_cache()
    say("k10 per switched SD2.1 pass (ms): " + "; ".join(f"{k} {v:.4f}" for k, v in per_pass.items()))
    return ok


# (B, H, W, Cin, Cout, prologue) of phase 8's K12 shapes and their calls
# in one switched SD2.1 768^2 pass (one CFG step and the VAE decode).
K12_SWEEP_SHAPES = [((2, 96, 96, 320, 320, True), 7), ((2, 96, 96, 640, 320, True), 2),
                    ((2, 96, 96, 640, 640, False), 1), ((2, 96, 96, 960, 320, True), 1),
                    ((2, 48, 48, 320, 640, True), 1), ((2, 48, 48, 640, 640, True), 6),
                    ((2, 48, 48, 960, 640, True), 1), ((2, 48, 48, 1280, 640, True), 1),
                    ((2, 48, 48, 1280, 1280, False), 1), ((2, 48, 48, 1920, 640, True), 1),
                    ((2, 24, 24, 640, 1280, True), 1), ((2, 24, 24, 1280, 1280, False), 1),
                    ((2, 24, 24, 1280, 1280, True), 6), ((2, 24, 24, 1920, 1280, True), 1),
                    ((2, 24, 24, 2560, 1280, True), 2), ((1, 96, 96, 512, 512, True), 10),
                    ((1, 192, 192, 512, 512, False), 1), ((1, 192, 192, 512, 512, True), 6),
                    ((1, 384, 384, 512, 512, False), 1), ((1, 384, 384, 512, 256, True), 1),
                    ((1, 384, 384, 256, 256, True), 5), ((1, 768, 768, 256, 256, False), 1),
                    ((1, 768, 768, 256, 128, True), 1), ((1, 768, 768, 128, 128, True), 5)]


def k12_sweep() -> bool:
    """K12 at each switched SD2.1 shape: every region shape a block can
    take, each checked against the plain f32 version and timed, beside the
    planner's choice through the entry point, the K2 route it replaces and
    F.conv2d; per-pass sums (the UNet's step and the VAE decode apart)."""
    from stable_diffusion_tpu_torch.ops import winograd
    from stable_diffusion_tpu_torch.ops.groupnorm import gn_scale_shift_kernel

    gen = torch.Generator(device="cuda").manual_seed(1234)
    ok, per_pass = True, {}
    with switches(True):
        for key, calls in K12_SWEEP_SHAPES:
            b, h, w, cin, cout, prologue = key
            part = "unet" if b == 2 else "vae"
            case = _switched_case("K12", key, gen)
            ref = case["ref"]().float()
            refmax = ref.abs().max().item()
            chosen = winograd.winograd_plan(b, h, w, cin, cout)
            entry, k2, lib = cuda_ms(case["kernel"]), cuda_ms(case["bf16"]), cuda_ms(case["library"])
            say(f"  k12 shape={key} calls={calls} region={chosen.region} entry_ms={entry:.4f} "
                f"k2_route_ms={k2:.4f} conv2d_ms={lib:.4f}")
            for name, ms in (("entry", entry), ("k2 route", k2), ("conv2d", lib)):
                per_pass[(part, name)] = per_pass.get((part, name), 0.0) + calls * ms
            args = case["args"]
            x, wt, bias = args[0], args[-2], args[-1]
            ss = gn_scale_shift_kernel(x, args[1], args[2]) if prologue else None
            for region in winograd.WINO_REGIONS:
                plan = chosen._replace(region=region,
                                       grid=(b * -(-(h // 2) // region[0]) * -(-(w // 2) // region[1]),
                                             chosen.grid[1]))
                run = lambda plan=plan: winograd.conv3x3_winograd_kernel(  # noqa: E731
                    x, wt, bias, ss, _plan=plan)
                got = run().float()
                torch.cuda.synchronize()
                rel = (got - ref).abs().max().item() / refmax
                good = bool(torch.isfinite(got).all().item()) and rel <= KERNEL_REL_TOL
                ok &= good
                ms = cuda_ms(run)
                per_pass[(part, region)] = per_pass.get((part, region), 0.0) + calls * ms
                say(f"    region {region} {'ok ' if good else 'BAD'} rel={rel:.3e} ms={ms:.4f}"
                    + (" <- plan" if region == chosen.region else ""))
            del case, ref
            torch.cuda.empty_cache()
    say("k12 per switched SD2.1 pass (ms): " + "; ".join(
        f"{p} {k} {v:.3f}" for (p, k), v in per_pass.items()))
    return ok


def sd21_line(sd) -> str:
    return (f"768^2 b1 DDIM {SERVE_STEPS} CFG 7.5: s/request switches off "
            f"{[round(x, 3) for x in sd['secs_off']]}, on {[round(x, 3) for x in sd['secs_on']]}; "
            f"drift p99={sd['drift_p99']:.4f}; golden f32 max_abs_err={sd['golden_err']:.3e}, "
            + ", ".join(f"{k} rel_l2={v:.3e}" for k, v in sd["golden_rels"].items()) + "; "
            + ", ".join(f"{k} {v['shapes']} shapes max_rel={v['max_rel_err']:.2e} kernel "
                        f"{v['ms']:.2f} ms, replaced route {v.get('bf16_ms', float('nan')):.2f}, "
                        f"library {'-' if v['library_ms'] is None else format(v['library_ms'], '.2f')}"
                        f", bound {v['bound_ms']:.2f}"
                        for k, v in {**sd["summary"], **sd["switched"]}.items())
            + f" per pass; peak_mem {sd['peak_gib']:.2f} GiB")


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        say("phase 1 device: FAIL, torch.cuda.is_available() is false")
        return 2
    card = card_line()
    say(card)
    sms, clock = set_exp_rate()
    say(f"phase 1 device: ok, {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__} cuda {torch.version.cuda}, {sms} SMs, max SM clock {clock:.0f} "
        f"MHz (exponential bound: {EXP_RATE:.3e} a second)")

    if "--root" in sys.argv[1:]:  # measure another checkout's package with this script
        sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--root") + 1]))
    from stable_diffusion_tpu_torch.ops import _cuda, conv, ffn, flash_attention, groupnorm, linear

    from stable_diffusion_tpu_torch.ops import winograd

    counters = kernel_counters()

    if "--k1-host" in sys.argv[1:]:
        say(f"  package: {os.path.dirname(os.path.dirname(groupnorm.__file__))}")
        _cuda.library()
        k1_host(build_pipeline(torch.bfloat16, "cuda"), counters)
        return 0

    # 2. build
    t0 = time.perf_counter()
    _cuda.library()
    nvcc_s = _cuda.build_seconds
    say(f"phase 2 build: ok, {time.perf_counter() - t0:.2f} s "
        f"(nvcc {'cached' if nvcc_s is None else f'{nvcc_s:.2f} s'})")
    occ = lambda d: "; ".join(  # noqa: E731
        f"{v} {o['registers']} registers, {o['spill_bytes']} spill bytes, {o['smem_bytes']} smem "
        f"bytes, {o['blocks_per_sm']} blocks/SM" for v, o in d.items())
    say("  K1 kernels (kind, vec): " + occ(groupnorm.gn_occupancy()))
    for c in (320, 640, 1280):
        say(f"  K4 variants at C={c} (G1 bm / G2 bn): " + occ(ffn.ffn_occupancy(c)))
    say("  K2 variants (bm, bn) at their largest tile: " + "; ".join(
        f"{v} {o['registers']} registers, {o['spill_bytes']} spill bytes, {o['smem_bytes']} smem "
        f"bytes, {o['blocks_per_sm']} blocks/SM" for v, o in conv.conv3x3_occupancy().items()))

    say("  K3 variants (padded d, plan): " + "; ".join(
        f"d{v.dp} {k3_note(v)} {o['registers']} registers, {o['spill_bytes']} spill bytes, "
        f"{o['smem_bytes']} smem bytes, {o['blocks_per_sm']} blocks/SM"
        for v, o in flash_attention.attention_occupancy().items()))
    for k in (320, 1280):
        say(f"  K8 variants (bm, bn, stages, min blocks) with K={k} resident: "
            + occ(linear.linear_q_occupancy(k)))
    if hasattr(conv, "conv3x3_q_occupancy"):  # not in a --root checkout older than the redesign
        say("  K7 variants (bm, bn) at their largest tile: " + occ(conv.conv3x3_q_occupancy()))
        for c in (320, 640, 1280):
            say(f"  K9 variants at C={c} (G1 bm, stages, min blocks / G2 bm, bn, stages): "
                + occ(ffn.ffn_q_occupancy(c)))
    for k in (320, 1280, 2560):
        say(f"  K10/K11 variants (resident, bm, bn, stages, min blocks) at K={k}: "
            + occ(linear.linear_occupancy(k)))
    o = winograd.winograd_occupancy()
    say(f"  K12 (64 tiles x 64 channels, F-fold): {o['registers']} registers, {o['spill_bytes']} spill "
        f"bytes, {o['smem_bytes']} smem bytes, {o['blocks_per_sm']} blocks/SM")
    if "--k8-sweep" in sys.argv[1:]:
        return 0 if k8_sweep() else 1
    if "--w8a8-sweep" in sys.argv[1:]:
        return 0 if w8a8_sweep() else 1
    if "--k12-sweep" in sys.argv[1:]:
        return 0 if k12_sweep() else 1
    if "--k10-sweep" in sys.argv[1:]:
        return 0 if k10_sweep() else 1
    if "--k3-sweep" in sys.argv[1:]:
        return 0 if k3_sweep() else 1
    if "--k56-sweep" in sys.argv[1:]:
        return 0 if k56_sweep() else 1
    if "--k4-sweep" in sys.argv[1:]:
        return 0 if k4_sweep() else 1

    if "--only-sd21" in sys.argv[1:]:
        ok8, sd = phase_sd21(counters)
        say(f"phase 8 sd21: {'ok' if ok8 else 'FAIL'}, " + sd21_line(sd))
        return 0 if ok8 else 1
    if "--img2img" in sys.argv[1:]:
        ok9, i2 = phase_img2img(counters, card)
        say(f"phase 9 img2img: {'ok' if ok9 else 'FAIL'}, " + img2img_line(i2))
        return 0 if ok9 else 1
    if "--cli" in sys.argv[1:]:
        ok10, cl = phase_cli(counters, card)
        say(f"phase 10 cli: {'ok' if ok10 else 'FAIL'}, " + cli_line(cl))
        return 0 if ok10 else 1
    if "--deepcache" in sys.argv[1:]:
        ok11, dc = phase_deepcache(counters, card)
        say(f"phase 11 deepcache: {'ok' if ok11 else 'FAIL'}, " + deepcache_line(dc))
        return 0 if ok11 else 1
    if "--training" in sys.argv[1:]:
        ok7, train = phase_training(build_pipeline(torch.bfloat16, "cuda").unet, counters)
        say(training_line(ok7, train))
        say(card)
        return 0 if ok7 else 1
    if "--trainer" in sys.argv[1:]:
        ok12, tr = phase_trainer(counters, card)
        say(f"phase 12 trainer: {'ok' if ok12 else 'FAIL'}, " + trainer_line(tr))
        return 0 if ok12 else 1
    if "--evaluation" in sys.argv[1:]:
        ok13, ev = phase_evaluation(counters, card)
        say(f"phase 13 evaluation: {'ok' if ok13 else 'FAIL'}, " + evaluation_line(ev))
        say(card)
        return 0 if ok13 else 1
    if "--demo" in sys.argv[1:]:
        ok14, dm = phase_demo(counters, card)
        say(f"phase 14 demo: {'ok' if ok14 else 'FAIL'}, " + demo_line(dm))
        return 0 if ok14 else 1
    if "--sharded" in sys.argv[1:]:
        ok15, sh = phase_sharded(counters, card)
        say(f"phase 15 sharded: {'ok' if ok15 else 'FAIL'}, " + (sharded_line(sh) if sh else ""))
        return 0 if ok15 else 1
    if "--sharded-train" in sys.argv[1:]:
        ok16, st = phase_sharded_train(counters, card)
        say(f"phase 16 sharded-train: {'ok' if ok16 else 'FAIL'}, "
            + (sharded_train_line(st) if st else ""))
        say(card)
        return 0 if ok16 else 1

    pipe = build_pipeline(torch.bfloat16, "cuda")
    if "--k2-device" in sys.argv[1:]:
        k2_device(pipe, counters)
        return 0

    # 3. kernels vs plain at the main path's shapes
    shapes = record_main_path_shapes(pipe, counters)
    ok3g = no_general_body(shapes, "serve path (one DDIM step)")
    ok3, summary = check_kernels(shapes, SERVING_KERNELS, "serve")
    ok3 &= ok3g
    say(f"phase 3 kernels: {'ok' if ok3 else 'FAIL'}, " + ", ".join(
        f"{k} {s['shapes']} shapes max_rel={s['max_rel_err']:.2e} kernel {s['ms']:.2f} ms, "
        f"plain {s['plain_ms']:.2f}, library "
        f"{'-' if s['library_ms'] is None else format(s['library_ms'], '.2f')}, "
        f"bound {s['bound_ms']:.2f} ({s['bound_by']}) per pass"
        for k, s in summary.items())
        + " (a pass: text encode + one CFG UNet step + VAE decode)")
    if not ok3:
        return 1

    # 4. golden
    ok4, g_err, g_rels = phase_golden()
    g_rel = g_rels["bf16 kernels"]
    say(f"phase 4 golden: {'ok' if ok4 else 'FAIL'}, f32 max_abs_err={g_err:.3e}, "
        f"bf16 rel_l2={g_rel:.3e}")
    if not ok4:
        return 1

    # 5. serving
    ok5, secs, launches, peak = phase_serving(pipe, counters)
    ok5 &= all(launches[k] > 0 for k in SERVING_KERNELS) and no_general_body(launches, "phase 5 requests")
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
    pipe.impl = "cuda"

    # 6. static-W8A8 serving
    ok6, w8 = phase_w8a8(pipe, counters)
    wsum = w8["summary"]
    say(f"phase 6 w8a8: {'ok' if ok6 else 'FAIL'}, {SERVE_REQUESTS} b{W8A8_BATCH} requests at "
        f"512^2, DDIM {SERVE_STEPS}, CFG 7.5: s/request={[round(s, 3) for s in w8['secs']]} "
        f"(bf16 {w8['bf16_s']:.3f}) peak_mem={w8['peak_gib']:.2f} GiB (bf16 "
        f"{w8['bf16_peak_gib']:.2f}) launches={w8['launches']}; drift p99={w8['drift_p99']:.4f}; "
        + ", ".join(f"{k} {v['shapes']} shapes max_rel={v['max_rel_err']:.2e} kernel "
                    f"{v['ms']:.2f} ms, " + (f"bf16 {v['bf16_ms']:.2f}, " if "bf16_ms" in v else "")
                    + f"bound {v['bound_ms']:.2f}" for k, v in wsum.items()) + " per pass")
    if not ok6:
        return 1

    # 7. training
    unet = pipe.unet
    del pipe
    torch.cuda.empty_cache()
    ok7, train = phase_training(unet, counters)
    tsum = train["summary"]
    say(training_line(ok7, train))
    if not ok7:
        return 1

    # 8. SD2.1 768^2, the kernel switches off and on
    del unet
    torch.cuda.empty_cache()
    ok8, sd = phase_sd21(counters)
    say(f"phase 8 sd21: {'ok' if ok8 else 'FAIL'}, " + sd21_line(sd))
    if not ok8:
        return 1

    # 9. img2img and inpaint, SD1.5 512^2 (BASELINE config 2)
    ok9, i2 = phase_img2img(counters, card)
    say(f"phase 9 img2img: {'ok' if ok9 else 'FAIL'}, " + img2img_line(i2))
    if not ok9:
        return 1

    # 10. the inference CLI at full SD1.5 width: loading, tokenizer, one-step, kohya LoRA
    ok10, cl = phase_cli(counters, card)
    say(f"phase 10 cli: {'ok' if ok10 else 'FAIL'}, " + cli_line(cl))
    if not ok10:
        return 1

    # 11. DeepCache: the split UNet at k = 1, 2, 3 (bf16 b1) and k = 2 (W8A8 b4)
    ok11, dc = phase_deepcache(counters, card)
    say(f"phase 11 deepcache: {'ok' if ok11 else 'FAIL'}, " + deepcache_line(dc))
    if not ok11:
        return 1

    # 12. the trainer CLI at full SD1.5 width: cached, uncached, resumed, served
    ok12, tr = phase_trainer(counters, card)
    say(f"phase 12 trainer: {'ok' if ok12 else 'FAIL'}, " + trainer_line(tr))
    if not ok12:
        return 1

    # 13. the evaluation path: CLIP score, W8A8 text tower, class2img, VQ-VAE, FID, the CLI
    ok13, ev = phase_evaluation(counters, card)
    say(f"phase 13 evaluation: {'ok' if ok13 else 'FAIL'}, " + evaluation_line(ev))
    if not ok13:
        return 1

    # 14. the Gradio demo's handlers, with gr.Progress, on the f16 SD1.5 directory
    ok14, dm = phase_demo(counters, card)
    say(f"phase 14 demo: {'ok' if ok14 else 'FAIL'}, " + demo_line(dm))
    if not ok14:
        return 1

    # 15. sharded serving: tp=2 over gloo on the one card, a 1x1 mesh over NCCL
    ok15, sh = phase_sharded(counters, card)
    say(f"phase 15 sharded: {'ok' if ok15 else 'FAIL'}, " + (sharded_line(sh) if sh else ""))
    if not ok15:
        return 1

    # 16. sharded training: meshes (1, 2) and (2, 1) over gloo, 1x1 over NCCL, the trainer CLI
    ok16, st = phase_sharded_train(counters, card)
    say(f"phase 16 sharded-train: {'ok' if ok16 else 'FAIL'}, "
        + (sharded_train_line(st) if st else ""))
    if not ok16:
        return 1

    # ms / plain_ms / bound_ms / library_ms: milliseconds per pass.  K1-K4:
    # serving (text encode + CFG UNet step + VAE decode), launches over phase
    # 5's requests, with their train-step figures under train_* and (K1-K3)
    # their W8A8 serving figures under w8a8_*; K5/K6: one train micro-step,
    # launches over phase 7's timed steps; K7-K9: the W8A8 b4 serving pass,
    # launches over phase 6's requests; K10-K12: the SD2.1 768^2 switched
    # pass, launches over phase 8's switched request (bf16_ms: the route each
    # replaces), with K1-K4's SD2.1 figures (switches off) under sd21_* and
    # their img2img b4 figures (one pass: text encode, the encoder at b1, one
    # CFG UNet step at batch 8, the decoder at b4; launches over phase 9's
    # two img2img requests and its inpaint request) under img2img_*, and
    # their CLI figures (one pass set: a b1 no-CFG DDPM step and decode, a
    # b1 and a b4 one-step pass; launches over phase 10's CLI runs) under
    # cli_*; K1-K4's DeepCache figures (the cached step at UNet batch 2;
    # launches over phase 11's b1 k = 2 request) under deepcache_*, K1-K3's
    # and K7-K9's W8A8 ones (the cached step at UNet batch 8; launches over
    # the b4 k = 2 request) under deepcache_w8a8_*, and K1-K6's trainer CLI
    # figures (one uncached run's shapes; launches over the cached run) under
    # trainer_*; phase 13's: K3 in the CLIP vision tower (b1 and b8 image
    # embeds; launches over those two calls) under eval_vision_*, K3's cross
    # body on one key (class2img's 4 one-key shapes; launches over a class2img
    # request) under eval_class2img_*, K1-K3 in the VQ-VAE round trip (512^2
    # b1) under eval_vqvae_*, and K8 in the W8A8 text tower (a b1 and a b2
    # forward) under eval_text_w8a8_*; K3's and K4's on a tensor-parallel
    # rank (phase 15: one sharded CFG step's shapes; launches over a tp=2
    # request of SHARD_STEPS steps) under shard_*, K1-K6's on a tp = 2 rank
    # in training (phase 16: one sharded b4 micro-step's shapes; launches
    # over rank 0's SHARD_TRAIN_CALLS micro-steps on the (1, 2) mesh) under
    # shard_train_* (the pair's under the pair's shard_train_*), and K1-K4's
    # launches in the demo's b1 txt2img request (phase 14) under
    # demo_launches.
    passes = {"serve": "serving: text encode + CFG UNet step + VAE decode",
              "train": "one train micro-step (b4)",
              "w8a8": "W8A8 serving (b4): text encode + CFG UNet step (UNet batch 8) + VAE decode",
              "sd21": "SD2.1 768^2 b1 serving, switches on: text encode + CFG UNet step + VAE "
                      "decode"}
    kernels = []
    for k in KERNELS:
        serving = k in SERVING_KERNELS
        which = ("serve" if serving else "w8a8" if k in W8A8_KERNELS
                 else "sd21" if k in SWITCHED_KERNELS else "train")
        s, n = {"serve": (summary.get(k), launches), "train": (tsum.get(k), train["launches"]),
                "w8a8": (wsum.get(k), w8["launches"]),
                "sd21": (sd["switched"].get(k), sd["launches_on"])}[which]
        row = dict(name=k, route=KERNELS[k]["route"], source=KERNELS[k]["source"],
                   replaces=KERNELS[k]["replaces"], launches=n[k],
                   max_abs_err=s["max_abs_err"], ms=s["ms"], plain_ms=s["plain_ms"],
                   bound_ms=s["bound_ms"], bound_by=s["bound_by"], library_ms=s["library_ms"],
                   max_rel_err=s["max_rel_err"], shapes=s["shapes"], pass_=passes[which],
                   library_call=KERNELS[k]["library"], replaces_all=KERNELS[k]["replaces_all"])
        for extra in ("bf16_ms", "library_shapes", "ms_at_library_shapes", "also_ms", "groups"):
            if extra in s:
                row[extra] = s[extra]
        if KERNELS[k].get("bf16"):
            row["bf16_call"] = KERNELS[k]["bf16"]
        if k == "K3":  # launches by body: phase 5's, 7's, 6's, 8's (switches off), 9's-12's
            for tag, m in (("", launches), ("train_", train["launches"]), ("w8a8_", w8["launches"]),
                           ("sd21_", sd["launches_off"]), ("img2img_", i2["launches"]),
                           ("cli_", cl["launches"]), ("deepcache_", dc["launches"][2]),
                           ("deepcache_w8a8_", dc["w8a8_launches"][DEEPCACHE_W8A8_K]),
                           ("trainer_", tr["launches"]), ("eval_vision_", ev["vision_launches"]),
                           ("eval_class2img_", ev["class2img_launches"]),
                           ("eval_vqvae_", ev["vqvae_launches"]),
                           ("eval_main_", ev["main_launches"])):
                row[f"{tag}bodies"] = {b: m[f"K3:{b}"] for b in K3_BODY_NAMES}
        dc2 = dc["launches"][2]
        w8dc = dc["w8a8_launches"][DEEPCACHE_W8A8_K]
        for tag, other, n2 in (("train", tsum, train["launches"]), ("w8a8", wsum, w8["launches"]),
                               ("sd21", sd["summary"], sd["launches_off"]),
                               ("img2img", i2["summary"], i2["launches"]),
                               ("cli", cl["summary"], cl["launches"]),
                               ("deepcache", dc["summary"], dc2),
                               ("deepcache_w8a8", dc["w8a8_summary"], w8dc),
                               ("trainer", tr["summary"], tr["launches"]),
                               ("eval_vision", ev["vision"], ev["vision_launches"]),
                               ("eval_class2img", ev["class2img"], ev["class2img_launches"]),
                               ("eval_vqvae", ev["vqvae"], ev["vqvae_launches"]),
                               ("eval_text_w8a8", ev["text"], ev["text_launches"]),
                               ("shard", sh["summary"], sh["launches"]),
                               ("shard_train", st["summary"], st["launches"])):
            if k in other and (serving or tag.startswith(("deepcache", "trainer", "eval",
                                                          "shard_train"))):
                t = other[k]
                row.update({f"{tag}_launches": n2[k], f"{tag}_max_abs_err": t["max_abs_err"],
                            f"{tag}_max_rel_err": t["max_rel_err"], f"{tag}_ms": t["ms"],
                            f"{tag}_plain_ms": t["plain_ms"], f"{tag}_bound_ms": t["bound_ms"],
                            f"{tag}_library_ms": t["library_ms"]})
                row.update({f"{tag}_{extra}": t[extra] for extra in ("also_ms", "groups")
                            if extra in t})
        if serving:  # phase 14: the demo's b1 txt2img request, in segments
            row["demo_launches"] = dm["launches"][k]
        row["pass"] = row.pop("pass_")
        kernels.append(row)
    # K5 + K6 as the one function they compute, per train micro-step
    sts = st["summary"]
    pair = dict(kernels=["K5", "K6"], ms=tsum["K5"]["ms"] + tsum["K6"]["ms"],
                plain_ms=tsum["K5"]["plain_ms"] + tsum["K6"]["plain_ms"],
                bound_ms=train["pair_bound_ms"], library_ms=train["pair_library_ms"],
                library_call="F.scaled_dot_product_attention backward (dq, dk, dv)",
                shard_train_ms=sts["K5"]["ms"] + sts["K6"]["ms"],
                shard_train_plain_ms=sts["K5"]["plain_ms"] + sts["K6"]["plain_ms"],
                shard_train_bound_ms=st["pair_bound_ms"],
                shard_train_library_ms=st["pair_library_ms"])
    say(json.dumps({"kernels": kernels, "pair": pair}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--shard-rank" in sys.argv[1:]:  # one rank of phase 15, started by phase_sharded
        sys.exit(shard_rank_main(sys.argv[sys.argv.index("--shard-rank") + 1:]))
    if "--train-rank" in sys.argv[1:]:  # one rank of phase 16, started by phase_sharded_train
        sys.exit(shard_train_rank_main(sys.argv[sys.argv.index("--train-rank") + 1:]))
    if "--train-cli-rank" in sys.argv[1:]:  # one rank of phase 16's trainer run
        sys.exit(train_cli_rank_main(sys.argv[sys.argv.index("--train-cli-rank") + 1:]))
    try:
        code = main()
    except Exception:  # any phase's failure: report it and exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
