"""PyTorch port of ``stable_diffusion_tpu`` for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (``ops/``, ``models/``, ``schedulers/``,
``pipeline.py``, ``utils/``); the JAX package is the reference each module is
held against.  Activations are NHWC at the public functions, as in JAX.

Every Pallas kernel of the JAX package has a hand-written Hopper counterpart
beside its plain PyTorch version (``csrc/`` for the CUDA C++ sources), on
the ported paths: SD1.5 and SD2.1 (768^2, v-prediction) txt2img, SD1.5
img2img and inpaint (the VAE encoder, DDPM, the cosine schedule), the
static-W8A8 serving form, the LoRA train step, and the JAX package's kernel
switches SD_TPU_FUSED_MM (K10, K11) and SD_TPU_WINOGRAD (K12), read at call
time and off by default, as there:

  K1  ops/groupnorm.py        GroupNorm stats + normalize(+SiLU), CUDA
  K2  ops/conv.py             3x3 conv with the GN+SiLU prologue, CUDA
  K3  ops/flash_attention.py  self / short-KV cross attention, CUDA
  K4  ops/ffn.py              LN -> GeGLU -> W2 -> +residual, CUDA
  K5  ops/flash_attention.py  self-attention backward: dQ, CUDA
  K6  ops/flash_attention.py  self-attention backward: dK, dV, CUDA
  K7  ops/conv.py             int8 3x3 conv with GN+SiLU+quantize prologue, CUDA
  K8  ops/linear.py           (LN ->) int8 matmul (+residual), CUDA
  K9  ops/ffn.py              LN -> int8 GeGLU FFN -> +residual, CUDA
  K10 ops/linear.py           (LN ->) bf16 matmul (+residual), CUDA
  K11 ops/linear.py           GroupNorm-normalize -> bf16 matmul, CUDA
  K12 ops/winograd.py         Winograd F(2x2,3x3) conv with the GN+SiLU prologue, CUDA

The ``impl`` argument chooses between them: ``"torch"`` runs the plain
versions, ``"cuda"`` runs the kernels (and raises on a CPU tensor or a shape
a kernel does not take), ``"auto"`` picks by the tensor's device.

This package never imports jax or ``stable_diffusion_tpu``.
"""
