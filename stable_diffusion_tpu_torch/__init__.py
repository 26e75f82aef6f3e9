"""PyTorch port of ``stable_diffusion_tpu`` for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (``ops/``, ``models/``, ``schedulers/``,
``pipeline.py``, ``utils/``); the JAX package is the reference each module is
held against.  Activations are NHWC at the public functions, as in JAX.

Every Pallas kernel on the SD1.5 txt2img path has a hand-written Hopper
counterpart beside its plain PyTorch version (``csrc/`` for the CUDA C++
sources):

  K1  ops/groupnorm.py        GroupNorm stats + normalize(+SiLU), Triton
  K2  ops/conv.py             3x3 conv with the GN+SiLU prologue, CUDA
  K3  ops/flash_attention.py  self / short-KV cross attention, CUDA
  K4  ops/ffn.py              LN -> GeGLU -> W2 -> +residual, CUDA

The ``impl`` argument chooses between them: ``"torch"`` runs the plain
versions, ``"cuda"`` runs the kernels (and raises on a CPU tensor or a shape
a kernel does not take), ``"auto"`` picks by the tensor's device.

This package never imports jax or ``stable_diffusion_tpu``.
"""
