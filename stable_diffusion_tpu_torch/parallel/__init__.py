"""Data x tensor parallelism on torch.distributed (port of stable_diffusion_tpu/parallel)."""
