"""Scaled dot-product attention entry point (port of
stable_diffusion_tpu/ops/attention.py).  Layout (B, S, H, D) throughout.

Non-causal attention goes through K3 (ops/flash_attention.py) on the card.
Causal attention (the text tower) stays plain, as the JAX package leaves it
to XLA.
"""

from __future__ import annotations

from typing import Optional

from stable_diffusion_tpu_torch.ops import flash_attention as fa
from stable_diffusion_tpu_torch.utils.device import use_kernel


def sdpa(q, k, v, *, causal: bool = False, scale: Optional[float] = None, impl: str = "auto"):
    # use_kernel first: impl="cuda" on a CPU tensor raises here too when causal
    if use_kernel(impl, q) and not causal:
        return fa.attention_kernel(q, k, v, scale=scale)
    return fa.attention_plain(q, k, v, scale=scale, causal=causal)
