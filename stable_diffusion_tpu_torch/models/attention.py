"""Multi-head (self/cross) attention (port of the plain fused-QKV form of
stable_diffusion_tpu/models/attention.py ``multihead_attention``).

The TPU-only ``_premerged_attention`` is not ported: it zero-padded head dims
to 64 and widths to 128 lanes inside the projection weights, which Hopper
does not need (K3 pads head dims to a multiple of 16 itself).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from stable_diffusion_tpu_torch.models import layers
from stable_diffusion_tpu_torch.ops.attention import sdpa


class MultiheadAttention(nn.Module):
    """Parameter holder; key paths ``q_proj``, ``k_proj``, ``v_proj``, ``out_proj``."""

    def __init__(self, embed_dim: int, *, cond_dim: Optional[int] = None,
                 qkv_bias: bool = True, out_bias: bool = True):
        super().__init__()
        cond_dim = embed_dim if cond_dim is None else cond_dim
        self.q_proj = nn.Linear(embed_dim, embed_dim, bias=qkv_bias)
        self.k_proj = nn.Linear(cond_dim, embed_dim, bias=qkv_bias)
        self.v_proj = nn.Linear(cond_dim, embed_dim, bias=qkv_bias)
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=out_bias)

    def fused_qkv(self):
        """(3E, E) weight and (3E,) bias of the fused projection, cached until
        a projection's parameters change."""
        ps = [self.q_proj, self.k_proj, self.v_proj]
        key = tuple((p.weight.data_ptr(), p.weight._version, p.weight.dtype) for p in ps)
        cached = getattr(self, "_qkv_cache", None)
        if cached is None or cached[0] != key:
            w = torch.cat([p.weight.detach() for p in ps], dim=0)
            b = (torch.cat([p.bias.detach() for p in ps])
                 if self.q_proj.bias is not None else None)
            cached = (key, w, b)
            self._qkv_cache = cached
        return cached[1], cached[2]


def multihead_attention(mod: MultiheadAttention, x, *, num_heads: int, cond=None,
                        causal: bool = False, impl: str = "auto", ln=None,
                        residual=None, ln_eps: float = 1e-5):
    """x: (B, Sq, E); cond: (B, Sk, Ck) or None.  Returns (B, Sq, E).

    ``ln``/``residual``, when given, apply the caller's pre-LN and add the
    residual after the output projection."""
    kv_in = x if cond is None else cond.to(x.dtype)
    b, sq, e = x.shape
    d = e // num_heads
    if ln is not None:
        x = layers.layer_norm(ln, x, eps=ln_eps)
        if cond is None:
            kv_in = x
    if cond is None:
        w, bias = mod.fused_qkv()
        q, k, v = torch.nn.functional.linear(x, w, bias).split(e, dim=-1)
        q, k, v = (t.reshape(b, sq, num_heads, d) for t in (q, k, v))
    else:
        sk = kv_in.shape[1]
        q = layers.linear(mod.q_proj, x).reshape(b, sq, num_heads, d)
        k = layers.linear(mod.k_proj, kv_in).reshape(b, sk, num_heads, d)
        v = layers.linear(mod.v_proj, kv_in).reshape(b, sk, num_heads, d)
    out = sdpa(q, k, v, causal=causal, impl=impl).reshape(b, sq, e)
    out = layers.linear(mod.out_proj, out)
    return out if residual is None else out + residual
