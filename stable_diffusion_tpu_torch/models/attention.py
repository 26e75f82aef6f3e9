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
        """(3E, E) weight and (3E,) bias of the fused projection.

        With grad enabled it is concatenated live from the projections'
        current tensors, so gradients reach them (and a
        ``torch.func.functional_call`` substitution, as the LoRA merge makes,
        is followed).  Under no_grad it is cached until one of those tensors
        is replaced or changed in place; the cache holds the tensors
        themselves, so a freed tensor's address cannot alias a new one."""
        ps = [self.q_proj, self.k_proj, self.v_proj]
        tensors = [t for p in ps for t in (p.weight, p.bias) if t is not None]
        if torch.is_grad_enabled():
            return self._concat(ps)
        key = [(t, t._version, t.data_ptr(), t.dtype) for t in tensors]
        cached = getattr(self, "_qkv_cache", None)
        if (cached is None or len(cached[0]) != len(key)
                or any(a[0] is not b[0] or a[1:] != b[1:] for a, b in zip(cached[0], key))):
            cached = (key, *self._concat(ps))
            self._qkv_cache = cached
        return cached[1], cached[2]

    @staticmethod
    def _concat(ps):
        w = torch.cat([p.weight for p in ps], dim=0)
        b = torch.cat([p.bias for p in ps]) if ps[0].bias is not None else None
        return w, b


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
