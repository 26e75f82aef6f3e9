"""Multi-head (self/cross) attention (port of the plain fused-QKV form of
stable_diffusion_tpu/models/attention.py ``multihead_attention``).

The TPU-only ``_premerged_attention`` is not ported: it zero-padded head dims
to 64 and widths to 128 lanes inside the projection weights, which Hopper
does not need (K3 pads head dims to a multiple of 16 itself).  Its static
W8A8 form equals the non-premerged one (tests/test_attention.py), which is
the form here: with W8A8 projections (``layers.QLinear`` with an
``act_scale``) self-attention runs one LN-prologue int8 QKV product with
q_proj's act_scale shared by q, k and v, cross-attention LN -> int8 q and
int8 k, v on the context, each with its own scale, and both an int8 output
projection with the residual (K8 on the card).  While a calibration
capture of the linears runs, q, k and v go through ``layers.linear`` one at
a time, as JAX's ``FORCE_UNFUSED_QKV``.

Tensor parallelism (parallel/mesh.py): a rank of a "model" axis of tp holds
E / tp rows of q/k/v (num_heads / tp whole heads) and E / tp columns of
out_proj.  The fused QKV is split by the local width, the attention (K3 on
the card) runs on the local heads, and the out projection's partial product
is summed over "model" before its bias and the residual are added, once.
In training the mate of that sum (``Mesh.column_input``) sits on ``x`` and
on the cross-attention context before the projections (the pre-LN
included), and on the pre-LN's weight and bias, so the gradient of each is
summed over every rank's heads; the residual is the caller's ``x``, taken
before it.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch
from torch import nn

from stable_diffusion_tpu_torch.models import layers
from stable_diffusion_tpu_torch.ops.attention import sdpa
from stable_diffusion_tpu_torch.ops.linear import (ln_matmul, ln_matmul_w8a8, matmul_residual,
                                                   matmul_w8a8)
from stable_diffusion_tpu_torch.parallel.mesh import row_parallel
from stable_diffusion_tpu_torch.utils.device import cached


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
        if torch.is_grad_enabled():
            return self._concat(ps)
        tensors = [t for p in ps for t in (p.weight, p.bias) if t is not None]
        return cached(self, "_qkv_cache", tensors, lambda: self._concat(ps))

    @staticmethod
    def _concat(ps):
        w = torch.cat([p.weight for p in ps], dim=0)
        b = torch.cat([p.bias for p in ps]) if ps[0].bias is not None else None
        return w, b

    def fused_qkv_q(self):
        """(3E, E) int8 weight, (3E,) f32 scale and (3E,) bias or None of the
        fused W8A8 projection, cached as :meth:`fused_qkv`'s."""
        ps = [self.q_proj, self.k_proj, self.v_proj]
        tensors = [t for p in ps for t in (p.weight_q, p.weight_scale, p.bias) if t is not None]

        def concat():
            b = torch.cat([p.bias for p in ps]) if ps[0].bias is not None else None
            return (torch.cat([p.weight_q for p in ps]), torch.cat([p.weight_scale for p in ps]), b)

        return cached(self, "_qkv_q_cache", tensors, concat)


def _w8a8_attention(mod: MultiheadAttention, x, kv_in, cond, num_heads, causal, impl, ln,
                    residual, ln_eps):
    b, sq, e = x.shape
    d = e // num_heads
    qp = mod.q_proj

    def project_x(w, scale, bias):  # the caller's pre-LN as the product's prologue
        if ln is None:
            return matmul_w8a8(x, w, scale, qp.act_scale, bias, impl=impl)
        return ln_matmul_w8a8(ln.weight, ln.bias, x, w, scale, qp.act_scale, bias, eps=ln_eps,
                              impl=impl)

    if cond is None:
        q, k, v = project_x(*mod.fused_qkv_q()).split(e, dim=-1)
        q, k, v = (t.reshape(b, sq, num_heads, d) for t in (q, k, v))
    else:
        sk = kv_in.shape[1]
        q = project_x(qp.weight_q, qp.weight_scale, qp.bias).reshape(b, sq, num_heads, d)
        k, v = (matmul_w8a8(kv_in, p.weight_q, p.weight_scale, p.act_scale, p.bias, impl=impl)
                .reshape(b, sk, num_heads, d) for p in (mod.k_proj, mod.v_proj))
    out = sdpa(q, k, v, causal=causal, impl=impl).reshape(b, sq, e)
    o = mod.out_proj
    return matmul_w8a8(out, o.weight_q, o.weight_scale, o.act_scale, o.bias, residual=residual,
                       impl=impl)


def multihead_attention(mod: MultiheadAttention, x, *, num_heads: int, cond=None,
                        causal: bool = False, impl: str = "auto", ln=None,
                        residual=None, ln_eps: float = 1e-5):
    """x: (B, Sq, E); cond: (B, Sk, Ck) or None.  Returns (B, Sq, E).

    ``ln``/``residual``, when given, apply the caller's pre-LN and add the
    residual after the output projection.  A tensor-parallel shard runs the
    rank's heads (``num_heads`` stays the whole model's)."""
    kv_in = x if cond is None else cond.to(x.dtype)
    b, sq, e = x.shape
    d = e // num_heads
    unfused = layers.capturing("linear")
    qp = mod.q_proj
    if isinstance(qp, layers.QLinear) and qp.w8a8 and not unfused:
        return _w8a8_attention(mod, x, kv_in, cond, num_heads, causal, impl, ln, residual, ln_eps)
    mesh = row_parallel(mod.out_proj)
    if mesh is not None:  # a shard: the mates of the out projection's sum
        x = mesh.column_input(x)
        kv_in = x if cond is None else mesh.column_input(kv_in)
        if ln is not None:
            ln = SimpleNamespace(weight=mesh.column_input(ln.weight),
                                 bias=mesh.column_input(ln.bias))
    dense = isinstance(qp, nn.Linear) and not unfused
    # the rank's width and heads: E and num_heads unless q_proj is a shard
    el = qp.weight.shape[0] if isinstance(qp, nn.Linear) else e
    heads = el // d
    if cond is None and dense:
        w, bias = mod.fused_qkv()
        qkv = (torch.nn.functional.linear(x, w, bias) if ln is None
               else ln_matmul(ln.weight, ln.bias, x, w, bias, eps=ln_eps, impl=impl))
        q, k, v = (t.reshape(b, sq, heads, d) for t in qkv.split(el, dim=-1))
    else:
        sk = kv_in.shape[1]
        if ln is not None and dense:
            q = ln_matmul(ln.weight, ln.bias, x, qp.weight, qp.bias, eps=ln_eps, impl=impl)
        else:
            if ln is not None:
                x = layers.layer_norm(ln, x, eps=ln_eps)
                if cond is None:
                    kv_in = x
            q = layers.linear(qp, x, impl=impl)
        q = q.reshape(b, sq, heads, d)
        k = layers.linear(mod.k_proj, kv_in, impl=impl).reshape(b, sk, heads, d)
        v = layers.linear(mod.v_proj, kv_in, impl=impl).reshape(b, sk, heads, d)
    out = sdpa(q, k, v, causal=causal, impl=impl).reshape(b, sq, el)
    o = mod.out_proj
    if residual is not None and isinstance(o, nn.Linear) and not unfused and mesh is None:
        return matmul_residual(out, o.weight, o.bias, residual, impl=impl)
    out = layers.linear(o, out, impl=impl)
    return out if residual is None else out + residual
