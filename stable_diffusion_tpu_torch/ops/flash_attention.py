"""Non-causal attention over (B, S, H, D): kernel K3 (CUDA) beside its plain version.

K3 (csrc/attention.cu) replaces three TPU kernels of
stable_diffusion_tpu/ops/flash_attention.py with one blockwise online
softmax: ``_single_pass_kernel`` and ``_flash_kernel`` (self-attention) and
``_cross_kernel`` (the 77-token text cross-attention, masked by ``kv_len``).
The note at the top of the source says what bounds it and how it is built.

q, k and v may be strided views (the split of a fused QKV projection): the
kernel takes each tensor's batch and sequence strides and needs only the
head and head-dim axes packed.
"""

from __future__ import annotations

from typing import Optional

import torch

from stable_diffusion_tpu_torch.ops import _cuda
from stable_diffusion_tpu_torch.utils.device import LaunchCounter, require, use_kernel

K3 = LaunchCounter()


def attention_plain(q, k, v, *, scale: Optional[float] = None, kv_len: Optional[int] = None,
                    causal: bool = False):
    """Einsum attention with an f32 softmax (ops/attention.py ``_xla_sdpa``):
    f32 logits, probabilities cast to v's dtype for the PV product.  Keys at
    or past ``kv_len`` are masked out."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    sq, sk = q.shape[1], k.shape[1]
    if causal or kv_len is not None:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qi + (sk - sq) >= ki
        if kv_len is not None:
            mask &= ki < kv_len
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _strides_ok(t: torch.Tensor, d: int) -> bool:
    return (t.stride(3) == 1 and t.stride(2) == d and t.stride(0) % 8 == 0
            and t.stride(1) % 8 == 0 and t.data_ptr() % 16 == 0)


def attention_kernel(q, k, v, *, scale: Optional[float] = None, kv_len: Optional[int] = None):
    """Launch K3.  q (B, Sq, H, D), k/v (B, Sk, H, D), bf16 on CUDA."""
    require(q.is_cuda, f"K3 needs a CUDA tensor, got {q.device}")
    require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, "K3 takes (B, S, H, D) tensors")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    require(k.shape == (b, sk, h, d) and v.shape == k.shape,
            f"K3: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    require(all(t.dtype == torch.bfloat16 for t in (q, k, v)), "K3 takes bf16 q, k, v")
    require(d % 8 == 0 and d <= 512, f"K3 takes head dims that are multiples of 8 up to 512, got {d}")
    require(all(_strides_ok(t, d) for t in (q, k, v)),
            "K3 needs packed (H, D) axes, strides that are multiples of 8 and 16-byte alignment")
    kv_len = sk if kv_len is None else int(kv_len)
    require(0 < kv_len <= sk, f"K3: kv_len={kv_len} for Sk={sk}")
    scale = d ** -0.5 if scale is None else float(scale)
    o = torch.empty((b, sq, h, d), device=q.device, dtype=q.dtype)
    code = _cuda.library().sdtk_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        b, h, sq, sk, d, kv_len, scale, _cuda.stream_handle(q))
    _cuda.check(code, "K3 attention")
    K3.launched((b, sq, sk, h, d))
    return o


def attention(q, k, v, *, scale: Optional[float] = None, kv_len: Optional[int] = None,
              impl: str = "auto"):
    """Non-causal attention: K3 on the card, the plain version on the CPU."""
    if not use_kernel(impl, q):
        return attention_plain(q, k, v, scale=scale, kv_len=kv_len)
    return attention_kernel(q, k, v, scale=scale, kv_len=kv_len)
