"""Exponential moving average of a tensor tree (port of
stable_diffusion_tpu/models/ema.py): a copy-through warmup for
``start_ema`` steps, then ema = beta * ema + (1 - beta) * params, in f32 and
cast back to the EMA's dtype.  Pure: new tensors, nothing updated in place."""

from __future__ import annotations

import torch

from stable_diffusion_tpu_torch.utils.tree import foreach_map, tree_map


def ema_init(params):
    return tree_map(lambda p: p.detach().clone(), params)


def ema_update(ema, params, step: int, *, beta: float = 0.995, start_ema: int = 2000):
    """``step``: the number of updates applied so far."""
    b = torch.tensor(0.0 if int(step) < start_ema else beta, dtype=torch.float32)
    b, one_minus_b = float(b), float(1.0 - b)  # f32 values, as JAX computes them

    def upd(es, ps):
        ef = [e.float() for e in es]
        new = torch._foreach_add(torch._foreach_mul(ef, b),
                                 torch._foreach_mul([p.detach().float() for p in ps], one_minus_b))
        return [n.to(e.dtype) for n, e in zip(new, es)]

    return foreach_map(upd, ema, params)
