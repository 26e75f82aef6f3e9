"""The trainer's optimizer as plain functions on tensor trees (port of
stable_diffusion_tpu/optim.py and of the optax transformations the JAX
trainer chains: ``adamw``, ``clip_by_global_norm``, ``MultiSteps``).

Not ``torch.optim``: the state and every update follow optax step for step
(the tests hold them to it), and the trees are the LoRA tree's nested dicts.
A :class:`Transform` is optax's ``GradientTransformation``: ``init(params)
-> state`` and ``update(grads, state, params) -> (updates, state)``; the
caller adds the updates (:func:`apply_updates`).  Scalars that optax keeps
in f32 (schedule values, bias corrections) are f32 here too.  The updates
run as ``torch._foreach_*`` operations over the tree's leaves, in optax's
order of operations.

``adamw_8bit`` keeps the Adam moments in blockwise 8 bits (the reference's
``bnb.AdamW8bit`` branch): m as signed linear int8 and v on a log scale, one
f32 scale per 256 values, dequantized inside the update.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Union

import torch
import torch.nn.functional as F

from stable_diffusion_tpu_torch.utils.tree import (foreach_map, global_norm, tree_map,
                                                   zeros_like)

BLOCK = 256
_F32 = torch.float32


class Transform(NamedTuple):
    init: Callable
    update: Callable


Schedule = Callable[[int], torch.Tensor]


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32)


# ---------------------------------------------------------------------------
# Learning-rate schedules (optax formulas, f32)
# ---------------------------------------------------------------------------


def _linear(init: float, end: float, steps: int) -> Schedule:
    def fn(count):
        frac = 1 - _f32(min(max(int(count), 0), steps)) / steps
        return (init - end) * frac + end
    return fn


def _cosine(init: float, decay_steps: int) -> Schedule:
    def fn(count):
        c = torch.minimum(_f32(int(count)), _f32(float(decay_steps)))
        return init * (0.5 * (1 + torch.cos(math.pi * c / float(decay_steps))))
    return fn


def _join(first: Schedule, then: Schedule, boundary: int) -> Schedule:
    return lambda count: first(count) if int(count) < boundary else then(int(count) - boundary)


def make_lr_schedule(kind: str, base_lr: float, *, warmup_steps: int = 0,
                     total_steps: int = 1000) -> Schedule:
    """kind: "constant" | "constant_with_warmup" | "cosine", over the
    optimizer-update horizon ``total_steps``."""
    if kind == "constant":
        return lambda count: _f32(base_lr)
    warm = max(warmup_steps, 1)
    if kind == "constant_with_warmup":
        return _join(_linear(0.0, base_lr, warm), lambda count: _f32(base_lr), warm)
    if kind == "cosine":
        decay = max(total_steps, warmup_steps + 1)
        return _join(_linear(0.0, base_lr, warm), _cosine(base_lr, decay - warm), warm)
    raise ValueError(f"unknown lr schedule {kind!r}")


def _lr_at(learning_rate: Union[float, Schedule], count: int) -> torch.Tensor:
    return learning_rate(count) if callable(learning_rate) else _f32(learning_rate)


# ---------------------------------------------------------------------------
# AdamW, clipping, accumulation (optax)
# ---------------------------------------------------------------------------


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Transform:
    """``optax.adamw``: scale_by_adam -> add_decayed_weights (every leaf) ->
    scale by -lr(count), the schedule read at the count before this update."""

    def init(params):
        return {"count": 0, "mu": zeros_like(params), "nu": zeros_like(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        mu = foreach_map(lambda g, m: torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                                         torch._foreach_mul(m, b1)),
                         grads, state["mu"])
        nu = foreach_map(lambda g, v: torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2), torch._foreach_mul(v, b2)),
            grads, state["nu"])
        bc1, bc2 = float(1 - _f32(b1) ** count), float(1 - _f32(b2) ** count)
        lr = float(_lr_at(learning_rate, state["count"]))

        def step(m, v, p):  # ((m / bc1) / (sqrt(v / bc2) + eps) + wd p) * -lr
            den = torch._foreach_sqrt(torch._foreach_div(v, bc2))
            torch._foreach_add_(den, eps)
            u = torch._foreach_div(torch._foreach_div(m, bc1), den)
            torch._foreach_add_(u, torch._foreach_mul(p, weight_decay))
            torch._foreach_mul_(u, -lr)
            return u

        return foreach_map(step, mu, nu, params), {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def clip_by_global_norm(max_norm: float) -> Transform:
    """Scale the whole tree by max_norm / norm when its norm is larger."""

    def update(grads, state, params=None):
        g_norm = float(global_norm(grads))
        if g_norm < max_norm:
            return grads, state
        return foreach_map(lambda ts: torch._foreach_mul(torch._foreach_div(ts, g_norm), max_norm),
                           grads), state

    return Transform(lambda params: {}, update)


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return [t.init(params) for t in transforms]

    def update(grads, state, params=None):
        new = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new.append(s)
        return grads, new

    return Transform(init, update)


def multi_steps(inner: Transform, every_k: int) -> Transform:
    """``optax.MultiSteps``: a running mean of the micro-step gradients; the
    inner transformation runs on every ``every_k``-th call and the other
    calls return zero updates."""

    def init(params):
        return {"mini_step": 0, "gradient_step": 0, "inner": inner.init(params),
                "acc": zeros_like(params)}

    def update(grads, state, params=None):
        n = state["mini_step"]
        acc = foreach_map(lambda g, a: torch._foreach_add(
            a, torch._foreach_div(torch._foreach_sub(g, a), n + 1)), grads, state["acc"])
        if n < every_k - 1:
            return zeros_like(acc), {**state, "mini_step": n + 1, "acc": acc}
        updates, inner_state = inner.update(acc, state["inner"], params)
        return updates, {"mini_step": 0, "gradient_step": state["gradient_step"] + 1,
                         "inner": inner_state, "acc": zeros_like(acc)}

    return Transform(init, update)


def apply_updates(params, updates):
    """params + updates, in each parameter's dtype (``optax.apply_updates``)."""
    return foreach_map(lambda ps, us: [s.to(p.dtype) for s, p in zip(torch._foreach_add(ps, us), ps)],
                       params, updates)


# ---------------------------------------------------------------------------
# Blockwise 8-bit moment storage
# ---------------------------------------------------------------------------


class Q8(NamedTuple):
    q: torch.Tensor      # int8 (linear) / uint8 (log), (nblocks, BLOCK)
    scale: torch.Tensor  # f32 per-block absmax (linear) or max (log), (nblocks, 1)


def _to_blocks(x: torch.Tensor) -> torch.Tensor:
    flat = x.to(_F32).reshape(-1)
    return F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)


def _from_blocks(blocks: torch.Tensor, shape) -> torch.Tensor:
    return blocks.reshape(-1)[: math.prod(shape)].reshape(shape)


def _quantize(x: torch.Tensor) -> Q8:
    """Signed linear blockwise int8 (the first moment)."""
    blocks = _to_blocks(x)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    return Q8(torch.round(blocks / torch.clamp(scale, min=1e-30)).to(torch.int8), scale)


def _dequantize(s: Q8, shape) -> torch.Tensor:
    return _from_blocks(s.q.to(_F32) * s.scale, shape)


# The second moment sits under a sqrt in the denominator: a log-uniform code
# over 7 decades below the block's max, code 0 kept for an exact 0.
_LOG_MIN = math.log(1e-7)


def _quantize_log(x: torch.Tensor) -> Q8:
    """Non-negative log-scale blockwise 8-bit (the second moment)."""
    blocks = _to_blocks(x)
    vmax = blocks.amax(dim=1, keepdim=True)
    y = torch.log(torch.clamp(blocks, min=1e-38) / torch.clamp(vmax, min=1e-38))
    t = torch.clamp(1.0 - y / _LOG_MIN, 0.0, 1.0)
    q = torch.where(blocks <= 0.0, 0.0, 1 + torch.round(t * 254.0))
    return Q8(q.to(torch.uint8), vmax)


def _dequantize_log(s: Q8, shape) -> torch.Tensor:
    t = (s.q.to(_F32) - 1.0) / 254.0
    val = s.scale * torch.exp(_LOG_MIN * (1.0 - t))
    return _from_blocks(torch.where(s.q == 0, 0.0, val), shape)


def adamw_8bit(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 1e-2) -> Transform:
    """AdamW with blockwise 8-bit moments; the schedule is read at the
    incremented count, as the JAX version does."""

    def init(params):
        return {"count": 0,
                "mu": tree_map(lambda p: _quantize(torch.zeros_like(p, dtype=_F32)), params),
                "nu": tree_map(lambda p: _quantize_log(torch.zeros_like(p, dtype=_F32)), params)}

    def update(grads, state, params):
        count = state["count"] + 1
        b1c, b2c = 1.0 - _f32(b1) ** count, 1.0 - _f32(b2) ** count
        lr = _lr_at(learning_rate, count)

        def upd(g, mu_q, nu_q, p):  # -> (update, new mu, new nu)
            g = g.to(_F32)
            mu = b1 * _dequantize(mu_q, g.shape) + (1.0 - b1) * g
            nu = b2 * _dequantize_log(nu_q, g.shape) + (1.0 - b2) * g * g
            step = mu / b1c / (torch.sqrt(nu / b2c) + eps)
            step = step + weight_decay * p.to(_F32)
            return (-lr * step).to(p.dtype), _quantize(mu), _quantize_log(nu)

        out = tree_map(upd, grads, state["mu"], state["nu"], params)
        return (tree_map(lambda o: o[0], out),
                {"count": count, "mu": tree_map(lambda o: o[1], out),
                 "nu": tree_map(lambda o: o[2], out)})

    return Transform(init, update)


def opt_state_nbytes(state) -> int:
    """Bytes of the tensors in an optimizer state."""
    if isinstance(state, dict):
        return sum(opt_state_nbytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(opt_state_nbytes(v) for v in state)
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    return 0
