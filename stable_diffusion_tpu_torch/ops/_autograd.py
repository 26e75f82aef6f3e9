"""The recompute backward that JAX's ``jax.custom_vjp`` wrappers use, as a
``torch.autograd.Function``.

A kernel's output carries no graph, so its entry point runs the kernel in
``Recompute.forward`` and, in the backward, differentiates the kernel's
plain PyTorch version on the saved inputs (``jax.vjp`` of the ``_xla_*``
reference in the JAX package).  ``fwd`` and ``plain`` are arguments, so the
CPU tests run the same Function with the plain version in both places.
Its users: K1 (``gn_scale_shift``), K3 (cross
attention), K4 (``geglu_ffn``), K10 (``ln_matmul``, ``matmul_residual``:
JAX ``_ln_mm_bwd``, ``_mm_res_bwd``), K11 (``gn_matmul``: ``_gn_mm_bwd``)
and K12 (the routed ``conv3x3`` / ``gn_silu_conv3x3``: ``_conv_bwd``,
differentiating the direct conv, the function K12 computes).
"""

from __future__ import annotations

import torch


def plain_vjp(fn, args, need, grad_out):
    """Gradients of ``fn(*args)`` against ``grad_out`` for the arguments whose
    ``need`` is set, None for the others (and nothing computed when no
    argument needs one)."""
    need = [bool(n) and a is not None for a, n in zip(args, need)]
    if not any(need):
        return [None] * len(args)
    with torch.enable_grad():
        ins = [None if a is None else a.detach().requires_grad_(n) for a, n in zip(args, need)]
        out = fn(*ins)
        got = iter(torch.autograd.grad(out, [a for a, n in zip(ins, need) if n], grad_out))
    return [next(got) if n else None for n in need]


class Recompute(torch.autograd.Function):
    """``fwd(*args)`` forward; the VJP of ``plain(*args)`` backward."""

    @staticmethod
    def forward(ctx, fwd, plain, *args):
        ctx.plain = plain
        ctx.save_for_backward(*args)
        return fwd(*args)

    @staticmethod
    def backward(ctx, grad_out):
        return (None, None, *plain_vjp(ctx.plain, ctx.saved_tensors, ctx.needs_input_grad[2:],
                                       grad_out))
