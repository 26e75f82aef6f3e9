"""Trees of tensors as nested dicts (the port's stand-in for JAX pytrees in
the trainer: the LoRA tree, its gradients, optimizer moments, the EMA).

The trainer's per-step arithmetic runs on the flattened leaves with
``torch._foreach_*`` operations: a few kernel launches for the whole tree
instead of a few per leaf (the LoRA tree of the SD1.5 train step has 384
leaves, and launching per leaf kept the card idle most of the step)."""

from __future__ import annotations

from typing import Callable, List, Mapping

import torch


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """Leaves in the order JAX flattens a dict tree (sorted keys)."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` (in tree_leaves order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, Mapping):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def foreach_map(fn: Callable, tree, *rest):
    """``fn`` on the leaf lists of trees of one structure (``torch._foreach_*``
    ops), its list of results as a tree of that structure."""
    return tree_unflatten(tree, fn(tree_leaves(tree), *(tree_leaves(r) for r in rest)))


def zeros_like(tree):
    """A tree of zeros shaped as ``tree``, filled by one multi-tensor launch."""
    leaves = [torch.empty_like(t) for t in tree_leaves(tree)]
    torch._foreach_zero_(leaves)
    return tree_unflatten(tree, leaves)


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in f32 (``optax.global_norm``)."""
    norms = torch._foreach_norm([leaf.float() for leaf in tree_leaves(tree)])
    return torch.linalg.vector_norm(torch.stack(norms))
