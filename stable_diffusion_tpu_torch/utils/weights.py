"""Weight bridge between the JAX package's parameter trees and the port's
``state_dict``s, and seeded random weights.

The JAX trees' key paths mirror the module names, so the bridge is the
inverse of stable_diffusion_tpu/utils/torch_interop.py ``convert_tensor``:
``kernel`` HWIO -> ``weight`` OIHW, ``kernel`` (in, out) -> ``weight``
(out, in), ``scale`` -> ``weight``, ``embedding`` -> ``weight`` as it is,
``bias`` as it is.  That module cannot be imported here (importing anything
under ``stable_diffusion_tpu`` imports jax), so ``flatten_tree`` and the
layout rules are written again.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_EMBEDDING_MARKERS = ("embedding", "embeddings")


def flatten_tree(tree, prefix: str = "") -> Dict[str, object]:
    """{"a": {"b": x}} -> {"a.b": x}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, path))
        else:
            out[path] = v
    return out


def unflatten(flat: Mapping[str, object]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _is_embedding(parts) -> bool:
    owner = parts[-2] if len(parts) >= 2 else ""
    return any(m in owner for m in _EMBEDDING_MARKERS)


def _jax_leaf(parts, ndim: int) -> str:
    """JAX leaf name of a torch parameter key (split on '.')."""
    name = parts[-1]
    if name != "weight":
        return name
    if ndim == 2 and _is_embedding(parts):
        return "embedding"
    return {4: "kernel", 2: "kernel", 1: "scale"}[ndim]


def _to_torch_layout(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and value.ndim == 4:
        return np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
    if leaf == "kernel" and value.ndim == 2:
        return np.transpose(value, (1, 0))  # (in, out) -> (out, in)
    return value


def _to_jax_layout(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and value.ndim == 4:
        return np.transpose(value, (2, 3, 1, 0))  # OIHW -> HWIO
    if leaf == "kernel" and value.ndim == 2:
        return np.transpose(value, (1, 0))
    return value


def jax_key(torch_key: str, ndim: int) -> str:
    parts = torch_key.split(".")
    return ".".join(parts[:-1] + [_jax_leaf(parts, ndim)])


def from_jax_params(tree, *, dtype=None, device=None) -> "OrderedDict[str, torch.Tensor]":
    """A JAX parameter tree (nested dicts of arrays) -> a torch ``state_dict``."""
    out = OrderedDict()
    for key, value in flatten_tree(tree).items():
        parts = key.split(".")
        leaf = parts[-1]
        value = _to_torch_layout(leaf, np.asarray(value))
        name = "bias" if leaf == "bias" else "weight"
        t = torch.from_numpy(np.require(value, requirements=["C", "W"]))
        out[".".join(parts[:-1] + [name])] = t.to(device=device, dtype=dtype or t.dtype)
    return out


def to_jax_params(module: nn.Module) -> Dict:
    """The module's parameters as a JAX-layout tree of numpy f32 arrays."""
    flat = {}
    for key, t in module.state_dict().items():
        leaf = _jax_leaf(key.split("."), t.dim())
        flat[jax_key(key, t.dim())] = _to_jax_layout(leaf, t.detach().float().cpu().numpy())
    return unflatten(flat)


def jax_param_shapes(module: nn.Module) -> Dict[str, tuple]:
    """{JAX flat key: JAX shape} of the module's parameters, computed without
    JAX (and without touching the values, so a meta-device module works)."""
    shapes = {}
    for key, t in module.state_dict().items():
        leaf = _jax_leaf(key.split("."), t.dim())
        view = np.broadcast_to(np.float32(0), tuple(t.shape))  # a shape, no storage
        shapes[jax_key(key, t.dim())] = _to_jax_layout(leaf, view).shape
    return shapes


def build(cls, cfg, *, device, dtype) -> nn.Module:
    """Construct a module without running its initialisers (meta device),
    then allocate uninitialised storage on ``device``; load or initialise
    the weights afterwards."""
    with torch.device("meta"):
        mod = cls(cfg)
    return mod.to_empty(device=device).to(dtype)


def philox_jax_params(module: nn.Module, seed: int, scale: float = 0.02) -> Dict[str, np.ndarray]:
    """Numpy Philox(seed) normal draws * scale for each JAX key, in sorted key
    order and JAX shapes: the parameters of tests/golden/full_sd15_ddim2.npz
    when seed is 7 (tests/test_golden.py ``_philox_params``)."""
    rng = np.random.Generator(np.random.Philox(seed))
    shapes = jax_param_shapes(module)
    return {k: rng.standard_normal(shapes[k], dtype=np.float32) * scale for k in sorted(shapes)}


@torch.no_grad()
def init_random_(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights drawn on the module's device: linear and conv
    weights N(0, 1/fan_in), embeddings N(0, 1), norm weights 1, biases 0.
    Keeps activations at unit scale through a deep stack, so a randomly
    weighted model still gives a non-degenerate image."""
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in module.named_parameters():
        parts = name.split(".")
        leaf = _jax_leaf(parts, p.dim())
        if leaf == "bias":
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        else:
            std = 1.0 if leaf == "embedding" else 1.0 / math.sqrt(p[0].numel())
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * std)
    return module
