"""Training checkpoints: save and resume (port of
stable_diffusion_tpu/utils/checkpoint.py).

A checkpoint is ``{"epoch", "state"}``: the trainer's state (the LoRA tree,
the optimizer state with its 8-bit moments where ``--use_8bit_adam`` keeps
them, the EMA, ``step``), every tensor moved to the CPU, written by
``torch.save`` to ``<path>.ckpt`` (through a temporary file, so a run cut
while writing leaves the previous checkpoint whole).  It is read back with
``torch.load(weights_only=True)``: tensors, containers, numbers and the
optimizer's ``Q8`` records only, no code from the file.

The JAX package writes orbax directories or flax msgpack files, which need
packages the port does not use: such a path raises ``ValueError``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from stable_diffusion_tpu_torch.optim import Q8

SUFFIX = ".ckpt"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_to_cpu(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree


def _refuse_jax_format(path: str) -> None:
    if path.endswith((".msgpack", ".orbax")) or os.path.isdir(path):
        kind = "a flax msgpack file" if path.endswith(".msgpack") else "an orbax checkpoint"
        raise ValueError(f"{path}: {kind}, the JAX trainer's format; the port reads the "
                         f"{SUFFIX} files of train_lora_dreambooth_torch.py (torch.save) only")


def save_train_checkpoint(path: str, state: Dict[str, Any]) -> str:
    """``state``: ``{"epoch", "state"}`` (anything of tensors, dicts, lists,
    tuples and numbers).  Returns the path written, ``path`` ending in
    ``.ckpt``."""
    _refuse_jax_format(path)
    path = path if path.endswith(SUFFIX) else path + SUFFIX
    tmp = path + ".tmp"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)
    return path


def load_train_checkpoint(path: str, *, device: Optional[torch.device] = None):
    """A checkpoint of :func:`save_train_checkpoint`, its tensors on
    ``device`` (as saved, on the CPU, when None)."""
    _refuse_jax_format(path)
    with torch.serialization.safe_globals([Q8]):
        return torch.load(path, map_location=device, weights_only=True)
