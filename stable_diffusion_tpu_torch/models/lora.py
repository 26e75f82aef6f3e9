"""LoRA as a tree of tensors merged functionally (port of
stable_diffusion_tpu/models/lora.py).

The tree is keyed by the dotted module path of each target (the JAX key
path, which the port's module names follow): ``{path: {"lora_A", "lora_B",
"alpha"}}``, in torch orientation (linear A (out, r), B (r, in); conv A
(O, r, kh, kw), B (r, I, kh, kw)), so a JAX tree carries over as it is
(``utils.weights.lora_from_jax``).  ``alpha`` is a 0-d tensor and a trained
leaf, as in JAX, where ``jax.value_and_grad`` differentiates the whole tree.

* delta = (A @ B) * scale (conv: ``einsum("orhw,rihw->oihw")``), with
  scale = rank / alpha, the reference's inverted convention, cast to the
  base weight's dtype.
* The merge is functional: :func:`merge_lora` returns new weight tensors,
  which reach the model through ``torch.func.functional_call``, so the
  gradients flow to A, B and alpha and the base weights stay as they are.
* On a tensor-parallel shard (parallel/mesh.py) the tree stays whole and
  the same on every rank, as JAX places it (``P()``), and each sharded
  target takes its rank's slice of the whole delta by ``local_shard``'s
  rule.  The gradient of such an entry is then this rank's part only:
  :func:`sharded_entries` names the entries whose gradients the train step
  sums over "model" (a replicated target's gradient is already whole).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import torch
from torch import nn

from stable_diffusion_tpu_torch.parallel.mesh import MODEL_AXIS, local_shard, param_spec
from stable_diffusion_tpu_torch.utils.device import span

# Default target suffixes, matching the reference CLIs.
DEFAULT_UNET_TARGETS = (
    "q_proj", "k_proj", "v_proj", "out_proj", "conv_input", "conv_output",
    "ffn.0.proj", "ffn.1",
)


def _kernel_modules(model: nn.Module):
    """(path, module) for every module that owns a kernel (JAX ``kernel``):
    the linears and convs."""
    return [(p, m) for p, m in model.named_modules() if isinstance(m, (nn.Linear, nn.Conv2d))]


def match_targets(model: nn.Module, targets: Sequence[str]) -> List[str]:
    """Sorted paths of kernel-owning modules whose path ends with a target."""
    return sorted(p for p, _ in _kernel_modules(model) if any(p.endswith(t) for t in targets))


def init_lora(generator: torch.Generator, model: nn.Module, *, rank: int, alpha: float,
              targets: Sequence[str] = DEFAULT_UNET_TARGETS, dtype=torch.float32,
              device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """A ~ N(0, 1) drawn from ``generator`` in sorted path order, B = 0."""
    mods = dict(_kernel_modules(model))
    device = next(model.parameters()).device if device is None else device
    lora = {}
    for path in match_targets(model, targets):
        w = mods[path].weight
        if w.dim() == 2:
            out_dim, in_dim = w.shape
            a_shape, b_shape = (out_dim, rank), (rank, in_dim)
        else:
            out_dim, in_dim, kh, kw = w.shape
            a_shape, b_shape = (out_dim, rank, kh, kw), (rank, in_dim, kh, kw)
        a = torch.randn(a_shape, generator=generator, device=generator.device, dtype=dtype)
        lora[path] = {"lora_A": a.to(device), "lora_B": torch.zeros(b_shape, dtype=dtype, device=device),
                      "alpha": torch.tensor(alpha, dtype=dtype, device=device)}
    return lora


def lora_delta(entry: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The weight delta of one entry, in the weight's torch layout."""
    a, b = entry["lora_A"], entry["lora_B"]
    scale = a.shape[1] / entry["alpha"]
    if a.dim() == 2:
        return (a @ b) * scale
    return torch.einsum("orhw,rihw->oihw", a, b) * scale


@torch.no_grad()
def merge_lora_(model: nn.Module, lora: Mapping[str, Mapping[str, torch.Tensor]]) -> nn.Module:
    """Fold each entry's delta into ``model``'s weights in place (a LoRA
    merged at load, for inference): weight + delta, the delta taken in at
    least f32 on the weight's device and cast to the weight's dtype.  A
    rank-2 entry on a 1x1 conv (a kohya file's linear proj_in / proj_out of
    SD2.1) takes the conv weight's shape."""
    params = dict(model.named_parameters())
    for path, entry in lora.items():
        w = params[f"{path}.weight"]
        e = {k: v.to(device=w.device, dtype=torch.promote_types(v.dtype, torch.float32))
             for k, v in entry.items()}
        w.copy_(w + lora_delta(e).reshape(w.shape).to(w.dtype))
    return model


def sharded_entries(lora: Mapping[str, Mapping[str, torch.Tensor]], mesh) -> List[str]:
    """The paths of ``lora`` whose target ``mesh`` splits over "model" (none
    without a mesh or on a model axis of one)."""
    if mesh is None or mesh.model == 1:
        return []
    return [p for p, e in lora.items() if MODEL_AXIS in param_spec(f"{p}.weight", e["lora_A"])]


def merge_lora(params: Mapping[str, torch.Tensor], lora: Mapping[str, Mapping[str, torch.Tensor]],
               *, enabled: bool = True, mesh=None) -> Dict[str, torch.Tensor]:
    """``params`` (``dict(model.named_parameters())``) with each target's
    ``{path}.weight`` replaced by weight + delta (cast to the weight's
    dtype); the others are the same tensors.  Pure: nothing is written.
    With ``mesh``, ``params`` are a shard's (``shard_module_``) and a
    sharded target adds its rank's slice of the whole delta."""
    out = dict(params)
    if not enabled:
        return out
    with span("lora_merge"):
        sharded = set(sharded_entries(lora, mesh))
        for path, entry in lora.items():
            key = f"{path}.weight"
            delta = lora_delta(entry)
            if path in sharded:
                delta = local_shard(key, delta, mesh)
            out[key] = out[key] + delta.to(out[key].dtype)
    return out
