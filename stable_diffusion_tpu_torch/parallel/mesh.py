"""Mesh construction and sharding rules on ``torch.distributed`` (port of
stable_diffusion_tpu/parallel/mesh.py).

A 2-D ("data", "model") mesh over the process group's world, laid out as
JAX's ``devices.reshape(data, model)``: rank r sits at (r // model, r %
model).  Data parallelism splits a request's batch lanes over "data";
tensor parallelism splits every transformer linear over "model" by JAX's
rule (Megatron's column -> row pairing): q/k/v (query/key/value), fc1 and
the GeGLU projection by output rows, out_proj (proj_attn), fc2 and ``ffn.1``
by input columns, with one all-reduce after each row-parallel product.
Convs, norms and embeddings stay replicated.

The hand-written kernels take raw pointers, so the shards are explicit: each
rank keeps its own slices as the modules' parameters (:func:`shard_module_`)
and the forward passes run on those local tensors (``models/attention.py``:
the rank's heads, K3 on them; ``layers.linear`` and ``models/unet.py``
``ffn_apply``: the row-parallel product without its bias, the all-reduce
over "model", then the bias and the residual added once).  Where that
differs from JAX, which lets GSPMD move data around one global program:

* the GeGLU projection's 8C output rows are value rows then gate rows, and
  JAX's one-block split would give one rank every value and the other every
  gate; here each rank keeps the matching value and gate halves, so K4 runs
  on a hidden width of 4C / tp;
* int8 holders (``layers.QLinear``, whose leaves are ``weight_q``, not
  ``weight``) stay replicated, bias included, as JAX's ``\\.kernel$`` rules
  leave the quantized kernels;
* ``StableDiffusion.shard`` leaves the VAE replicated: its mid attention is
  one head of 512 and cannot be split by heads.

Collectives follow the cards the ranks hold (:func:`backend_for`, on the
cards' UUIDs that :func:`init_distributed` exchanges): gloo on the CPU, NCCL
when no two ranks hold the same card, and gloo where ranks share one (NCCL
refuses two ranks on one device); a gloo mesh moves a CUDA tensor through
the host for its collective, in f32.

Training (JAX lets GSPMD derive the backward): the collectives sit in the
autograd graph as Megatron's pair.  :meth:`Mesh.all_reduce` over "model" is
the row-parallel sum: the sum in the forward, the gradient passed on as it
is in the backward (everything after the sum is replicated, so every rank
holds the same gradient of it).  :meth:`Mesh.column_input` is its mate at
every column-parallel input (``models/attention.py``'s x and cross-attention
context, ``ffn_apply``'s x, the text tower's ``fc1`` input, and the weight
and bias of a LayerNorm fused ahead of the projection): the tensor
itself in the forward, and in the backward the sum over "model" of each
rank's gradient, which reaches the input through that rank's heads or
hidden units only.  :meth:`Mesh.sum_flat` sums a list of tensors (a
gradient tree's leaves) over an axis in one collective.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

# JAX's rules (parallel/mesh.py), on PyTorch's names: ``kernel`` (in, out) is
# ``weight`` (out, in), so a column kernel shards dim 0 and a row kernel dim 1.
_COL_WEIGHT = re.compile(r"(q_proj|k_proj|v_proj|query|key|value|fc1|ffn\.0\.proj)\.weight$")
_COL_BIAS = re.compile(r"(q_proj|k_proj|v_proj|query|key|value|fc1|ffn\.0\.proj)\.bias$")
_ROW_WEIGHT = re.compile(r"(out_proj|proj_attn|fc2|ffn\.1)\.weight$")
# The GeGLU projection: value rows, then gate rows, split as matching halves.
_PAIRED = re.compile(r"ffn\.0\.proj\.(weight|bias)$")


def param_spec(path: str, tensor: torch.Tensor) -> Tuple[Optional[str], ...]:
    """The sharding of one parameter, keyed by its dotted path: one entry a
    dim, ``"model"`` where the dim is split; ``()`` is replicated.  JAX's
    ``param_spec`` on the transposed kernel."""
    if tensor.dim() == 2:
        if _COL_WEIGHT.search(path):
            return (MODEL_AXIS, None)
        if _ROW_WEIGHT.search(path):
            return (None, MODEL_AXIS)
    if tensor.dim() == 1 and _COL_BIAS.search(path):
        return (MODEL_AXIS,)
    return ()


def backend_for(cards) -> str:
    """The collective backend for ranks holding ``cards``, one entry a rank:
    a card's UUID, or ``""`` for a rank on the CPU.  gloo on the CPU, NCCL
    when every rank holds a card of its own, gloo when two ranks share one."""
    if "" in cards:
        return "gloo"
    return "nccl" if len(set(cards)) == len(cards) else "gloo"


def init_distributed(rank: int, world_size: int, init_method: str, device="cuda") -> torch.device:
    """Join the process group (``init_method`` e.g. ``tcp://localhost:PORT``
    or ``file://PATH``) and return this rank's device: the CPU, the card
    ``device`` names, or card ``rank % device_count`` for a bare ``"cuda"``.
    The ranks first swap their cards' UUIDs through the rendezvous store,
    and the world takes :func:`backend_for`'s backend on them.  A CUDA
    device on a machine without a card raises."""
    device = torch.device(device)
    card = ""
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') on a machine without a card")
        index = device.index if device.index is not None else rank % torch.cuda.device_count()
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
        card = str(torch.cuda.get_device_properties(device).uuid)
    store, rank, world_size = next(dist.rendezvous(init_method, rank, world_size))
    store.set(f"sdtk_card/{rank}", card)
    cards = [store.get(f"sdtk_card/{r}").decode() for r in range(world_size)]
    dist.init_process_group(backend_for(cards), store=dist.PrefixStore("default_pg", store),
                            rank=rank, world_size=world_size)
    return device


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on a ("data", "model") mesh: the axes' sizes, its
    coordinates and the group of each axis it belongs to."""

    data: int
    model: int
    coords: Tuple[int, int]
    groups: Dict[str, object]
    backend: str

    def size(self, axis: str) -> int:
        return self.data if axis == DATA_AXIS else self.model

    def index(self, axis: str) -> int:
        return self.coords[0 if axis == DATA_AXIS else 1]

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where this mesh's backend takes it: gloo works on host tensors."""
        return t.cpu() if self.backend != "nccl" and t.is_cuda else t

    def _sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over ``axis`` as a new tensor (``t`` is left as
        it was); through the host on a gloo mesh, in f32 there."""
        wire = self._wire(t)
        wire = (wire.float() if wire is not t else wire.clone()).contiguous()
        dist.all_reduce(wire, group=self.groups[axis])
        return wire.to(device=t.device, dtype=t.dtype)

    def all_reduce(self, t: torch.Tensor, axis: str = MODEL_AXIS) -> torch.Tensor:
        """The sum of ``t`` over ``axis`` (``t`` itself on an axis of one).
        Where ``t`` wants a gradient, the row-parallel rule: the gradient
        passes the sum unchanged."""
        if self.size(axis) == 1:
            return t
        if torch.is_grad_enabled() and t.requires_grad:
            return _RowSum.apply(t, self, axis)
        return self._sum(t, axis)

    def column_input(self, t: torch.Tensor, axis: str = MODEL_AXIS) -> torch.Tensor:
        """The mate of :meth:`all_reduce` at a column-parallel input: ``t``
        itself, whose gradient is summed over ``axis`` in the backward."""
        if self.size(axis) == 1 or not (torch.is_grad_enabled() and t.requires_grad):
            return t
        return _ColumnInput.apply(t, self, axis)

    def sum_flat(self, tensors, axis: str):
        """Each of ``tensors`` summed over ``axis``, by one collective on
        their concatenation in f32 (each back in its own dtype)."""
        tensors = list(tensors)
        if self.size(axis) == 1 or not tensors:
            return tensors
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        flat = self._sum(flat, axis)
        return [p.view(t.shape).to(t.dtype)
                for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    def lanes(self, batch: int) -> slice:
        """This rank's lanes of a batch of ``batch``: a contiguous 1 / data of it."""
        if batch % self.data:
            raise ValueError(f"a batch of {batch} does not split over data={self.data}")
        n = batch // self.data
        return slice(self.coords[0] * n, (self.coords[0] + 1) * n)

    def gather_lanes(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's lanes of ``t`` (dim 0), in lane order, on every rank."""
        if self.data == 1:
            return t
        wire = self._wire(t).contiguous()
        parts = [torch.empty_like(wire) for _ in range(self.data)]
        dist.all_gather(parts, wire, group=self.groups[DATA_AXIS])
        return torch.cat(parts).to(t.device)


class _RowSum(torch.autograd.Function):
    """The row-parallel sum (:meth:`Mesh.all_reduce` on a tensor that wants
    a gradient): the sum over the axis forward, the identity backward."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh._sum(t, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _ColumnInput(torch.autograd.Function):
    """The mate (:meth:`Mesh.column_input`): the identity forward, the sum
    over the axis backward."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh._sum(grad, ctx.axis), None, None


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """A ("data", "model") mesh over the initialised world, on the world's
    backend; ``data=None`` takes every rank the model axis leaves.  Every
    rank must call it, in the same order as its other group creations."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised (init_distributed)")
    n, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        if n % model:
            raise ValueError(f"{n} ranks do not split into model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    backend = dist.get_backend()
    groups = {}
    for d in range(data):
        ranks = [d * model + m for m in range(model)]
        g = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            groups[MODEL_AXIS] = g
    for m in range(model):
        ranks = [d * model + m for d in range(data)]
        g = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            groups[DATA_AXIS] = g
    return Mesh(data, model, divmod(rank, model), groups, backend)


def local_shard(path: str, tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``tensor`` under :func:`param_spec` (a copy), or
    ``tensor`` where it is replicated.  The GeGLU projection keeps the
    rank's share of the value rows beside the same share of the gate rows."""
    spec = param_spec(path, tensor)
    if MODEL_AXIS not in spec or mesh.model == 1:
        return tensor
    dim, tp, i = spec.index(MODEL_AXIS), mesh.model, mesh.index(MODEL_AXIS)
    halves = tensor.chunk(2, dim=dim) if _PAIRED.search(path) else (tensor,)
    for h in halves:
        if h.shape[dim] % tp:
            raise ValueError(f"{path}: {h.shape[dim]} rows or columns do not split over "
                             f"model={tp}")
    return torch.cat([h.chunk(tp, dim=dim)[i] for h in halves], dim=dim).clone()


def shard_module_(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep only this rank's slices of ``module``'s tensor-parallel linears
    (in place), and mark each row-parallel one with the mesh its output is
    summed over (a column-parallel one needs no mark: the forward passes
    read the rank's width from its weight).  Int8 holders stay replicated.
    A mesh whose model axis is 1 changes nothing."""
    if mesh.model == 1:
        return module
    for name, mod in module.named_modules():
        w = mod._parameters.get("weight")
        if w is None:
            continue
        prefix = f"{name}." if name else ""
        spec = param_spec(prefix + "weight", w)
        if MODEL_AXIS not in spec:
            continue
        for leaf in ("weight", "bias"):
            p = mod._parameters.get(leaf)
            if p is not None:
                local = local_shard(prefix + leaf, p.detach(), mesh)
                setattr(mod, leaf, nn.Parameter(local, requires_grad=p.requires_grad))
        if spec.index(MODEL_AXIS) == 1:
            mod._sdtk_row_mesh = mesh
    return module


def row_parallel(mod: nn.Module) -> Optional[Mesh]:
    """The mesh of a row-parallel linear (its output needs the all-reduce), else None."""
    return getattr(mod, "_sdtk_row_mesh", None)


def reduce_add(mod: nn.Module, y: torch.Tensor, residual: Optional[torch.Tensor] = None):
    """The row-parallel rule: ``y``, the partial product of ``mod``'s shard
    without its bias, summed over "model", then ``mod``'s bias and
    ``residual`` added once."""
    y = row_parallel(mod).all_reduce(y)
    if mod.bias is not None:
        y = y + mod.bias
    return y if residual is None else y + residual


def shard_params(state: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A ``state_dict``'s tensors as this rank keeps them (JAX
    ``shard_params``): :func:`local_shard` of each, a bias split only where
    its layer's ``weight`` is (an int8 holder's bias stays whole)."""
    out = {}
    for k, v in state.items():
        owner = k[:-len("bias")] + "weight" if k.endswith("bias") else k
        split = owner in state and MODEL_AXIS in param_spec(owner, state[owner])
        out[k] = local_shard(k, v, mesh) if split else v
    return out


def data_sharding(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's lanes of a batch (dim 0) over "data" (JAX ``data_sharding``)."""
    return t[mesh.lanes(t.shape[0])]


def replicate(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A batch split by :func:`data_sharding`, whole again on every rank (JAX ``replicate``)."""
    return mesh.gather_lanes(t)
