"""A module's pass replayed as a CUDA graph: one launch for the ~1000 of
the hand-written kernels' Python wrappers and ctypes calls.

:class:`GraphCache` keeps the graphs of one module (:func:`cache`),
keyed by the call's signature (the inputs' shapes, strides, dtypes and
devices, and what the caller adds: ``impl``, the kernel switches) at the
module's present weights (every parameter and buffer: its address and
``_version``; a weight changed in place, replaced or re-laid drops every
graph).  The first call at a signature and weights runs eagerly, which
warms up what a capture must find ready (the kernel library, each
function's attributes, the tensors :func:`~utils.device.cached` derives,
the workspaces grown to size), returns that pass's output, and then
captures the pass into a memory pool private to the module's graphs; each
later call replays: its inputs copied into the graph's, one launch, the
output cloned, so no caller holds a tensor the next replay overwrites.  At
most :data:`MAX_GRAPHS` signatures keep a graph, the least recent evicted.

A call engages only where what it can observe allows: the caller's part
(:func:`replays`: a CUDA input, the kernels' ``impl``, no recomputation,
no capture already running), then the module's (:meth:`GraphCache.engages`:
autograd would record nothing, and no module is a tensor-parallel shard,
whose all-reduce stays eager).  Every other call runs eagerly, unchanged.

A replay runs no Python, so it counts what the capture's wrappers would
have: each ``LaunchCounter`` gets the launches and shape keys the capture
gathered (:class:`~utils.device.GraphCapture`), so N replays leave every
counter as N eager passes do.  The graph holds the cached tensors and the
workspaces it was captured with, so a later eager call that grows a
workspace or refreshes a cache frees none of them.
"""

from __future__ import annotations

import collections
import functools
import itertools
import operator
import weakref
from typing import Callable, Sequence

import torch
from torch import nn

from stable_diffusion_tpu_torch.parallel.mesh import row_parallel
from stable_diffusion_tpu_torch.utils import device
from stable_diffusion_tpu_torch.utils.device import span

MAX_GRAPHS = 4
_IS_TENSOR = functools.partial(operator.is_not, None)
_VERSION = operator.attrgetter("_version")

_TREE = [0]       # bumped at every module, parameter or buffer registration in the process
_HOOKED = []      # the global registration hooks, once
CACHES = weakref.WeakKeyDictionary()  # module -> its GraphCache


def _registered(*_) -> None:
    _TREE[0] += 1


def _hook_registrations() -> None:
    """Count module-tree changes (a holder swapped in by the quantizer, a
    shard's new parameters) with torch's global registration hooks, so the
    module list is walked again only after one."""
    if not _HOOKED:
        from torch.nn.modules import module as M

        _HOOKED.extend(reg(_registered) for reg in (
            M.register_module_module_registration_hook,
            M.register_module_parameter_registration_hook,
            M.register_module_buffer_registration_hook))


def replays(x: torch.Tensor, impl: str, checkpointing: bool) -> bool:
    """The caller's part of the rule: ``x`` on a CUDA device, ``impl``
    resolving to the hand-written kernels there, no recomputation in a
    backward, and no capture of the current stream already running (an
    outer capture records the eager launches)."""
    return (x.is_cuda and impl in ("cuda", "auto") and not checkpointing
            and not torch.cuda.is_current_stream_capturing())


def cache(module: nn.Module, span_name: str) -> "GraphCache":
    """``module``'s graphs (:data:`CACHES`), made at its first call that
    may replay; they die with the module (a ``copy.deepcopy`` of it starts
    with none)."""
    c = CACHES.get(module)
    if c is None:
        c = CACHES[module] = GraphCache(span_name)
    return c


class _Graph:
    """One captured pass: the graph, its input and output tensors, the
    launch counts to credit at each replay, and what it reads outside its pool."""

    __slots__ = ("graph", "inputs", "output", "credits", "held")

    def __init__(self, graph, inputs, output, credits, held):
        self.graph, self.inputs, self.output = graph, inputs, output
        self.credits, self.held = credits, held


def _credits(launches) -> list:
    """[(counter, launches, Counter of shape keys)] of a capture's gathered launches."""
    by = {}
    for counter, key in launches:
        by.setdefault(counter, collections.Counter())[key] += 1
    return [(c, sum(keys.values()), keys) for c, keys in by.items()]


class GraphCache:
    """The CUDA graphs of one module's pass (see the module docstring);
    each replay opens the span ``span_name``."""

    def __init__(self, span_name: str):
        _hook_registrations()
        self.span_name = span_name
        self.graphs = collections.OrderedDict()   # signature -> _Graph, least recent first
        self.weights = []                         # the tensors the graphs were captured at (held)
        self.stamp = None                         # their versions and addresses
        self.pool = None
        self._tree = -1
        self._dicts = ()   # the non-empty parameter and buffer dicts of the module list
        self._sharded = False

    # -- what the call observes ------------------------------------------

    def tensors(self, module: nn.Module) -> list:
        """Every parameter and buffer of ``module`` and its children, in a
        fixed order (the module list is walked again after any registration)."""
        if self._tree != _TREE[0]:
            modules = tuple(module.modules())
            self._dicts = tuple(d for m in modules for d in (m._parameters, m._buffers) if d)
            self._sharded = any(row_parallel(m) is not None for m in modules)
            self._tree = _TREE[0]
        return list(filter(_IS_TENSOR, itertools.chain.from_iterable(map(dict.values,
                                                                         self._dicts))))

    def engages(self, tensors: list, inputs: Sequence[torch.Tensor]) -> bool:
        """The module's part of the rule, on its :meth:`tensors`: autograd
        would record nothing (grad off, or no input, parameter or buffer
        requires it) and no module is a row-parallel shard
        (``parallel/mesh.py``)."""
        return not (self._sharded or (torch.is_grad_enabled() and any(
            t.requires_grad for t in (*inputs, *tensors))))

    @staticmethod
    def stamp_of(tensors: list) -> tuple:
        """The weights' versions and addresses: equal to the held weights'
        exactly when each tensor is the held one's storage (held, so no
        address can be reused meanwhile) unchanged since."""
        return list(map(_VERSION, tensors)), list(map(torch.Tensor.data_ptr, tensors))

    @staticmethod
    def signature(inputs: Sequence[torch.Tensor], extra=()) -> tuple:
        return (tuple((tuple(t.shape), t.stride(), t.dtype, t.device) for t in inputs), extra)

    # -- the call ----------------------------------------------------------

    def __call__(self, module: nn.Module, run: Callable, inputs: Sequence[torch.Tensor],
                 extra=()):
        """``run(*inputs)``, eagerly or from a graph of it (see the module
        docstring); the caller has checked :func:`replays`, and the inputs
        are tensors on one CUDA device."""
        tensors = self.tensors(module)
        if not self.engages(tensors, inputs):
            return run(*inputs)
        stamp = self.stamp_of(tensors)
        if stamp != self.stamp:  # new weights: a graph may read stale cached tensors
            self.graphs.clear()
            self.pool = None
            self.weights, self.stamp = tensors, stamp
        sig = self.signature(inputs, extra)
        g = self.graphs.get(sig)
        if g is None:  # warm up, then capture
            out = run(*inputs)
            self.graphs[sig] = self._capture(run, inputs)
            while len(self.graphs) > MAX_GRAPHS:
                self.graphs.popitem(last=False)
            return out
        self.graphs.move_to_end(sig)
        return self._replay(g, inputs)

    def _capture(self, run: Callable, inputs: Sequence[torch.Tensor]) -> _Graph:
        """Capture ``run`` on copies of ``inputs`` into the module's pool."""
        static = [torch.empty_like(t).copy_(t) for t in inputs]
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(static[0].device), device.graph_capture() as gathered:
            with torch.cuda.graph(graph, pool=self.pool):
                out = run(*static)
        return _Graph(graph, static, out, _credits(gathered.launches), gathered.tensors_read())

    def _replay(self, g: _Graph, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        with span(self.span_name):
            for s, t in zip(g.inputs, inputs):
                s.copy_(t)
            g.graph.replay()
            for counter, n, keys in g.credits:
                counter.credit(n, keys)
            return g.output.clone()
