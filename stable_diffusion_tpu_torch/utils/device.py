"""The ``impl`` switch, the launch counters every kernel wrapper keeps, the
spans that name the port's work on the profiler's clock, and the cache of
the tensors a wrapper derives from its weights."""

from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Callable, Sequence

import torch

IMPLS = ("torch", "cuda", "auto")


def use_kernel(impl: str, x: torch.Tensor) -> bool:
    """True when ``x`` should go through a hand-written kernel.

    ``"torch"`` never does; ``"cuda"`` always does and raises for a tensor
    that is not on a CUDA device; ``"auto"`` does exactly when ``x`` is on
    one.  Nothing here falls back: a wrapper that gets True launches its
    kernel or raises.
    """
    if impl == "torch":
        return False
    if impl == "cuda":
        if not x.is_cuda:
            raise ValueError(f"impl='cuda' needs a CUDA tensor, got one on {x.device}")
        return True
    if impl == "auto":
        return x.is_cuda
    raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or as it is when wider (f64 in the gradient checks):
    the plain versions' statistics and softmaxes run in this."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def require(cond: bool, what: str) -> None:
    """Raise ValueError(what) unless ``cond``: the kernels' shape checks."""
    if not cond:
        raise ValueError(what)


def wants_grad(*tensors) -> bool:
    """True when autograd would record an operation on any of ``tensors``."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def require_no_grad(kernel: str, *tensors) -> None:
    """A raw kernel wrapper writes into ``torch.empty`` through ctypes, so its
    output has no ``grad_fn``: raise rather than return a result that would
    silently cut the graph.  The entry points wrap the kernel in its
    ``torch.autograd.Function`` where a gradient is wanted."""
    if wants_grad(*tensors):
        raise RuntimeError(f"{kernel}: the raw kernel carries no gradient; call its entry point, "
                           "which wraps it in an autograd Function, or run under torch.no_grad()")


def require_inference(what: str, *tensors) -> None:
    """The W8A8 forms are inference-only (JAX ``_q_raise_bwd``): raise
    rather than differentiate through the int8 round/clip quantizer."""
    if wants_grad(*tensors):
        raise NotImplementedError(
            f"{what} is inference-only: gradients through the int8 round/clip quantizer would be "
            "silently wrong; train in bf16 and quantize afterwards (utils/quantize_model)")


class SpanRecorder:
    """The switch of the port's spans, with :class:`LaunchCounter`'s
    contract: :meth:`record` turns them on, :meth:`stop_recording` turns
    them off and returns each span's calls in between (a Counter by name,
    without the ``sd.`` prefix).  Off unless something records them."""

    def __init__(self):
        self.calls = None

    def record(self) -> None:
        """Turn spans on (their counts cleared)."""
        self.calls = collections.Counter()

    def stop_recording(self) -> collections.Counter:
        calls, self.calls = self.calls, None
        return calls


SPANS = SpanRecorder()
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range ``sd.<name>`` around the
    block while :data:`SPANS` records, counted there; else one shared null
    context, so an unrecorded span costs an attribute test.

    The spans: ``denoise_step`` (one step of the denoise loop, or the one
    UNet pass and x0 of the one-step model), ``unet`` (a UNet pass),
    ``transformer`` (one transformer stack of the UNet), ``add_embed``
    (SDXL's pooled and size conditioning), ``sampler`` (CFG combine,
    inpaint blend, step noise, the sampler's step), ``text`` (the text
    tower, both of SDXL's), ``vae_decode``, ``to_host`` (the
    images' finite check, rounding and copy to the host), ``train_step``
    (one micro-step), ``lora_merge``, ``backward``, ``optimizer`` (the
    update, its application and the EMA) and ``K1``..``K12`` (a
    hand-written kernel's wrapper, from its checks to the launch's return).
    Spans opened by autograd's backward run on its engine's thread."""
    calls = SPANS.calls
    if calls is None:
        return _OFF
    calls[name] += 1
    return torch.profiler.record_function("sd." + name)


class LaunchCounter:
    """A kernel's launch count.

    ``launches`` is a plain integer that the kernel's wrapper raises by one
    each time it launches the kernel, and nowhere else.  While ``shapes`` is
    a Counter (see :meth:`record`), each launch also counts its shape key, so
    a run can list the shapes it gave the kernel.  :meth:`span` is the
    wrapper's span, named as the counter.
    """

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.shapes = None

    def span(self):
        return span(self.name)

    def launched(self, key) -> None:
        self.launches += 1
        if self.shapes is not None:
            self.shapes[key] += 1

    def reset(self) -> None:
        self.launches = 0

    def record(self) -> None:
        """Start counting launches per shape key (cleared on each call)."""
        self.shapes = collections.Counter()

    def stop_recording(self) -> collections.Counter:
        shapes, self.shapes = self.shapes, None
        return shapes


def cached(owner, attr: str, tensors: Sequence[torch.Tensor], make: Callable):
    """``make()``, kept in ``owner.__dict__[attr]`` until one of ``tensors``
    is replaced or changed in place (a weight re-laid for a kernel, a
    concatenation, folded scales).  The cache refers to the tensors weakly:
    a freed tensor's address cannot alias a new one, and a cache kept on a
    tensor it was made from forms no reference cycle, so it is freed with
    the tensor (the LoRA merge makes new weights every step)."""
    key = [(t._version, t.data_ptr()) for t in tensors]
    hit = owner.__dict__.get(attr)
    if (hit is not None and len(hit[0]) == len(tensors)
            and all(r() is t for r, t in zip(hit[0], tensors)) and hit[1] == key):
        return hit[2]
    value = make()
    owner.__dict__[attr] = ([weakref.ref(t) for t in tensors], key, value)
    return value
