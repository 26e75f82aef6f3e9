"""The ``impl`` switch and the launch counters every kernel wrapper keeps."""

from __future__ import annotations

import collections

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


def require(cond: bool, what: str) -> None:
    """Raise ValueError(what) unless ``cond``: the kernels' shape checks."""
    if not cond:
        raise ValueError(what)


class LaunchCounter:
    """A kernel's launch count.

    ``launches`` is a plain integer that the kernel's wrapper raises by one
    each time it launches the kernel, and nowhere else.  While ``shapes`` is
    a Counter (see :meth:`record`), each launch also counts its shape key, so
    a run can list the shapes it gave the kernel.
    """

    def __init__(self):
        self.launches = 0
        self.shapes = None

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
