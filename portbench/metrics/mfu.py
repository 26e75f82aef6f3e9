"""The whole step's share of the bf16 peak: the model FLOPs (counted on the
meta device over the reference: a request's text tower, UNet at every step
with CFG's doubled batch, and decode; a micro-step's forward and backward
to the LoRA leaves) of the untraced pass that precedes the traced window,
over its host-clock seconds (a request's only while it was served) and
989 TFLOP/s."""

from portbench.lib import readers


def read(view):
    return readers.mfu(view)
