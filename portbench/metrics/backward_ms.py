"""Device milliseconds of the backward a micro-step: the union of the
device operations launched inside the program's ``sd.backward`` spans
(``torch.autograd.grad`` of the loss, K5/K6 and the recomputed plain VJPs
included) over the recorder's count of them."""

from portbench.lib import spans

COUNTERS = spans.COUNTERS


def read(view):
    return spans.device_ms_per_call(view, "backward")
