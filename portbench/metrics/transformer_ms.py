"""Device milliseconds of one UNet call spent in its transformer stacks:
the union of the device operations launched inside the program's
``sd.transformer`` spans (each stack: its GroupNorm and projections, K3,
K4 and the attention projections of every block) over the recorder's count
of ``sd.unet``.  A program without the span reads nothing."""

from portbench.lib import spans
from portbench.lib.trace import union_length

COUNTERS = spans.COUNTERS


def read(view):
    calls = spans.calls(view, "unet")
    if not calls or not spans.ranges(view.trace, "transformer"):
        return None
    busy = union_length((k[1], k[2]) for k in spans.launched_in(view.trace, "transformer"))
    return busy / 1e3 / calls if busy > 0 else None
