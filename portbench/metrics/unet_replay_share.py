"""Percent of the UNet's calls in the traced window that replayed a
captured CUDA graph: the recorder's count of the program's
``sd.unet_replay`` span (opened around each replay, inside ``sd.unet``)
over its count of ``sd.unet``.  A program without the span, or one that
replayed nothing, reads nothing."""

from portbench.lib import spans

COUNTERS = spans.COUNTERS


def read(view):
    calls = spans.calls(view, "unet")
    if not calls or not spans.ranges(view.trace, "unet_replay"):
        return None
    return 100.0 * spans.calls(view, "unet_replay") / calls
