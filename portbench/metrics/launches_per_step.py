"""Device operations (kernels, copies, fills) launched a step: those
launched inside the program's ``sd.train_step`` spans over the recorder's
count of them in a training cell, else inside its ``sd.denoise_step`` spans
(a step of the denoise loop; the one-step model's one UNet pass and x0).
What the host launches a step, which bounds a host-paced step's time."""

from portbench.lib import spans

COUNTERS = spans.COUNTERS


def read(view):
    step = "train_step" if spans.calls(view, "train_step") else "denoise_step"
    return spans.launches_per_call(view, step)
