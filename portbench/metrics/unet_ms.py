"""Device milliseconds of one UNet call (one step at the cell's batch, CFG's
doubled where it applies): the kernels launched inside the benchmark's
``unet`` range."""

from portbench.lib import readers


def read(view):
    return readers.range_ms(view, "unet")
