"""Device milliseconds of one VAE decode: the kernels launched inside the
benchmark's ``vae_decode`` range."""

from portbench.lib import readers


def read(view):
    return readers.range_ms(view, "vae_decode")
