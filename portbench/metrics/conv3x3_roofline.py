"""K2's share of its roofline: the least time of the 3x3 convolutions K2's
launch counter recorded (``work.conv3x3_work``) over the device time of
K2's kernels."""

from portbench.lib import readers, work

COUNTERS = {"K2": "stable_diffusion_tpu_torch.ops.conv:K2"}
KERNELS = ("conv3x3_kernel", "conv3x3_reduce")


def read(view):
    return readers.roofline(view, "K2", KERNELS, work.conv3x3_work)
