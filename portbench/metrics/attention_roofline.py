"""K3's share of its roofline, over all its bodies: the least time of the
attentions K3's launch counter recorded (``work.attention_work``, the
exponentials on the SFUs included) over the device time of K3's kernels."""

from portbench.lib import readers, work

COUNTERS = {"K3": "stable_diffusion_tpu_torch.ops.flash_attention:K3"}
KERNELS = ("attention_kernel", "attention_merge_kernel")


def read(view):
    return readers.roofline(view, "K3", KERNELS, work.attention_work)
