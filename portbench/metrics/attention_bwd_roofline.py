"""K5 and K6's share of the roofline of the self-attention gradient they
compute together: the least time of the gradients K5's launch counter
recorded (``work.attention_bwd_work``) over the device time of K5's and
K6's kernels."""

from portbench.lib import readers, work

COUNTERS = {"K5": "stable_diffusion_tpu_torch.ops.flash_attention:K5"}
KERNELS = ("bwd_dq_kernel", "bwd_dq_ring", "bwd_dkv_kernel", "bwd_dkv_ring")


def read(view):
    return readers.roofline(view, "K5", KERNELS, work.attention_bwd_work)
