"""K4's share of its roofline: the least time of the LN -> GeGLU FFNs that
K4's launch counter recorded (:func:`ffn_work`) over the device time of
K4's kernels (G1, G2 and G2's split-K reduce)."""

from portbench.lib import readers

COUNTERS = {"K4": "stable_diffusion_tpu_torch.ops.ffn:K4"}
KERNELS = ("ffn_up_kernel", "ffn_down_kernel", "ffn_reduce_kernel")


def ffn_work(key) -> dict:
    """K4's key (m, c) or (m, c, hidden) (hidden 4C when absent): m rows of
    LN(x) W1^T (2H values and gates) -> GeGLU -> W2^T, 2 m C 2H + 2 m H C
    FLOP; x, W1, b1, W2, b2 read and y written once, in bf16.  The
    residual and the LayerNorm's affine are left out (the key does not say
    whether a call had a residual), so the least time is never overstated."""
    m, c = key[:2]
    h = key[2] if len(key) > 2 else 4 * c
    return dict(flops=2 * m * c * 2 * h + 2 * m * h * c,
                nbytes=2 * (m * c + 2 * h * c + 2 * h + c * h + c + m * c))


def read(view):
    return readers.roofline(view, "K4", KERNELS, ffn_work)
