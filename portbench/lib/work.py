"""The yardstick of the per-layer metrics: the H100's published peaks, the
least time of a piece of work (the roofline), the work of each kernel's
operation from the shape keys its launch counter records, and the model
FLOPs of a callable counted by ``FlopCounterMode`` on the meta device.

The work of an operation is counted from its shapes, never from what a
kernel does: each input byte read once, each output byte written once."""

from __future__ import annotations

from typing import Callable

import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# one exponential a logit on the special-function units: 16 ex2 a clock per
# SM (CUDA C++ Programming Guide, throughput at compute capability 9.0)
EX2_PER_CLOCK_PER_SM = 16


def exp_rate(sms: int, max_sm_clock_mhz: float) -> float:
    return EX2_PER_CLOCK_PER_SM * sms * max_sm_clock_mhz * 1e6


def bound_s(flops: float, nbytes: float, flop_rate: float = BF16_FLOPS, exps: float = 0.0,
            exps_per_s: float = 0.0) -> float:
    """The least time of the work: the larger of its bytes over HBM
    bandwidth, its FLOPs over the peak and its exponentials over the SFUs."""
    t_exp = exps / exps_per_s if exps and exps_per_s else 0.0
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_rate, t_exp)


def conv3x3_work(key) -> dict:
    """K2's key (b, h, w, cin, cout, prologue): a bf16 SAME 3x3 conv, with
    the GroupNorm scale/shift of each image read when the prologue is on."""
    b, h, w, cin, cout, prologue = key
    px = b * h * w
    return dict(flops=2 * px * cin * cout * 9,
                nbytes=2 * (px * (cin + cout) + 9 * cin * cout + cout)
                + (b * 2 * cin * 4 if prologue else 0))


def attention_work(key) -> dict:
    """K3's key (b, sq, sk, h, d): softmax(q k^T) v in bf16, one exponential
    a logit."""
    b, sq, sk, h, d = key
    return dict(flops=4 * b * h * sq * sk * d, nbytes=2 * b * h * d * (2 * sq + 2 * sk),
                exps=b * h * sq * sk)


def attention_bwd_work(key) -> dict:
    """K5's key (b, s, h, d): the whole self-attention gradient that K5 and K6
    compute together: 10 B H S^2 D FLOP (the logits again, dV, dP, dQ,
    dK); q, k, v, o and dO read and dq, dk, dv written once."""
    b, s, h, d = key
    nbhsd = b * h * s * d
    return dict(flops=10 * nbhsd * s, nbytes=2 * 8 * nbhsd)


def model_flops(fn: Callable[[], object]) -> float:
    """The FLOPs that ``fn`` (run on meta tensors) counts under
    ``torch.utils.flop_counter.FlopCounterMode``, backward included when
    ``fn`` runs one."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def meta_randn(*shape) -> torch.Tensor:
    return torch.empty(shape, device="meta")
