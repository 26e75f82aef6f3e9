"""The transformer's GeGLU feed-forward block: kernel K4 (CUDA) beside its
plain version.

K4 (csrc/ffn.cu) replaces stable_diffusion_tpu/ops/ffn.py's bf16
``_make_kernel`` (``_ffn_call`` via ``geglu_ffn`` -> ``_ln_ffn_res``): LN ->
x W1 split into value and gate halves -> (hv + bv) * gelu_erf(hg + bg) ->
W2 -> +b2 -> +residual.  It runs as two ``wgmma`` GEMMs: G1 (LN prologue,
GeGLU epilogue) writes the bf16 (M, H) GeGLU output, G2 (+b2 +residual
epilogue, split-K where its tiles leave SMs idle) reads it back; the note at
the top of the source says what bounds it and why.  :func:`ffn_plan`
mirrors the C dispatch; the CPU tests hold it and an emulation of both
GEMMs' schedules.

Weights are in PyTorch's layout: W1 (2H, C) with the value rows first and
the gate rows second, W2 (C, H); G1's loads pair each 32 value rows with
the 32 gate rows of the same hidden units.  The hidden width H is 4C in a
whole model (the default) and 4C / tp on a rank of a tensor-parallel mesh
(parallel/mesh.py keeps matching value and gate halves there); K4 takes any
H % 64 == 0.  The gradient is the VJP of the plain
version, recomputed (JAX ``_ln_ffn_res_bwd``).

K9 (csrc/ffn_q.cu) is the static-W8A8 form, replacing ffn.py's int8
``_make_q_kernel`` (``_ffn_q``): LN -> quantize with the first linear's
act_scale -> int8 value and gate products -> dequantize -> GeGLU in f32 ->
requantize with the second linear's act_scale -> int8 W2 product ->
dequantize, +b2, +residual.  It runs as K4's two GEMMs in s8 behind K8's
quantize launch: the LN'd rows' codes and G1's int8 GeGLU output live in a
per-device scratch; :func:`ffn_q_plan` mirrors the C dispatch.  The plain
version follows JAX ``_ffn_q_xla`` (the layer path: the LN and each
linear's output cast to the input dtype); K9 keeps the LN output and the
GeGLU intermediate in f32 as the TPU kernel does, so in f32 the two are one
function.  Inference only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from stable_diffusion_tpu_torch.ops import _cuda
from stable_diffusion_tpu_torch.ops._autograd import Recompute
from stable_diffusion_tpu_torch.ops.linear import layer_norm_plain, matmul_w8a8_plain
from stable_diffusion_tpu_torch.ops.quantize import folded_scales
from stable_diffusion_tpu_torch.utils.device import (LaunchCounter, at_least_f32, require,
                                                     require_inference, require_no_grad, use_kernel,
                                                     wants_grad, workspace_table)

K4 = LaunchCounter("K4")
K9 = LaunchCounter("K9")


def geglu_ffn_plain(x, ln_weight, ln_bias, w1, b1, w2, b2, residual=None, *, eps: float = 1e-5,
                    hidden: int = None):
    """LN -> GeGLU -> W2 (+residual), as the JAX layer path: f32 LN stats, the
    gelu taken in f32 and cast back (``_ffn_xla``).  W1 (2H, C), W2 (C, H):
    ``hidden`` H (4C when None) is checked against them."""
    c = x.shape[-1]
    hidden = 4 * c if hidden is None else hidden
    require(tuple(w1.shape) == (2 * hidden, c) and tuple(w2.shape) == (c, hidden),
            f"GeGLU FFN at hidden {hidden}: W1 {tuple(w1.shape)}, W2 {tuple(w2.shape)}, expected "
            f"{(2 * hidden, c)} and {(c, hidden)}")
    h = F.linear(layer_norm_plain(x, ln_weight, ln_bias, eps), w1, b1)
    value, gate = h.chunk(2, dim=-1)
    h = value * F.gelu(at_least_f32(gate)).to(x.dtype)
    out = F.linear(h, w2, b2)
    return out if residual is None else out + residual


# K4's compiled variants (csrc/ffn.cu SDTK_FFN_UP_VARIANTS / _DN_VARIANTS):
# G1 (rows a block, ring stages, asynchronous products), G2 (rows a block,
# columns a block, ring stages, asynchronous products).  A G1 block tile is
# 128 W1 rows, 32 values then their 32 gates twice (64 hidden units); a G2
# block has a warpgroup per 64 rows.
FFN_KC = 64            # channels a K step
FFN_G1_VARIANTS = ((128, 2, 0), (128, 4, 1), (64, 4, 1))
FFN_G2_VARIANTS = ((64, 160, 3, 0), (64, 128, 4, 0), (64, 64, 6, 0))
FFN_MAX_C = 1280
SMEM_BLOCK = 232448    # shared bytes a block may use on an H100
SMEM_SM = 233472       # an SM's shared memory (228 KB)
FFN_MAX_KSPLIT = 16


class FfnPlan(NamedTuple):
    """K4's launch at (m, c, hidden): G1 variant ``g1`` = (rows a block, stages,
    async), its N tiles split over ``nsplit1`` blocks a row block; G2
    variant ``g2`` = (rows, columns, stages, async), its K split over
    ``ksplit2`` blocks (f32 partials, reduced in split order).  ``smem1``,
    ``smem2``: each kernel's dynamic shared bytes."""
    g1: tuple
    nsplit1: int
    g2: tuple
    ksplit2: int
    smem1: int
    smem2: int

    @property
    def bm1(self) -> int:
        return self.g1[0]

    @property
    def bm2(self) -> int:
        return self.g2[0]

    @property
    def bn2(self) -> int:
        return self.g2[1]

    def grid1(self, m: int):
        return -(-m // self.bm1), self.nsplit1

    def grid2(self, m: int, c: int):
        """(column blocks, row blocks, splits): the launch grid."""
        return -(-c // self.bn2), -(-m // self.bm2), self.ksplit2


def _up_smem(bm: int, stages: int, c: int) -> int:
    """1024 bytes to align the ring, ``stages`` slabs of 128 W1 rows x 64
    channels, the block's rows of x (64-channel chunks, C padded)."""
    return 1024 + (stages * 128 + bm * -(-c // FFN_KC)) * FFN_KC * 2


def _dn_smem(bm: int, bn: int, stages: int) -> int:
    return 1024 + stages * (bm + bn) * FFN_KC * 2


@functools.lru_cache(maxsize=None)
def ffn_plan(m: int, c: int, sms: int = 132, g1: tuple = None, g2: tuple = None,
             hidden: int = None) -> FfnPlan:
    """K4's launch for an (m, c) call at hidden width ``hidden`` (4C when
    None; a multiple of 64) on a card of ``sms`` SMs, as csrc/ffn.cu's entry
    takes it (``g1`` / ``g2`` name a variant to measure instead of the
    planner's).

    G1: 128 rows a block; a two-slab ring, synchronous products and two
    blocks an SM where that fits shared memory (C <= 320), else a
    four-slab ring with products kept in flight across steps, in 64-row
    blocks where 128 rows do not fit (C = 1280).  Its H / 64 N tiles are
    split over ``nsplit1`` blocks a row block, the count that finishes in
    the fewest waves x (tiles a block + 1, the block's own rows of x being
    about one tile's loads), the fewest splits on a tie.  G2: 64 rows a
    block, two blocks an SM; 160 columns where C % 160 == 0, else 128
    where C % 128 == 0, else 64; where its tiles fill at most half the
    SMs, its K = H is split into ceil(sms / tiles) parts (at least four
    64-channel steps each, at most 16).  The variants are the ones the H100 sweep
    (chip_smoke.py --k4-sweep) found fastest per pass."""
    require(c % 16 == 0 and 16 <= c <= FFN_MAX_C and m >= 1,
            f"K4 takes C % 16 == 0 and C <= {FFN_MAX_C}, got C={c}")
    hidden = 4 * c if hidden is None else hidden
    require(hidden >= 64 and hidden % 64 == 0,
            f"K4 takes a hidden width that is a multiple of 64, got {hidden}")
    if g1 is None:
        g1 = ((128, 2, 0) if _up_smem(128, 2, c) + 1024 <= SMEM_SM // 2
              else (128, 4, 1) if _up_smem(128, 4, c) <= SMEM_BLOCK else (64, 4, 1))
    require(g1 in FFN_G1_VARIANTS and _up_smem(*g1[:2], c) <= SMEM_BLOCK,
            f"K4: G1 variant {g1} does not fit C={c}")
    smem1 = _up_smem(*g1[:2], c)
    resident1 = max(1, min(2 if g1[1] == 2 else 1, SMEM_SM // (smem1 + 1024)))
    ntiles, mb = hidden // 64, -(-m // g1[0])
    best = None
    for ns in range(1, ntiles + 1):
        cost = -(-mb * ns // (sms * resident1)) * (-(-ntiles // ns) + 1)
        if best is None or cost < best[0]:
            best = (cost, ns)
    if g2 is None:
        g2 = next(v for v in FFN_G2_VARIANTS if c % v[1] == 0 or v[1] == 64)
    require(g2 in FFN_G2_VARIANTS, f"K4: no G2 variant {g2}")
    tiles2 = -(-m // g2[0]) * -(-c // g2[1])
    ksplit2 = 1
    if 2 * tiles2 <= sms:
        ksplit2 = max(1, min(-(-sms // tiles2), hidden // 64 // 4, FFN_MAX_KSPLIT))
    return FfnPlan(g1, best[1], g2, ksplit2, smem1, _dn_smem(*g2[:3]))


_SCRATCH = workspace_table()  # device index -> uint8 scratch: G1's output h, G2's split-K partials


def _scratch(x: torch.Tensor, nbytes: int) -> int:
    """The pointer of at least ``nbytes`` of scratch on ``x``'s device,
    reused call after call (calls on one stream are ordered, so two streams
    must not run K4 on one device at once)."""
    buf = _SCRATCH.get(x.get_device())
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1 << 20), device=x.device, dtype=torch.uint8)
        _SCRATCH[x.get_device()] = buf
    return buf.data_ptr()


def _check(x, ln_weight, ln_bias, w1, b1, w2, b2, residual, hidden):
    """The shape rules; returns (m, c)."""
    c = x.shape[-1]
    params = (ln_weight, ln_bias, w1, b1, w2, b2) + (() if residual is None else (residual,))
    shapes = ((c,), (c,), (2 * hidden, c), (2 * hidden,), (c, hidden), (c,), x.shape)
    require(hidden >= 64 and hidden % 64 == 0,
            f"K4 takes a hidden width that is a multiple of 64, got {hidden}")
    if not (x.is_cuda and c % 16 == 0 and c <= FFN_MAX_C
            and all(t.shape == s for t, s in zip(params, shapes))
            and all(t.dtype == torch.bfloat16 and t.is_contiguous() and t.data_ptr() % 16 == 0
                    for t in (x, *params))):
        require(x.is_cuda, f"K4 needs a CUDA tensor, got {x.device}")
        require(c % 16 == 0 and c <= FFN_MAX_C,
                f"K4 takes C % 16 == 0 and C <= {FFN_MAX_C}, got C={c}")
        for t, want in zip(params, shapes):
            require(tuple(t.shape) == tuple(want),
                    f"K4: parameter or residual {tuple(t.shape)}, expected {tuple(want)}")
        raise ValueError("K4 takes contiguous, 16-byte aligned bf16 tensors")
    return x.numel() // c, c


def geglu_ffn_kernel(x, ln_weight, ln_bias, w1, b1, w2, b2, residual=None, *, eps: float = 1e-5,
                     hidden: int = None, _plan: FfnPlan = None, _parts: int = 3):
    """Launch K4.  x (..., C) bf16 on CUDA; every parameter bf16 and
    contiguous; W1 (2H, C), W2 (C, H) at ``hidden`` H (4C when None; a
    multiple of 64).  It allocates only its output: the GeGLU output h and
    split-K partials live in a per-device scratch.  For measuring: ``_plan``
    runs another plan; ``_parts`` 1 launches G1 alone, 2 G2 alone (on
    whatever h the scratch holds, so its output means nothing)."""
    with K4.span():
        require_no_grad("K4", x, ln_weight, ln_bias, w1, b1, w2, b2, residual)
        hidden = 4 * x.shape[-1] if hidden is None else hidden
        m, c = _check(x, ln_weight, ln_bias, w1, b1, w2, b2, residual, hidden)
        plan = _plan or ffn_plan(m, c, _cuda.sm_count(x.get_device()), hidden=hidden)
        h_bytes = -(-m * hidden * 2 // 256) * 256
        h = _scratch(x, h_bytes + (plan.ksplit2 * m * c * 4 if plan.ksplit2 > 1 else 0))
        out = torch.empty_like(x)
        _cuda.check(_cuda.call_packed(
            _cuda.library().sdtk_ffn, x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            None if residual is None else residual.data_ptr(), h,
            h + h_bytes if plan.ksplit2 > 1 else None, out.data_ptr(), m, c, hidden, *plan.g1,
            plan.nsplit1, *plan.g2, plan.ksplit2, _parts, _cuda.f32_bits(eps),
            _cuda.stream_handle(x)), "K4 ffn")
        K4.launched((m, c) if hidden == 4 * c else (m, c, hidden))
        return out


def ffn_occupancy(c: int = 320) -> dict:
    """Each compiled K4 variant on the current card: ``{("G1", *variant) |
    ("G2", *variant): {...}}`` with registers a thread, spill (local) bytes
    a thread, shared bytes a block (G1's for width ``c``; variants that do
    not fit it left out) and resident blocks an SM, from the runtime."""
    keys = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm")
    out = {}
    for bm, st, asy in FFN_G1_VARIANTS:
        if _up_smem(bm, st, c) <= SMEM_BLOCK:
            got = (ctypes.c_int * 4)()
            _cuda.check(_cuda.library().sdtk_ffn_attrs(0, bm, 0, st, asy, c, got), "K4 attributes")
            out[("G1", bm, st, asy)] = dict(zip(keys, got))
    for bm, bn, st, asy in FFN_G2_VARIANTS:
        got = (ctypes.c_int * 4)()
        _cuda.check(_cuda.library().sdtk_ffn_attrs(1, bm, bn, st, asy, c, got), "K4 attributes")
        out[("G2", bm, bn, st, asy)] = dict(zip(keys, got))
    return out


def geglu_ffn(x, ln_weight, ln_bias, w1, b1, w2, b2, residual=None, *, eps: float = 1e-5,
              hidden: int = None, impl: str = "auto"):
    """LN -> GeGLU FFN (-> +residual): K4 on the card, the plain version on
    the CPU.  ``hidden``: the width H of W1 (2H, C) and W2 (C, H), 4C when
    None (a rank's shard of a tensor-parallel FFN holds 4C / tp)."""
    args = (x, ln_weight, ln_bias, w1, b1, w2, b2, residual)
    plain = functools.partial(geglu_ffn_plain, eps=eps, hidden=hidden)
    if not use_kernel(impl, x):
        return plain(*args)
    fwd = functools.partial(geglu_ffn_kernel, eps=eps, hidden=hidden)
    if wants_grad(*args):
        return Recompute.apply(fwd, plain, *args)
    return fwd(*args)


# ---------------------------------------------------------------------------
# Static W8A8: K9
# ---------------------------------------------------------------------------


def geglu_ffn_w8a8_plain(x, ln_weight, ln_bias, w1_q, w1_scale, b1, act1, w2_q, w2_scale, b2, act2,
                         residual=None, *, eps: float = 1e-5):
    """(LN ->) W8A8 GeGLU FFN (-> +residual), JAX ``_ffn_q_xla``: W1 (2H, C)
    int8 value rows then gate rows, W2 (C, H) int8; act1 / act2 the two
    linears' calibrated input absmax."""
    h = x if ln_weight is None else layer_norm_plain(x, ln_weight, ln_bias, eps)
    h = matmul_w8a8_plain(h, w1_q, w1_scale, act1, b1)
    value, gate = h.chunk(2, dim=-1)
    h = value * F.gelu(at_least_f32(gate)).to(x.dtype)
    out = matmul_w8a8_plain(h, w2_q, w2_scale, act2, b2)
    return out if residual is None else out + residual


# K9's compiled variants (csrc/ffn_q.cu SDTK_FFN_Q_UP_VARIANTS /
# _DN_VARIANTS): G1 (rows a block, ring stages, blocks an SM for the launch
# bound), a tile 128 W1 rows (32 values then their 32 gates, twice: 64
# hidden units); G2 (rows a block, columns a block, ring stages).
FFN_Q_KC = 128          # K bytes a step: one 128-byte row of int8
FFN_Q_G1_VARIANTS = ((128, 3, 2),)
FFN_Q_G2_VARIANTS = ((128, 160, 4), (64, 64, 4))
FFN_Q_MAX_C = 1280


class FfnQPlan(NamedTuple):
    """K9's launch at (m, c, hidden): G1 variant ``g1`` = (rows a block,
    stages, blocks an SM), its hidden tiles split over ``nsplit1`` blocks a
    row block; G2 variant ``g2`` = (rows, columns, stages), one tile a block
    over all of the hidden width.  ``smem1``, ``smem2``: each GEMM's dynamic
    shared bytes."""
    g1: tuple
    nsplit1: int
    g2: tuple
    smem1: int
    smem2: int

    def grid1(self, m: int):
        """(row blocks, hidden splits): G1's launch grid."""
        return -(-m // self.g1[0]), self.nsplit1

    def grid2(self, m: int, c: int):
        """(column blocks, row blocks): G2's launch grid."""
        return -(-c // self.g2[1]), -(-m // self.g2[0])


def g1_smem(bm: int, stages: int, c: int) -> int:
    """1024 bytes to align the ring, ``stages`` slabs of 128 W1 rows x 128
    bytes, the block's int8 rows of all of C (128-byte chunks), three tiles'
    os1 (f32) and b1 (bf16) for their epilogues."""
    return 1024 + stages * 128 * FFN_Q_KC + bm * -(-c // FFN_Q_KC) * FFN_Q_KC + 3 * 128 * 6


def g2_smem(bm: int, bn: int, stages: int) -> int:
    """1024 bytes to align the ring, ``stages`` steps of bm rows of h and bn
    rows of W2, 128 bytes each."""
    return 1024 + stages * (bm + bn) * FFN_Q_KC


@functools.lru_cache(maxsize=None)
def ffn_q_plan(m: int, c: int, hidden: int, sms: int = 132, g2: tuple = None) -> FfnQPlan:
    """K9's launch for an (m, c, hidden) call on a card of ``sms`` SMs, as
    csrc/ffn_q.cu's entry takes it (``g2`` names another G2 variant, for
    measuring).

    G1: 128 rows a block and a three-slab ring (two blocks an SM where
    shared memory allows, C = 320); its H / 64 tiles split over
    ``nsplit1`` blocks a row block, the count that finishes in the fewest
    waves x (tiles a block + the block's own rows, about one tile's loads),
    the fewest splits on a tie (K4's G1 rule).  G2: 128 x 160 tiles where
    their blocks reach half the SMs (M >= 2048 at C = 1280), else 64 x 64.
    The H100 sweep (chip_smoke.py --w8a8-sweep) found these the fastest at
    the four path shapes."""
    require(c % 32 == 0 and c <= FFN_Q_MAX_C and hidden % 64 == 0 and m >= 1,
            f"K9 takes C % 32 == 0, C <= {FFN_Q_MAX_C} and a hidden width % 64 == 0, "
            f"got C={c}, H={hidden}")
    g1 = FFN_Q_G1_VARIANTS[0]
    smem1 = g1_smem(*g1[:2], c)
    resident = max(1, min(g1[2], SMEM_SM // (smem1 + 1024)))
    ntiles, mb = hidden // 64, -(-m // g1[0])
    best = None
    for ns in range(1, ntiles + 1):
        cost = -(-mb * ns // (sms * resident)) * (-(-ntiles // ns) + 1)
        if best is None or cost < best[0]:
            best = (cost, ns)
    if g2 is None:
        g2 = next((v for v in FFN_Q_G2_VARIANTS if 2 * -(-m // v[0]) * -(-c // v[1]) >= sms),
                  FFN_Q_G2_VARIANTS[-1])
    require(g2 in FFN_Q_G2_VARIANTS, f"K9: no G2 variant {g2}")
    return FfnQPlan(g1, best[1], g2, smem1, g2_smem(*g2))


_Q_SCRATCH = workspace_table()  # device index -> int8 scratch: the LN'd rows' codes, then G1's codes


def _q_scratch(x: torch.Tensor, nbytes: int) -> int:
    """The pointer of at least ``nbytes`` of scratch on ``x``'s device,
    reused call after call (calls on one stream are ordered, so two streams
    must not run K9 on one device at once)."""
    buf = _Q_SCRATCH.get(x.get_device())
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1 << 20), device=x.device, dtype=torch.uint8)
        _Q_SCRATCH[x.get_device()] = buf
    return buf.data_ptr()


def _h_offset(m: int, c: int) -> int:
    """Byte offset of G1's int8 (M, H) codes in the scratch, after the x codes."""
    return -(-m * c // 256) * 256


def k9_codes(x: torch.Tensor, hidden: int):
    """(x codes (M, C), h codes (M, H)): what K9's two quantize points wrote
    for ``x`` (..., C), as views of the scratch (for tests: valid until the
    next K9 call)."""
    c = x.shape[-1]
    m = x.numel() // c
    buf = _Q_SCRATCH[x.get_device()].view(torch.int8)
    off = _h_offset(m, c)
    return buf[:m * c].view(m, c), buf[off:off + m * hidden].view(m, hidden)


def _k9_refuse(x, ln_weight, ln_bias, w1_q, s1, out_scale1, b1, w2_q, s2, out_scale2, b2,
               residual):
    """Raise the ValueError that names what K9 does not take (its shape
    rules, checked in one expression on the launch path)."""
    require(x.is_cuda, f"K9 needs a CUDA tensor, got {x.device}")
    c = x.shape[-1]
    hidden = w2_q.shape[-1]
    require(c % 32 == 0 and c <= FFN_Q_MAX_C and hidden % 64 == 0,
            f"K9 takes C % 32 == 0, C <= {FFN_Q_MAX_C} and a hidden width % 64 == 0, "
            f"got C={c}, H={hidden}")
    require(w1_q.shape == (2 * hidden, c) and w2_q.shape == (c, hidden)
            and all(t.dtype == torch.int8 and t.is_contiguous() for t in (w1_q, w2_q)),
            f"K9: w1_q {tuple(w1_q.shape)} / w2_q {tuple(w2_q.shape)} for C={c}, H={hidden}")
    for t, n in ((s1, 1), (out_scale1, 2 * hidden), (s2, 1), (out_scale2, c)):
        require(t.shape == (n,) and t.dtype == torch.float32 and t.is_contiguous(),
                "K9: the folded scales must be contiguous f32")
    bf = [x, b1, b2] + [t for t in (ln_weight, ln_bias, residual) if t is not None]
    require(all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in bf),
            "K9 takes contiguous bf16 activations, biases, residual and LN affine")
    require(b1.shape == (2 * hidden,) and b2.shape == (c,), "K9: bias shapes")
    require((ln_weight is None) == (ln_bias is None)
            and (ln_weight is None or ln_weight.shape == ln_bias.shape == (c,)),
            "K9: LN weight and bias must both be (C,) or both None")
    require(residual is None or residual.shape == x.shape, "K9: residual shape differs from x")
    raise ValueError("K9 needs 16-byte aligned tensors")


def geglu_ffn_w8a8_kernel(x, ln_weight, ln_bias, w1_q, s1, out_scale1, b1, w2_q, s2, out_scale2, b2,
                          residual=None, *, eps: float = 1e-5, _plan: FfnQPlan = None,
                          _parts: int = 7):
    """Launch K9.  x (..., C) bf16 contiguous on CUDA; w1_q (2H, C) and w2_q
    (C, H) int8; (s1, out_scale1) and (s2, out_scale2) the two linears'
    ``folded_scales``; b1 (2H,), b2 (C,), the LN affine (C,) and the
    residual bf16.  For measuring: ``_plan`` runs another plan; ``_parts``
    (1 the quantize, 2 G1, 4 G2, summed) launches a subset, on whatever the
    scratch holds."""
    with K9.span():
        require_no_grad("K9", x, ln_weight, ln_bias, b1, b2, residual)
        c = x.shape[-1]
        hidden = w2_q.shape[-1]
        f32 = (s1, out_scale1, s2, out_scale2)
        bf = [t for t in (x, b1, b2, ln_weight, ln_bias, residual) if t is not None]
        if not (x.is_cuda and c % 32 == 0 and c <= FFN_Q_MAX_C and hidden % 64 == 0
                and w1_q.shape == (2 * hidden, c) and w2_q.shape == (c, hidden)
                and w1_q.dtype == w2_q.dtype == torch.int8
                and w1_q.is_contiguous() and w2_q.is_contiguous()
                and s1.shape == s2.shape == (1,) and out_scale1.shape == (2 * hidden,)
                and out_scale2.shape == (c,)
                and all(t.dtype == torch.float32 and t.is_contiguous() for t in f32)
                and all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in bf)
                and b1.shape == (2 * hidden,) and b2.shape == (c,)
                and (ln_weight is None) == (ln_bias is None)
                and (ln_weight is None or ln_weight.shape == ln_bias.shape == (c,))
                and (residual is None or residual.shape == x.shape)
                and x.data_ptr() % 16 == 0 and w1_q.data_ptr() % 16 == 0
                and w2_q.data_ptr() % 16 == 0):
            _k9_refuse(x, ln_weight, ln_bias, w1_q, s1, out_scale1, b1, w2_q, s2, out_scale2, b2,
                       residual)
        m = x.numel() // c
        plan = _plan or ffn_q_plan(m, c, hidden, _cuda.sm_count(x.get_device()))
        off = _h_offset(m, c)
        xq = _q_scratch(x, off + m * hidden)
        out = torch.empty_like(x)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        _cuda.check(_cuda.call_packed(
            _cuda.library().sdtk_ffn_q, x.data_ptr(), ptr(ln_weight), ptr(ln_bias), w1_q.data_ptr(),
            s1.data_ptr(), out_scale1.data_ptr(), b1.data_ptr(), w2_q.data_ptr(), s2.data_ptr(),
            out_scale2.data_ptr(), b2.data_ptr(), ptr(residual), out.data_ptr(), xq, xq + off,
            m, c, hidden, *plan.g1, plan.nsplit1, *plan.g2, _parts, _cuda.f32_bits(eps),
            _cuda.stream_handle(x)), "K9 ffn_q")
        K9.launched((m, c, hidden, ln_weight is not None, residual is not None))
        return out


def ffn_q_occupancy(c: int = 320) -> dict:
    """Each compiled K9 variant on the current card: ``{("G1", *variant) |
    ("G2", *variant): {...}}`` (G1's shared bytes for width ``c``, variants
    that do not fit it left out) with registers a thread, spill (local)
    bytes a thread, shared bytes a block and resident blocks an SM, from the
    runtime."""
    keys = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm")
    out = {}
    for bm, st, mb in FFN_Q_G1_VARIANTS:
        if g1_smem(bm, st, c) <= SMEM_BLOCK:
            got = (ctypes.c_int * 4)()
            _cuda.check(_cuda.library().sdtk_ffn_q_attrs(0, bm, 0, st, mb, c, got), "K9 attributes")
            out[("G1", bm, st, mb)] = dict(zip(keys, got))
    for bm, bn, st in FFN_Q_G2_VARIANTS:
        got = (ctypes.c_int * 4)()
        _cuda.check(_cuda.library().sdtk_ffn_q_attrs(1, bm, bn, st, 0, c, got), "K9 attributes")
        out[("G2", bm, bn, st)] = dict(zip(keys, got))
    return out


def geglu_ffn_w8a8(x, ln_weight, ln_bias, w1_q, w1_scale, b1, act1, w2_q, w2_scale, b2, act2,
                   residual=None, *, eps: float = 1e-5, impl: str = "auto"):
    """(LN ->) static-W8A8 GeGLU FFN (-> +residual): K9 on the card, the
    plain version on the CPU.  Inference only."""
    require_inference("W8A8 GeGLU FFN", x, ln_weight, ln_bias, w1_scale, b1, act1, w2_scale, b2,
                      act2, residual)
    if not use_kernel(impl, x):
        return geglu_ffn_w8a8_plain(x, ln_weight, ln_bias, w1_q, w1_scale, b1, act1, w2_q,
                                    w2_scale, b2, act2, residual, eps=eps)
    s1, os1 = folded_scales(w1_scale, act1)
    s2, os2 = folded_scales(w2_scale, act2)
    return geglu_ffn_w8a8_kernel(x, ln_weight, ln_bias, w1_q, s1, os1, b1, w2_q, s2, os2, b2,
                                 residual, eps=eps)
