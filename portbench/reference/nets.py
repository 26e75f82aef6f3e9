"""The plain reference networks: the CLIP text towers (ViT-L, and OpenCLIP
ViT-H at its penultimate layer), the SD UNet and the VAE decoder, written in
plain PyTorch in NCHW, in float32, from the published descriptions.

Nothing here imports the program.  Parameters are read by name from a
mapping (:class:`Params`), under the key names of the published diffusers
layout as the benchmark's weight maker writes them, so one seeded state
dict feeds both the program and this reference.  ``Params.recording()``
runs a network on the meta device and lists the names and shapes it reads:
that list is what the weight maker draws.

Every product (linear, convolution, the two attention products) goes
through an :class:`Ops`, which computes it in float32 (``"f32"``), or with
both operands rounded to float8 e4m3 under a per-tensor scale (``"fp8"``,
gradients kept in float32): the lower precision that the benchmark's
control runs.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

SD_LATENT_SCALE = 0.18215
FP8_MAX = 448.0


class Params:
    """Named parameters of one network, read by ``P(name, shape)``.

    Over a mapping it returns the tensor, checking its shape; in recording
    mode (:meth:`recording`) it returns a meta tensor of that shape and
    keeps the shape, so running a network lists its parameters."""

    def __init__(self, tensors: Optional[Mapping[str, torch.Tensor]], prefix: str = "",
                 shapes: Optional[Dict[str, tuple]] = None):
        self.tensors, self.prefix, self.shapes = tensors, prefix, shapes

    @classmethod
    def recording(cls) -> "Params":
        return cls(None, "", {})

    def sub(self, name: str) -> "Params":
        return Params(self.tensors, f"{self.prefix}{name}.", self.shapes)

    def __call__(self, name: str, shape) -> torch.Tensor:
        key, shape = self.prefix + name, tuple(shape)
        if self.tensors is None:
            self.shapes[key] = shape
            return torch.empty(shape, device="meta")
        t = self.tensors[key]
        if tuple(t.shape) != shape:
            raise ValueError(f"{key}: {tuple(t.shape)}, expected {shape}")
        return t


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale (amax -> 448);
    its gradient passes straight through in ``x``'s dtype (a cast's own
    backward would round the gradient to float8 unscaled, flushing it)."""
    if x.device.type == "meta":
        return x
    d = x.detach()
    scale = d.abs().amax().clamp(min=1e-30) / FP8_MAX
    return x + ((d / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale - d)


class f32_products:
    """TF32 off for float32 matrix products and convolutions inside the
    block (the card would otherwise round their inputs to TF32), restored
    after."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


class Ops:
    """The products of the reference, in ``precision`` "f32" or "fp8"."""

    def __init__(self, precision: str = "f32", attn_chunk: int = 1024):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be 'f32' or 'fp8', got {precision!r}")
        self.q = _fp8 if precision == "fp8" else (lambda x: x)
        self.attn_chunk = attn_chunk

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv(self, x, w, b=None, stride: int = 1, padding: int = 1):
        return F.conv2d(self.q(x), self.q(w), b, stride=stride, padding=padding)

    def attention(self, q, k, v, causal: bool = False):
        """(B, H, S, D) softmax(q k^T / sqrt(D)) v, in blocks of query rows."""
        scale = q.shape[-1] ** -0.5
        k, v = self.q(k), self.q(v)
        outs = []
        for s0 in range(0, q.shape[2], self.attn_chunk):
            qc = self.q(q[:, :, s0:s0 + self.attn_chunk])
            logits = torch.matmul(qc, k.transpose(-1, -2)) * scale
            if causal:
                rows = torch.arange(s0, s0 + qc.shape[2], device=q.device)[:, None]
                cols = torch.arange(k.shape[2], device=q.device)[None, :]
                logits = logits.masked_fill(cols > rows, float("-inf"))
            outs.append(torch.matmul(self.q(torch.softmax(logits, dim=-1)), v))
        return torch.cat(outs, dim=2)


# ---------------------------------------------------------------------------
# Shared layers
# ---------------------------------------------------------------------------


def _linear(P: Params, ops: Ops, x, din: int, dout: int, bias: bool = True):
    return ops.linear(x, P("weight", (dout, din)), P("bias", (dout,)) if bias else None)


def _conv(P: Params, ops: Ops, x, cin: int, cout: int, k: int, stride: int = 1):
    return ops.conv(x, P("weight", (cout, cin, k, k)), P("bias", (cout,)), stride=stride,
                    padding=k // 2)


def _group_norm(P: Params, x, c: int, eps: float):
    return F.group_norm(x, 32, P("weight", (c,)), P("bias", (c,)), eps)


def _layer_norm(P: Params, x, c: int, eps: float = 1e-5):
    return F.layer_norm(x, (c,), P("weight", (c,)), P("bias", (c,)), eps)


def _heads(x, h: int):
    b, s, e = x.shape
    return x.reshape(b, s, h, e // h).transpose(1, 2)


def _merge(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _mha(P: Params, ops: Ops, x, ctx, e: int, dctx: int, heads: int, *, qkv_bias: bool,
         causal: bool = False):
    """Multi-head attention with the q/k/v/out projections of ``P``."""
    kv = x if ctx is None else ctx
    q = _linear(P.sub("q_proj"), ops, x, e, e, qkv_bias)
    k = _linear(P.sub("k_proj"), ops, kv, dctx, e, qkv_bias)
    v = _linear(P.sub("v_proj"), ops, kv, dctx, e, qkv_bias)
    o = ops.attention(_heads(q, heads), _heads(k, heads), _heads(v, heads), causal=causal)
    return _linear(P.sub("out_proj"), ops, _merge(o), e, e)


# ---------------------------------------------------------------------------
# Text towers: CLIP ViT-L/14 (SD1.5) and OpenCLIP ViT-H/14 to its
# penultimate layer (SD2.1): token + position embeddings, pre-LN causal
# blocks, the final LayerNorm.
# ---------------------------------------------------------------------------


def text_encoder(P: Params, cfg: Mapping, ids: torch.Tensor, ops: Ops) -> torch.Tensor:
    """(B, 77) token ids -> (B, 77, hidden)."""
    e, hid, heads = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_attention_heads"]
    eps = cfg.get("layer_norm_eps", 1e-5)
    act = ((lambda x: x * torch.sigmoid(1.702 * x)) if cfg["hidden_act"] == "quick_gelu"
           else F.gelu)
    emb = P.sub("embeddings")
    tok = emb.sub("token_embedding")("weight", (cfg["vocab_size"], e))
    pos = emb.sub("position_embedding")("weight", (cfg["max_position_embeddings"], e))
    x = tok[ids] + pos[:ids.shape[1]]
    for i in range(cfg["num_hidden_layers"]):
        L = P.sub(f"encoder.layers.{i}")
        h = _layer_norm(L.sub("layer_norm1"), x, e, eps)
        x = x + _mha(L.sub("self_attn"), ops, h, None, e, e, heads, qkv_bias=True, causal=True)
        h = _layer_norm(L.sub("layer_norm2"), x, e, eps)
        h = act(_linear(L.sub("mlp.fc1"), ops, h, e, hid))
        x = x + _linear(L.sub("mlp.fc2"), ops, h, hid, e)
    return _layer_norm(P.sub("final_layer_norm"), x, e, eps)


# ---------------------------------------------------------------------------
# The UNet (diffusers UNet2DConditionModel of SD1.5 / SD2.1), NCHW
# ---------------------------------------------------------------------------


def _resblock(P: Params, ops: Ops, x, temb, cin: int, cout: int, tdim: int, eps: float):
    h = _conv(P.sub("conv_1"), ops, F.silu(_group_norm(P.sub("groupnorm_1"), x, cin, eps)),
              cin, cout, 3)
    h = h + _linear(P.sub("t_embed"), ops, F.silu(temb), tdim, cout)[:, :, None, None]
    h = _conv(P.sub("conv_2"), ops, F.silu(_group_norm(P.sub("groupnorm_2"), h, cout, eps)),
              cout, cout, 3)
    if cin != cout:
        x = _conv(P.sub("proj_input"), ops, x, cin, cout, 1)
    return h + x


def _transformer(P: Params, ops: Ops, x, ctx, c: int, dctx: int, heads: int):
    b, _, hh, ww = x.shape
    res = x
    h = _conv(P.sub("conv_input"), ops, _group_norm(P.sub("groupnorm"), x, c, 1e-6), c, c, 1)
    t = h.flatten(2).transpose(1, 2)  # (B, HW, C)
    T = P.sub("transformer_block")
    t = t + _mha(T.sub("attn1"), ops, _layer_norm(T.sub("layernorm_1"), t, c), None, c, c, heads,
                 qkv_bias=False)
    t = t + _mha(T.sub("attn2"), ops, _layer_norm(T.sub("layernorm_2"), t, c), ctx, c, dctx,
                 heads, qkv_bias=False)
    value, gate = _linear(T.sub("ffn.0.proj"), ops, _layer_norm(T.sub("layernorm_3"), t, c), c,
                          8 * c).chunk(2, dim=-1)
    t = t + _linear(T.sub("ffn.1"), ops, value * F.gelu(gate), 4 * c, c)
    h = t.transpose(1, 2).reshape(b, c, hh, ww)
    return _conv(P.sub("conv_output"), ops, h, c, c, 1) + res


def _per_stage(v, n: int) -> tuple:
    return tuple([v] * n) if isinstance(v, int) else tuple(v)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) timesteps -> (B, dim): cos then sin of t * 10000^(-i / (dim / 2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    x = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(x), torch.sin(x)], dim=-1)


def unet(P: Params, cfg: Mapping, x: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor,
         ops: Ops) -> torch.Tensor:
    """x (B, 4, h, w) latents, t (B,) timesteps, ctx (B, 77, D) -> the model
    output (B, 4, h, w)."""
    bc = list(cfg["block_out_channels"])
    n, lpb, eps = len(bc), cfg["layers_per_block"], cfg.get("norm_eps", 1e-5)
    heads = _per_stage(cfg["attention_head_dim"], n)  # the port's name: heads a stage
    dctx = _per_stage(cfg["cross_attention_dim"], n)
    attn = tuple(k == "CrossAttnDownBlock2D" for k in cfg["down_block_types"])
    t0 = cfg["t_embed_dim"]
    tdim = 4 * t0
    te = P.sub("time_embedding.ffn")
    temb = _linear(te.sub("2"), ops, F.silu(_linear(te.sub("0"), ops,
                                                    timestep_embedding(t, t0).to(x.dtype), t0,
                                                    tdim)),
                   tdim, tdim)

    def block(B: Params, h, cin, cout, stage):
        h = _resblock(B.sub("0"), ops, h, temb, cin, cout, tdim, eps)
        if attn[stage]:
            h = _transformer(B.sub("1"), ops, h, ctx, cout, dctx[stage], heads[stage])
        return h

    h = _conv(P.sub("encoder.conv_in"), ops, x, cfg["in_channels"], bc[0], 3)
    skips = [h]
    cin = bc[0]
    for i in range(n):
        S = P.sub(f"encoder.down.{i}")
        for j in range(lpb):
            h = block(S.sub(f"block.{j}"), h, cin, bc[i], i)
            cin = bc[i]
            skips.append(h)
        if i != n - 1:
            h = _conv(S.sub("downsample.conv"), ops, h, bc[i], bc[i], 3, stride=2)
            skips.append(h)
    M = P.sub("bottleneck")
    h = _resblock(M.sub("0"), ops, h, temb, bc[-1], bc[-1], tdim, eps)
    h = _transformer(M.sub("1"), ops, h, ctx, bc[-1], dctx[-1], heads[-1])
    h = _resblock(M.sub("2"), ops, h, temb, bc[-1], bc[-1], tdim, eps)
    cin = bc[-1]
    for u, i in enumerate(reversed(range(n))):
        S = P.sub(f"decoder.up.{u}")
        for j in range(lpb + 1):
            skip = skips.pop()
            h = block(S.sub(f"block.{j}"), torch.cat([h, skip], dim=1), cin + skip.shape[1],
                      bc[i], i)
            cin = bc[i]
        if i != 0:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = _conv(S.sub("upsample.conv"), ops, h, bc[i], bc[i], 3)
    h = F.silu(_group_norm(P.sub("output.0"), h, bc[0], eps))
    return _conv(P.sub("output.2"), ops, h, bc[0], cfg["out_channels"], 3)


# ---------------------------------------------------------------------------
# The VAE decoder (diffusers AutoencoderKL's post_quant_conv and decoder)
# ---------------------------------------------------------------------------


def _vae_res(P: Params, ops: Ops, x, cin: int, cout: int, eps: float):
    h = _conv(P.sub("conv1"), ops, F.silu(_group_norm(P.sub("norm1"), x, cin, eps)), cin, cout, 3)
    h = _conv(P.sub("conv2"), ops, F.silu(_group_norm(P.sub("norm2"), h, cout, eps)), cout,
              cout, 3)
    if cin != cout:
        x = _conv(P.sub("conv_shortcut"), ops, x, cin, cout, 1)
    return h + x


def _vae_attention(P: Params, ops: Ops, x, c: int):
    b, _, hh, ww = x.shape
    t = _group_norm(P.sub("group_norm"), x, c, 1e-6).flatten(2).transpose(1, 2)
    q, k, v = (_linear(P.sub(n), ops, t, c, c)[:, None] for n in ("query", "key", "value"))
    o = ops.attention(q, k, v)[:, 0]
    o = _linear(P.sub("proj_attn"), ops, o, c, c)
    return o.transpose(1, 2).reshape(b, c, hh, ww) + x


def vae_decode(P: Params, cfg: Mapping, z: torch.Tensor, ops: Ops) -> torch.Tensor:
    """(B, 4, h, w) scaled latents -> (B, 3, 8h, 8w) images in about [-1, 1]."""
    ch, mult, zc = cfg["base_channels"], list(cfg["ch_mult"]), cfg["latent_channels"]
    eps = cfg.get("norm_eps", 1e-6)
    top = ch * mult[-1]
    z = _conv(P.sub("post_quant_conv"), ops, z / SD_LATENT_SCALE, zc, zc, 1)
    D = P.sub("decoder")
    h = _conv(D.sub("conv_in"), ops, z, zc, top, 3)
    M = D.sub("mid_block")
    h = _vae_res(M.sub("resnets.0"), ops, h, top, top, eps)
    h = _vae_attention(M.sub("attentions.0"), ops, h, top)
    h = _vae_res(M.sub("resnets.1"), ops, h, top, top, eps)
    cin = top
    for u, i in enumerate(reversed(range(len(mult)))):
        U = D.sub(f"up_blocks.{u}")
        cout = ch * mult[i]
        for j in range(3):
            h = _vae_res(U.sub(f"resnets.{j}"), ops, h, cin, cout, eps)
            cin = cout
        if i != 0:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = _conv(U.sub("upsamplers.0.conv"), ops, h, cout, cout, 3)
    h = F.silu(_group_norm(D.sub("conv_norm_out"), h, ch, eps))
    return _conv(D.sub("conv_out"), ops, h, ch, cfg["out_channels"], 3)


def param_shapes(cfg: Mapping) -> Dict[str, Dict[str, tuple]]:
    """{"unet" | "text_encoder" | "vae": {name: shape}}: the parameters the
    three networks read, listed by running them on the meta device."""
    ops = Ops()
    out = {}
    P = Params.recording()
    ids = torch.zeros((1, 77), dtype=torch.long, device="meta")
    text_encoder(P, cfg["text"], ids, ops)
    out["text_encoder"] = P.shapes
    P = Params.recording()
    u = cfg["unet"]
    dctx = _per_stage(u["cross_attention_dim"], len(u["block_out_channels"]))[0]
    unet(P, u, torch.empty((1, u["in_channels"], 8, 8), device="meta"),
         torch.zeros((1,), dtype=torch.long, device="meta"),
         torch.empty((1, 77, dctx), device="meta"), ops)
    out["unet"] = P.shapes
    P = Params.recording()
    vae_decode(P, cfg["vae"], torch.empty((1, cfg["vae"]["latent_channels"], 8, 8),
                                          device="meta"), ops)
    out["vae"] = P.shapes
    return out
