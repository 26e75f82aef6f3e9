"""Config-driven UNet denoiser (port of stable_diffusion_tpu/models/unet.py
``unet_apply``).

NHWC activations; submodule names follow the JAX key paths
(``encoder.down.{i}.block.{j}.{0,1}``, ``bottleneck.{0,1,2}``,
``decoder.up.{u}``, ``output.{0,2}``).  On the card every GroupNorm+SiLU+3x3
conv runs as K1 stats + K2, every non-causal attention as K3, every
feed-forward block as K4; the 1x1 convs, projections, stride-2 convs,
conv_in/conv_out and the time embedding are plain matmuls and convs, as
JAX leaves them to XLA.  The switches of the JAX package reach the same
sites: with SD_TPU_FUSED_MM on, the resblock 1x1 shortcut + residual, the
transformer's ``conv_output`` + residual and the attention pre-LN
projections run K10, the transformer's GroupNorm -> ``conv_input`` K11;
with SD_TPU_WINOGRAD=1 the routed 3x3 convs run K12 (ops/winograd.py).

SDXL base (``UNetConfig.sdxl``; no JAX counterpart): a transformer of
``transformer_layers_per_block`` blocks at each attention site of a stage,
the bottleneck at the last stage's depth, and the text-time conditioning
(``add_embedding`` on the pooled text state and six size numbers) added to
the time embedding in :meth:`UNet.time_embedding_apply`, the one place
every pass takes its ``t_embed`` from.

DeepCache (JAX ``unet_shallow_encoder``, ``unet_deep``,
``unet_shallow_decoder``, ``unet_apply_split``, ``unet_apply_cached``):
the body is written once, as three parts cut where JAX cuts it, and
``forward`` is their composition.  :meth:`UNet.shallow_encoder` is
``conv_in`` and stage 0 (its skips and the downsampled ``down0``),
:meth:`UNet.deep` stages 1..n-1, the bottleneck and every decoder stage
but the last (the feature entering the last stage, ``block_out_channels[1]``
channels at the latent resolution), :meth:`UNet.shallow_decoder` the last
decoder stage and the output head.  :meth:`UNet.forward_cached` runs the
two shallow parts around a held deep feature: every layer it reaches is a
layer of the full pass at the same shape, so it launches a subset of the
full pass's kernel shapes.

Quantized (utils/quantize_model.py): the call sites hand the int8 holders
to the layers, so a calibrated UNet runs every W8A8 linear (attention
projections, ``t_embed``, the time embedding) through K8, every W8A8 FFN
through K9 and every W8A8 resblock conv through K1 stats + K7; weight-only
holders run dequantized through the bf16 kernels, and the 1x1 convs stay
bf16 in both packages.

``gradient_checkpointing`` recomputes each resblock+transformer unit in the
backward (JAX ``_block_apply(remat=True)``, ``jax.checkpoint``) through
``torch.utils.checkpoint``.  The unit's parameters go to the checkpointed
function as explicit inputs, so a recompute after a
``torch.func.functional_call`` (the LoRA merge) sees the merged tensors.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Union

import torch
import torch.utils.checkpoint
from torch import nn

from stable_diffusion_tpu_torch.models import layers
from stable_diffusion_tpu_torch.models.attention import MultiheadAttention, multihead_attention
from stable_diffusion_tpu_torch.ops.ffn import geglu_ffn, geglu_ffn_w8a8
from stable_diffusion_tpu_torch.ops.groupnorm import group_norm_silu
from stable_diffusion_tpu_torch.ops.linear import gn_matmul, matmul_residual
from stable_diffusion_tpu_torch.parallel.mesh import reduce_add, row_parallel
from stable_diffusion_tpu_torch.utils import graphs
from stable_diffusion_tpu_torch.utils.device import cached, span


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    attention_head_dim: Union[int, tuple] = (5, 10, 20, 20)
    num_attention_heads: Optional[Union[int, tuple]] = None
    cross_attention_dim: Union[int, tuple] = 1024
    down_block_types: tuple = ("CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                               "CrossAttnDownBlock2D", "DownBlock2D")
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    t_embed_dim: int = 320
    # transformer blocks in each attention site of a stage (SDXL: 1, 2, 10;
    # the bottleneck takes the last stage's)
    transformer_layers_per_block: Union[int, tuple] = 1
    # SDXL's added conditioning: "text_time" adds to the time embedding an
    # MLP of the pooled text state beside the six size numbers' sinusoids
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: Optional[int] = None

    @classmethod
    def from_dict(cls, data: dict) -> "UNetConfig":
        """A unet config.json (lists become tuples; unknown keys dropped)."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in data.items()
                      if k in known})

    @classmethod
    def sd15(cls) -> "UNetConfig":
        return cls(attention_head_dim=8, cross_attention_dim=768)

    @classmethod
    def sd21(cls) -> "UNetConfig":
        """SD2.1: heads (5, 10, 20, 20) of d=64, cross dim 1024 (the defaults)."""
        return cls()

    @classmethod
    def sdxl(cls) -> "UNetConfig":
        """SDXL base 1.0: three stages, no attention at the first, transformer
        depths (1, 2, 10), heads of d=64, cross dim 2048, the text-time
        conditioning (pooled 1280 + 6 x 256 sinusoids = 2816)."""
        return cls(block_out_channels=(320, 640, 1280), attention_head_dim=(5, 10, 20),
                   cross_attention_dim=2048,
                   down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                                     "CrossAttnDownBlock2D"),
                   transformer_layers_per_block=(1, 2, 10), addition_embed_type="text_time",
                   addition_time_embed_dim=256, projection_class_embeddings_input_dim=2816)

    @property
    def num_stages(self) -> int:
        return len(self.block_out_channels)

    @property
    def heads_per_stage(self) -> tuple:
        h = self.num_attention_heads if self.num_attention_heads is not None else self.attention_head_dim
        return tuple([h] * self.num_stages) if isinstance(h, int) else tuple(h)

    @property
    def cross_dim_per_stage(self) -> tuple:
        c = self.cross_attention_dim
        return tuple([c] * self.num_stages) if isinstance(c, int) else tuple(c)

    @property
    def depth_per_stage(self) -> tuple:
        d = self.transformer_layers_per_block
        return tuple([d] * self.num_stages) if isinstance(d, int) else tuple(d)

    @property
    def stage_has_attention(self) -> tuple:
        return tuple(t == "CrossAttnDownBlock2D" for t in self.down_block_types)

    @property
    def time_embed_dim(self) -> int:
        return self.t_embed_dim * 4


# ---------------------------------------------------------------------------
# Parameter modules
# ---------------------------------------------------------------------------


def _conv(cin, cout, k):
    return nn.Conv2d(cin, cout, k, padding=k // 2)


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, t_dim: int, groups: int):
        super().__init__()
        self.groupnorm_1 = nn.GroupNorm(groups, in_ch)
        self.conv_1 = _conv(in_ch, out_ch, 3)
        self.t_embed = nn.Linear(t_dim, out_ch)
        self.groupnorm_2 = nn.GroupNorm(groups, out_ch)
        self.conv_2 = _conv(out_ch, out_ch, 3)
        if in_ch != out_ch:
            self.proj_input = _conv(in_ch, out_ch, 1)


class TransformerBlock(nn.Module):
    def __init__(self, ch: int, cond_dim: int):
        super().__init__()
        self.layernorm_1 = nn.LayerNorm(ch)
        self.attn1 = MultiheadAttention(ch, qkv_bias=False)
        self.layernorm_2 = nn.LayerNorm(ch)
        self.attn2 = MultiheadAttention(ch, cond_dim=cond_dim, qkv_bias=False)
        self.layernorm_3 = nn.LayerNorm(ch)
        self.ffn = nn.ModuleDict({"0": layers.GEGLU(ch, 4 * ch), "1": nn.Linear(4 * ch, ch)})


class Transformer(nn.Module):
    """GroupNorm -> ``conv_input`` -> ``depth`` transformer blocks ->
    ``conv_output``; one block is held as ``transformer_block`` (the JAX key
    path), a deeper stack as ``transformer_blocks.{k}``."""

    def __init__(self, ch: int, cond_dim: int, groups: int, depth: int = 1):
        super().__init__()
        self.groupnorm = nn.GroupNorm(groups, ch)
        self.conv_input = _conv(ch, ch, 1)
        if depth == 1:
            self.transformer_block = TransformerBlock(ch, cond_dim)
        else:
            self.transformer_blocks = nn.ModuleDict({str(k): TransformerBlock(ch, cond_dim)
                                                     for k in range(depth)})
        self.conv_output = _conv(ch, ch, 1)

    def blocks(self) -> tuple:
        """The stack's transformer blocks in order."""
        stack = self._modules.get("transformer_blocks")
        return (self.transformer_block,) if stack is None else tuple(stack.values())


class _Block(nn.ModuleDict):
    """One resblock (``"0"``) and optional transformer (``"1"``) unit."""

    def forward(self, x, t_embed, cond, *, num_heads: int, eps: float, impl: str):
        x = resblock_apply(self["0"], x, t_embed, eps=eps, impl=impl)
        if "1" in self:
            x = transformer_apply(self["1"], x, cond, num_heads=num_heads, impl=impl)
        return x


class _Conv(nn.Module):
    """Holder for a key path ending in ``.conv``."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = _conv(cin, cout, 3)


class _Stage(nn.Module):
    def __init__(self, blocks: dict, resample: Optional[str], ch: int):
        super().__init__()
        self.block = nn.ModuleDict(blocks)
        if resample is not None:
            setattr(self, resample, _Conv(ch, ch))


class _Encoder(nn.Module):
    def __init__(self, conv_in: nn.Module, down: dict):
        super().__init__()
        self.conv_in = conv_in
        self.down = nn.ModuleDict(down)


class _Decoder(nn.Module):
    def __init__(self, up: dict):
        super().__init__()
        self.up = nn.ModuleDict(up)


class _TimeEmbedding(nn.Module):
    def __init__(self, t_in: int, t_dim: int):
        super().__init__()
        self.ffn = nn.ModuleDict({"0": nn.Linear(t_in, t_dim), "2": nn.Linear(t_dim, t_dim)})


class _AddEmbedding(nn.Module):
    """SDXL's ``add_embedding``: linear_1 -> SiLU -> linear_2 (diffusers' key paths)."""

    def __init__(self, d_in: int, t_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(d_in, t_dim)
        self.linear_2 = nn.Linear(t_dim, t_dim)


def sinusoid(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(N,) values -> (N, dim) f32: cos then sin of t * 10000^(-i / (dim / 2))
    (diffusers' ``flip_sin_to_cos``, frequency shift 0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    x = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(x), torch.sin(x)], dim=-1)


def resblock_apply(p: ResBlock, x, t_embed, *, eps: float, impl: str):
    h = layers.gn_silu_conv3x3(p.groupnorm_1, p.conv_1, x, eps=eps, impl=impl)
    h = h + layers.linear(p.t_embed, layers.silu(t_embed), impl=impl)[:, None, None, :]
    h = layers.gn_silu_conv3x3(p.groupnorm_2, p.conv_2, h, eps=eps, impl=impl)
    if hasattr(p, "proj_input"):
        b, hh, ww, ci = x.shape
        co = h.shape[-1]
        y = matmul_residual(x.reshape(b, hh * ww, ci), p.proj_input.weight[:, :, 0, 0],
                            p.proj_input.bias, h.reshape(b, hh * ww, co), impl=impl)
        return y.reshape(h.shape)
    return h + x


def ffn_apply(ln: nn.LayerNorm, ffn: nn.ModuleDict, x, *, impl: str):
    """LN -> GeGLU FFN -> +x (JAX ``ops/ffn.geglu_ffn`` on parameter dicts):
    K9 for W8A8 linears, K4 for bf16 or weight-only ones (dequantized), and
    the layer path while a calibration capture records the linears.  A
    tensor-parallel shard (parallel/mesh.py: the rank's value and gate
    halves of the projection, the matching columns of ``ffn.1``) runs K4 at
    the rank's hidden width without b2 or the residual, sums over "model",
    then adds both once; K4's input and its LayerNorm's weight and bias
    carry the sum's mate (``Mesh.column_input``), the residual does not."""
    p0, p1 = ffn["0"].proj, ffn["1"]
    mesh = row_parallel(p1)
    if mesh is not None and not layers.capturing("linear"):
        zero = cached(p1, "_tp_zero_b2", [p1.bias], lambda: torch.zeros_like(p1.bias))
        mate = mesh.column_input
        y = geglu_ffn(mate(x), mate(ln.weight), mate(ln.bias), p0.weight, p0.bias, p1.weight,
                      zero, hidden=p1.weight.shape[1], impl=impl)
        return reduce_add(p1, y, x)
    if layers.capturing("linear"):
        h = layers.geglu(ffn["0"], layers.layer_norm(ln, x), impl=impl)
        return layers.linear(p1, h, impl=impl) + x
    if isinstance(p0, layers.QLinear) and p0.w8a8:
        return geglu_ffn_w8a8(x, ln.weight, ln.bias, p0.weight_q, p0.weight_scale, p0.bias,
                              p0.act_scale, p1.weight_q, p1.weight_scale, p1.bias, p1.act_scale,
                              residual=x, impl=impl)
    w = [p.dequantized(x.dtype) if isinstance(p, layers.QLinear) else p.weight for p in (p0, p1)]
    return geglu_ffn(x, ln.weight, ln.bias, w[0], p0.bias, w[1], p1.bias, residual=x, impl=impl)


def transformer_apply(p: Transformer, x, cond, *, num_heads: int, impl: str):
    with span("transformer"):
        b, hh, ww, c = x.shape
        res = x
        x = gn_matmul(x, p.groupnorm.weight, p.groupnorm.bias, p.conv_input.weight[:, :, 0, 0],
                      p.conv_input.bias, eps=1e-6, impl=impl).reshape(b, hh * ww, c)
        for tb in p.blocks():
            x = multihead_attention(tb.attn1, x, num_heads=num_heads, impl=impl,
                                    ln=tb.layernorm_1, residual=x)
            x = multihead_attention(tb.attn2, x, num_heads=num_heads, cond=cond, impl=impl,
                                    ln=tb.layernorm_2, residual=x)
            x = ffn_apply(tb.layernorm_3, tb.ffn, x, impl=impl)
        x = matmul_residual(x, p.conv_output.weight[:, :, 0, 0], p.conv_output.bias,
                            res.reshape(b, hh * ww, c), impl=impl)
        return x.reshape(b, hh, ww, c)


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        bc = list(cfg.block_out_channels)
        n = cfg.num_stages
        cross = cfg.cross_dim_per_stage
        depth = cfg.depth_per_stage
        has_attn = cfg.stage_has_attention
        t_dim = cfg.time_embed_dim
        g = cfg.norm_num_groups

        def block(in_ch, out_ch, stage):
            m = {"0": ResBlock(in_ch, out_ch, t_dim, g)}
            if has_attn[stage]:
                m["1"] = Transformer(out_ch, cross[stage], g, depth[stage])
            return _Block(m)

        block_in = [bc[0]] + bc
        down = {}
        for i in range(n):
            blocks = {str(j): block(block_in[i] if j == 0 else bc[i], bc[i], i)
                      for j in range(cfg.layers_per_block)}
            down[str(i)] = _Stage(blocks, "downsample" if i != n - 1 else None, bc[i])
        self.time_embedding = _TimeEmbedding(cfg.t_embed_dim, t_dim)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = _AddEmbedding(cfg.projection_class_embeddings_input_dim, t_dim)
        elif cfg.addition_embed_type is not None:
            raise ValueError(f"addition_embed_type {cfg.addition_embed_type!r} is not supported "
                             "(only SDXL's 'text_time')")
        self.encoder = _Encoder(_conv(cfg.in_channels, bc[0], 3), down)
        mid = bc[-1]
        self.bottleneck = nn.ModuleDict({
            "0": ResBlock(mid, mid, t_dim, g),
            "1": Transformer(mid, cross[-1], g, depth[-1]),
            "2": ResBlock(mid, mid, t_dim, g),
        })
        dec_in = bc + [bc[-1]]
        up = {}
        for u, i in enumerate(reversed(range(n))):
            out_ch = bc[i]
            mid_in = dec_in[i - 1] if i > 0 else bc[0]
            ins = [dec_in[i + 1] + out_ch, out_ch + out_ch, out_ch + mid_in]
            blocks = {str(j): block(ins[j], out_ch, i) for j in range(cfg.layers_per_block + 1)}
            up[str(u)] = _Stage(blocks, "upsample" if i != 0 else None, out_ch)
        self.decoder = _Decoder(up)
        self.output = nn.ModuleDict({"0": nn.GroupNorm(g, bc[0]),
                                     "2": _conv(bc[0], cfg.out_channels, 3)})

    # -- forward ------------------------------------------------------------

    def time_embedding_apply(self, timestep: torch.Tensor, dtype, impl: str = "auto",
                             added_cond: Optional[dict] = None) -> torch.Tensor:
        """(B,) int timesteps -> (B, 4*t_embed_dim); cos-then-sin sinusoid.
        A UNet with SDXL's text-time conditioning adds to it
        ``add_embedding`` of [text_embeds, the sinusoids of the six
        time_ids] from ``added_cond`` (``{"text_embeds": (B, P),
        "time_ids": (B, 6)}``), which it requires; any other UNet refuses it."""
        t = sinusoid(timestep, self.cfg.t_embed_dim).to(dtype)
        ffn = self.time_embedding.ffn
        emb = layers.linear(ffn["2"], layers.silu(layers.linear(ffn["0"], t, impl=impl)),
                            impl=impl)
        add = self._modules.get("add_embedding")
        if (add is None) != (added_cond is None):
            raise ValueError("added_cond ({'text_embeds', 'time_ids'}) is required by a UNet with "
                             "addition_embed_type 'text_time' and refused by any other")
        if add is None:
            return emb
        with span("add_embed"):
            ids = added_cond["time_ids"]
            times = sinusoid(ids.reshape(-1), self.cfg.addition_time_embed_dim)
            a = torch.cat([added_cond["text_embeds"].to(dtype),
                           times.reshape(ids.shape[0], -1).to(dtype)], dim=-1)
            a = layers.linear(add.linear_2, layers.silu(layers.linear(add.linear_1, a, impl=impl)),
                              impl=impl)
            return emb + a

    def _block(self, p: _Block, x, t_embed, cond, num_heads, impl, remat):
        kw = dict(num_heads=num_heads, eps=self.cfg.norm_eps, impl=impl)
        if not (remat and torch.is_grad_enabled()):
            return p(x, t_embed, cond, **kw)
        names, tensors = zip(*p.named_parameters())

        def run(x, t_embed, cond, *tensors):
            return torch.func.functional_call(p, dict(zip(names, tensors)), (x, t_embed, cond), kw)

        return torch.utils.checkpoint.checkpoint(run, x, t_embed, cond, *tensors,
                                                 use_reentrant=False)

    def shallow_encoder(self, x, t_embed, cond, *, impl: str = "auto",
                        gradient_checkpointing: bool = False):
        """``conv_in`` + stage 0 -> (stage-0 skips [conv_in, b0, b1], down0)."""
        cfg = self.cfg
        h = layers.conv2d(self.encoder.conv_in, x)
        skips = [h]
        stage = self.encoder.down["0"]
        for j in range(cfg.layers_per_block):
            h = self._block(stage.block[str(j)], h, t_embed, cond, cfg.heads_per_stage[0], impl,
                            gradient_checkpointing)
            skips.append(h)
        return skips, layers.conv2d(stage.downsample.conv, h, stride=2, padding=1)

    def deep(self, down0, t_embed, cond, *, impl: str = "auto",
             gradient_checkpointing: bool = False):
        """Stages 1..n-1, the bottleneck and the decoder stages before the
        last; ``down0`` is the first skip.  Returns the feature entering the
        last decoder stage."""
        cfg = self.cfg
        remat, eps, heads, n = (gradient_checkpointing, cfg.norm_eps, cfg.heads_per_stage,
                                cfg.num_stages)
        h = down0
        skips = [down0]
        for i in range(1, n):
            stage = self.encoder.down[str(i)]
            for j in range(cfg.layers_per_block):
                h = self._block(stage.block[str(j)], h, t_embed, cond, heads[i], impl, remat)
                skips.append(h)
            if i != n - 1:
                h = layers.conv2d(stage.downsample.conv, h, stride=2, padding=1)
                skips.append(h)

        mid = self.bottleneck
        h = resblock_apply(mid["0"], h, t_embed, eps=eps, impl=impl)
        h = transformer_apply(mid["1"], h, cond, num_heads=heads[-1], impl=impl)
        h = resblock_apply(mid["2"], h, t_embed, eps=eps, impl=impl)

        for u, i in enumerate(reversed(range(1, n))):
            stage = self.decoder.up[str(u)]
            prev_hw = skips[-1].shape[2]
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=-1)
                h = self._block(stage.block[str(j)], h, t_embed, cond, heads[i], impl, remat)
            if not (skips and skips[-1].shape[2] == prev_hw):
                h = layers.upsample_nearest_2x(h)
            h = layers.conv3x3(stage.upsample.conv, h, impl=impl)
        return h

    def shallow_decoder(self, deep_h, skips, t_embed, cond, *, impl: str = "auto",
                        gradient_checkpointing: bool = False):
        """The last decoder stage on ``deep_h`` and the stage-0 skips, then
        the output head."""
        cfg = self.cfg
        stage = self.decoder.up[str(cfg.num_stages - 1)]
        h, skips = deep_h, list(skips)
        for j in range(cfg.layers_per_block + 1):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = self._block(stage.block[str(j)], h, t_embed, cond, cfg.heads_per_stage[0], impl,
                            gradient_checkpointing)
        out = self.output
        h = group_norm_silu(h, out["0"].weight, out["0"].bias, eps=cfg.norm_eps, silu=True,
                            impl=impl)
        return layers.conv2d(out["2"], h)

    def _full(self, x, timestep, cond, *, impl: str, gradient_checkpointing: bool,
              added_cond: Optional[dict]):
        kw = dict(impl=impl, gradient_checkpointing=gradient_checkpointing)
        t_embed = self.time_embedding_apply(timestep, x.dtype, impl, added_cond)
        skips, down0 = self.shallow_encoder(x, t_embed, cond, **kw)
        deep_h = self.deep(down0, t_embed, cond, **kw)
        return self.shallow_decoder(deep_h, skips, t_embed, cond, **kw), deep_h

    def forward_split(self, x: torch.Tensor, timestep: torch.Tensor, cond: torch.Tensor, *,
                      added_cond: Optional[dict] = None, impl: str = "auto",
                      gradient_checkpointing: bool = False):
        """The full pass -> (epsilon prediction, the deep feature to hold)."""
        with span("unet"):
            return self._full(x, timestep, cond, impl=impl,
                              gradient_checkpointing=gradient_checkpointing,
                              added_cond=added_cond)

    def forward_cached(self, x: torch.Tensor, timestep: torch.Tensor, cond: torch.Tensor,
                       deep_h: torch.Tensor, *, added_cond: Optional[dict] = None,
                       impl: str = "auto") -> torch.Tensor:
        """A cached step: the shallow stage recomputed around ``deep_h``."""
        with span("unet"):
            t_embed = self.time_embedding_apply(timestep, x.dtype, impl, added_cond)
            skips, _ = self.shallow_encoder(x, t_embed, cond, impl=impl)
            return self.shallow_decoder(deep_h, skips, t_embed, cond, impl=impl)

    def forward(self, x: torch.Tensor, timestep: torch.Tensor, cond: torch.Tensor, *,
                added_cond: Optional[dict] = None, impl: str = "auto",
                gradient_checkpointing: bool = False) -> torch.Tensor:
        """x: (B, H, W, in_channels) NHWC latents; timestep: (B,) or (1,);
        cond: (B, 77, cross_dim); ``added_cond``: SDXL's pooled text and
        size conditioning (:meth:`time_embedding_apply`).  Returns the
        epsilon prediction.

        On the card's kernels, with nothing for autograd to record, no
        calibration capture and no tensor-parallel shard, the pass replays
        as a CUDA graph (utils/graphs.py) from its second call at a
        signature and weights on; the graph launches the same kernels."""
        with span("unet"):
            keys = None if added_cond is None else tuple(sorted(added_cond))
            inputs = (x, timestep, cond, *(added_cond[k] for k in keys or ()))
            if (graphs.replays(x, impl, gradient_checkpointing) and layers.CAPTURE is None
                    and all(isinstance(t, torch.Tensor) and t.device == x.device
                            for t in inputs)):
                def run(x, timestep, cond, *added):
                    return self._full(x, timestep, cond, impl=impl, gradient_checkpointing=False,
                                      added_cond=None if keys is None else dict(zip(keys, added))
                                      )[0]

                switches = tuple(os.environ.get(k) for k in ("SD_TPU_FUSED_MM", "SD_TPU_WINOGRAD"))
                return graphs.cache(self, "unet_replay")(self, run, inputs, (impl, keys, switches))
            return self._full(x, timestep, cond, impl=impl,
                              gradient_checkpointing=gradient_checkpointing,
                              added_cond=added_cond)[0]
