"""Config-driven UNet denoiser (port of stable_diffusion_tpu/models/unet.py
``unet_apply``).

NHWC activations; submodule names follow the JAX key paths
(``encoder.down.{i}.block.{j}.{0,1}``, ``bottleneck.{0,1,2}``,
``decoder.up.{u}``, ``output.{0,2}``).  On the card every GroupNorm+SiLU+3x3
conv runs as K1 stats + K2, every non-causal attention as K3, every
feed-forward block as K4; the 1x1 convs, projections, stride-2 convs,
conv_in/conv_out and the time embedding are plain matmuls and convs, as
JAX leaves them to XLA.  The DeepCache split is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
from torch import nn

from stable_diffusion_tpu_torch.models import layers
from stable_diffusion_tpu_torch.models.attention import MultiheadAttention, multihead_attention
from stable_diffusion_tpu_torch.ops.conv import conv3x3, gn_silu_conv3x3
from stable_diffusion_tpu_torch.ops.ffn import geglu_ffn
from stable_diffusion_tpu_torch.ops.groupnorm import group_norm_silu
from stable_diffusion_tpu_torch.ops.linear import gn_matmul, matmul_residual


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

    @classmethod
    def sd15(cls) -> "UNetConfig":
        return cls(attention_head_dim=8, cross_attention_dim=768)

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
    def __init__(self, ch: int, cond_dim: int, groups: int):
        super().__init__()
        self.groupnorm = nn.GroupNorm(groups, ch)
        self.conv_input = _conv(ch, ch, 1)
        self.transformer_block = TransformerBlock(ch, cond_dim)
        self.conv_output = _conv(ch, ch, 1)


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


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        bc = list(cfg.block_out_channels)
        n = cfg.num_stages
        cross = cfg.cross_dim_per_stage
        has_attn = cfg.stage_has_attention
        t_dim = cfg.time_embed_dim
        g = cfg.norm_num_groups

        def block(in_ch, out_ch, stage):
            m = {"0": ResBlock(in_ch, out_ch, t_dim, g)}
            if has_attn[stage]:
                m["1"] = Transformer(out_ch, cross[stage], g)
            return nn.ModuleDict(m)

        block_in = [bc[0]] + bc
        down = {}
        for i in range(n):
            blocks = {str(j): block(block_in[i] if j == 0 else bc[i], bc[i], i)
                      for j in range(cfg.layers_per_block)}
            down[str(i)] = _Stage(blocks, "downsample" if i != n - 1 else None, bc[i])
        self.time_embedding = _TimeEmbedding(cfg.t_embed_dim, t_dim)
        self.encoder = _Encoder(_conv(cfg.in_channels, bc[0], 3), down)
        mid = bc[-1]
        self.bottleneck = nn.ModuleDict({
            "0": ResBlock(mid, mid, t_dim, g),
            "1": Transformer(mid, cross[-1], g),
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

    def time_embedding_apply(self, timestep: torch.Tensor, dtype) -> torch.Tensor:
        """(B,) int timesteps -> (B, 4*t_embed_dim); cos-then-sin sinusoid."""
        half = self.cfg.t_embed_dim // 2
        freqs = torch.exp(-math.log(10000.0)
                          * torch.arange(half, dtype=torch.float32, device=timestep.device) / half)
        x = timestep.float()[:, None] * freqs[None, :]
        t = torch.cat([torch.cos(x), torch.sin(x)], dim=-1).to(dtype)
        ffn = self.time_embedding.ffn
        return layers.linear(ffn["2"], layers.silu(layers.linear(ffn["0"], t)))

    def _resblock(self, p: ResBlock, x, t_embed, impl):
        eps = self.cfg.norm_eps
        h = gn_silu_conv3x3(x, p.groupnorm_1.weight, p.groupnorm_1.bias, p.conv_1.weight,
                            p.conv_1.bias, eps=eps, impl=impl)
        h = h + layers.linear(p.t_embed, layers.silu(t_embed))[:, None, None, :]
        h = gn_silu_conv3x3(h, p.groupnorm_2.weight, p.groupnorm_2.bias, p.conv_2.weight,
                            p.conv_2.bias, eps=eps, impl=impl)
        if hasattr(p, "proj_input"):
            b, hh, ww, ci = x.shape
            co = h.shape[-1]
            y = matmul_residual(x.reshape(b, hh * ww, ci), p.proj_input.weight[:, :, 0, 0],
                                p.proj_input.bias, h.reshape(b, hh * ww, co))
            return y.reshape(h.shape)
        return h + x

    def _transformer(self, p: Transformer, x, cond, num_heads, impl):
        b, hh, ww, c = x.shape
        res = x
        x = gn_matmul(x, p.groupnorm.weight, p.groupnorm.bias, p.conv_input.weight[:, :, 0, 0],
                      p.conv_input.bias, eps=1e-6, impl=impl).reshape(b, hh * ww, c)
        tb = p.transformer_block
        x = multihead_attention(tb.attn1, x, num_heads=num_heads, impl=impl,
                                ln=tb.layernorm_1, residual=x)
        x = multihead_attention(tb.attn2, x, num_heads=num_heads, cond=cond, impl=impl,
                                ln=tb.layernorm_2, residual=x)
        ffn = tb.ffn
        x = geglu_ffn(x, tb.layernorm_3.weight, tb.layernorm_3.bias, ffn["0"].proj.weight,
                      ffn["0"].proj.bias, ffn["1"].weight, ffn["1"].bias, residual=x, impl=impl)
        x = matmul_residual(x, p.conv_output.weight[:, :, 0, 0], p.conv_output.bias,
                            res.reshape(b, hh * ww, c))
        return x.reshape(b, hh, ww, c)

    def _block(self, p: nn.ModuleDict, x, t_embed, cond, num_heads, impl):
        x = self._resblock(p["0"], x, t_embed, impl)
        if "1" in p:
            x = self._transformer(p["1"], x, cond, num_heads, impl)
        return x

    def forward(self, x: torch.Tensor, timestep: torch.Tensor, cond: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
        """x: (B, H, W, in_channels) NHWC latents; timestep: (B,) or (1,);
        cond: (B, 77, cross_dim).  Returns the epsilon prediction."""
        cfg = self.cfg
        heads = cfg.heads_per_stage
        n = cfg.num_stages
        t_embed = self.time_embedding_apply(timestep, x.dtype)

        h = layers.conv2d(self.encoder.conv_in, x)
        skips = [h]
        for i in range(n):
            stage = self.encoder.down[str(i)]
            for j in range(cfg.layers_per_block):
                h = self._block(stage.block[str(j)], h, t_embed, cond, heads[i], impl)
                skips.append(h)
            if i != n - 1:
                h = layers.conv2d(stage.downsample.conv, h, stride=2, padding=1)
                skips.append(h)

        mid = self.bottleneck
        h = self._resblock(mid["0"], h, t_embed, impl)
        h = self._transformer(mid["1"], h, cond, heads[-1], impl)
        h = self._resblock(mid["2"], h, t_embed, impl)

        for u, i in enumerate(reversed(range(n))):
            stage = self.decoder.up[str(u)]
            prev_hw = skips[-1].shape[2]
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=-1)
                h = self._block(stage.block[str(j)], h, t_embed, cond, heads[i], impl)
            if i != 0:
                if not (skips and skips[-1].shape[2] == prev_hw):
                    h = layers.upsample_nearest_2x(h)
                conv = stage.upsample.conv
                h = conv3x3(h, conv.weight, conv.bias, impl=impl)

        out = self.output
        h = group_norm_silu(h, out["0"].weight, out["0"].bias, eps=cfg.norm_eps, silu=True,
                            impl=impl)
        return layers.conv2d(out["2"], h)
