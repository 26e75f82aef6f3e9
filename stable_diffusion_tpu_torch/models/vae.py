"""VAE decoder (port of the decode half of stable_diffusion_tpu/models/vae.py:
``decode``, ``decoder_apply``, ``_residual_block``, ``_mid_attention``).
The encoder is not ported yet.

On the card every GroupNorm goes through K1 (including the mid-attention
and ``conv_norm_out`` norms that JAX leaves to XLA), every GN+SiLU+3x3 conv
and upsampler conv through K2, and the single-head d=512 mid attention
through K3.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from stable_diffusion_tpu_torch.models import layers
from stable_diffusion_tpu_torch.ops.attention import sdpa
from stable_diffusion_tpu_torch.ops.conv import conv3x3, gn_silu_conv3x3
from stable_diffusion_tpu_torch.ops.groupnorm import group_norm_silu

SD_LATENT_SCALE = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    ch_mult: tuple = (1, 2, 4, 4)
    norm_eps: float = 1e-6


def _conv(cin, cout, k):
    return nn.Conv2d(cin, cout, k, padding=k // 2)


class ResidualBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, in_ch)
        self.conv1 = _conv(in_ch, out_ch, 3)
        self.norm2 = nn.GroupNorm(32, out_ch)
        self.conv2 = _conv(out_ch, out_ch, 3)
        if in_ch != out_ch:
            self.conv_shortcut = _conv(in_ch, out_ch, 1)

    def forward(self, x, *, eps: float, impl: str):
        h = gn_silu_conv3x3(x, self.norm1.weight, self.norm1.bias, self.conv1.weight,
                            self.conv1.bias, eps=eps, impl=impl)
        h = gn_silu_conv3x3(h, self.norm2.weight, self.norm2.bias, self.conv2.weight,
                            self.conv2.bias, eps=eps, impl=impl)
        if hasattr(self, "conv_shortcut"):
            x = layers.conv2d(self.conv_shortcut, x)
        return h + x


class MidAttention(nn.Module):
    """Single-head attention over the h*w tokens at the full channel width."""

    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(32, ch)
        self.query = nn.Linear(ch, ch)
        self.key = nn.Linear(ch, ch)
        self.value = nn.Linear(ch, ch)
        self.proj_attn = nn.Linear(ch, ch)

    def forward(self, x, *, impl: str):
        b, h, w, c = x.shape
        xn = group_norm_silu(x, self.group_norm.weight, self.group_norm.bias, eps=1e-6,
                             silu=False, impl=impl)
        tokens = xn.reshape(b, h * w, c)
        q, k, v = (layers.linear(m, tokens)[:, :, None, :]
                   for m in (self.query, self.key, self.value))
        out = sdpa(q, k, v, impl=impl)[:, :, 0, :]
        return layers.linear(self.proj_attn, out).reshape(b, h, w, c) + x


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleDict({"0": ResidualBlock(ch, ch), "1": ResidualBlock(ch, ch)})
        self.attentions = nn.ModuleDict({"0": MidAttention(ch)})


class _Conv(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = _conv(ch, ch, 3)


class _UpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleDict({"0": ResidualBlock(in_ch, out_ch),
                                      "1": ResidualBlock(out_ch, out_ch),
                                      "2": ResidualBlock(out_ch, out_ch)})
        if upsample:
            self.upsamplers = nn.ModuleDict({"0": _Conv(out_ch)})


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.base_channels
        top = ch * cfg.ch_mult[-1]
        self.conv_in = _conv(cfg.latent_channels, top, 3)
        self.mid_block = _Mid(top)
        up = {}
        block_in = top
        for u, i in enumerate(reversed(range(len(cfg.ch_mult)))):
            block_out = ch * cfg.ch_mult[i]
            up[str(u)] = _UpBlock(block_in, block_out, upsample=i != 0)
            block_in = block_out
        self.up_blocks = nn.ModuleDict(up)
        self.conv_norm_out = nn.GroupNorm(32, ch)
        self.conv_out = _conv(ch, cfg.out_channels, 3)


class VAEDecoder(nn.Module):
    """The decode half of the VAE: key paths ``post_quant_conv`` and
    ``decoder.*`` of the JAX tree."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        z = cfg.latent_channels
        self.decoder = Decoder(cfg)
        self.post_quant_conv = _conv(z, z, 1)

    def decoder_apply(self, z: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        """Latent NHWC (B,h,w,z) -> image (B,8h,8w,3) in [-1,1]."""
        d, eps = self.decoder, self.cfg.norm_eps
        h = layers.conv2d(d.conv_in, z)
        mid = d.mid_block
        h = mid.resnets["0"](h, eps=eps, impl=impl)
        h = mid.attentions["0"](h, impl=impl)
        h = mid.resnets["1"](h, eps=eps, impl=impl)
        for stage in d.up_blocks.values():
            for blk in stage.resnets.values():
                h = blk(h, eps=eps, impl=impl)
            if hasattr(stage, "upsamplers"):
                conv = stage.upsamplers["0"].conv
                h = conv3x3(layers.upsample_nearest_2x(h), conv.weight, conv.bias, impl=impl)
        h = group_norm_silu(h, d.conv_norm_out.weight, d.conv_norm_out.bias, eps=eps,
                            silu=True, impl=impl)
        return layers.conv2d(d.conv_out, h)

    def decode(self, z: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        """Latent -> image in [-1, 1]; divides by the 0.18215 latent scale."""
        z = layers.conv2d(self.post_quant_conv, z / SD_LATENT_SCALE)
        return self.decoder_apply(z, impl=impl)
