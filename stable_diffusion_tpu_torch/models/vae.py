"""The VAE (port of stable_diffusion_tpu/models/vae.py: ``encoder_apply``,
``encode_moments``, ``encode``, ``decode``, ``decoder_apply``,
``_residual_block``, ``_mid_attention``, and the VQ-VAE's
``vqvae_encode``, ``vqvae_decode``, ``vqvae_ema_codebook_update``,
``init_vqvae``).  :class:`VAEDecoder` is the decode
half alone (key paths ``decoder.*`` and ``post_quant_conv``); :class:`VAE`
adds ``encoder.*`` and ``quant_conv``, the whole ``init_vae`` tree.

On the card every GroupNorm goes through K1 (including the mid-attention
and ``conv_norm_out`` norms that JAX leaves to XLA), every resblock
GN+SiLU+3x3 conv and upsampler conv through K2, and the single-head d=512
mid attention through K3.  The encoder's ``conv_in`` (3 channels), its
stride-2 downsamplers, ``conv_out``, ``quant_conv`` and the 1x1 shortcuts
stay plain convs, as JAX computes them outside any kernel too.  The
VQ-VAE runs the same kernels at the same sites (its decoder's ``conv_in``
takes 8 channels); its distance product stays plain.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from stable_diffusion_tpu_torch.models import layers
from stable_diffusion_tpu_torch.ops.attention import sdpa
from stable_diffusion_tpu_torch.ops.conv import conv3x3, gn_silu_conv3x3
from stable_diffusion_tpu_torch.ops.groupnorm import group_norm_silu
from stable_diffusion_tpu_torch.utils.device import span

SD_LATENT_SCALE = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    ch_mult: tuple = (1, 2, 4, 4)
    norm_eps: float = 1e-6
    # latents are the encoder's sample times this (SDXL's VAE: 0.13025)
    scaling_factor: float = SD_LATENT_SCALE

    @classmethod
    def sdxl(cls) -> "VAEConfig":
        """SDXL base 1.0's VAE: SD's architecture at scaling factor 0.13025."""
        return cls(scaling_factor=0.13025)

    @classmethod
    def from_dict(cls, data: dict) -> "VAEConfig":
        """A diffusers ``vae/config.json``: ``block_out_channels`` sets
        ``base_channels`` / ``ch_mult``; what the fixed topology (2 encoder
        and 3 decoder resnets a stage, GroupNorm(32)) cannot build raises."""
        kw = dict(in_channels=data.get("in_channels", 3), out_channels=data.get("out_channels", 3),
                  latent_channels=data.get("latent_channels", 4),
                  scaling_factor=float(data.get("scaling_factor", SD_LATENT_SCALE)))
        boc = data.get("block_out_channels")
        if boc is not None:
            base = int(boc[0])
            if base <= 0 or any(int(c) % base for c in boc):
                raise ValueError(f"unsupported block_out_channels={boc}: stages must be integer "
                                 f"multiples of the first ({base})")
            kw["base_channels"] = base
            kw["ch_mult"] = tuple(int(c) // base for c in boc)
        lpb = int(data.get("layers_per_block", 2))
        if lpb != 2:
            raise ValueError(f"layers_per_block={lpb} unsupported: the VAE has 2 encoder / 3 "
                             "decoder resnets a stage")
        groups = int(data.get("norm_num_groups", 32))
        if groups != 32:
            raise ValueError(f"norm_num_groups={groups} unsupported: GroupNorm(32) throughout")
        return cls(**kw)


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


class _DownBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleDict({"0": ResidualBlock(in_ch, out_ch),
                                      "1": ResidualBlock(out_ch, out_ch)})
        if downsample:
            self.downsamplers = nn.ModuleDict({"0": _Conv(out_ch)})


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.base_channels
        in_mult = (1,) + tuple(cfg.ch_mult)
        n = len(cfg.ch_mult)
        top = ch * cfg.ch_mult[-1]
        self.conv_in = _conv(cfg.in_channels, ch, 3)
        self.down_blocks = nn.ModuleDict({
            str(i): _DownBlock(ch * in_mult[i], ch * cfg.ch_mult[i], downsample=i != n - 1)
            for i in range(n)})
        self.mid_block = _Mid(top)
        self.conv_norm_out = nn.GroupNorm(32, top)
        self.conv_out = _conv(top, 2 * cfg.latent_channels, 3)


class _UpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleDict({"0": ResidualBlock(in_ch, out_ch),
                                      "1": ResidualBlock(out_ch, out_ch),
                                      "2": ResidualBlock(out_ch, out_ch)})
        if upsample:
            self.upsamplers = nn.ModuleDict({"0": _Conv(out_ch)})


class Decoder(nn.Module):
    """``z_channels``: the latent channels ``conv_in`` takes (the VQ-VAE's
    decoder takes 2 * latent_channels); ``cfg.latent_channels`` by default."""

    def __init__(self, cfg: VAEConfig, z_channels: Optional[int] = None):
        super().__init__()
        ch = cfg.base_channels
        top = ch * cfg.ch_mult[-1]
        self.conv_in = _conv(z_channels or cfg.latent_channels, top, 3)
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


def _mid_apply(mid: _Mid, h: torch.Tensor, eps: float, impl: str) -> torch.Tensor:
    h = mid.resnets["0"](h, eps=eps, impl=impl)
    h = mid.attentions["0"](h, impl=impl)
    return mid.resnets["1"](h, eps=eps, impl=impl)


def decoder_apply(d: Decoder, z: torch.Tensor, eps: float, impl: str) -> torch.Tensor:
    """Latent NHWC (B,h,w,z) -> image (B,8h,8w,3) in [-1,1] (JAX ``decoder_apply``)."""
    h = _mid_apply(d.mid_block, layers.conv2d(d.conv_in, z), eps, impl)
    for stage in d.up_blocks.values():
        for blk in stage.resnets.values():
            h = blk(h, eps=eps, impl=impl)
        if hasattr(stage, "upsamplers"):
            conv = stage.upsamplers["0"].conv
            h = conv3x3(layers.upsample_nearest_2x(h), conv.weight, conv.bias, impl=impl)
    h = group_norm_silu(h, d.conv_norm_out.weight, d.conv_norm_out.bias, eps=eps, silu=True,
                        impl=impl)
    return layers.conv2d(d.conv_out, h)


def encoder_apply(e: Encoder, x: torch.Tensor, eps: float, impl: str) -> torch.Tensor:
    """Image NHWC (B,H,W,3) -> (B,H/8,W/8,2z) (JAX ``encoder_apply``)."""
    h = layers.conv2d(e.conv_in, x)
    for stage in e.down_blocks.values():
        for blk in stage.resnets.values():
            h = blk(h, eps=eps, impl=impl)
        if hasattr(stage, "downsamplers"):
            h = layers.conv2d(stage.downsamplers["0"].conv, h, stride=2,
                              padding=((0, 1), (0, 1)))
    h = _mid_apply(e.mid_block, h, eps, impl)
    h = group_norm_silu(h, e.conv_norm_out.weight, e.conv_norm_out.bias, eps=eps, silu=True,
                        impl=impl)
    return layers.conv2d(e.conv_out, h)


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
        return decoder_apply(self.decoder, z, self.cfg.norm_eps, impl)

    def decode(self, z: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        """Latent -> image in [-1, 1]; divides by the latent scale
        (``cfg.scaling_factor``, SD's 0.18215 by default)."""
        with span("vae_decode"):
            z = layers.conv2d(self.post_quant_conv, z / self.cfg.scaling_factor)
            return self.decoder_apply(z, impl=impl)


class VAE(VAEDecoder):
    """The whole VAE: the decode half plus ``encoder`` and ``quant_conv``."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__(cfg)
        z = cfg.latent_channels
        self.encoder = Encoder(cfg)
        self.quant_conv = _conv(2 * z, 2 * z, 1)

    def encoder_apply(self, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        """Image NHWC (B,H,W,3) -> moments (B,H/8,W/8,2z)."""
        return encoder_apply(self.encoder, x, self.cfg.norm_eps, impl)

    def encode_moments(self, x: torch.Tensor, *, impl: str = "auto"):
        """Image NHWC -> (mean, stdev), each (B,H/8,W/8,z); the log-variance
        is clipped to [-30, 20]."""
        moments = layers.conv2d(self.quant_conv, self.encoder_apply(x, impl=impl))
        mean, log_var = moments.chunk(2, dim=-1)
        return mean, torch.exp(0.5 * log_var.clamp(-30.0, 20.0))

    def encode(self, x: torch.Tensor, *, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None, impl: str = "auto"):
        """-> (latent, mean, stdev).  With ``noise`` the latent is
        mean + stdev * noise, unscaled (img2img, inpaint and training use
        this); without, the noise is drawn from ``generator`` and the latent
        is scaled by ``cfg.scaling_factor`` (JAX's asymmetry, kept)."""
        mean, std = self.encode_moments(x, impl=impl)
        if noise is not None:
            return mean + std * noise, mean, std
        draw = torch.randn(std.shape, generator=generator, device=std.device).to(std.dtype)
        return (mean + std * draw) * self.cfg.scaling_factor, mean, std


# ---------------------------------------------------------------------------
# VQ-VAE (JAX ``vqvae_encode``, ``vqvae_decode``, ``vqvae_ema_codebook_update``)
# ---------------------------------------------------------------------------


class VQVAE(nn.Module):
    """The encoder, a decoder on 2 * latent_channels and a codebook
    ``quant_embedding`` of ``codebook_size`` codes (JAX ``init_vqvae``'s tree)."""

    def __init__(self, cfg: VAEConfig = VAEConfig(), codebook_size: int = 1024):
        super().__init__()
        self.cfg = cfg
        z2 = 2 * cfg.latent_channels
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg, z_channels=z2)
        self.quant_embedding = nn.Embedding(codebook_size, z2)


def vq_distances(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, K) squared distances in f32, JAX's expansion |z|^2 - 2 z.e + |e|^2."""
    flat, codebook = flat.float(), codebook.float()
    return ((flat ** 2).sum(dim=1, keepdim=True) - 2.0 * flat @ codebook.T
            + (codebook ** 2).sum(dim=1)[None, :])


def vqvae_encode(model: VQVAE, x: torch.Tensor, *, impl: str = "auto"):
    """-> (quantized NHWC, vq + commitment loss (f32), code indices (B, h, w)).

    The nearest code is the argmin of :func:`vq_distances` (a plain product:
    JAX computes it in XLA), the first index among ties; the quantized
    latent carries the straight-through gradient to the encoder."""
    z = encoder_apply(model.encoder, x, model.cfg.norm_eps, impl)
    b, h, w, c = z.shape
    flat = z.reshape(-1, c)
    codebook = model.quant_embedding.weight
    idx = torch.argmin(vq_distances(flat, codebook), dim=-1)
    quant = codebook[idx].to(flat.dtype)
    vq_loss = torch.mean((flat.detach().float() - quant.float()) ** 2)
    commit_loss = torch.mean((flat.float() - quant.detach().float()) ** 2)
    quant = flat + (quant - flat).detach()  # straight-through
    return quant.reshape(b, h, w, c), vq_loss + commit_loss, idx.reshape(b, h, w)


def vqvae_decode(model: VQVAE, z: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    return decoder_apply(model.decoder, z, model.cfg.norm_eps, impl)


@torch.no_grad()
def vqvae_ema_codebook_update(model: VQVAE, ema_state, min_indices: torch.Tensor,
                              encoder_out: torch.Tensor, *, beta: float = 0.995):
    """EMA codebook update: state {"N": (K,), "M": (K, c)}, both f32.  The
    codebook is replaced in place by M / max(N, 1e-8); returns (model, new
    state) (JAX returns new parameters)."""
    codebook = model.quant_embedding.weight
    k, c = codebook.shape
    flat_z = encoder_out.reshape(-1, c).float()
    onehot = torch.nn.functional.one_hot(min_indices.reshape(-1).long(), k).float()
    n_new = beta * ema_state["N"] + (1 - beta) * onehot.sum(dim=0)
    m_new = beta * ema_state["M"] + (1 - beta) * (onehot.T @ flat_z)
    codebook.copy_(m_new / torch.clamp(n_new[:, None], min=1e-8))
    return model, {"N": n_new, "M": m_new}


def init_vqvae(seed: int, cfg: VAEConfig = VAEConfig(), codebook_size: int = 1024, *,
               device="cuda", dtype=torch.float32) -> VQVAE:
    """A seeded random VQ-VAE on ``device`` (``utils.weights.init_random_``)."""
    from stable_diffusion_tpu_torch.utils.weights import build, init_random_

    return init_random_(build(VQVAE, cfg, codebook_size, device=device, dtype=dtype), seed)
