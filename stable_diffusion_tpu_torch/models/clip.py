"""CLIP text towers (port of stable_diffusion_tpu/models/clip.py
``text_model_apply`` and ``openclip_apply``): SD1.5's CLIP ViT-L
(QuickGELU) and SD2.1's OpenCLIP ViT-H (GELU), one pre-LN causal
transformer with a final LayerNorm.  Its causal attention stays plain on the
card, as in JAX.  :class:`OpenCLIP` is the OpenCLIP checkpoint's form: the
same tower with its parameters rooted at ``text_model``."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from stable_diffusion_tpu_torch.models import layers
from stable_diffusion_tpu_torch.models.attention import MultiheadAttention, multihead_attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    hidden_act: str = "gelu"  # "gelu" (ViT-H) | "quick_gelu" (ViT-L)
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_dict(cls, data: dict) -> "CLIPTextConfig":
        """A text_encoder config.json; keys the tower does not use are dropped."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    @classmethod
    def vit_h(cls) -> "CLIPTextConfig":
        """SD 2.1 OpenCLIP ViT-H text tower (the defaults)."""
        return cls()

    @classmethod
    def vit_l(cls) -> "CLIPTextConfig":
        """SD 1.5 CLIP ViT-L/14 text tower."""
        return cls(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                   num_attention_heads=12, hidden_act="quick_gelu")


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size)
        self.self_attn = MultiheadAttention(cfg.hidden_size)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size)
        self.mlp = _MLP(cfg.hidden_size, cfg.intermediate_size)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleDict({str(i): _Layer(cfg) for i in range(cfg.num_hidden_layers)})


class CLIPTextModel(nn.Module):
    """Key paths as the JAX tree: ``embeddings.*``, ``encoder.layers.{i}.*``,
    ``final_layer_norm``."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        """Token ids (B, S) -> last hidden state (B, S, hidden), in the
        parameters' dtype."""
        cfg = self.cfg
        act = layers.quick_gelu if cfg.hidden_act == "quick_gelu" else layers.gelu
        seq = input_ids.shape[-1]
        emb = self.embeddings
        x = layers.embedding(emb.token_embedding, input_ids)
        x = x + emb.position_embedding.weight[:seq]
        for layer in self.encoder.layers.values():
            res = x
            h = layers.layer_norm(layer.layer_norm1, x, eps=cfg.layer_norm_eps)
            h = multihead_attention(layer.self_attn, h, num_heads=cfg.num_attention_heads,
                                    causal=True, impl=impl)
            x = h + res
            res = x
            h = layers.layer_norm(layer.layer_norm2, x, eps=cfg.layer_norm_eps)
            h = layers.linear(layer.mlp.fc2, act(layers.linear(layer.mlp.fc1, h)))
            x = h + res
        return layers.layer_norm(self.final_layer_norm, x, eps=cfg.layer_norm_eps)


class OpenCLIP(nn.Module):
    """OpenCLIP.encode_text's parameter tree: the tower under ``text_model``."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.text_model = CLIPTextModel(cfg)


def openclip_apply(model: OpenCLIP, input_ids: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """JAX ``openclip_apply``: the tower rooted at ``text_model``."""
    return model.text_model(input_ids, impl=impl)
