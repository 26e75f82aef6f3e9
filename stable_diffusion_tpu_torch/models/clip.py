"""CLIP towers (port of stable_diffusion_tpu/models/clip.py).

Text: ``text_model_apply`` and ``openclip_apply`` (SD1.5's CLIP ViT-L,
QuickGELU, and SD2.1's OpenCLIP ViT-H, GELU: one pre-LN causal transformer
with a final LayerNorm; :class:`OpenCLIP` is the same tower rooted at
``text_model``), SDXL's pair (``CLIPTextConfig.sdxl_pair``: ViT-L and
:class:`CLIPTextModelWithProjection`'s OpenCLIP ViT-bigG, each handing on
its penultimate layer, bigG also its pooled, projected EOS state), and the
v1 naming of the same tower (:class:`TextEncoderV1`, JAX
``text_encoder_v1_apply``).  The causal
attention stays plain on the card, as JAX leaves it to XLA; a W8A8 text
tower (``utils/quantize_model.quantize_text_encoder_static``) runs every
linear on K8.

Vision and score (JAX ``vision_model_apply``, ``clip_image_embed``,
``clip_text_embed``, ``clip_score``): :class:`CLIPModel` holds HF
``CLIPModel``'s key names (``text_model.*``, ``vision_model.*`` with HF's
``pre_layrnorm``, ``visual_projection``, ``text_projection``,
``logit_scale``), so an HF state dict loads as it is.  The vision tower's
self-attention runs on K3 on the card; its patch conv and every linear
stay plain, as JAX computes them in XLA.

Class2img: :class:`ClassEncoder` (JAX ``class_encoder_apply``), a table of
``num_classes + 1`` rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from stable_diffusion_tpu_torch.models import layers
from stable_diffusion_tpu_torch.models.attention import MultiheadAttention, multihead_attention
from stable_diffusion_tpu_torch.parallel.mesh import row_parallel


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
    # the state a text tower hands the UNet: "last" (the last layer through
    # the final LayerNorm) or "penultimate" (SDXL: the second-to-last
    # layer's output, not normalized)
    hidden_state: str = "last"

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

    @classmethod
    def sdxl_pair(cls) -> tuple:
        """SDXL base's two towers, each handing on its penultimate layer:
        CLIP ViT-L/14 and OpenCLIP ViT-bigG/14 (1280 wide, 32 layers, 20
        heads, GELU, a 1280-wide projection of its pooled state)."""
        return (dataclasses.replace(cls.vit_l(), hidden_state="penultimate"),
                cls(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
                    num_attention_heads=20, hidden_act="gelu", hidden_state="penultimate"))


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class _Layer(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim)
        self.self_attn = MultiheadAttention(dim)
        self.layer_norm2 = nn.LayerNorm(dim)
        self.mlp = _MLP(dim, hidden)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleDict({str(i): _Layer(cfg.hidden_size, cfg.intermediate_size)
                                     for i in range(cfg.num_hidden_layers)})


def _act(name: str):
    return layers.quick_gelu if name == "quick_gelu" else layers.gelu


def _block(x, ln1, attn, ln2, fc1, fc2, *, act, num_heads: int, eps: float, causal: bool,
           impl: str):
    """Pre-LN block: LN -> self-attention -> +res; LN -> MLP -> +res.  On a
    tensor-parallel shard ``fc1``'s input carries the mate of ``fc2``'s sum
    (``Mesh.column_input``; the attention places its own)."""
    h = layers.layer_norm(ln1, x, eps=eps)
    x = multihead_attention(attn, h, num_heads=num_heads, causal=causal, impl=impl) + x
    h = layers.layer_norm(ln2, x, eps=eps)
    mesh = row_parallel(fc2)
    if mesh is not None:
        h = mesh.column_input(h)
    return layers.linear(fc2, act(layers.linear(fc1, h, impl=impl)), impl=impl) + x


def _embed(emb: nn.Embedding, pos: nn.Embedding, input_ids: torch.Tensor) -> torch.Tensor:
    return layers.embedding(emb, input_ids) + pos.weight[:input_ids.shape[-1]]


class CLIPTextModel(nn.Module):
    """Key paths as the JAX tree: ``embeddings.*``, ``encoder.layers.{i}.*``,
    ``final_layer_norm``."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        if cfg.hidden_state not in ("last", "penultimate"):
            raise ValueError(f"hidden_state must be 'last' or 'penultimate', got "
                             f"{cfg.hidden_state!r}")
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size)

    def hidden_states(self, input_ids: torch.Tensor, *, impl: str = "auto",
                      count: Optional[int] = None) -> list:
        """The outputs of the first ``count`` layers (all when None), in order."""
        cfg = self.cfg
        x = _embed(self.embeddings.token_embedding, self.embeddings.position_embedding, input_ids)
        out = []
        for layer in list(self.encoder.layers.values())[:count]:
            x = _block(x, layer.layer_norm1, layer.self_attn, layer.layer_norm2, layer.mlp.fc1,
                       layer.mlp.fc2, act=_act(cfg.hidden_act),
                       num_heads=cfg.num_attention_heads, eps=cfg.layer_norm_eps, causal=True,
                       impl=impl)
            out.append(x)
        return out

    def forward(self, input_ids: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        """Token ids (B, S) -> the hidden state (B, S, hidden) that
        ``cfg.hidden_state`` names, in the parameters' dtype ("penultimate"
        stops before the last layer, which it does not need)."""
        cfg = self.cfg
        if cfg.hidden_state == "penultimate":
            return self.hidden_states(input_ids, impl=impl, count=cfg.num_hidden_layers - 1)[-1]
        x = self.hidden_states(input_ids, impl=impl)[-1]
        return layers.layer_norm(self.final_layer_norm, x, eps=cfg.layer_norm_eps)


class CLIPTextModelWithProjection(CLIPTextModel):
    """HF ``CLIPTextModelWithProjection`` (SDXL's second tower): the tower's
    keys and ``text_projection`` (no bias, at the tower's width, as bigG's
    1280 -> 1280).  Returns the hidden state and the pooled state: the final
    LayerNorm of the last layer at the EOS token (the first maximum of the
    ids) through ``text_projection``."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__(cfg)
        self.text_projection = nn.Linear(cfg.hidden_size, cfg.hidden_size, bias=False)

    def forward(self, input_ids: torch.Tensor, *, impl: str = "auto"):
        """Token ids (B, S) -> ((B, S, hidden) as ``cfg.hidden_state`` names
        it, (B, hidden) pooled)."""
        cfg = self.cfg
        states = self.hidden_states(input_ids, impl=impl)
        last = states[-1]
        eos = _first_argmax(input_ids)
        rows = torch.arange(last.shape[0], device=last.device)
        pooled = layers.layer_norm(self.final_layer_norm, last[rows, eos], eps=cfg.layer_norm_eps)
        hidden = (states[-2] if cfg.hidden_state == "penultimate"
                  else layers.layer_norm(self.final_layer_norm, last, eps=cfg.layer_norm_eps))
        return hidden, layers.linear(self.text_projection, pooled, impl=impl)


class OpenCLIP(nn.Module):
    """OpenCLIP.encode_text's parameter tree: the tower under ``text_model``."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.text_model = CLIPTextModel(cfg)


def openclip_apply(model: OpenCLIP, input_ids: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """JAX ``openclip_apply``: the tower rooted at ``text_model``."""
    return model.text_model(input_ids, impl=impl)


# ---------------------------------------------------------------------------
# The v1 naming of the ViT-L text tower (JAX ``text_encoder_v1_apply``)
# ---------------------------------------------------------------------------


class _V1Embedding(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _V1Layer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layernorm_1 = nn.LayerNorm(cfg.hidden_size)
        self.self_attn = MultiheadAttention(cfg.hidden_size)
        self.layernorm_2 = nn.LayerNorm(cfg.hidden_size)
        self.ffn = nn.ModuleDict({"0": nn.Linear(cfg.hidden_size, cfg.intermediate_size),
                                  "2": nn.Linear(cfg.intermediate_size, cfg.hidden_size)})


class TextEncoderV1(nn.Module):
    """The CLIP text tower under the v1 key names: ``text_embedding.{embedding,
    position_embedding}``, ``encoder_layers.{i}.{layernorm_1, self_attn,
    ffn.0, ffn.2, layernorm_2}``, ``final_layer_norm``; QuickGELU whatever
    ``hidden_act`` says, as in JAX."""

    def __init__(self, cfg: Optional[CLIPTextConfig] = None):
        super().__init__()
        cfg = cfg or CLIPTextConfig.vit_l()
        self.cfg = cfg
        self.text_embedding = _V1Embedding(cfg)
        self.encoder_layers = nn.ModuleDict({str(i): _V1Layer(cfg)
                                             for i in range(cfg.num_hidden_layers)})
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        cfg = self.cfg
        x = _embed(self.text_embedding.embedding, self.text_embedding.position_embedding,
                   input_ids)
        for p in self.encoder_layers.values():
            x = _block(x, p.layernorm_1, p.self_attn, p.layernorm_2, p.ffn["0"], p.ffn["2"],
                       act=layers.quick_gelu, num_heads=cfg.num_attention_heads,
                       eps=cfg.layer_norm_eps, causal=True, impl=impl)
        return layers.layer_norm(self.final_layer_norm, x, eps=cfg.layer_norm_eps)


def text_encoder_v1_apply(model: TextEncoderV1, input_ids: torch.Tensor, *,
                          impl: str = "auto") -> torch.Tensor:
    return model(input_ids, impl=impl)


def init_text_encoder_v1(seed: int, cfg: Optional[CLIPTextConfig] = None, *, device="cuda",
                         dtype=torch.float32) -> TextEncoderV1:
    """A seeded random v1 tower on ``device`` (``utils.weights.init_random_``)."""
    from stable_diffusion_tpu_torch.utils.weights import build, init_random_

    return init_random_(build(TextEncoderV1, cfg, device=device, dtype=dtype), seed)


# ---------------------------------------------------------------------------
# Class encoder (class2img; JAX ``class_encoder_apply``)
# ---------------------------------------------------------------------------


class ClassEncoder(nn.Module):
    """A label -> embedding table of ``num_classes + 1`` rows (key ``embedding``)."""

    def __init__(self, num_classes: int, emb_dim: int = 768):
        super().__init__()
        self.embedding = nn.Embedding(num_classes + 1, emb_dim)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        return layers.embedding(self.embedding, labels)


def class_encoder_apply(model: ClassEncoder, labels: torch.Tensor) -> torch.Tensor:
    return model(labels)


def init_class_encoder(seed: int, num_classes: int, emb_dim: int = 768, *, device="cuda",
                       dtype=torch.float32) -> ClassEncoder:
    from stable_diffusion_tpu_torch.utils.weights import build, init_random_

    return init_random_(build(ClassEncoder, num_classes, emb_dim, device=device, dtype=dtype),
                        seed)


# ---------------------------------------------------------------------------
# CLIP vision tower and the CLIP score
# ---------------------------------------------------------------------------

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 768
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_dict(cls, data: dict) -> "CLIPVisionConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, cfg.hidden_size)


class CLIPVisionTransformer(nn.Module):
    """HF ``CLIPVisionTransformer``'s keys: ``embeddings.{class_embedding,
    patch_embedding, position_embedding}``, ``pre_layrnorm``,
    ``encoder.layers.{i}.*``, ``post_layernorm``."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size)

    def forward(self, pixel_values: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        """(B, H, W, 3) normalized pixels -> pooled (B, hidden): the post-LN
        CLS token.  The patch conv runs in the parameters' dtype."""
        cfg, emb = self.cfg, self.embeddings
        w = emb.patch_embedding.weight
        b = pixel_values.shape[0]
        patches = F.conv2d(pixel_values.to(w.dtype).permute(0, 3, 1, 2), w, stride=cfg.patch_size)
        patches = patches.flatten(2).transpose(1, 2)  # (B, patches, hidden), row-major
        cls = emb.class_embedding.to(w.dtype).expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, patches], dim=1)
        x = x + emb.position_embedding.weight[:x.shape[1]].to(x.dtype)
        x = layers.layer_norm(self.pre_layrnorm, x, eps=cfg.layer_norm_eps)
        for layer in self.encoder.layers.values():
            x = _block(x, layer.layer_norm1, layer.self_attn, layer.layer_norm2, layer.mlp.fc1,
                       layer.mlp.fc2, act=_act(cfg.hidden_act),
                       num_heads=cfg.num_attention_heads, eps=cfg.layer_norm_eps, causal=False,
                       impl=impl)
        return layers.layer_norm(self.post_layernorm, x[:, 0], eps=cfg.layer_norm_eps)


def vision_model_apply(model: CLIPVisionTransformer, pixel_values: torch.Tensor, *,
                       impl: str = "auto") -> torch.Tensor:
    return model(pixel_values, impl=impl)


class CLIPModel(nn.Module):
    """HF ``CLIPModel``'s parameter tree: both towers and both projections."""

    def __init__(self, tcfg: CLIPTextConfig, vcfg: CLIPVisionConfig, projection_dim: int = 768):
        super().__init__()
        self.text_config, self.vision_config = tcfg, vcfg
        self.text_model = CLIPTextModel(tcfg)
        self.vision_model = CLIPVisionTransformer(vcfg)
        self.visual_projection = nn.Linear(vcfg.hidden_size, projection_dim, bias=False)
        self.text_projection = nn.Linear(tcfg.hidden_size, projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.empty(()))

    @classmethod
    def from_config(cls, cfg: dict, *, device="cuda", dtype=torch.float32) -> "CLIPModel":
        """Uninitialised, on ``device``, from an HF ``CLIPModel`` config.json."""
        tcfg = CLIPTextConfig.from_dict(cfg.get("text_config", cfg))
        vcfg = CLIPVisionConfig.from_dict(cfg.get("vision_config", cfg))
        dim = int(cfg.get("projection_dim", vcfg.projection_dim))
        from stable_diffusion_tpu_torch.utils.weights import build

        return build(cls, tcfg, vcfg, dim, device=device, dtype=dtype)


def clip_image_embed(model: CLIPModel, pixel_values: torch.Tensor, *,
                     impl: str = "auto") -> torch.Tensor:
    return layers.linear(model.visual_projection, model.vision_model(pixel_values, impl=impl))


def clip_text_embed(model: CLIPModel, input_ids: torch.Tensor, *,
                    impl: str = "auto") -> torch.Tensor:
    """The hidden state at the EOT token (the first maximum of the ids, as
    ``jnp.argmax`` picks) through ``text_projection``."""
    hidden = model.text_model(input_ids, impl=impl)
    eot = _first_argmax(input_ids)
    pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), eot]
    return layers.linear(model.text_projection, pooled)


def _first_argmax(ids: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum of each row (``torch.argmax`` promises no
    particular one among ties)."""
    s = ids.shape[-1]
    hit = ids == ids.amax(dim=-1, keepdim=True)
    pos = torch.arange(s, device=ids.device).expand_as(ids)
    return torch.where(hit, pos, s).amin(dim=-1)


def clip_score(model: CLIPModel, pixel_values: torch.Tensor, input_ids: torch.Tensor, *,
               impl: str = "auto") -> torch.Tensor:
    """torchmetrics' CLIP score, 100 * max(cos, 0) per pair, in f32.
    ``pixel_values``: (B, H, W, 3) raw [0, 255] images (CLIP's normalization
    is applied here)."""
    mean = torch.tensor(CLIP_MEAN, device=pixel_values.device)
    std = torch.tensor(CLIP_STD, device=pixel_values.device)
    px = (pixel_values.float() / 255.0 - mean) / std
    img = clip_image_embed(model, px, impl=impl).float()
    txt = clip_text_embed(model, input_ids, impl=impl).float()
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
    return torch.clamp((img * txt).sum(dim=-1), min=0.0) * 100.0


def init_vision_model(seed: int, cfg: CLIPVisionConfig, *, device="cuda",
                      dtype=torch.float32) -> CLIPVisionTransformer:
    from stable_diffusion_tpu_torch.utils.weights import build, init_random_

    return init_random_(build(CLIPVisionTransformer, cfg, device=device, dtype=dtype), seed)


def init_clip_model(seed: int, tcfg: CLIPTextConfig, vcfg: CLIPVisionConfig,
                    projection_dim: int = 768, *, device="cuda", dtype=torch.float32) -> CLIPModel:
    """A seeded random :class:`CLIPModel` (``logit_scale`` HF's log(1 / 0.07))."""
    from stable_diffusion_tpu_torch.utils.weights import build, init_random_

    model = build(CLIPModel, tcfg, vcfg, projection_dim, device=device, dtype=dtype)
    for i, part in enumerate((model.text_model, model.vision_model, model.visual_projection,
                              model.text_projection)):
        init_random_(part, seed + i)
    with torch.no_grad():
        model.logit_scale.fill_(math.log(1 / 0.07))
    return model
