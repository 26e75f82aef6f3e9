"""Synthesized checkpoints for the port's loader tests and for
``chip_smoke.py``'s CLI phase: the port's state dicts written out in
diffusers, CompVis/LDM and kohya naming, and a CLIP vocabulary learned from
a fixed text.

The inverse maps (port key -> source key) are written by hand from each
layout, independently of the converters' rules; the tests let the JAX
package's strict converters judge them.  Imports neither JAX nor the JAX
package, so ``chip_smoke.py`` can run it where JAX is absent.
"""

from __future__ import annotations

import collections
import json
import os
import re
from typing import Dict, Mapping, Optional

import torch

from stable_diffusion_tpu_torch import tokenizer as T
from stable_diffusion_tpu_torch.utils import safetensors_io

# the tiny configs of tests/test_cli.py (UNet, text) and a 4-stage VAE at 32
TINY_UNET = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=(2, 4, 4, 4),
                 cross_attention_dim=24, t_embed_dim=16)
TINY_TEXT = dict(hidden_size=24, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
                 max_position_embeddings=77, vocab_size=49408)
TINY_VAE = dict(ch_mult=(1, 1, 1, 1), base_channels=32)

VOCAB_TEXT = (
    "a photo of a cat sitting on the mat, a painting of a dog in the style of van gogh. "
    "an astronaut riding a horse on the moon; highly detailed, 4k, trending on artstation. "
    "the quick brown fox jumps over the lazy dog! it's a beautiful day, we'll see. "
    "portrait of a woman with red hair, oil on canvas, by greg rutkowski and alphonse mucha. "
    "café crème brûlée naïve façade, 東京の夜景, 北京 上海, ½ ⅓ Ⅻ 3.14159 100% #1 @home ")


def distinct(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """f32 tensors of ``state``'s shapes whose elements tell every tensor and
    every position apart: tensor i holds i + (k mod 4096) / 4096 at flat
    index k (exact in f32 below 4096 tensors), so a swapped pairing, a
    transpose or a wrong third of a fused tensor changes values."""
    if len(state) >= 4096:
        raise ValueError("too many tensors to keep their values distinct")
    return {k: (i + (torch.arange(v.numel()) % 4096).float() / 4096).reshape(v.shape)
            for i, (k, v) in enumerate(state.items())}


# ---------------------------------------------------------------------------
# diffusers
# ---------------------------------------------------------------------------

_D_RES = {"groupnorm_1": "norm1", "conv_1": "conv1", "t_embed": "time_emb_proj",
          "groupnorm_2": "norm2", "conv_2": "conv2", "proj_input": "conv_shortcut"}
_D_ATTN = {"groupnorm": "norm", "conv_input": "proj_in", "conv_output": "proj_out",
           "layernorm_1": "transformer_blocks.0.norm1", "layernorm_2": "transformer_blocks.0.norm2",
           "layernorm_3": "transformer_blocks.0.norm3", "ffn.0.proj": "transformer_blocks.0.ff.net.0.proj",
           "ffn.1": "transformer_blocks.0.ff.net.2"}
_D_PROJ = {"q_proj": "to_q", "k_proj": "to_k", "v_proj": "to_v", "out_proj": "to_out.0"}


def _d_attn(inner: str) -> str:
    """The diffusers name of a transformer's key: its one ``transformer_block``
    or a deeper stack's ``transformer_blocks.{k}`` (SDXL)."""
    m = re.fullmatch(r"transformer_blocks\.(\d+)\.(.*)", inner)
    k, inner = (m.group(1), "transformer_block." + m.group(2)) if m else ("0", inner)
    m = re.fullmatch(r"transformer_block\.(attn\d)\.(\w+)", inner)
    if m:
        return f"transformer_blocks.{k}.{m.group(1)}.{_D_PROJ[m.group(2)]}"
    return _D_ATTN[inner.removeprefix("transformer_block.")].replace(
        "transformer_blocks.0.", f"transformer_blocks.{k}.")


def diffusers_unet_key(key: str) -> str:
    """The diffusers name of a port UNet key."""
    stem, leaf = key.rsplit(".", 1)
    simple = {"time_embedding.ffn.0": "time_embedding.linear_1",
              "time_embedding.ffn.2": "time_embedding.linear_2", "encoder.conv_in": "conv_in",
              "add_embedding.linear_1": "add_embedding.linear_1",
              "add_embedding.linear_2": "add_embedding.linear_2",
              "output.0": "conv_norm_out", "output.2": "conv_out"}
    if stem in simple:
        return f"{simple[stem]}.{leaf}"
    m = re.fullmatch(r"encoder\.down\.(\d+)\.downsample\.conv", stem)
    if m:
        return f"down_blocks.{m.group(1)}.downsamplers.0.conv.{leaf}"
    m = re.fullmatch(r"decoder\.up\.(\d+)\.upsample\.conv", stem)
    if m:
        return f"up_blocks.{m.group(1)}.upsamplers.0.conv.{leaf}"
    m = re.fullmatch(r"bottleneck\.(\d)\.(.*)", stem)
    if m:
        k, inner = m.groups()
        if k == "1":
            return f"mid_block.attentions.0.{_d_attn(inner)}.{leaf}"
        return f"mid_block.resnets.{0 if k == '0' else 1}.{_D_RES[inner]}.{leaf}"
    m = re.fullmatch(r"(encoder\.down|decoder\.up)\.(\d+)\.block\.(\d+)\.(\d)\.(.*)", stem)
    root, stage, block, kind, inner = m.groups()
    side = "down_blocks" if root == "encoder.down" else "up_blocks"
    if kind == "0":
        return f"{side}.{stage}.resnets.{block}.{_D_RES[inner]}.{leaf}"
    return f"{side}.{stage}.attentions.{block}.{_d_attn(inner)}.{leaf}"


def _is_proj_weight(key: str) -> bool:
    return bool(re.search(r"\.(conv_input|conv_output)\.weight$", key))


def to_diffusers_unet(state: Mapping[str, torch.Tensor], *, linear_proj: bool = False):
    """A port UNet state dict in diffusers naming; ``linear_proj`` writes
    proj_in / proj_out as rank-2 linears (SD2.1's use_linear_projection)."""
    return {diffusers_unet_key(k): (v[:, :, 0, 0] if linear_proj and _is_proj_weight(k) else v)
            for k, v in state.items()}


def to_diffusers_vae(state: Mapping[str, torch.Tensor], *, swiftbrush: bool = False):
    """The port's VAE naming is diffusers'; ``swiftbrush`` writes the mid
    attention as to_q / to_k / to_v / to_out.0."""
    if not swiftbrush:
        return dict(state)
    names = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}
    return {re.sub(r"attentions\.0\.(query|key|value|proj_attn)\.",
                   lambda m: f"attentions.0.{names[m.group(1)]}.", k): v for k, v in state.items()}


def to_diffusers_text(state: Mapping[str, torch.Tensor], n_positions: int = 77):
    """HF ``CLIPTextModel`` naming: under ``text_model.``, with its
    ``position_ids`` buffer."""
    out = {f"text_model.{k}": v for k, v in state.items()}
    out["text_model.embeddings.position_ids"] = torch.arange(n_positions)[None]
    return out


def to_diffusers_text_2(state: Mapping[str, torch.Tensor], n_positions: int = 77):
    """HF ``CLIPTextModelWithProjection`` naming: the tower under
    ``text_model.``, ``text_projection`` at the root."""
    out = to_diffusers_text({k: v for k, v in state.items()
                             if not k.startswith("text_projection.")}, n_positions)
    out["text_projection.weight"] = state["text_projection.weight"]
    return out


def write_diffusers_dir(root: str, unet: Mapping, text: Mapping, vae: Mapping, *, unet_config: dict,
                        text_config: dict, vae_config: dict, scheduler_config: Optional[dict] = None,
                        dtype: Optional[torch.dtype] = None, linear_proj: bool = False,
                        swiftbrush: bool = False, text_2: Optional[Mapping] = None,
                        text_config_2: Optional[dict] = None) -> None:
    """A diffusers model directory of three port state dicts, or four with
    SDXL's ``text_2`` (cast to ``dtype`` when given; ``position_ids`` stay
    int64)."""
    def cast(sd):
        return {k: (v.to(dtype) if dtype is not None and v.is_floating_point() else v).contiguous()
                for k, v in sd.items()}

    for sub, sd, name, cfg in (
            ("unet", to_diffusers_unet(unet, linear_proj=linear_proj),
             "diffusion_pytorch_model.safetensors", unet_config),
            ("text_encoder", to_diffusers_text(text, text_config.get("max_position_embeddings", 77)),
             "model.safetensors", text_config),
            ("vae", to_diffusers_vae(vae, swiftbrush=swiftbrush), "diffusion_pytorch_model.safetensors",
             vae_config)) + (() if text_2 is None else (
            ("text_encoder_2",
             to_diffusers_text_2(text_2, text_config_2.get("max_position_embeddings", 77)),
             "model.safetensors", text_config_2),)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        safetensors_io.save_file(cast(sd), os.path.join(root, sub, name))
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(cfg, f)
    if scheduler_config is not None:
        os.makedirs(os.path.join(root, "scheduler"), exist_ok=True)
        with open(os.path.join(root, "scheduler", "scheduler_config.json"), "w") as f:
            json.dump(scheduler_config, f)


# ---------------------------------------------------------------------------
# CompVis / LDM single file
# ---------------------------------------------------------------------------

_L_RES = {"groupnorm_1": "in_layers.0", "conv_1": "in_layers.2", "t_embed": "emb_layers.1",
          "groupnorm_2": "out_layers.0", "conv_2": "out_layers.3", "proj_input": "skip_connection"}


def ldm_unet_key(key: str, up_attention) -> str:
    """The LDM name of a port UNet key: input block 1 + 3i + j, output block
    3i + j, the stage-closing upsampler after the resnet and, where the
    decoder stage has one (``up_attention[i]``), the attention."""
    p = "model.diffusion_model."
    stem, leaf = key.rsplit(".", 1)
    simple = {"time_embedding.ffn.0": "time_embed.0", "time_embedding.ffn.2": "time_embed.2",
              "encoder.conv_in": "input_blocks.0.0", "output.0": "out.0", "output.2": "out.2"}
    if stem in simple:
        return f"{p}{simple[stem]}.{leaf}"
    inner_name = (lambda kind, inner: _L_RES[inner] if kind == "0" else _d_attn(inner))
    m = re.fullmatch(r"encoder\.down\.(\d+)\.downsample\.conv", stem)
    if m:
        return f"{p}input_blocks.{3 + 3 * int(m.group(1))}.0.op.{leaf}"
    m = re.fullmatch(r"decoder\.up\.(\d+)\.upsample\.conv", stem)
    if m:
        i = int(m.group(1))
        return f"{p}output_blocks.{3 * i + 2}.{2 if up_attention[i] else 1}.conv.{leaf}"
    m = re.fullmatch(r"bottleneck\.(\d)\.(.*)", stem)
    if m:
        return f"{p}middle_block.{m.group(1)}.{inner_name('1' if m.group(1) == '1' else '0', m.group(2))}.{leaf}"
    root, i, j, kind, inner = re.fullmatch(
        r"(encoder\.down|decoder\.up)\.(\d+)\.block\.(\d+)\.(\d)\.(.*)", stem).groups()
    n = 1 + 3 * int(i) + int(j) if root == "encoder.down" else 3 * int(i) + int(j)
    blocks = "input_blocks" if root == "encoder.down" else "output_blocks"
    return f"{p}{blocks}.{n}.{kind}.{inner_name(kind, inner)}.{leaf}"


_L_VAE_RES = {"conv_shortcut": "nin_shortcut"}
_L_VAE_ATTN = {"group_norm": "norm", "query": "q", "key": "k", "value": "v", "proj_attn": "proj_out"}


def ldm_vae_key(key: str) -> str:
    """The CompVis name of a port VAE key (the decoder's stages counted
    upwards: the port's up_blocks.i is up.{3 - i})."""
    p = "first_stage_model."
    if key.split(".")[0] in ("quant_conv", "post_quant_conv"):
        return p + key
    side, rest = key.split(".", 1)
    stem, leaf = rest.rsplit(".", 1)
    simple = {"conv_in": "conv_in", "conv_out": "conv_out", "conv_norm_out": "norm_out"}
    if stem in simple:
        return f"{p}{side}.{simple[stem]}.{leaf}"
    m = re.fullmatch(r"mid_block\.resnets\.(\d)\.(\w+)", stem)
    if m:
        return f"{p}{side}.mid.block_{int(m.group(1)) + 1}.{_L_VAE_RES.get(m.group(2), m.group(2))}.{leaf}"
    m = re.fullmatch(r"mid_block\.attentions\.0\.(\w+)", stem)
    if m:
        return f"{p}{side}.mid.attn_1.{_L_VAE_ATTN[m.group(1)]}.{leaf}"
    m = re.fullmatch(r"(down|up)_blocks\.(\d+)\.resnets\.(\d+)\.(\w+)", stem)
    if m:
        du, i, j, name = m.groups()
        i = int(i) if du == "down" else 3 - int(i)
        return f"{p}{side}.{du}.{i}.block.{j}.{_L_VAE_RES.get(name, name)}.{leaf}"
    m = re.fullmatch(r"(down|up)_blocks\.(\d+)\.(down|up)samplers\.0\.conv", stem)
    du, i = m.group(1), int(m.group(2))
    return f"{p}{side}.{du}.{i if du == 'down' else 3 - i}.{du}sample.conv.{leaf}"


def _ldm_text_v2(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """open_clip naming: q / k / v fused into in_proj along the out dim."""
    p = "cond_stage_model.model."
    out = {}
    for k, v in state.items():
        m = re.fullmatch(r"encoder\.layers\.(\d+)\.(\w+)\.(\w+)\.(weight|bias)", k)
        if k == "embeddings.token_embedding.weight":
            out[p + "token_embedding.weight"] = v
        elif k == "embeddings.position_embedding.weight":
            out[p + "positional_embedding"] = v
        elif k.startswith("final_layer_norm."):
            out[p + "ln_final." + k.rsplit(".", 1)[1]] = v
        elif m and m.group(3) in ("q_proj", "k_proj", "v_proj"):
            if m.group(3) == "q_proj":
                base = f"encoder.layers.{m.group(1)}.self_attn."
                out[f"{p}transformer.resblocks.{m.group(1)}.attn.in_proj_{m.group(4)}"] = torch.cat(
                    [state[f"{base}{n}.{m.group(4)}"] for n in ("q_proj", "k_proj", "v_proj")])
        elif m:
            name = {("self_attn", "out_proj"): "attn.out_proj", ("mlp", "fc1"): "mlp.c_fc",
                    ("mlp", "fc2"): "mlp.c_proj"}.get((m.group(2), m.group(3)))
            out[f"{p}transformer.resblocks.{m.group(1)}.{name}.{m.group(4)}"] = v
        else:
            ln = re.fullmatch(r"encoder\.layers\.(\d+)\.layer_norm([12])\.(weight|bias)", k)
            out[f"{p}transformer.resblocks.{ln.group(1)}.ln_{ln.group(2)}.{ln.group(3)}"] = v
    return out


def to_ldm(unet: Mapping, vae: Mapping, text: Mapping, *, version: str) -> Dict[str, torch.Tensor]:
    """One CompVis/LDM state dict of the three port state dicts: SD 1.x's
    HF text naming or SD 2.x's open_clip one (and rank-2 proj_in /
    proj_out), with keys a real file carries that the loader skips
    (schedule buffers, EMA copies, open_clip's resblock 23)."""
    v1 = version.startswith("1")
    stages = {int(k.split(".")[2]) for k in unet if k.startswith("decoder.up.")}
    up_attention = {i: any(k.startswith(f"decoder.up.{i}.block.0.1.") for k in unet) for i in stages}
    out = {ldm_unet_key(k, up_attention): (v if v1 or not _is_proj_weight(k) else v[:, :, 0, 0])
           for k, v in unet.items()}
    out.update({ldm_vae_key(k): (v[:, :, None, None] if re.search(
        r"mid_block\.attentions\.0\.(query|key|value|proj_attn)\.weight$", k) else v)
        for k, v in vae.items()})
    if v1:
        out.update({f"cond_stage_model.transformer.text_model.{k}": v for k, v in text.items()})
    else:
        out.update(_ldm_text_v2(text))
    out.update({"alphas_cumprod": torch.ones(1000), "betas": torch.ones(1000),
                "model_ema.decay": torch.tensor(0.9999), "logvar": torch.zeros(1000)})
    if v1:
        out["cond_stage_model.transformer.text_model.embeddings.position_ids"] = torch.arange(77)[None]
    else:
        out.update({"cond_stage_model.model.text_projection": torch.zeros(2, 2),
                    "cond_stage_model.model.logit_scale": torch.tensor(1.0),
                    "cond_stage_model.model.transformer.resblocks.23.ln_1.weight": torch.ones(2)})
    return out


# ---------------------------------------------------------------------------
# kohya LoRA
# ---------------------------------------------------------------------------


def kohya_key(target: str, path: str) -> str:
    """The kohya module name of a port module path."""
    if target == "text_encoder":
        return "lora_te_text_model_" + path.replace(".", "_")
    m = re.fullmatch(r"(encoder\.down|decoder\.up)\.(\d+)\.block\.(\d+)\.1\.(.*)", path)
    if m:
        side = "down_blocks" if m.group(1) == "encoder.down" else "up_blocks"
        head, inner = f"lora_unet_{side}_{m.group(2)}_attentions_{m.group(3)}", m.group(4)
    else:
        head, inner = "lora_unet_mid_block_attentions_0", path.removeprefix("bottleneck.1.")
    return f"{head}_{_d_attn(inner).replace('.', '_')}"


def kohya_state(modules: Mapping[str, torch.nn.Module], paths: Mapping[str, list], *, rank: int,
                alpha: float, seed: int, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A kohya state dict over ``paths`` ({"unet": [...], "text_encoder":
    [...]} module paths of ``modules``): lora_up (out, r[, 1, 1]) and
    lora_down (r, in[, 1, 1]) drawn from ``seed``, and alpha."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for target, ps in paths.items():
        weights = dict(modules[target].named_parameters())
        for path in ps:
            w = weights[f"{path}.weight"]
            tail = tuple(w.shape[2:])
            key = kohya_key(target, path)
            out[f"{key}.lora_up.weight"] = torch.randn((w.shape[0], rank, *tail), generator=gen).to(dtype)
            out[f"{key}.lora_down.weight"] = (torch.randn((rank, w.shape[1], *tail), generator=gen)
                                              / w.shape[1] ** 0.5).to(dtype)
            out[f"{key}.alpha"] = torch.tensor(alpha, dtype=dtype)
    return out


# ---------------------------------------------------------------------------
# a CLIP vocabulary
# ---------------------------------------------------------------------------


def learn_merges(text: str, n: int):
    """Greedy BPE on the byte-mapped pieces of ``text`` (CLIP's symbols, the
    last of a word ending in </w>): the most frequent adjacent pair, ties by
    first appearance, up to ``n`` times."""
    enc = T.bytes_to_unicode()
    words = collections.Counter()
    for piece in T.clip_pattern().findall(T.basic_clean(text)):
        mapped = "".join(enc[b] for b in piece.encode("utf-8"))
        words[tuple(mapped[:-1]) + (mapped[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n):
        pairs = collections.Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: pairs[p])
        merges.append(best)
        merged = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    return merges


def write_vocab(directory: str, n_merges: int = 150, text: str = VOCAB_TEXT):
    """``vocab.json`` and ``merges.txt`` in CLIP's layout: the 256 byte
    symbols, their </w> forms, the merges learned from ``text``, then
    <|startoftext|> and <|endoftext|>.  Returns the merges."""
    os.makedirs(directory, exist_ok=True)
    symbols = list(T.bytes_to_unicode().values())
    merges = learn_merges(text, n_merges)
    vocab = {}
    for t in [*symbols, *(s + "</w>" for s in symbols), *("".join(m) for m in merges),
              "<|startoftext|>", "<|endoftext|>"]:
        vocab.setdefault(t, len(vocab))
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(directory, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    return merges
