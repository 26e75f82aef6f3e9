"""Checkpoint loading (port of stable_diffusion_tpu/utils/model_converter.py,
rule for rule): diffusers directories' UNet, VAE and text-encoder files, a
single CompVis/LDM checkpoint (SD 1.x or 2.x), and kohya LoRA files.

Read the tensors (:func:`read_checkpoint`: safetensors through
:mod:`utils.safetensors_io`, anything else through ``torch.load``), rename
each key to the port's module path by the first full-matching rule (the
JAX converter's regexes; strict: an unmatched key raises ``KeyError``), and
apply the per-tensor reshapes (``_as_conv1x1``, ``_squeeze_conv``,
``_chunk3``).  No transposes: the port keeps torch layouts under the JAX
trees' key paths (``utils/weights.py``), so what the JAX converter hands
``from_torch_state_dict`` is already the port's ``state_dict``.  The
loaders return such ``state_dict``s; :func:`load_into` copies one into a
module through ``load_state_dict(strict=True)``, so a missing or extra key
raises, casting to the module's dtype on its device.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import torch
from torch import nn

from stable_diffusion_tpu_torch.utils import safetensors_io

Flat = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# IO
# ---------------------------------------------------------------------------


def read_torch_ckpt(path: str) -> Flat:
    """A ``torch.save``d checkpoint, its ``state_dict`` when it has one.
    Unpickling runs code from the file (``weights_only=False``, as the JAX
    converter reads LDM checkpoints): load only files you trust."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.detach() for k, v in sd.items() if isinstance(v, torch.Tensor)}


def read_checkpoint(path: str) -> Flat:
    if path.endswith(".safetensors"):
        return safetensors_io.load_file(path)
    return read_torch_ckpt(path)


def load_into(module: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy ``state_dict`` into ``module`` in place (strict: a missing or
    extra key raises); each tensor is cast to the parameter's dtype by
    ``copy_`` on the parameter's device."""
    module.load_state_dict(state_dict, strict=True)
    return module


# ---------------------------------------------------------------------------
# Rule engine
# ---------------------------------------------------------------------------

Rule = Tuple[re.Pattern, str, Optional[Callable[[torch.Tensor], torch.Tensor]]]


def _compile(rules: Iterable[Tuple]) -> List[Rule]:
    return [(re.compile(r[0]), r[1], r[2] if len(r) > 2 else None) for r in rules]


def remap(flat: Mapping[str, torch.Tensor], rules: List[Rule]) -> Flat:
    """Apply the first full-matching rule to each key.  Unmatched keys raise,
    so no weight is dropped silently."""
    out: Flat = {}
    unmatched = []
    for key, val in flat.items():
        for pat, repl, fn in rules:
            m = pat.fullmatch(key)
            if m:
                out[m.expand(repl)] = fn(val) if fn else val
                break
        else:
            unmatched.append(key)
    if unmatched:
        raise KeyError(f"{len(unmatched)} unmatched keys, e.g. {unmatched[:5]}")
    return out


def _as_conv1x1(w: torch.Tensor) -> torch.Tensor:
    """A rank-2 linear (out, in) -> a 1x1 conv OIHW (SD2.1's
    ``use_linear_projection`` proj_in / proj_out)."""
    return w[:, :, None, None] if w.dim() == 2 else w


def _squeeze_conv(w: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv OIHW -> a linear (out, in) (the CompVis VAE's attention)."""
    return w.reshape(w.shape[0], w.shape[1]) if w.dim() == 4 else w


def _chunk3(idx: int):
    """The ``idx``-th third of a fused q/k/v tensor along its out dim."""
    def fn(w: torch.Tensor) -> torch.Tensor:
        return torch.chunk(w, 3, dim=0)[idx]

    return fn


# ---------------------------------------------------------------------------
# Diffusers UNet
# ---------------------------------------------------------------------------

_RES_MAP = {
    "norm1": "groupnorm_1",
    "conv1": "conv_1",
    "time_emb_proj": "t_embed",
    "norm2": "groupnorm_2",
    "conv2": "conv_2",
    "conv_shortcut": "proj_input",
}


def _shift_groups(repl: str, by: int) -> str:
    """A replacement's group references moved up by ``by`` (the inner rules
    sit behind two groups of the outer pattern)."""
    return re.sub(r"\\(\d)", lambda m: "\\" + str(int(m.group(1)) + by), repl)


def _unet_rules() -> List[Rule]:
    attn_inner = [
        (r"norm\.(weight|bias)", r"groupnorm.\1", None),
        (r"proj_in\.weight", r"conv_input.weight", _as_conv1x1),
        (r"proj_in\.bias", r"conv_input.bias", None),
        (r"proj_out\.weight", r"conv_output.weight", _as_conv1x1),
        (r"proj_out\.bias", r"conv_output.bias", None),
        (r"transformer_blocks\.(\d+)\.norm1\.(weight|bias)", r"transformer_blocks.\1.layernorm_1.\2", None),
        (r"transformer_blocks\.(\d+)\.norm2\.(weight|bias)", r"transformer_blocks.\1.layernorm_2.\2", None),
        (r"transformer_blocks\.(\d+)\.norm3\.(weight|bias)", r"transformer_blocks.\1.layernorm_3.\2", None),
        (r"transformer_blocks\.(\d+)\.attn(\d)\.to_q\.(weight|bias)", r"transformer_blocks.\1.attn\2.q_proj.\3", None),
        (r"transformer_blocks\.(\d+)\.attn(\d)\.to_k\.(weight|bias)", r"transformer_blocks.\1.attn\2.k_proj.\3", None),
        (r"transformer_blocks\.(\d+)\.attn(\d)\.to_v\.(weight|bias)", r"transformer_blocks.\1.attn\2.v_proj.\3", None),
        (r"transformer_blocks\.(\d+)\.attn(\d)\.to_out\.0\.(weight|bias)", r"transformer_blocks.\1.attn\2.out_proj.\3", None),
        (r"transformer_blocks\.(\d+)\.ff\.net\.0\.proj\.(weight|bias)", r"transformer_blocks.\1.ffn.0.proj.\2", None),
        (r"transformer_blocks\.(\d+)\.ff\.net\.2\.(weight|bias)", r"transformer_blocks.\1.ffn.1.\2", None),
    ]
    rules: List[Tuple] = [
        (r"time_embedding\.linear_1\.(weight|bias)", r"time_embedding.ffn.0.\1"),
        (r"time_embedding\.linear_2\.(weight|bias)", r"time_embedding.ffn.2.\1"),
        (r"add_embedding\.(linear_[12])\.(weight|bias)", r"add_embedding.\1.\2"),
        (r"conv_in\.(weight|bias)", r"encoder.conv_in.\1"),
        (r"conv_norm_out\.(weight|bias)", r"output.0.\1"),
        (r"conv_out\.(weight|bias)", r"output.2.\1"),
        (r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(weight|bias)", r"encoder.down.\1.downsample.conv.\2"),
        (r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(weight|bias)", r"decoder.up.\1.upsample.conv.\2"),
    ]
    for name, target in _RES_MAP.items():
        rules += [
            (rf"down_blocks\.(\d+)\.resnets\.(\d+)\.{name}\.(weight|bias)",
             rf"encoder.down.\1.block.\2.0.{target}.\3"),
            (rf"up_blocks\.(\d+)\.resnets\.(\d+)\.{name}\.(weight|bias)",
             rf"decoder.up.\1.block.\2.0.{target}.\3"),
            (rf"mid_block\.resnets\.0\.{name}\.(weight|bias)", rf"bottleneck.0.{target}.\1"),
            (rf"mid_block\.resnets\.1\.{name}\.(weight|bias)", rf"bottleneck.2.{target}.\1"),
        ]
    for pat, repl, fn in attn_inner:
        rules += [
            (rf"down_blocks\.(\d+)\.attentions\.(\d+)\.{pat}",
             r"encoder.down.\1.block.\2.1." + _shift_groups(repl, 2), fn),
            (rf"up_blocks\.(\d+)\.attentions\.(\d+)\.{pat}",
             r"decoder.up.\1.block.\2.1." + _shift_groups(repl, 2), fn),
            (rf"mid_block\.attentions\.0\.{pat}", "bottleneck.1." + repl, fn),
        ]
    return _compile(rules)


_UNET_RULES = _unet_rules()


_STACK = re.compile(r"(.*\.)transformer_blocks\.(\d+)\.(.*)")


def _single_blocks(flat: Flat) -> Flat:
    """A transformer whose checkpoint holds block 0 alone is the port's
    depth-1 ``Transformer``: its ``transformer_blocks.0.*`` become
    ``transformer_block.*``; deeper stacks keep ``transformer_blocks.{k}``."""
    deep = {m.group(1) for k in flat if (m := _STACK.fullmatch(k)) and m.group(2) != "0"}
    out: Flat = {}
    for k, v in flat.items():
        m = _STACK.fullmatch(k)
        if m and m.group(1) not in deep:
            k = f"{m.group(1)}transformer_block.{m.group(3)}"
        out[k] = v
    return out


def convert_unet_diffusers(flat: Mapping[str, torch.Tensor]) -> Flat:
    """A diffusers UNet state dict (SD1.5's conv or SD2.1's and SDXL's
    linear proj_in / proj_out; SDXL's deeper transformer stacks and
    ``add_embedding``) -> the port's ``UNet`` state dict."""
    return _single_blocks(remap(flat, _UNET_RULES))


def load_unet_diffusers(path: str) -> Flat:
    return convert_unet_diffusers(read_checkpoint(path))


# ---------------------------------------------------------------------------
# Diffusers VAE and text encoder
# ---------------------------------------------------------------------------

_VAE_SWIFTBRUSH_RULES = _compile([
    (r"(encoder|decoder)\.mid_block\.attentions\.0\.to_q\.(weight|bias)", r"\1.mid_block.attentions.0.query.\2"),
    (r"(encoder|decoder)\.mid_block\.attentions\.0\.to_k\.(weight|bias)", r"\1.mid_block.attentions.0.key.\2"),
    (r"(encoder|decoder)\.mid_block\.attentions\.0\.to_v\.(weight|bias)", r"\1.mid_block.attentions.0.value.\2"),
    (r"(encoder|decoder)\.mid_block\.attentions\.0\.to_out\.0\.(weight|bias)", r"\1.mid_block.attentions.0.proj_attn.\2"),
    (r"(.*)", r"\1"),
])


def convert_vae_diffusers(flat: Mapping[str, torch.Tensor]) -> Flat:
    """The stock diffusers VAE naming is the port's; newer files
    ("swiftbrush") name the mid attention to_q / to_k / to_v / to_out.0."""
    return remap(flat, _VAE_SWIFTBRUSH_RULES)


def load_vae_diffusers(path: str) -> Flat:
    return convert_vae_diffusers(read_checkpoint(path))


def convert_text_encoder_diffusers(flat: Mapping[str, torch.Tensor]) -> Flat:
    """HF ``CLIPTextModel`` naming is the port's under ``text_model.``: strip
    that root and drop ``position_ids`` (a buffer, not a weight).
    ``CLIPTextModelWithProjection``'s ``text_projection`` (SDXL's
    ``text_encoder_2/``) keeps its name."""
    out = {}
    for k, v in flat.items():
        if k.split(".")[-1] == "position_ids":
            continue
        out[k[len("text_model."):] if k.startswith("text_model.") else k] = v
    return out


def load_text_encoder_diffusers(path: str) -> Flat:
    return convert_text_encoder_diffusers(read_checkpoint(path))


# ---------------------------------------------------------------------------
# A single CompVis/LDM checkpoint (SD 1.x and 2.x)
# ---------------------------------------------------------------------------

_LDM_SKIP = [re.compile(p) for p in (
    r"model_ema\..*", r"alphas_cumprod.*", r"betas", r"alphas.*", r"sqrt_.*",
    r"log_one_minus.*", r"posterior_.*", r"v_posterior.*", r".*\.num_batches_tracked",
    r"cond_stage_model\.model\.text_projection", r"cond_stage_model\.model\.logit_scale",
    r"cond_stage_model\.transformer\.text_model\.embeddings\.position_ids",
    r"first_stage_model\.loss\..*", r"logvar",
    # open_clip ships 24 resblocks; SD2.1 conditions on the penultimate, so
    # the 23-layer tower has no use for resblock 23
    r"cond_stage_model\.model\.transformer\.resblocks\.23\..*",
    r"model\.diffusion_model\.label_emb\..*",
)]


def _ldm_unet_rules() -> List[Rule]:
    p = r"model\.diffusion_model\."
    res_inner = [
        (r"in_layers\.0", "groupnorm_1", None),
        (r"in_layers\.2", "conv_1", None),
        (r"emb_layers\.1", "t_embed", None),
        (r"out_layers\.0", "groupnorm_2", None),
        (r"out_layers\.3", "conv_2", None),
        (r"skip_connection", "proj_input", None),
    ]
    attn_inner = [
        (r"norm", "groupnorm", None),
        (r"proj_in", "conv_input", _as_conv1x1),
        (r"proj_out", "conv_output", _as_conv1x1),
        (r"transformer_blocks\.0\.norm1", "transformer_block.layernorm_1", None),
        (r"transformer_blocks\.0\.norm2", "transformer_block.layernorm_2", None),
        (r"transformer_blocks\.0\.norm3", "transformer_block.layernorm_3", None),
        (r"transformer_blocks\.0\.attn1\.to_q", "transformer_block.attn1.q_proj", None),
        (r"transformer_blocks\.0\.attn1\.to_k", "transformer_block.attn1.k_proj", None),
        (r"transformer_blocks\.0\.attn1\.to_v", "transformer_block.attn1.v_proj", None),
        (r"transformer_blocks\.0\.attn1\.to_out\.0", "transformer_block.attn1.out_proj", None),
        (r"transformer_blocks\.0\.attn2\.to_q", "transformer_block.attn2.q_proj", None),
        (r"transformer_blocks\.0\.attn2\.to_k", "transformer_block.attn2.k_proj", None),
        (r"transformer_blocks\.0\.attn2\.to_v", "transformer_block.attn2.v_proj", None),
        (r"transformer_blocks\.0\.attn2\.to_out\.0", "transformer_block.attn2.out_proj", None),
        (r"transformer_blocks\.0\.ff\.net\.0\.proj", "transformer_block.ffn.0.proj", None),
        (r"transformer_blocks\.0\.ff\.net\.2", "transformer_block.ffn.1", None),
    ]
    rules: List[Tuple] = [
        (p + r"time_embed\.0\.(weight|bias)", r"unet.time_embedding.ffn.0.\1"),
        (p + r"time_embed\.2\.(weight|bias)", r"unet.time_embedding.ffn.2.\1"),
        (p + r"input_blocks\.0\.0\.(weight|bias)", r"unet.encoder.conv_in.\1"),
        (p + r"out\.0\.(weight|bias)", r"unet.output.0.\1"),
        (p + r"out\.2\.(weight|bias)", r"unet.output.2.\1"),
    ]
    # encoder: input_blocks n = 1..11 hold stage (n-1)//3, block (n-1)%3;
    # n = 3, 6, 9 are the downsamplers
    for n in range(1, 12):
        i, j = (n - 1) // 3, (n - 1) % 3
        if j == 2:
            rules.append((p + rf"input_blocks\.{n}\.0\.op\.(weight|bias)",
                          rf"unet.encoder.down.{i}.downsample.conv.\1"))
            continue
        for pat, tgt, fn in res_inner:
            rules.append((p + rf"input_blocks\.{n}\.0\.{pat}\.(weight|bias)",
                          rf"unet.encoder.down.{i}.block.{j}.0.{tgt}.\1", fn))
        for pat, tgt, fn in attn_inner:
            rules.append((p + rf"input_blocks\.{n}\.1\.{pat}\.(weight|bias)",
                          rf"unet.encoder.down.{i}.block.{j}.1.{tgt}.\1", fn))
    for pat, tgt, fn in res_inner:
        rules.append((p + rf"middle_block\.0\.{pat}\.(weight|bias)", rf"unet.bottleneck.0.{tgt}.\1", fn))
        rules.append((p + rf"middle_block\.2\.{pat}\.(weight|bias)", rf"unet.bottleneck.2.{tgt}.\1", fn))
    for pat, tgt, fn in attn_inner:
        rules.append((p + rf"middle_block\.1\.{pat}\.(weight|bias)", rf"unet.bottleneck.1.{tgt}.\1", fn))
    # decoder: output_blocks n = 0..11 hold stage n//3, block n%3; the
    # upsampler closing stages 0..2 sits at module index 1 (no attention) or 2
    for n in range(12):
        i, j = n // 3, n % 3
        for pat, tgt, fn in res_inner:
            rules.append((p + rf"output_blocks\.{n}\.0\.{pat}\.(weight|bias)",
                          rf"unet.decoder.up.{i}.block.{j}.0.{tgt}.\1", fn))
        for pat, tgt, fn in attn_inner:
            rules.append((p + rf"output_blocks\.{n}\.1\.{pat}\.(weight|bias)",
                          rf"unet.decoder.up.{i}.block.{j}.1.{tgt}.\1", fn))
        if j == 2 and i < 3:
            rules.append((p + rf"output_blocks\.{n}\.[12]\.conv\.(weight|bias)",
                          rf"unet.decoder.up.{i}.upsample.conv.\1"))
    return _compile(rules)


def _ldm_vae_rules() -> List[Rule]:
    p = r"first_stage_model\."
    rules: List[Tuple] = [
        (p + r"quant_conv\.(weight|bias)", r"vae.quant_conv.\1"),
        (p + r"post_quant_conv\.(weight|bias)", r"vae.post_quant_conv.\1"),
    ]
    for side in ("encoder", "decoder"):
        sp = p + side + r"\."
        t = f"vae.{side}."
        rules += [
            (sp + r"conv_in\.(weight|bias)", t + r"conv_in.\1"),
            (sp + r"conv_out\.(weight|bias)", t + r"conv_out.\1"),
            (sp + r"norm_out\.(weight|bias)", t + r"conv_norm_out.\1"),
            (sp + r"mid\.block_1\.(norm1|conv1|norm2|conv2)\.(weight|bias)", t + r"mid_block.resnets.0.\1.\2"),
            (sp + r"mid\.block_2\.(norm1|conv1|norm2|conv2)\.(weight|bias)", t + r"mid_block.resnets.1.\1.\2"),
            (sp + r"mid\.block_1\.nin_shortcut\.(weight|bias)", t + r"mid_block.resnets.0.conv_shortcut.\1"),
            (sp + r"mid\.block_2\.nin_shortcut\.(weight|bias)", t + r"mid_block.resnets.1.conv_shortcut.\1"),
            (sp + r"mid\.attn_1\.norm\.(weight|bias)", t + r"mid_block.attentions.0.group_norm.\1"),
            (sp + r"mid\.attn_1\.(?:q|to_q)\.(weight|bias)", t + r"mid_block.attentions.0.query.\1", _squeeze_conv),
            (sp + r"mid\.attn_1\.(?:k|to_k)\.(weight|bias)", t + r"mid_block.attentions.0.key.\1", _squeeze_conv),
            (sp + r"mid\.attn_1\.(?:v|to_v)\.(weight|bias)", t + r"mid_block.attentions.0.value.\1", _squeeze_conv),
            (sp + r"mid\.attn_1\.(?:proj_out|to_out\.0)\.(weight|bias)", t + r"mid_block.attentions.0.proj_attn.\1", _squeeze_conv),
        ]
    rules += [
        (p + r"encoder\.down\.(\d+)\.block\.(\d+)\.(norm1|conv1|norm2|conv2)\.(weight|bias)",
         r"vae.encoder.down_blocks.\1.resnets.\2.\3.\4"),
        (p + r"encoder\.down\.(\d+)\.block\.(\d+)\.nin_shortcut\.(weight|bias)",
         r"vae.encoder.down_blocks.\1.resnets.\2.conv_shortcut.\3"),
        (p + r"encoder\.down\.(\d+)\.downsample\.conv\.(weight|bias)",
         r"vae.encoder.down_blocks.\1.downsamplers.0.conv.\2"),
    ]
    # the CompVis decoder counts its stages upwards (up.3 runs first); the
    # port's up_blocks.0 is the deepest
    for c in range(4):
        ours = 3 - c
        rules += [
            (p + rf"decoder\.up\.{c}\.block\.(\d+)\.(norm1|conv1|norm2|conv2)\.(weight|bias)",
             rf"vae.decoder.up_blocks.{ours}.resnets.\1.\2.\3"),
            (p + rf"decoder\.up\.{c}\.block\.(\d+)\.nin_shortcut\.(weight|bias)",
             rf"vae.decoder.up_blocks.{ours}.resnets.\1.conv_shortcut.\2"),
            (p + rf"decoder\.up\.{c}\.upsample\.conv\.(weight|bias)",
             rf"vae.decoder.up_blocks.{ours}.upsamplers.0.conv.\1"),
        ]
    return _compile(rules)


def _ldm_text_rules_v1() -> List[Rule]:
    """SD 1.x: ``cond_stage_model.transformer.text_model.*`` is HF naming."""
    return _compile([(r"cond_stage_model\.transformer\.text_model\.(.*)", r"text_encoder.\1")])


def _ldm_text_rules_v2() -> List[Rule]:
    """SD 2.x: ``cond_stage_model.model.*`` is open_clip naming; the fused
    ``attn.in_proj`` splits into q / k / v (thirds of its out dim)."""
    p = r"cond_stage_model\.model\."
    t = "text_encoder."
    rules: List[Tuple] = [
        (p + r"token_embedding\.weight", t + "embeddings.token_embedding.weight"),
        (p + r"positional_embedding", t + "embeddings.position_embedding.weight"),
        (p + r"ln_final\.(weight|bias)", t + r"final_layer_norm.\1"),
        (p + r"transformer\.resblocks\.(\d+)\.ln_1\.(weight|bias)", t + r"encoder.layers.\1.layer_norm1.\2"),
        (p + r"transformer\.resblocks\.(\d+)\.ln_2\.(weight|bias)", t + r"encoder.layers.\1.layer_norm2.\2"),
        (p + r"transformer\.resblocks\.(\d+)\.attn\.out_proj\.(weight|bias)", t + r"encoder.layers.\1.self_attn.out_proj.\2"),
        (p + r"transformer\.resblocks\.(\d+)\.mlp\.c_fc\.(weight|bias)", t + r"encoder.layers.\1.mlp.fc1.\2"),
        (p + r"transformer\.resblocks\.(\d+)\.mlp\.c_proj\.(weight|bias)", t + r"encoder.layers.\1.mlp.fc2.\2"),
    ]
    for idx, name in enumerate(("q_proj", "k_proj", "v_proj")):
        rules.append((p + r"transformer\.resblocks\.(\d+)\.attn\.in_proj_weight",
                      t + rf"encoder.layers.\1.self_attn.{name}.weight", _chunk3(idx)))
        rules.append((p + r"transformer\.resblocks\.(\d+)\.attn\.in_proj_bias",
                      t + rf"encoder.layers.\1.self_attn.{name}.bias", _chunk3(idx)))
    return _compile(rules)


_LDM_RULES = (_ldm_unet_rules(), _ldm_vae_rules(), _ldm_text_rules_v1(), _ldm_text_rules_v2())


def convert_ldm_checkpoint(flat: Mapping[str, torch.Tensor]) -> Dict[str, Flat]:
    """A CompVis/LDM state dict -> ``{"unet", "vae", "text_encoder"}`` state
    dicts of the port's modules.  Both text namings are taken whatever the
    version (open_clip's ``cond_stage_model.model.*`` and HF's
    ``cond_stage_model.transformer.*``).  A fused ``in_proj`` hits all three
    of its q / k / v rules; every other key stops at its first."""
    out: Flat = {}
    unmatched = []
    for key, val in flat.items():
        if any(s.fullmatch(key) for s in _LDM_SKIP):
            continue
        fused = "in_proj" in key
        hits = 0
        for rules in _LDM_RULES:
            for pat, repl, fn in rules:
                m = pat.fullmatch(key)
                if m:
                    out[m.expand(repl)] = fn(val) if fn else val
                    hits += 1
                    if not fused:
                        break
            if hits and not fused:
                break
        if not hits:
            unmatched.append(key)
    if unmatched:
        raise KeyError(f"{len(unmatched)} unmatched LDM keys, e.g. {unmatched[:8]}")
    split: Dict[str, Flat] = {"unet": {}, "vae": {}, "text_encoder": {}}
    for k, v in out.items():
        root, rest = k.split(".", 1)
        split[root][rest] = v
    return split


def load_ldm_checkpoint(path: str) -> Dict[str, Flat]:
    return convert_ldm_checkpoint(read_checkpoint(path))


# ---------------------------------------------------------------------------
# kohya LoRA safetensors
# ---------------------------------------------------------------------------

_KOHYA_UNET = _compile([
    (r"lora_unet_down_blocks_(\d+)_attentions_(\d+)_transformer_blocks_0_attn(\d)_to_(q|k|v)",
     r"encoder.down.\1.block.\2.1.transformer_block.attn\3.\4_proj"),
    (r"lora_unet_down_blocks_(\d+)_attentions_(\d+)_transformer_blocks_0_attn(\d)_to_out_0",
     r"encoder.down.\1.block.\2.1.transformer_block.attn\3.out_proj"),
    (r"lora_unet_down_blocks_(\d+)_attentions_(\d+)_transformer_blocks_0_ff_net_0_proj",
     r"encoder.down.\1.block.\2.1.transformer_block.ffn.0.proj"),
    (r"lora_unet_down_blocks_(\d+)_attentions_(\d+)_transformer_blocks_0_ff_net_2",
     r"encoder.down.\1.block.\2.1.transformer_block.ffn.1"),
    (r"lora_unet_down_blocks_(\d+)_attentions_(\d+)_proj_in", r"encoder.down.\1.block.\2.1.conv_input"),
    # some kohya exports name the attention-level proj_out "out_proj"
    (r"lora_unet_down_blocks_(\d+)_attentions_(\d+)_(?:proj_out|out_proj)", r"encoder.down.\1.block.\2.1.conv_output"),
    (r"lora_unet_up_blocks_(\d+)_attentions_(\d+)_transformer_blocks_0_attn(\d)_to_(q|k|v)",
     r"decoder.up.\1.block.\2.1.transformer_block.attn\3.\4_proj"),
    (r"lora_unet_up_blocks_(\d+)_attentions_(\d+)_transformer_blocks_0_attn(\d)_to_out_0",
     r"decoder.up.\1.block.\2.1.transformer_block.attn\3.out_proj"),
    (r"lora_unet_up_blocks_(\d+)_attentions_(\d+)_transformer_blocks_0_ff_net_0_proj",
     r"decoder.up.\1.block.\2.1.transformer_block.ffn.0.proj"),
    (r"lora_unet_up_blocks_(\d+)_attentions_(\d+)_transformer_blocks_0_ff_net_2",
     r"decoder.up.\1.block.\2.1.transformer_block.ffn.1"),
    (r"lora_unet_up_blocks_(\d+)_attentions_(\d+)_proj_in", r"decoder.up.\1.block.\2.1.conv_input"),
    (r"lora_unet_up_blocks_(\d+)_attentions_(\d+)_(?:proj_out|out_proj)", r"decoder.up.\1.block.\2.1.conv_output"),
    (r"lora_unet_mid_block_attentions_0_transformer_blocks_0_attn(\d)_to_(q|k|v)",
     r"bottleneck.1.transformer_block.attn\1.\2_proj"),
    (r"lora_unet_mid_block_attentions_0_transformer_blocks_0_attn(\d)_to_out_0",
     r"bottleneck.1.transformer_block.attn\1.out_proj"),
    (r"lora_unet_mid_block_attentions_0_transformer_blocks_0_ff_net_0_proj",
     r"bottleneck.1.transformer_block.ffn.0.proj"),
    (r"lora_unet_mid_block_attentions_0_transformer_blocks_0_ff_net_2",
     r"bottleneck.1.transformer_block.ffn.1"),
    (r"lora_unet_mid_block_attentions_0_proj_in", r"bottleneck.1.conv_input"),
    (r"lora_unet_mid_block_attentions_0_(?:proj_out|out_proj)", r"bottleneck.1.conv_output"),
])

_KOHYA_TEXT = _compile([
    (r"lora_te_text_model_encoder_layers_(\d+)_self_attn_(q|k|v|out)_proj",
     r"encoder.layers.\1.self_attn.\2_proj"),
    (r"lora_te_text_model_encoder_layers_(\d+)_mlp_fc(\d)", r"encoder.layers.\1.mlp.fc\2"),
])


def load_lora_kohya(path: str, *, reference_scale_convention: bool = False) -> Dict[str, Dict]:
    """A kohya LoRA safetensors file -> ``{"unet": tree, "text_encoder":
    tree}``, each ``{module path: {"lora_A" (out, r[, 1, 1]), "lora_B" (r,
    in[, 1, 1]), "alpha"}}`` in ``models/lora.py``'s form.

    kohya scales a delta by alpha / rank; ``models/lora.py`` by rank /
    alpha (the reference's inverted convention), so the ``alpha`` leaf holds
    rank^2 / alpha_kohya, and the merge gives kohya's delta.
    ``reference_scale_convention=True`` stores the file's alpha as it is,
    as the reference loader does."""
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, val in read_checkpoint(path).items():
        if key.endswith(".alpha"):
            base, leaf = key[: -len(".alpha")], "alpha"
        else:  # <module>.lora_up.weight / <module>.lora_down.weight
            base, mid, last = key.rsplit(".", 2)
            leaf = f"{mid}.{last}"
        groups.setdefault(base, {})[leaf] = val

    out: Dict[str, Dict] = {"unet": {}, "text_encoder": {}}
    unmatched = []
    for base, tensors in groups.items():
        target, rules = (("unet", _KOHYA_UNET) if base.startswith("lora_unet_")
                         else ("text_encoder", _KOHYA_TEXT))
        for pat, repl, _ in rules:
            m = pat.fullmatch(base)
            if m:
                up, down = tensors["lora_up.weight"], tensors["lora_down.weight"]
                rank = down.shape[0]
                alpha = float(tensors["alpha"]) if "alpha" in tensors else float(rank)
                if not reference_scale_convention:
                    alpha = rank * rank / alpha
                out[target][m.expand(repl)] = {"lora_A": up, "lora_B": down,
                                               "alpha": torch.tensor(alpha, dtype=torch.float32)}
                break
        else:
            unmatched.append(base)
    if unmatched:
        raise KeyError(f"{len(unmatched)} unmatched kohya LoRA keys, e.g. {unmatched[:5]}")
    return out
