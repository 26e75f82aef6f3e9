"""The plain reference of SDXL base 1.0 (Podell et al., arXiv:2307.01952;
stabilityai/stable-diffusion-xl-base-1.0's ``unet/``, ``text_encoder/``,
``text_encoder_2/``, ``vae/`` and ``scheduler/`` configs), in plain
PyTorch, NCHW, float32, in the manner of :mod:`nets` and reusing its layers.

- Text: CLIP ViT-L/14 and OpenCLIP ViT-bigG/14 on the same ids; the
  context is both towers' penultimate hidden states (no final LayerNorm)
  side by side, the pooled state bigG's final LayerNorm of its last
  layer at the EOS token (the first maximum of the ids) through
  ``text_projection`` (no bias).
- UNet: ``transformer_layers_per_block`` transformer blocks at each
  attention site of a stage (the bottleneck at the last stage's depth);
  the time embedding plus ``add_embedding`` (linear_1 -> SiLU ->
  linear_2) of [pooled, the 256-wide cos-then-sin sinusoid of each of the
  six time ids (original h, w, crop top, left, target h, w)].
- The VAE decoder at ``scaling_factor`` (0.13025).
- txt2img: DDIM (eta 0) under classifier-free guidance, epsilon prediction.

Departures from the published description, all of them the benchmark's
configuration (``configs/sdxl.json``'s ``assumed``): DDIM in place of the
default Euler sampler; the same ids to both towers; the unconditional half
the empty prompt's ids through both towers (``force_zeros_for_empty_prompt``
left out); proj_in / proj_out held as 1x1 convolutions (the same product);
the time ids the request's size as original and target size with crop
(0, 0); no refiner.  Parameters are read by the port's key names
(:class:`nets.Params`); ViT-L's last layer and final LayerNorm are never
read, since its penultimate state is all SDXL takes from it.

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from portbench.reference import nets, sampling
from portbench.reference.nets import Ops, Params


# ---------------------------------------------------------------------------
# Text: the two towers
# ---------------------------------------------------------------------------


def _layer_outputs(P: Params, cfg: Mapping, ids: torch.Tensor, ops: Ops, count: int) -> list:
    """The outputs of a CLIP text tower's first ``count`` pre-LN causal layers."""
    e, hid, heads = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_attention_heads"]
    eps = cfg.get("layer_norm_eps", 1e-5)
    act = ((lambda x: x * torch.sigmoid(1.702 * x)) if cfg["hidden_act"] == "quick_gelu"
           else F.gelu)
    emb = P.sub("embeddings")
    tok = emb.sub("token_embedding")("weight", (cfg["vocab_size"], e))
    pos = emb.sub("position_embedding")("weight", (cfg["max_position_embeddings"], e))
    x = tok[ids] + pos[:ids.shape[1]]
    out = []
    for i in range(count):
        L = P.sub(f"encoder.layers.{i}")
        h = nets._layer_norm(L.sub("layer_norm1"), x, e, eps)
        x = x + nets._mha(L.sub("self_attn"), ops, h, None, e, e, heads, qkv_bias=True,
                          causal=True)
        h = nets._layer_norm(L.sub("layer_norm2"), x, e, eps)
        h = act(nets._linear(L.sub("mlp.fc1"), ops, h, e, hid))
        x = x + nets._linear(L.sub("mlp.fc2"), ops, h, hid, e)
        out.append(x)
    return out


def first_argmax(ids: torch.Tensor) -> torch.Tensor:
    """The index of the first maximum of each row (the EOS token)."""
    hit = ids == ids.amax(dim=-1, keepdim=True)
    pos = torch.arange(ids.shape[-1], device=ids.device).expand_as(ids)
    return torch.where(hit, pos, ids.shape[-1]).amin(dim=-1)


def encode_text(P1: Params, P2: Params, cfg: Mapping, ids: torch.Tensor, ops: Ops):
    """(B, 77) ids -> (context (B, 77, D1 + D2), pooled (B, projection_dim))."""
    c1, c2 = cfg["text"], cfg["text_2"]
    h1 = _layer_outputs(P1, c1, ids, ops, c1["num_hidden_layers"] - 1)[-1]
    states = _layer_outputs(P2, c2, ids, ops, c2["num_hidden_layers"])
    e = c2["hidden_size"]
    last = states[-1][torch.arange(ids.shape[0], device=ids.device), first_argmax(ids)]
    pooled = nets._layer_norm(P2.sub("final_layer_norm"), last, e, c2.get("layer_norm_eps", 1e-5))
    pooled = ops.linear(pooled, P2.sub("text_projection")("weight", (c2["projection_dim"], e)))
    return torch.cat([h1, states[-2]], dim=-1), pooled


# ---------------------------------------------------------------------------
# The UNet
# ---------------------------------------------------------------------------


def _transformer(P: Params, ops: Ops, x, ctx, c: int, dctx: int, heads: int, depth: int):
    """GroupNorm -> proj_in -> ``depth`` x [LN -> self-attention, LN ->
    cross-attention, LN -> GeGLU FFN (4C)], each with its residual ->
    proj_out -> + input.  One block is named ``transformer_block``, a
    deeper stack's ``transformer_blocks.{k}``."""
    b, _, hh, ww = x.shape
    res = x
    h = nets._conv(P.sub("conv_input"), ops, nets._group_norm(P.sub("groupnorm"), x, c, 1e-6),
                   c, c, 1)
    t = h.flatten(2).transpose(1, 2)  # (B, HW, C)
    names = ["transformer_block"] if depth == 1 else [f"transformer_blocks.{k}"
                                                      for k in range(depth)]
    for name in names:
        T = P.sub(name)
        t = t + nets._mha(T.sub("attn1"), ops, nets._layer_norm(T.sub("layernorm_1"), t, c), None,
                          c, c, heads, qkv_bias=False)
        t = t + nets._mha(T.sub("attn2"), ops, nets._layer_norm(T.sub("layernorm_2"), t, c), ctx,
                          c, dctx, heads, qkv_bias=False)
        value, gate = nets._linear(T.sub("ffn.0.proj"), ops,
                                   nets._layer_norm(T.sub("layernorm_3"), t, c), c,
                                   8 * c).chunk(2, dim=-1)
        t = t + nets._linear(T.sub("ffn.1"), ops, value * F.gelu(gate), 4 * c, c)
    h = t.transpose(1, 2).reshape(b, c, hh, ww)
    return nets._conv(P.sub("conv_output"), ops, h, c, c, 1) + res


def time_embedding(P: Params, cfg: Mapping, t: torch.Tensor, added: Optional[Mapping], dtype,
                   ops: Ops) -> torch.Tensor:
    """The time embedding, plus ``add_embedding`` of [text_embeds, the time
    ids' sinusoids] where the configuration has the text-time conditioning."""
    t0 = cfg["t_embed_dim"]
    tdim = 4 * t0
    te = P.sub("time_embedding.ffn")
    emb = nets._linear(te.sub("2"), ops, F.silu(nets._linear(
        te.sub("0"), ops, nets.timestep_embedding(t, t0).to(dtype), t0, tdim)), tdim, tdim)
    if cfg.get("addition_embed_type") is None:
        return emb
    ids = added["time_ids"]
    times = nets.timestep_embedding(ids.reshape(-1), cfg["addition_time_embed_dim"])
    a = torch.cat([added["text_embeds"].to(dtype), times.reshape(ids.shape[0], -1).to(dtype)],
                  dim=-1)
    A = P.sub("add_embedding")
    din = cfg["projection_class_embeddings_input_dim"]
    a = nets._linear(A.sub("linear_2"), ops,
                     F.silu(nets._linear(A.sub("linear_1"), ops, a, din, tdim)), tdim, tdim)
    return emb + a


def unet(P: Params, cfg: Mapping, x: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor,
         added: Optional[Mapping], ops: Ops) -> torch.Tensor:
    """x (B, 4, h, w) latents, t (B,) timesteps, ctx (B, 77, D), ``added``
    {"text_embeds": (B, P), "time_ids": (B, 6)} -> the model output (B, 4, h, w)."""
    bc = list(cfg["block_out_channels"])
    n, lpb, eps = len(bc), cfg["layers_per_block"], cfg.get("norm_eps", 1e-5)
    heads = nets._per_stage(cfg["attention_head_dim"], n)  # heads a stage, as the port reads it
    dctx = nets._per_stage(cfg["cross_attention_dim"], n)
    depth = nets._per_stage(cfg.get("transformer_layers_per_block", 1), n)
    attn = tuple(k == "CrossAttnDownBlock2D" for k in cfg["down_block_types"])
    tdim = 4 * cfg["t_embed_dim"]
    temb = time_embedding(P, cfg, t, added, x.dtype, ops)

    def block(B: Params, h, cin, cout, stage):
        h = nets._resblock(B.sub("0"), ops, h, temb, cin, cout, tdim, eps)
        if attn[stage]:
            h = _transformer(B.sub("1"), ops, h, ctx, cout, dctx[stage], heads[stage], depth[stage])
        return h

    h = nets._conv(P.sub("encoder.conv_in"), ops, x, cfg["in_channels"], bc[0], 3)
    skips = [h]
    cin = bc[0]
    for i in range(n):
        S = P.sub(f"encoder.down.{i}")
        for j in range(lpb):
            h = block(S.sub(f"block.{j}"), h, cin, bc[i], i)
            cin = bc[i]
            skips.append(h)
        if i != n - 1:
            h = nets._conv(S.sub("downsample.conv"), ops, h, bc[i], bc[i], 3, stride=2)
            skips.append(h)
    M = P.sub("bottleneck")
    h = nets._resblock(M.sub("0"), ops, h, temb, bc[-1], bc[-1], tdim, eps)
    h = _transformer(M.sub("1"), ops, h, ctx, bc[-1], dctx[-1], heads[-1], depth[-1])
    h = nets._resblock(M.sub("2"), ops, h, temb, bc[-1], bc[-1], tdim, eps)
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
            h = nets._conv(S.sub("upsample.conv"), ops, h, bc[i], bc[i], 3)
    h = F.silu(nets._group_norm(P.sub("output.0"), h, bc[0], eps))
    return nets._conv(P.sub("output.2"), ops, h, bc[0], cfg["out_channels"], 3)


# ---------------------------------------------------------------------------
# The VAE decoder at the configuration's scaling factor
# ---------------------------------------------------------------------------


def vae_decode(P: Params, cfg: Mapping, z: torch.Tensor, ops: Ops) -> torch.Tensor:
    """(B, 4, h, w) scaled latents -> (B, 3, 8h, 8w) images in about [-1, 1]."""
    ch, mult, zc = cfg["base_channels"], list(cfg["ch_mult"]), cfg["latent_channels"]
    eps = cfg.get("norm_eps", 1e-6)
    top = ch * mult[-1]
    z = nets._conv(P.sub("post_quant_conv"), ops, z / cfg["scaling_factor"], zc, zc, 1)
    D = P.sub("decoder")
    h = nets._conv(D.sub("conv_in"), ops, z, zc, top, 3)
    M = D.sub("mid_block")
    h = nets._vae_res(M.sub("resnets.0"), ops, h, top, top, eps)
    h = nets._vae_attention(M.sub("attentions.0"), ops, h, top)
    h = nets._vae_res(M.sub("resnets.1"), ops, h, top, top, eps)
    cin = top
    for u, i in enumerate(reversed(range(len(mult)))):
        U = D.sub(f"up_blocks.{u}")
        cout = ch * mult[i]
        for j in range(3):
            h = nets._vae_res(U.sub(f"resnets.{j}"), ops, h, cin, cout, eps)
            cin = cout
        if i != 0:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = nets._conv(U.sub("upsamplers.0.conv"), ops, h, cout, cout, 3)
    h = F.silu(nets._group_norm(D.sub("conv_norm_out"), h, ch, eps))
    return nets._conv(D.sub("conv_out"), ops, h, ch, cfg["out_channels"], 3)


# ---------------------------------------------------------------------------
# Parameters and txt2img
# ---------------------------------------------------------------------------


def added_cond(pooled: torch.Tensor, size) -> Dict[str, torch.Tensor]:
    """The text-time conditioning of a request at ``size`` (h, w): original
    and target size ``size``, crop (0, 0)."""
    h, w = size
    ids = torch.tensor([[h, w, 0, 0, h, w]], dtype=torch.float32, device=pooled.device)
    return {"text_embeds": pooled, "time_ids": ids.expand(pooled.shape[0], 6)}


def param_shapes(cfg: Mapping) -> Dict[str, Dict[str, tuple]]:
    """{"unet" | "text_encoder" | "text_encoder_2" | "vae": {name: shape}}:
    the parameters the networks read, listed by running them on meta."""
    ops = Ops()
    P1, P2 = Params.recording(), Params.recording()
    ids = torch.zeros((1, 77), dtype=torch.long, device="meta")
    _, pooled = encode_text(P1, P2, cfg, ids, ops)
    out = {"text_encoder": P1.shapes, "text_encoder_2": P2.shapes}
    P = Params.recording()
    u = cfg["unet"]
    dctx = nets._per_stage(u["cross_attention_dim"], len(u["block_out_channels"]))[0]
    added = {"text_embeds": pooled, "time_ids": torch.zeros((1, 6), device="meta")}
    unet(P, u, torch.empty((1, u["in_channels"], 8, 8), device="meta"),
         torch.zeros((1,), dtype=torch.long, device="meta"),
         torch.empty((1, 77, dctx), device="meta"), added, ops)
    out["unet"] = P.shapes
    P = Params.recording()
    vae_decode(P, cfg["vae"], torch.empty((1, cfg["vae"]["latent_channels"], 8, 8),
                                          device="meta"), ops)
    out["vae"] = P.shapes
    return out


@torch.no_grad()
def txt2img(weights: Mapping[str, Mapping], cfg: Mapping, cond_ids, uncond_ids, latents, *,
            steps: int, cfg_scale: float, ops: Ops) -> torch.Tensor:
    """The decode (B, 3, H, W) of a DDIM txt2img request: ``latents`` (B, h,
    w, 4) NHWC start; context and pooled state of [uncond; cond]; eps =
    uncond + s (cond - uncond)."""
    P = {k: Params(v) for k, v in weights.items()}
    dev = latents.device
    ids = torch.cat([torch.as_tensor(uncond_ids), torch.as_tensor(cond_ids)]).to(dev)
    ctx, pooled = encode_text(P["text_encoder"], P["text_encoder_2"], cfg, ids, ops)
    x = latents.to(ctx.dtype).permute(0, 3, 1, 2)
    b = x.shape[0]
    added = added_cond(pooled, (8 * x.shape[2], 8 * x.shape[3]))
    table = sampling.alphas_hat()
    ts, prevs = sampling.ddim_timesteps(steps)
    for t, prev in zip(ts, prevs):
        tt = torch.full((2 * b,), t, dtype=torch.long, device=dev)
        out = unet(P["unet"], cfg["unet"], torch.cat([x, x]), tt, ctx, added, ops)
        uncond, cond = out.chunk(2)
        x = sampling.ddim_step(x, uncond + cfg_scale * (cond - uncond), t, prev, table,
                               cfg["prediction_type"])
    return vae_decode(P["vae"], cfg["vae"], x, ops)
