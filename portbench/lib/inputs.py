"""Everything a run feeds the program, made from ``--seed``: the weights
(one large normal draw per network on the device, scaled by each tensor's
role), the LoRA tree, the token ids and starting latents of each request,
and each training micro-step's batch.  The same seed gives the same values
on the program's side and on the reference's."""

from __future__ import annotations

import hashlib
from typing import Dict, Mapping

import numpy as np
import torch

BOS, EOS = 49406, 49407


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of ``seed`` (``seed`` any integer)."""
    text = ":".join(str(x) for x in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def _std(name: str, shape: tuple) -> tuple:
    """(mean, std) of a parameter: embeddings N(0, 1), weights N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    if len(shape) >= 2:
        if "embedding" in name:
            return 0.0, 1.0
        return 0.0, float(np.prod(shape[1:])) ** -0.5
    if name.endswith("bias"):
        return 0.0, 0.1
    return 1.0, 0.1


@torch.no_grad()
def make_weights(shapes: Mapping[str, Mapping[str, tuple]], seed: int, device,
                 dtype=torch.bfloat16) -> Dict[str, Dict[str, torch.Tensor]]:
    """{network: {name: tensor}} in ``dtype``: each network one normal draw
    of all its elements on ``device``, cut into its tensors in sorted name
    order and scaled by :func:`_std`."""
    out = {}
    for net in sorted(shapes):
        names = sorted(shapes[net])
        sizes = [int(np.prod(shapes[net][n])) for n in names]
        flat = torch.randn(sum(sizes), generator=generator(device, seed, "weights", net),
                           device=device)
        tensors, start = {}, 0
        for name, size in zip(names, sizes):
            shape = tuple(shapes[net][name])
            mean, std = _std(name, shape)
            tensors[name] = (flat[start:start + size].view(shape) * std + mean).to(dtype)
            start += size
        del flat
        out[net] = tensors
    return out


def request_ids(seed: int, index: int, batch: int, vocab: int = 49408):
    """(cond, uncond) (B, 77) int64 ids of one request: each cond row BOS,
    5 to 40 tokens drawn from the vocabulary below BOS, EOS, then EOS as
    padding; the uncond rows are the empty prompt (BOS, EOS, padding)."""
    rng = np.random.default_rng(sub_seed(seed, "ids", index))
    cond = np.full((batch, 77), EOS, np.int64)
    cond[:, 0] = BOS
    for r in range(batch):
        n = int(rng.integers(5, 41))
        cond[r, 1:1 + n] = rng.integers(0, min(vocab, BOS), n)
    uncond = np.full((batch, 77), EOS, np.int64)
    uncond[:, 0] = BOS
    return cond, uncond


def request_latents(seed: int, index: int, shape, device, dtype=torch.bfloat16) -> torch.Tensor:
    """The starting latents (B, h, w, 4) of one request, in the served dtype."""
    return torch.randn(shape, generator=generator(device, seed, "latents", index),
                       device=device).to(dtype)


def lora_tree(seed: int, shapes: Mapping[str, tuple], targets, rank: int, alpha: float,
              device) -> Dict[str, Dict[str, torch.Tensor]]:
    """A LoRA tree (f32) on the UNet weights named in ``shapes`` whose
    module path ends with one of ``targets``: A ~ N(0, 1/rank), B ~ N(0,
    0.01/in), so the delta is about a tenth of the weight's scale and
    every leaf, alpha included, has a gradient from the first step."""
    meta = str(device) == "meta"  # shapes alone, for counting FLOPs
    g = None if meta else generator(device, seed, "lora")

    def randn(*shape):
        if meta:
            return torch.empty(shape, device="meta")
        return torch.randn(shape, generator=g, device=device)

    tree = {}
    for key in sorted(shapes):
        path, leaf = key.rsplit(".", 1)
        shape = shapes[key]
        if leaf != "weight" or len(shape) != 2 or not path.endswith(tuple(targets)):
            continue
        out_dim, in_dim = shape
        tree[path] = {
            "lora_A": randn(out_dim, rank) * rank ** -0.5,
            "lora_B": randn(rank, in_dim) * 0.1 * in_dim ** -0.5,
            "alpha": torch.tensor(float(alpha), device=device)}
    return tree


def train_batch(seed: int, index: int, batch: int, latent_hw, ctx_dim: int, device,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """One micro-step's cached-encoder batch: latent moments, VAE noise,
    noise, text embeddings and timesteps, all rows distinct."""
    g = generator(device, seed, "batch", index)
    h, w = latent_hw
    lat = (batch, h, w, 4)
    mean = torch.randn(lat, generator=g, device=device)
    std = torch.nn.functional.softplus(torch.randn(lat, generator=g, device=device))
    out = {"latent_mean": mean, "latent_std": std,
           "vae_noise": torch.randn(lat, generator=g, device=device),
           "noise": torch.randn(lat, generator=g, device=device),
           "text_emb": torch.randn((batch, 77, ctx_dim), generator=g, device=device)}
    out = {k: v.to(dtype) for k, v in out.items()}
    out["t"] = torch.randint(0, 1000, (batch,), generator=g, device=device)
    return out
