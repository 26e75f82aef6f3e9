"""The plain reference of the LoRA DreamBooth train step on cached encoders:
the LoRA merge (delta = A B rank / alpha), the denoising loss of the
[instance; prior] halves, and optax's MultiSteps(chain(clip_by_global_norm,
adamw)) with the EMA beside it, in float32 over nested dicts
``{path: {"lora_A", "lora_B", "alpha"}}``."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping

import numpy as np
import torch

from portbench.reference import nets
from portbench.reference.sampling import alphas_hat


@dataclasses.dataclass(frozen=True)
class Hyper:
    learning_rate: float = 1e-4
    weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    grad_accum_steps: int = 2
    prior_loss_weight: float = 1.0
    ema_beta: float = 0.995
    ema_start: int = 2000
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


def leaves(tree) -> Dict[str, torch.Tensor]:
    """{"path|leaf": tensor} of a LoRA tree."""
    return {f"{p}|{k}": v for p in sorted(tree) for k, v in sorted(tree[p].items())}


def unflatten(flat: Mapping[str, torch.Tensor]):
    tree = {}
    for key, v in flat.items():
        p, k = key.split("|")
        tree.setdefault(p, {})[k] = v
    return tree


def merged(base: Mapping[str, torch.Tensor], lora) -> Dict[str, torch.Tensor]:
    """``base`` with each target's weight + A B * rank / alpha."""
    out = dict(base)
    for path, e in lora.items():
        a, b = e["lora_A"], e["lora_B"]
        key = f"{path}.weight"
        out[key] = out[key] + ((a @ b) * (a.shape[1] / e["alpha"])).reshape(out[key].shape)
    return out


ROWS_PER_BLOCK = 4  # rows a forward and backward at once, so that f32 fits


def loss_rows(weights, unet_cfg, lora, batch, rows: slice, prediction_type: str,
              table: torch.Tensor, ops: nets.Ops) -> torch.Tensor:
    """The sum of squared errors of the model output on ``rows`` of the batch."""
    lat = batch["latent_mean"][rows] + batch["latent_std"][rows] * batch["vae_noise"][rows]
    t, noise = batch["t"][rows], batch["noise"][rows]
    ah = table[t].reshape(-1, 1, 1, 1)
    x_t = ah.sqrt() * lat + (1 - ah).sqrt() * noise
    pred = nets.unet(nets.Params(merged(weights, lora)), unet_cfg, x_t.permute(0, 3, 1, 2), t,
                     batch["text_emb"][rows], ops).permute(0, 2, 3, 1)
    target = noise if prediction_type == "epsilon" else ah.sqrt() * noise - (1 - ah).sqrt() * lat
    return torch.sum((pred - target) ** 2)


def loss_and_grad(weights, unet_cfg, lora, batch, *, hp: Hyper, prediction_type: str,
                  ops: nets.Ops):
    """(loss, {"path|leaf": gradient}): MSE(instance half) + w MSE(prior
    half), the forward and backward run ``ROWS_PER_BLOCK`` rows at a time
    and the gradients summed."""
    table = torch.as_tensor(alphas_hat(), device=batch["t"].device)
    flat = {k: v.detach().clone().requires_grad_(True) for k, v in leaves(lora).items()}
    tree = unflatten(flat)
    n = batch["t"].shape[0] // 2
    per_half = n * batch["noise"][0].numel()  # elements a half's mean is taken over
    total, grads = 0.0, {k: torch.zeros_like(v) for k, v in flat.items()}
    for start, w in ((0, 1.0), (n, hp.prior_loss_weight)):
        for b0 in range(start, start + n, ROWS_PER_BLOCK):
            rows = slice(b0, min(b0 + ROWS_PER_BLOCK, start + n))
            loss = w / per_half * loss_rows(weights, unet_cfg, tree, batch, rows,
                                            prediction_type, table, ops)
            for k, g in zip(flat, torch.autograd.grad(loss, list(flat.values()))):
                grads[k] += g
            total += float(loss.detach()) if loss.device.type != "meta" else 0.0
    return total, grads


def global_norm(flat: Mapping[str, torch.Tensor]) -> float:
    return math.sqrt(sum(float((g.double() ** 2).sum()) for g in flat.values()))


class Trainer:
    """The optimizer state of MultiSteps(chain(clip, adamw)), the EMA and the
    step counter, advanced one micro-step at a time."""

    def __init__(self, lora, hp: Hyper):
        self.hp = hp
        self.params = {k: v.detach().float().clone() for k, v in leaves(lora).items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.acc = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.ema = {k: v.clone() for k, v in self.params.items()}
        self.count = self.mini = self.step = 0

    def update(self, grads: Mapping[str, torch.Tensor]) -> None:
        hp, n = self.hp, self.mini
        self.acc = {k: a + (grads[k] - a) / (n + 1) for k, a in self.acc.items()}
        if n < hp.grad_accum_steps - 1:
            self.mini = n + 1
        else:
            g = self.acc
            norm = global_norm(g)
            if norm >= hp.max_grad_norm:
                g = {k: v / norm * hp.max_grad_norm for k, v in g.items()}
            self.count += 1
            c = self.count
            bc1, bc2 = 1 - hp.b1 ** c, 1 - hp.b2 ** c
            for k, p in self.params.items():
                self.mu[k] = (1 - hp.b1) * g[k] + hp.b1 * self.mu[k]
                self.nu[k] = (1 - hp.b2) * g[k] * g[k] + hp.b2 * self.nu[k]
                u = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + hp.eps)
                self.params[k] = p - hp.learning_rate * (u + hp.weight_decay * p)
            self.acc = {k: torch.zeros_like(v) for k, v in self.acc.items()}
            self.mini = 0
        self.step += 1
        beta = 0.0 if self.step < hp.ema_start else hp.ema_beta
        self.ema = {k: beta * e + (1 - beta) * self.params[k] for k, e in self.ema.items()}

    def lora(self):
        return unflatten(self.params)


def follow(weights, unet_cfg, lora0, batches, *, hp: Hyper, prediction_type: str,
           ops: nets.Ops) -> dict:
    """The reference over ``batches`` from ``lora0``: each step's loss, each
    leaf's norm of the first gradient, and each leaf's norm of the change
    of the parameters and of the EMA after the last step."""
    tr = Trainer(lora0, hp)
    losses, first = [], None
    for batch in batches:
        loss, grads = loss_and_grad(weights, unet_cfg, tr.lora(), batch, hp=hp,
                                    prediction_type=prediction_type, ops=ops)
        losses.append(loss)
        if first is None:
            first = {k: float(g.double().norm()) for k, g in grads.items()}
        tr.update(grads)
    return {"losses": losses, "grad_norms": first, "change_norms": change_norms(lora0, tr.params),
            "ema_change_norms": change_norms(lora0, tr.ema)}


def change_norms(lora0, flat: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's norm of ``flat`` less its value in ``lora0``."""
    start = leaves(lora0)
    return {k: float((v.double() - start[k].double()).norm()) for k, v in flat.items()}


def worst_leaf_gap(prog: Mapping[str, float], ref: Mapping[str, float],
                   keep=None) -> float:
    """max over leaves of |prog - ref| / max(ref of the leaf, median ref leaf)."""
    keys = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)
