"""LoRA / DreamBooth training step on the cached frozen encoders (port of
stable_diffusion_tpu/training.py).

* The DreamBooth loss: the batch stacks [instance; class-prior] halves;
  loss = MSE(instance) + prior_loss_weight * MSE(prior), in the prediction's
  dtype.
* The base weights are frozen: the LoRA tree is merged into them inside the
  loss and reaches the models through ``torch.func.functional_call``, so
  gradients flow to the LoRA tree only (``alpha`` included, as in JAX).
* The optimizer is ``optim``'s optax-equivalent chain: MultiSteps(chain(
  clip_by_global_norm, adamw)).  The reported ``grad_norm`` is that of the
  raw micro-step gradient; EMA and ``step`` advance on every call.
* Frozen encoders, cached or not: the batch carries ``latent_mean``/
  ``latent_std`` (from :func:`precompute_latent_moments`) or ``images``
  (encoded by the frozen VAE), each with ``vae_noise``; and ``text_emb``
  or token ids while the text encoder is frozen.

State: ``{"lora": {"unet"[, "text_encoder"]}, "opt_state", "ema", "step"}``
with ``step`` a Python int.  ``base`` is ``{"unet": UNet, "text_encoder":
CLIPTextModel[, "vae": VAE]}`` (the VAE for batches of images).

Across a ("data", "model") mesh (parallel/mesh.py; JAX shards the batch
over "data" and lets GSPMD derive the gradient sums): ``base`` holds the
rank's shards (``shard_module_``), the state is whole and the same on every
rank, and every rank is given the whole batch and keeps its lanes.  A
rank's loss is its lanes' share of the global loss (the squared-error sums
of its instance and prior lanes, each over the global half's element
count), so the loss and the gradients summed over "data" are JAX's; the
gradients of the LoRA entries on sharded targets are first summed over
"model" (each rank's slice of the delta gave its part).  The optimizer,
the clipping and the EMA then see the same sums on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from stable_diffusion_tpu_torch import optim
from stable_diffusion_tpu_torch.models import ema as ema_m
from stable_diffusion_tpu_torch.models import lora as lora_m
from stable_diffusion_tpu_torch.parallel import mesh as pmesh
from stable_diffusion_tpu_torch.schedulers import schedule as S
from stable_diffusion_tpu_torch.utils.device import span
from stable_diffusion_tpu_torch.utils.tree import (global_norm, tree_leaves, tree_map,
                                                   tree_unflatten)

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 1e-2
    rank: int = 128
    alpha: float = 128.0
    prior_loss_weight: float = 1.0
    grad_accum_steps: int = 1
    use_ema: bool = False
    ema_beta: float = 0.995
    ema_start: int = 2000
    max_grad_norm: Optional[float] = 1.0
    gradient_checkpointing: bool = False
    train_text_encoder: bool = False
    lora_targets: tuple = lora_m.DEFAULT_UNET_TARGETS
    lr_schedule: str = "constant"  # constant | constant_with_warmup | cosine
    lr_warmup_steps: int = 0
    lr_total_steps: int = 1000
    use_8bit_adam: bool = False


TEXT_TARGETS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")


def make_optimizer(cfg: TrainConfig) -> optim.Transform:
    lr = optim.make_lr_schedule(cfg.lr_schedule, cfg.learning_rate,
                                warmup_steps=cfg.lr_warmup_steps, total_steps=cfg.lr_total_steps)
    if cfg.use_8bit_adam:
        tx = optim.adamw_8bit(lr, weight_decay=cfg.weight_decay)
    else:
        tx = optim.adamw(lr, weight_decay=cfg.weight_decay)
    if cfg.max_grad_norm:
        tx = optim.chain(optim.clip_by_global_norm(cfg.max_grad_norm), tx)
    if cfg.grad_accum_steps > 1:
        tx = optim.multi_steps(tx, cfg.grad_accum_steps)
    return tx


def init_train_state(generator: torch.Generator, base, cfg: TrainConfig):
    """A fresh LoRA tree (A from ``generator``, B = 0), its optimizer state,
    the EMA and step 0."""
    lora = {"unet": lora_m.init_lora(generator, base["unet"], rank=cfg.rank, alpha=cfg.alpha,
                                     targets=cfg.lora_targets)}
    if cfg.train_text_encoder:
        lora["text_encoder"] = lora_m.init_lora(generator, base["text_encoder"], rank=cfg.rank,
                                                alpha=cfg.alpha, targets=TEXT_TARGETS)
    return {"lora": lora, "opt_state": make_optimizer(cfg).init(lora),
            "ema": ema_m.ema_init(lora) if cfg.use_ema else lora, "step": 0}


def _frozen(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in model.named_parameters()}


def dreambooth_loss(lora, base, batch, *, alphas_hat: torch.Tensor, train_cfg: TrainConfig,
                    prediction_type: str = "epsilon", impl: str = "auto",
                    mesh: Optional[pmesh.Mesh] = None) -> torch.Tensor:
    """batch: "t" (2B,), "noise" (2B,h,w,4), "vae_noise", and "latent_mean"/
    "latent_std" (2B,h,w,4) or "images" (2B,8h,8w,3) in [-1, 1];
    "text_emb" (2B,77,d) or "input_ids" (2B,77).  On a ``mesh`` whose data
    axis is split: the rank's lanes of the batch and its share of the loss."""
    unet, text_encoder = base["unet"], base.get("text_encoder")
    split = mesh is not None and mesh.data > 1
    if split:
        lanes = mesh.lanes(len(batch["t"]))
        batch = {k: v[lanes] for k, v in batch.items()}
    if "text_encoder" in lora:
        params = lora_m.merge_lora(_frozen(text_encoder), lora["text_encoder"], mesh=mesh)
        text_emb = torch.func.functional_call(text_encoder, params, (batch["input_ids"],),
                                              {"impl": impl})
    elif "text_emb" in batch:
        text_emb = batch["text_emb"]
    else:
        with torch.no_grad():
            text_emb = text_encoder(batch["input_ids"], impl=impl)

    if "latent_mean" in batch:
        latents = (batch["latent_mean"] + batch["latent_std"] * batch["vae_noise"]).detach()
    else:  # explicit noise: the unscaled latent, as JAX's training path
        with torch.no_grad():
            latents = base["vae"].encode(batch["images"], noise=batch["vae_noise"], impl=impl)[0]

    x_t = S.forward_process(alphas_hat, latents, batch["t"], batch["noise"])
    params = lora_m.merge_lora(_frozen(unet), lora["unet"], mesh=mesh)
    pred = torch.func.functional_call(
        unet, params, (x_t, batch["t"], text_emb),
        {"impl": impl, "gradient_checkpointing": train_cfg.gradient_checkpointing})
    if prediction_type == "v_prediction":
        target = S.v_prediction_targets(alphas_hat, latents, batch["noise"], batch["t"])
    else:
        target = batch["noise"]
    if split:
        return _lane_share(pred, target, lanes, mesh.data, train_cfg.prior_loss_weight)
    pred_inst, pred_prior = pred.chunk(2, dim=0)
    tgt_inst, tgt_prior = target.chunk(2, dim=0)
    loss_inst = torch.mean((pred_inst - tgt_inst) ** 2)
    loss_prior = torch.mean((pred_prior - tgt_prior) ** 2)
    return loss_inst + train_cfg.prior_loss_weight * loss_prior


def _lane_share(pred, target, lanes: slice, data: int, prior_loss_weight: float):
    """This rank's share of MSE(instance) + w MSE(prior) over the global
    batch: each local lane's squared-error sum (f32) over the element count
    of its global half, w on the prior half's lanes."""
    n = pred.shape[0]
    half = n * data // 2
    index = torch.arange(lanes.start, lanes.start + n, device=pred.device)
    weight = torch.where(index < half, 1.0, prior_loss_weight) / (half * pred[0].numel())
    sums = ((pred - target) ** 2).flatten(1).sum(1, dtype=torch.float32)
    return (sums * weight).sum().to(pred.dtype)


def sum_over_mesh(loss, grads, mesh: Optional[pmesh.Mesh]):
    """(loss, grads) of a rank made the whole batch's on every rank: the
    gradients of the LoRA entries on sharded targets summed over "model",
    then the loss and every gradient summed over "data"."""
    if mesh is None:
        return loss, grads
    keys = [(part, path, k) for part in sorted(grads)
            for path in lora_m.sharded_entries(grads[part], mesh) for k in sorted(grads[part][path])]
    summed = mesh.sum_flat([grads[part][path][k] for part, path, k in keys], pmesh.MODEL_AXIS)
    for (part, path, k), g in zip(keys, summed):
        grads[part][path][k] = g
    flat = mesh.sum_flat([loss, *tree_leaves(grads)], pmesh.DATA_AXIS)
    return flat[0], tree_unflatten(grads, flat[1:])


def loss_and_grad(lora, base, batch, *, mesh: Optional[pmesh.Mesh] = None, **kw):
    """(loss, gradient tree of the LoRA tree), like ``jax.value_and_grad``;
    on a ``mesh``, the whole batch's on every rank (:func:`sum_over_mesh`).

    Every LoRA leaf reaches the loss, so a leaf the graph does not reach
    (a detached weight, a kernel output with no ``grad_fn``) raises here."""
    params = tree_map(lambda t: t.detach().requires_grad_(True), lora)
    loss = dreambooth_loss(params, base, batch, mesh=mesh, **kw)
    with span("backward"):
        grads = torch.autograd.grad(loss, tree_leaves(params))
    return sum_over_mesh(loss.detach(), tree_unflatten(params, grads), mesh)


def make_train_step(base, *, schedule: S.DiffusionSchedule, train_cfg: TrainConfig,
                    impl: str = "auto", mesh: Optional[pmesh.Mesh] = None):
    """(state, batch) -> (state, {"loss", "grad_norm"}).  With ``mesh``,
    ``base`` is sharded on it and every rank is given the whole batch."""
    tx = make_optimizer(train_cfg)
    device = next(base["unet"].parameters()).device
    table = torch.as_tensor(schedule.alphas_hat, device=device)

    def step_fn(state, batch):
        with span("train_step"):
            loss, grads = loss_and_grad(state["lora"], base, batch, alphas_hat=table,
                                        train_cfg=train_cfg,
                                        prediction_type=schedule.prediction_type, impl=impl,
                                        mesh=mesh)
            step = state["step"] + 1
            with span("optimizer"):
                updates, opt_state = tx.update(grads, state["opt_state"], state["lora"])
                lora = optim.apply_updates(state["lora"], updates)
                if train_cfg.use_ema:
                    ema = ema_m.ema_update(state["ema"], lora, step, beta=train_cfg.ema_beta,
                                           start_ema=train_cfg.ema_start)
                else:
                    ema = lora
            new_state = {"lora": lora, "opt_state": opt_state, "ema": ema, "step": step}
            return new_state, {"loss": loss, "grad_norm": global_norm(grads)}

    return step_fn


def make_eval_step(base, *, schedule: S.DiffusionSchedule, train_cfg: TrainConfig,
                   impl: str = "auto", mesh: Optional[pmesh.Mesh] = None):
    """(state, batch) -> the test loss, no update (on a ``mesh``, summed over "data")."""
    device = next(base["unet"].parameters()).device
    table = torch.as_tensor(schedule.alphas_hat, device=device)

    @torch.no_grad()
    def eval_fn(state, batch):
        loss = dreambooth_loss(state["lora"], base, batch, alphas_hat=table, train_cfg=train_cfg,
                               prediction_type=schedule.prediction_type, impl=impl, mesh=mesh)
        return loss if mesh is None else mesh.all_reduce(loss, pmesh.DATA_AXIS)

    return eval_fn


def sample_noise_for_latents(generator: torch.Generator, lat_shape, num_train_timesteps: int = 1000,
                             *, device=None, dtype=torch.float32):
    """(t, eps, vae noise) for a latent shape (b, h, w, z), from ``generator``."""
    device = generator.device if device is None else device
    t = torch.randint(0, num_train_timesteps, (lat_shape[0],), generator=generator,
                      device=generator.device)
    eps = torch.randn(lat_shape, generator=generator, device=generator.device)
    vnoise = torch.randn(lat_shape, generator=generator, device=generator.device)
    return t.to(device), eps.to(device, dtype), vnoise.to(device, dtype)


def sample_batch_noise(generator: torch.Generator, batch_images, latent_factor: int = 8,
                       num_train_timesteps: int = 1000, **kw):
    b, h, w, _ = batch_images.shape
    return sample_noise_for_latents(generator, (b, h // latent_factor, w // latent_factor, 4),
                                    num_train_timesteps, **kw)


@torch.no_grad()
def precompute_latent_moments(vae, images, *, impl: str = "auto", micro_batch: int = 8):
    """The frozen VAE encoder run once over ``images`` (an (N,H,W,3) array
    in [-1, 1], or any indexable sequence of (H,W,3) images, streamed
    ``micro_batch`` at a time): host numpy (mean, std), each (N,h,w,4).
    The last micro-batch is padded with its last image to the fixed shape."""
    p = next(vae.parameters())
    n = len(images)
    mb = min(micro_batch, n)
    means, stds = [], []
    for start in range(0, n, mb):
        chunk = np.stack([np.asarray(images[i]) for i in range(start, min(start + mb, n))])
        pad = mb - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, chunk[-1:].repeat(pad, axis=0)])
        m, s = vae.encode_moments(torch.tensor(chunk, device=p.device, dtype=p.dtype), impl=impl)
        means.append(m.float().cpu().numpy()[: mb - pad])
        stds.append(s.float().cpu().numpy()[: mb - pad])
    return np.concatenate(means), np.concatenate(stds)


@torch.no_grad()
def precompute_text_embedding(text_encoder, input_ids, *, impl: str = "auto", dtype=None):
    """The frozen text tower's output for fixed prompts (B, 77) -> (B, 77, d)."""
    emb = text_encoder(torch.as_tensor(input_ids, device=next(text_encoder.parameters()).device),
                       impl=impl)
    return emb if dtype is None else emb.to(dtype)
