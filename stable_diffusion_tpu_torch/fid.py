"""Fréchet Inception Distance (the port's copy of stable_diffusion_tpu/fid.py):

  FID = ||mu_r - mu_f||^2 + Tr(S_r + S_f - 2 (S_r S_f)^{1/2})

The features come from the card (:func:`make_feature_fn`); the statistics
are small (a 2048-d mean and covariance), so the matrix square root runs on
the host in f64 with scipy, as in JAX.

Two backbones:
  * "inception": InceptionV3 pool3 (``models/inception.py``), weights from a
    local torchvision / pytorch-fid state dict;
  * "clip": CLIP-FID (arXiv 2203.06026), the CLIP vision tower's image
    embedding from an HF ``CLIPModel`` directory (the one CLIP score uses),
    its self-attention on K3 on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def feature_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mean (D,), covariance (D, D)), float64."""
    f = np.asarray(feats, np.float64)
    if f.ndim != 2 or f.shape[0] < 2:
        raise ValueError(f"feature_stats needs (N >= 2, D) features, got {f.shape}")
    return f.mean(axis=0), np.cov(f, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians; the covariances are jittered
    by eps * I where the product's square root is not finite."""
    from scipy import linalg

    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    diff = mu1 - mu2

    def _sqrtm(a):
        out = linalg.sqrtm(a)  # scipy >= 1.17 returns the array alone
        return out[0] if isinstance(out, tuple) else out

    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):  # a symmetric PSD product: the imaginary part is noise
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * np.trace(covmean))


def fid_from_features(real_feats: np.ndarray, fake_feats: np.ndarray) -> float:
    mu_r, s_r = feature_stats(real_feats)
    mu_f, s_f = feature_stats(fake_feats)
    return frechet_distance(mu_r, s_r, mu_f, s_f)


def load_clip_model(clip_model_dir: str, *, device="cuda", dtype=None):
    """An HF ``CLIPModel`` directory (``config.json``, ``model.safetensors``)
    -> ``models.clip.CLIPModel`` on ``device`` in ``dtype`` (bf16 on a CUDA
    device, where K3 takes it; f32 elsewhere), read with the port's reader."""
    import json
    import os

    import torch

    from stable_diffusion_tpu_torch.models.clip import CLIPModel
    from stable_diffusion_tpu_torch.utils import safetensors_io

    device = torch.device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    with open(os.path.join(clip_model_dir, "config.json")) as f:
        cfg = json.load(f)
    state = {k: v for k, v in safetensors_io.load_file(
        os.path.join(clip_model_dir, "model.safetensors")).items()
        if not k.endswith("position_ids")}
    model = CLIPModel.from_config(cfg, device=device, dtype=dtype)
    model.load_state_dict(state, strict=True)
    return model.requires_grad_(False)


def make_feature_fn(backbone: str, weights_path: str = "", clip_model_dir: str = "", *,
                    device="cuda", impl: str = "auto"):
    """A (B, H, W, 3) numpy-in-[0, 1] -> (B, D) numpy f32 feature function.

    "inception" needs ``weights_path``; "clip" needs ``clip_model_dir`` and
    resizes to the tower's image size bilinearly (antialiased when it
    downsamples, as ``jax.image.resize``) before CLIP's normalization."""
    import torch

    from stable_diffusion_tpu_torch.models import clip as clip_m
    from stable_diffusion_tpu_torch.models import inception as inc

    if backbone == "inception":
        model = inc.load_inception_params(weights_path, device=device)

        @torch.no_grad()
        def features(images01):
            x = torch.as_tensor(np.asarray(images01, np.float32), device=device)
            return inc.pool3_features(model, x).cpu().numpy()

        return features

    if backbone == "clip":
        model = load_clip_model(clip_model_dir, device=device)
        size = model.vision_config.image_size
        mean = torch.tensor(clip_m.CLIP_MEAN, device=device)
        std = torch.tensor(clip_m.CLIP_STD, device=device)

        @torch.no_grad()
        def features(images01):
            x = torch.as_tensor(np.asarray(images01, np.float32), device=device)
            x = inc.resize_bilinear(x, (size, size))
            return clip_m.clip_image_embed(model, (x - mean) / std, impl=impl).float().cpu().numpy()

        return features

    raise ValueError(f"unknown FID backbone {backbone!r}")
