"""InceptionV3 pool3 features for FID (port of
stable_diffusion_tpu/models/inception.py): torchvision's InceptionV3 layer
graph with pytorch-fid's deviations under ``fid_variant`` (the avg pools in
the blocks leave the padding out of the count; Mixed_7c's pool branch is a
max pool).

The module's key names are torchvision's (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch1x1.bn.running_mean``, ...), so a torchvision or
pytorch-fid state dict loads as it is (:func:`load_inception_params`).  The
convs are plain ``F.conv2d``, as JAX computes them in XLA; the tower runs
in f32 (NCHW inside, NHWC at the edges).

``pool3_features`` resizes to 299x299 bilinearly as ``jax.image.resize``
does: antialiased when it downsamples (JAX's default, whatever the JAX
docstring says), then maps [0, 1] to [-1, 1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3

# Every BasicConv2d in the tower: name -> (cin, cout, (kh, kw), stride, (ph, pw))
_STEM = {
    "Conv2d_1a_3x3": (3, 32, (3, 3), 2, (0, 0)),
    "Conv2d_2a_3x3": (32, 32, (3, 3), 1, (0, 0)),
    "Conv2d_2b_3x3": (32, 64, (3, 3), 1, (1, 1)),
    "Conv2d_3b_1x1": (64, 80, (1, 1), 1, (0, 0)),
    "Conv2d_4a_3x3": (80, 192, (3, 3), 1, (0, 0)),
}


def _inception_a(cin, pool_features):
    return {
        "branch1x1": (cin, 64, (1, 1), 1, (0, 0)),
        "branch5x5_1": (cin, 48, (1, 1), 1, (0, 0)),
        "branch5x5_2": (48, 64, (5, 5), 1, (2, 2)),
        "branch3x3dbl_1": (cin, 64, (1, 1), 1, (0, 0)),
        "branch3x3dbl_2": (64, 96, (3, 3), 1, (1, 1)),
        "branch3x3dbl_3": (96, 96, (3, 3), 1, (1, 1)),
        "branch_pool": (cin, pool_features, (1, 1), 1, (0, 0)),
    }


def _inception_b(cin):
    return {
        "branch3x3": (cin, 384, (3, 3), 2, (0, 0)),
        "branch3x3dbl_1": (cin, 64, (1, 1), 1, (0, 0)),
        "branch3x3dbl_2": (64, 96, (3, 3), 1, (1, 1)),
        "branch3x3dbl_3": (96, 96, (3, 3), 2, (0, 0)),
    }


def _inception_c(cin, c7):
    return {
        "branch1x1": (cin, 192, (1, 1), 1, (0, 0)),
        "branch7x7_1": (cin, c7, (1, 1), 1, (0, 0)),
        "branch7x7_2": (c7, c7, (1, 7), 1, (0, 3)),
        "branch7x7_3": (c7, 192, (7, 1), 1, (3, 0)),
        "branch7x7dbl_1": (cin, c7, (1, 1), 1, (0, 0)),
        "branch7x7dbl_2": (c7, c7, (7, 1), 1, (3, 0)),
        "branch7x7dbl_3": (c7, c7, (1, 7), 1, (0, 3)),
        "branch7x7dbl_4": (c7, c7, (7, 1), 1, (3, 0)),
        "branch7x7dbl_5": (c7, 192, (1, 7), 1, (0, 3)),
        "branch_pool": (cin, 192, (1, 1), 1, (0, 0)),
    }


def _inception_d(cin):
    return {
        "branch3x3_1": (cin, 192, (1, 1), 1, (0, 0)),
        "branch3x3_2": (192, 320, (3, 3), 2, (0, 0)),
        "branch7x7x3_1": (cin, 192, (1, 1), 1, (0, 0)),
        "branch7x7x3_2": (192, 192, (1, 7), 1, (0, 3)),
        "branch7x7x3_3": (192, 192, (7, 1), 1, (3, 0)),
        "branch7x7x3_4": (192, 192, (3, 3), 2, (0, 0)),
    }


def _inception_e(cin):
    return {
        "branch1x1": (cin, 320, (1, 1), 1, (0, 0)),
        "branch3x3_1": (cin, 384, (1, 1), 1, (0, 0)),
        "branch3x3_2a": (384, 384, (1, 3), 1, (0, 1)),
        "branch3x3_2b": (384, 384, (3, 1), 1, (1, 0)),
        "branch3x3dbl_1": (cin, 448, (1, 1), 1, (0, 0)),
        "branch3x3dbl_2": (448, 384, (3, 3), 1, (1, 1)),
        "branch3x3dbl_3a": (384, 384, (1, 3), 1, (0, 1)),
        "branch3x3dbl_3b": (384, 384, (3, 1), 1, (1, 0)),
        "branch_pool": (cin, 192, (1, 1), 1, (0, 0)),
    }


SPEC = {
    **_STEM,
    "Mixed_5b": _inception_a(192, 32),
    "Mixed_5c": _inception_a(256, 64),
    "Mixed_5d": _inception_a(288, 64),
    "Mixed_6a": _inception_b(288),
    "Mixed_6b": _inception_c(768, 128),
    "Mixed_6c": _inception_c(768, 160),
    "Mixed_6d": _inception_c(768, 160),
    "Mixed_6e": _inception_c(768, 192),
    "Mixed_7a": _inception_d(768),
    "Mixed_7b": _inception_e(1280),
    "Mixed_7c": _inception_e(2048),
}


# ---------------------------------------------------------------------------
# Modules (parameter holders with torchvision's names)
# ---------------------------------------------------------------------------


class _BatchNorm(nn.Module):
    """Inference BatchNorm's tensors: ``weight``, ``bias``, ``running_mean``,
    ``running_var`` (torchvision's ``num_batches_tracked`` is not kept)."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(ch))
        self.bias = nn.Parameter(torch.empty(ch))
        self.register_buffer("running_mean", torch.empty(ch))
        self.register_buffer("running_var", torch.empty(ch))


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm (eps 1e-3, inference) -> ReLU."""

    def __init__(self, spec):
        super().__init__()
        cin, cout, k, stride, pad = spec
        self.spec = spec
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=False)
        self.bn = _BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, _, stride, pad = self.spec
        y = F.conv2d(x, self.conv.weight, stride=stride, padding=pad)
        bn = self.bn
        inv = torch.rsqrt(bn.running_var + BN_EPS)
        y = ((y - bn.running_mean[:, None, None]) * inv[:, None, None] * bn.weight[:, None, None]
             + bn.bias[:, None, None])
        return F.relu(y)


class InceptionV3(nn.Module):
    def __init__(self):
        super().__init__()
        for name, spec in SPEC.items():
            if isinstance(spec, dict):
                self.add_module(name, nn.ModuleDict({k: BasicConv2d(s) for k, s in spec.items()}))
            else:
                self.add_module(name, BasicConv2d(spec))


# ---------------------------------------------------------------------------
# Blocks (NCHW)
# ---------------------------------------------------------------------------


def _max_pool(x, k=3, stride=2, pad=0):
    return F.max_pool2d(x, k, stride, pad)


def _avg_pool_3x3(x, count_include_pad: bool):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=count_include_pad)


def _chain(p, x, names):
    for n in names:
        x = p[n](x)
    return x


def block_a(p, x, fid_variant: bool = True):
    b1 = p["branch1x1"](x)
    b5 = _chain(p, x, ["branch5x5_1", "branch5x5_2"])
    b3 = _chain(p, x, ["branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"])
    bp = p["branch_pool"](_avg_pool_3x3(x, count_include_pad=not fid_variant))
    return torch.cat([b1, b5, b3, bp], dim=1)


def block_b(p, x):
    b3 = p["branch3x3"](x)
    bd = _chain(p, x, ["branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"])
    return torch.cat([b3, bd, _max_pool(x)], dim=1)


def block_c(p, x, fid_variant: bool = True):
    b1 = p["branch1x1"](x)
    b7 = _chain(p, x, ["branch7x7_1", "branch7x7_2", "branch7x7_3"])
    bd = _chain(p, x, [f"branch7x7dbl_{i}" for i in range(1, 6)])
    bp = p["branch_pool"](_avg_pool_3x3(x, count_include_pad=not fid_variant))
    return torch.cat([b1, b7, bd, bp], dim=1)


def block_d(p, x):
    b3 = _chain(p, x, ["branch3x3_1", "branch3x3_2"])
    b7 = _chain(p, x, [f"branch7x7x3_{i}" for i in range(1, 5)])
    return torch.cat([b3, b7, _max_pool(x)], dim=1)


def block_e(p, x, fid_variant: bool = True, pool_kind: str = "avg"):
    b1 = p["branch1x1"](x)
    b3 = p["branch3x3_1"](x)
    b3 = torch.cat([p["branch3x3_2a"](b3), p["branch3x3_2b"](b3)], dim=1)
    bd = _chain(p, x, ["branch3x3dbl_1", "branch3x3dbl_2"])
    bd = torch.cat([p["branch3x3dbl_3a"](bd), p["branch3x3dbl_3b"](bd)], dim=1)
    if pool_kind == "max":  # pytorch-fid's FIDInceptionE_2 (Mixed_7c)
        bp = _max_pool(x, k=3, stride=1, pad=1)
    else:
        bp = _avg_pool_3x3(x, count_include_pad=not fid_variant)
    return torch.cat([b1, b3, bd, p["branch_pool"](bp)], dim=1)


# ---------------------------------------------------------------------------
# Tower
# ---------------------------------------------------------------------------


def inception_apply(model: InceptionV3, x: torch.Tensor, *, fid_variant: bool = True):
    """(B, 299, 299, 3) in [-1, 1] -> (B, 2048) pool3 features, f32."""
    x = x.float().permute(0, 3, 1, 2)
    for n in ["Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"]:
        x = getattr(model, n)(x)
    x = _max_pool(x)
    for n in ["Conv2d_3b_1x1", "Conv2d_4a_3x3"]:
        x = getattr(model, n)(x)
    x = _max_pool(x)
    for n in ["Mixed_5b", "Mixed_5c", "Mixed_5d"]:
        x = block_a(getattr(model, n), x, fid_variant)
    x = block_b(model.Mixed_6a, x)
    for n in ["Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"]:
        x = block_c(getattr(model, n), x, fid_variant)
    x = block_d(model.Mixed_7a, x)
    x = block_e(model.Mixed_7b, x, fid_variant, "avg")
    x = block_e(model.Mixed_7c, x, fid_variant, "max" if fid_variant else "avg")
    return x.mean(dim=(2, 3))


def resize_bilinear(images: torch.Tensor, size) -> torch.Tensor:
    """NHWC f32 -> (B, *size, C): ``jax.image.resize(..., "bilinear")``,
    which antialiases when it downsamples."""
    x = images.float().permute(0, 3, 1, 2)
    down = size[0] < x.shape[2] or size[1] < x.shape[3]
    y = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False, antialias=down)
    return y.permute(0, 2, 3, 1)


def pool3_features(model: InceptionV3, images01: torch.Tensor, *, fid_variant: bool = True):
    """Float images in [0, 1], any (B, H, W, 3) -> (B, 2048)."""
    x = resize_bilinear(images01, (299, 299))
    return inception_apply(model, x * 2.0 - 1.0, fid_variant=fid_variant)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_inception(seed: int, *, device="cuda") -> InceptionV3:
    """Seeded random weights with the real shapes (f32): convs
    N(0, 2/fan_in) (He's, which keeps the activations' scale through ~95
    conv -> ReLU layers, so the pool3 features of different images differ),
    BatchNorm the identity.  JAX's ``init_inception`` draws N(0, 0.05^2)
    kernels; the tests load JAX's tree through the weight bridge instead."""
    from stable_diffusion_tpu_torch.utils.weights import build, init_random_

    model = init_random_(build(InceptionV3, device=device), seed)
    for mod in model.modules():
        if isinstance(mod, _BatchNorm):
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
        elif isinstance(mod, nn.Conv2d):
            mod.weight.mul_(2.0 ** 0.5)
    return model


def load_inception_params(path: str, *, device="cuda") -> InceptionV3:
    """A torchvision / pytorch-fid InceptionV3 state dict (``.safetensors``
    through the port's reader, else ``torch.load(weights_only=True)``, its
    ``state_dict`` when it has one) loaded into :class:`InceptionV3` on
    ``device``.  ``fc``, ``AuxLogits`` and ``num_batches_tracked`` are
    dropped (FID uses pool3 only); a missing tensor raises."""
    if path.endswith(".safetensors"):
        from stable_diffusion_tpu_torch.utils import safetensors_io

        sd = safetensors_io.load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    sd = {k: v for k, v in sd.items()
          if not k.startswith(("fc.", "AuxLogits.")) and "num_batches_tracked" not in k}
    from stable_diffusion_tpu_torch.utils.weights import build

    model = build(InceptionV3, device=device)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if missing or unexpected:
        raise ValueError(f"{path}: not an InceptionV3 state dict: missing {sorted(missing)[:5]}, "
                         f"unexpected {sorted(unexpected)[:5]}")
    return model
