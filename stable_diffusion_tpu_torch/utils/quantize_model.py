"""Quantization and calibration of the port's models (port of
stable_diffusion_tpu/utils/quantize_model.py).

The JAX functions map parameter trees to new trees; these work on the
port's modules in place and return them (copy a module first to keep the
float one): ``quantize_params`` swaps every ``nn.Linear`` for a
``layers.QLinear``, ``quantize_convs`` every 3x3 ``nn.Conv2d`` for a
``layers.QConv2d`` (per-output-channel int8, ``ops.quantize``), and the
calibration functions attach ``act_scale`` (the input absmax over the
calibration batches, an f32 buffer) to every linear or resblock conv that
the forward reached.  A holder with ``act_scale`` is static W8A8.

Calibration runs ``apply_fn(module, batch)`` under ``layers.CAPTURE``; the
running absmax stays on the device and is attached as it is, with no host
read.  Layers are identified by their holder module, so ``apply_fn`` must
run the module it is given (JAX keys by parameter-subtree identity and has
the same rule).  Run it under ``torch.no_grad()`` or give it inputs that
want no gradient.

The prompt-corpus sweeps (``calibrate_cond_encoder``, ``calibrate_unet``)
and ``quantize_text_encoder_static`` are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch
from torch import nn

from stable_diffusion_tpu_torch.models import layers

DEFAULT_CALIBRATION_PROMPTS = (
    "a photo of a cat sitting on a windowsill at sunset",
    "an astronaut riding a horse in photorealistic style",
    "a bowl of fresh fruit on a wooden table, studio lighting",
    "a watercolor painting of a mountain lake at dawn",
    "a futuristic city skyline at night, neon lights, rain",
    "a close-up portrait of an elderly fisherman, dramatic light",
    "a golden retriever puppy playing in autumn leaves",
    "an isometric illustration of a cozy coffee shop",
)


def _weight(mod: nn.Module) -> torch.Tensor:
    return mod.weight_q if isinstance(mod, layers._QuantHolder) else mod.weight


def _is_conv3x3(mod: nn.Module) -> bool:
    return isinstance(mod, (nn.Conv2d, layers.QConv2d)) and _weight(mod).shape[2:] == (3, 3)


def _swap(module: nn.Module, want: Callable[[nn.Module], bool], make: Callable) -> nn.Module:
    """Replace every submodule for which ``want`` holds by ``make(it)``."""
    for name, child in list(module.named_children()):
        if want(child):
            setattr(module, name, make(child))
        else:
            _swap(child, want, make)
    return module


def quantize_params(module: nn.Module) -> nn.Module:
    """Weight-only int8 on every linear (``nn.Linear`` -> ``QLinear``); a
    linear that carries a calibrated ``act_scale`` becomes W8A8."""
    return _swap(module, lambda m: isinstance(m, nn.Linear), layers.QLinear.from_float)


quantize_unet = quantize_params


def quantize_convs(module: nn.Module) -> nn.Module:
    """Per-output-channel int8 on every 3x3 conv (``nn.Conv2d`` ->
    ``QConv2d``); with a conv ``act_scale`` the resblock convs run as int8
    convs (K7)."""
    return _swap(module, lambda m: isinstance(m, nn.Conv2d) and _is_conv3x3(m),
                 layers.QConv2d.from_float)


def _set_act_scale(mod: nn.Module, value: torch.Tensor) -> None:
    if isinstance(mod, layers._QuantHolder) or "act_scale" in mod._buffers:
        mod.act_scale = value
    else:
        mod.register_buffer("act_scale", value)


def attach_act_scales(module: nn.Module, scale: float = 1.0, *, convs: bool = False) -> nn.Module:
    """A fixed ``act_scale`` on every linear and, with ``convs``, every 3x3
    conv, without calibration.  For timing only: 1.0 is far below real
    activation ranges, so the int8 path clips hard and the output is
    degraded; calibrate for accuracy."""
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, layers.QLinear)) or (convs and _is_conv3x3(mod)):
            _set_act_scale(mod, torch.tensor(float(scale), dtype=torch.float32,
                                             device=_weight(mod).device))
    return module


def quantization_error(module: nn.Module, qmodule: nn.Module) -> Dict[str, float]:
    """Per-layer relative RMS error of the quantized weights: for each holder
    of ``qmodule`` whose counterpart in ``module`` holds a float weight."""
    floats = dict(module.named_modules())
    errs = {}
    for name, q in qmodule.named_modules():
        f = floats.get(name)
        if isinstance(q, layers._QuantHolder) and f is not None and hasattr(f, "weight"):
            w = f.weight.detach().float()
            wq = q.dequantized(torch.float32)
            errs[name] = float(torch.sqrt(torch.mean((w - wq) ** 2))
                               / (torch.sqrt(torch.mean(w ** 2)) + 1e-12))
    return errs


def _calibrate(kind: str, apply_fn: Callable, module: nn.Module, batches: Iterable) -> nn.Module:
    capture = layers.Capture(kind)
    prev, layers.CAPTURE = layers.CAPTURE, capture
    try:
        for batch in batches:
            apply_fn(module, batch)
    finally:
        layers.CAPTURE = prev
    records = capture.records
    if not records:
        raise RuntimeError(f"calibration recorded no {kind} activations: apply_fn did not route "
                           f"through models.layers ({kind})")
    attached = 0
    for mod in module.modules():
        if mod in records:
            _set_act_scale(mod, records[mod])
            attached += 1
    if attached != len(records):
        raise RuntimeError(f"calibration recorded {len(records)} {kind} layers but only "
                           f"{attached} re-attached to the module; apply_fn must run the module "
                           "it is given")
    return module


def calibrate_static_activations(apply_fn: Callable, module: nn.Module, batches) -> nn.Module:
    """Attach to every linear the forward reached its input absmax over
    ``batches`` (``apply_fn(module, batch)``); ``quantize_params`` then
    gives a static-W8A8 model."""
    return _calibrate("linear", apply_fn, module, batches)


def calibrate_static_conv_activations(apply_fn: Callable, module: nn.Module, batches) -> nn.Module:
    """Attach to every resblock conv (GroupNorm -> SiLU -> 3x3 conv) the
    forward reached the absmax of its post-SiLU input over ``batches``."""
    return _calibrate("conv", apply_fn, module, batches)


def quantize_unet_static(unet: nn.Module, sample_batches, *, impl: str = "auto") -> nn.Module:
    """Static W8A8 UNet linears: calibrate over (x, t, cond) batches, then
    quantize the linears."""
    def apply(m, b):
        with torch.no_grad():
            m(b[0], b[1], b[2], impl=impl)

    return quantize_params(calibrate_static_activations(apply, unet, sample_batches))
