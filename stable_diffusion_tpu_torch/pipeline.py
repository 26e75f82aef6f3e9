"""txt2img, img2img, inpaint and SwiftBrush one-step (port of
stable_diffusion_tpu/pipeline.py ``StableDiffusion.from_pretrained``,
``tokenize``, ``generate``, ``generate_in_one_step`` and ``inpaint``: CLIP
text tower -> [VAE encode -> q-sample at the strength-truncated first step
->] DDIM or DDPM denoise loop with classifier-free guidance, or one UNet
pass at t = 999 -> VAE decode).

Numerical contract, as in JAX: ``generate`` takes context = [uncond, cond]
and eps = uncond + s * (cond - uncond); ``inpaint`` takes [cond, uncond]
and eps = cond + s * (cond - uncond), and at every step replaces the latent
outside the mask by the encoded image re-noised with the predicted noise.
DDPM takes the model output as eps under any prediction type, as JAX does.
``generate`` takes JAX's ``context`` (class2img: a precomputed
conditioning, a (B, D) one a single token, in place of the ids and the
text tower) and ``deepcache_interval`` (DeepCache: the full UNet
every k-th step, its shallow stage around the held deep feature between);
``inpaint`` and ``generate_in_one_step`` take none, as in JAX.
``generate`` and ``inpaint`` take JAX's progress mode
(``progress_callback(done, total)`` at 0 and after each ``progress_every``
steps): the loop runs in segments, and with DeepCache each segment starts
again from a full step, as JAX's segments do; every draw still comes from
the one generator in one order, so without DeepCache a segmented call
gives the one call's image, DDPM included (JAX draws a key a segment).
The port cannot replay ``jax.random``: every draw (encode noise, starting or
q-sample noise, inpaint's mask noise, the per-step noises) can be passed in
(the tests pass the noise JAX drew); the rest are drawn in that order from
one ``torch.Generator`` seeded with ``seed`` on the pipeline's device.
Images come back NHWC, float in [0, 1] or uint8; the TPU's lane-packed
(b, h, w*3) transfer layout is not ported.

The pipeline never moves work to the CPU: it runs on ``device``, and with
``impl="cuda"`` it refuses a device that is not CUDA.  Images and masks are
numpy arrays (or PIL images); PIL is imported only where a resize or a PIL
object needs it.  ``generate``, ``generate_in_one_step`` and ``inpaint``
take token ids as their first arguments, or ``prompt=`` / ``uncond_prompt=``
strings (a list: one a lane), which :meth:`StableDiffusion.tokenize` turns
into ids with the pipeline's tokenizer (``tokenizer.py``, or any object
with ``transformers``' ``batch_encode_plus``), by JAX's rules.

:meth:`StableDiffusion.shard` puts the pipeline on a ("data", "model")
mesh (parallel/mesh.py): the UNet's and text tower's transformer linears
split over "model", the VAE replicated; a request's lanes split over
"data", each CFG pair on one rank.  Every rank draws the whole batch's
noise from the seeded generator and keeps its lanes, so a sharded request
gives the unsharded request's image, and the images are gathered to every
rank.  :meth:`StableDiffusion.from_pretrained`
loads a diffusers directory or a single LDM file
(``utils/model_converter.py``); the CLI is ``inference_torch.py`` at the
repository's root.

The pipeline carries its scheduler config, as JAX's does
(``scheduler_config``, ``make_schedule``), and denoises with that config's
``prediction_type``: :meth:`StableDiffusion.for_version` builds SD1.5
(ViT-L, epsilon) or SD2.1 (OpenCLIP ViT-H, v-prediction), mirroring the JAX
package's ``sd_version`` choice.  Without a config the schedule is SD1.5's.

SDXL base (:meth:`StableDiffusion.sdxl`, or a diffusers directory with
``text_encoder_2/``; no JAX counterpart) takes the same calls: the ids go
to both text towers, the context is their penultimate states side by side,
and every UNet pass of ``generate`` (img2img included) and ``inpaint``
gets the second tower's pooled state and the time ids (the request's
``img_size`` as original and target size, crop (0, 0)), CFG's halves in
the context's order.  The one-step entry, training, sharding and W8A8 are
not ported for it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stable_diffusion_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextModel,
                                                    CLIPTextModelWithProjection)
from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
from stable_diffusion_tpu_torch.models.vae import VAE, VAEConfig
from stable_diffusion_tpu_torch.parallel import mesh as pmesh
from stable_diffusion_tpu_torch.schedulers import schedule as S
from stable_diffusion_tpu_torch.utils.device import span

MAX_TEXT_LEN = 77
# SwiftBrush's one step: t = 999 with alpha_T^2 = 0.0047 (JAX _one_step_jit)
ONE_STEP_T = 999
ONE_STEP_ALPHA2 = 0.0047


def scheduler_config_for(sd_version: str) -> dict:
    """The scheduler config JAX's ``from_pretrained`` gives a single-file
    checkpoint of ``sd_version``: 1.x epsilon, 2.x v-prediction."""
    return {"num_train_timesteps": 1000, "beta_start": 0.00085, "beta_end": 0.012,
            "prediction_type": "epsilon" if sd_version.startswith("1") else "v_prediction"}


def cfg_combine(pred: torch.Tensor, cfg_scale: float, order: str = "uncond_first") -> torch.Tensor:
    """The two halves of the batch -> eps.  "uncond_first" (generate):
    uncond + s * (cond - uncond); "cond_first" (inpaint): cond + s * (cond -
    uncond)."""
    a, b = pred.chunk(2, dim=0)
    if order == "uncond_first":
        uncond, cond = a, b
        base = uncond
    else:
        cond, uncond = a, b
        base = cond
    return base + torch.tensor(cfg_scale, dtype=pred.dtype) * (cond - uncond)


def scale_img(x, old_range, new_range, clamp: bool = False):
    """Linear range rescale of a numpy array or a tensor."""
    old_min, old_max = old_range
    new_min, new_max = new_range
    x = (x - old_min) * (new_max - new_min) / (old_max - old_min) + new_min
    if clamp:
        x = x.clamp(new_min, new_max) if isinstance(x, torch.Tensor) else np.clip(x, new_min, new_max)
    return x


def _pil_image(img, mode: str, img_size: Tuple[int, int], resample=None):
    """``img`` (a PIL image or an array cast to uint8) converted to ``mode``
    and resized to ``img_size`` by PIL (JAX's preprocessing)."""
    try:
        from PIL import Image
    except ImportError as e:  # another resize gives other pixels
        raise ImportError("resizing or converting this image needs PIL; pass a uint8 numpy "
                          f"array already at img_size {img_size}") from e
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img.astype(np.uint8))
    img = img.convert(mode)
    size = (img_size[1], img_size[0])
    img = img.resize(size) if resample is None else img.resize(size, getattr(Image, resample))
    return np.asarray(img)


def preprocess_image(img, img_size: Tuple[int, int]) -> np.ndarray:
    """An image, as an array or a PIL image -> (1, H, W, 3) float32 in
    [-1, 1].  An (H, W, 3) array already at ``img_size`` is taken as it is
    (PIL's resize to the same size is a copy); anything else goes through
    PIL's RGB conversion and bilinear resize."""
    if isinstance(img, np.ndarray) and img.shape == (*img_size, 3):
        arr = img.astype(np.uint8)
    else:
        arr = _pil_image(img, "RGB", img_size, "BILINEAR")
    arr = arr.astype(np.float32) / 255.0
    return ((arr - 0.5) / 0.5)[None]


def preprocess_mask(mask, img_size: Tuple[int, int]) -> np.ndarray:
    """A mask (H, W), as an array or a PIL image -> bool (1, H/8, W/8, 1),
    True where the image is regenerated.  The 8x downsample is JAX's
    ``jax.image.resize(method="bicubic")``: Keys cubic (a = -0.5),
    antialiased; every nonzero value counts, the negative ringing outside a
    hard edge included.  An (H, W) array at ``img_size`` needs no PIL."""
    if isinstance(mask, np.ndarray) and mask.shape == tuple(img_size):
        arr = mask.astype(np.uint8)
    else:
        arr = _pil_image(mask, "L", img_size)
    x = torch.from_numpy(arr.astype(np.float32))[None, None]
    small = F.interpolate(x, size=(img_size[0] // 8, img_size[1] // 8), mode="bicubic",
                          align_corners=False, antialias=True)
    small = scale_img(small, (0.0, 255.0), (0.0, 1.0))
    return small[0, 0, :, :, None][None].numpy().astype(bool)


def _sampler_step(table, lat, t, pt, eps, noise, sampler: str, prediction_type: str,
                  eta: float) -> torch.Tensor:
    if sampler == "ddpm":
        return S.ddpm_step(table, lat, t, pt, eps, noise)
    return S.ddim_step(table, lat, t, pt, eps, prediction_type=prediction_type, eta=eta,
                       noise=noise if eta > 0 else None)


class _Draws:
    """The noise of one call: each draw is the array or tensor passed in
    (checked for its shape) or the next draw of one seeded generator on the
    device.  On a data-parallel rank (``lanes`` of a batch of ``batch``)
    each draw is the whole batch's, and the rank keeps its lanes of it."""

    def __init__(self, device, dtype, seed: int, lanes: Optional[slice] = None,
                 batch: Optional[int] = None):
        self.device, self.dtype = device, dtype
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.lanes, self.batch = lanes, batch

    def full(self, shape) -> tuple:
        """A lane-batched shape of this rank (its lanes first) as the whole batch's."""
        return tuple(shape) if self.lanes is None else (self.batch, *shape[1:])

    def __call__(self, name: str, given, shape, lane_dim: Optional[int] = 0) -> torch.Tensor:
        """``shape`` is the whole batch's; ``lane_dim`` the dim of its lanes
        (None: not a lane-batched draw)."""
        if given is None:
            t = torch.randn(shape, generator=self.gen, device=self.device).to(self.dtype)
        else:
            t = (given.to(device=self.device, dtype=self.dtype) if isinstance(given, torch.Tensor)
                 else torch.tensor(np.asarray(given), device=self.device, dtype=self.dtype))
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name} {tuple(t.shape)}, expected {tuple(shape)}")
        if self.lanes is None or lane_dim is None:
            return t
        return t[(slice(None),) * lane_dim + (self.lanes,)]


def _prompts(prompt, uncond_prompt, batch_size: Optional[int]):
    """JAX ``generate``'s prompt rules: a string is repeated over the batch
    (``batch_size``, 1 when None); a list is one prompt a lane and sets the
    batch (a ``batch_size`` other than 1 or its length raises); an
    ``uncond_prompt`` list must have one entry a lane."""
    n = 1 if batch_size is None else int(batch_size)
    if isinstance(prompt, str):
        prompts = [prompt] * n
    else:
        prompts = list(prompt)
        if n not in (1, len(prompts)):
            raise ValueError(f"batch_size={n} conflicts with a {len(prompts)}-prompt list; omit "
                             "batch_size or match it")
        n = len(prompts)
    if isinstance(uncond_prompt, str):
        return prompts, [uncond_prompt] * n
    uncond = list(uncond_prompt)
    if len(uncond) != n:
        raise ValueError(f"uncond_prompt list has {len(uncond)} entries for batch_size={n}")
    return prompts, uncond


@dataclasses.dataclass
class StableDiffusion:
    """The models on one device, in one dtype, the ``impl`` switch and the
    scheduler config (None: SD1.5's).  SDXL adds ``text_encoder_2`` (a
    :class:`CLIPTextModelWithProjection`): the context is both towers'
    hidden states side by side, and the UNet's text-time conditioning takes
    the second's pooled state with the size numbers of the request."""

    unet: UNet
    text_encoder: CLIPTextModel
    vae: VAE
    impl: str = "auto"
    scheduler_config: Optional[dict] = None
    tokenizer: Any = None
    mesh: Any = None  # parallel.mesh.Mesh after shard()
    text_encoder_2: Optional[CLIPTextModelWithProjection] = None

    @classmethod
    def build(cls, unet_config: UNetConfig, text_config: CLIPTextConfig,
              vae_config: VAEConfig = VAEConfig(), *, device="cuda", dtype=torch.float32,
              impl: str = "auto", scheduler_config: Optional[dict] = None,
              text_config_2: Optional[CLIPTextConfig] = None) -> "StableDiffusion":
        """Uninitialised models on ``device`` (the card unless the caller asks
        for the CPU): load a state_dict into each
        (``utils.weights.from_jax_params``) or initialise them
        (``utils.weights.init_random_``) before generating.  On a CUDA device
        the kernels take bf16: build with ``dtype=torch.bfloat16``, or use
        ``impl="torch"`` for f32 (the kernels raise on f32 rather than fall
        back).  ``text_config_2`` adds SDXL's second tower, its pooled state
        projected at the tower's width; the UNet's ``cross_attention_dim`` is
        then the two towers' widths together."""
        from stable_diffusion_tpu_torch.utils.weights import build

        pipe = cls(unet=build(UNet, unet_config, device=device, dtype=dtype),
                   text_encoder=build(CLIPTextModel, text_config, device=device, dtype=dtype),
                   vae=build(VAE, vae_config, device=device, dtype=dtype), impl=impl,
                   scheduler_config=scheduler_config)
        if text_config_2 is not None:
            pipe.text_encoder_2 = build(CLIPTextModelWithProjection, text_config_2,
                                        device=device, dtype=dtype)
        return pipe

    @classmethod
    def sdxl(cls, *, device="cuda", dtype=torch.float32, impl: str = "auto") -> "StableDiffusion":
        """SDXL base 1.0 at its published widths (``UNetConfig.sdxl``,
        ``CLIPTextConfig.sdxl_pair``, ``VAEConfig.sdxl``); its schedule is
        SD1.5's, the default.  Uninitialised, as :meth:`build`."""
        text, text_2 = CLIPTextConfig.sdxl_pair()
        return cls.build(UNetConfig.sdxl(), text, VAEConfig.sdxl(), device=device, dtype=dtype,
                         impl=impl, text_config_2=text_2)

    @classmethod
    def for_version(cls, sd_version: str = "1.5", *, device="cuda", dtype=torch.float32,
                    impl: str = "auto") -> "StableDiffusion":
        """The full-width models of ``sd_version`` (JAX ``from_pretrained``'s
        single-file choice): 1.x is SD1.5 (``UNetConfig.sd15()``, CLIP
        ViT-L, epsilon), 2.x SD2.1 (``UNetConfig.sd21()``, OpenCLIP ViT-H,
        v-prediction).  Uninitialised, as :meth:`build`."""
        v1 = sd_version.startswith("1")
        return cls.build(UNetConfig.sd15() if v1 else UNetConfig.sd21(),
                         CLIPTextConfig.vit_l() if v1 else CLIPTextConfig.vit_h(), VAEConfig(),
                         device=device, dtype=dtype, impl=impl,
                         scheduler_config=scheduler_config_for(sd_version))

    @classmethod
    def from_pretrained(cls, path: str, *, sd_version: str = "1.5", dtype=torch.bfloat16,
                        tokenizer=None, impl: str = "auto", device="cuda") -> "StableDiffusion":
        """The models of a diffusers directory (``unet/``, ``text_encoder/``,
        ``vae/``, each a ``config.json`` and a safetensors file, and an
        optional ``scheduler/scheduler_config.json``; SDXL's also
        ``text_encoder_2/``, and then both towers hand on their penultimate
        layers) or of a single
        CompVis/LDM ``.ckpt`` / ``.safetensors`` file, whose configs come
        from ``sd_version`` (:meth:`for_version`).  The modules are built on
        ``device`` in ``dtype`` and the checkpoint's tensors copied into
        them (strict: a missing or extra key raises).  A ``.ckpt`` is
        unpickled, which runs code from the file: load only trusted files."""
        from stable_diffusion_tpu_torch.utils import model_converter as mc

        if os.path.isfile(path):
            pipe = cls.for_version(sd_version, device=device, dtype=dtype, impl=impl)
            states = mc.load_ldm_checkpoint(path)
        else:
            def config(sub, name="config.json"):
                with open(os.path.join(path, sub, name)) as f:
                    return json.load(f)

            sched = os.path.join(path, "scheduler", "scheduler_config.json")
            xl = os.path.isdir(os.path.join(path, "text_encoder_2"))
            text = [CLIPTextConfig.from_dict(config(sub))
                    for sub in ("text_encoder", "text_encoder_2")[:1 + xl]]
            if xl:
                text = [dataclasses.replace(c, hidden_state="penultimate") for c in text]
                width = config("text_encoder_2").get("projection_dim", text[1].hidden_size)
                if width != text[1].hidden_size:
                    raise ValueError(f"text_encoder_2 projects {text[1].hidden_size} -> {width}; "
                                     "the port's SDXL tower projects at its own width")
            pipe = cls.build(UNetConfig.from_dict(config("unet")), text[0],
                             VAEConfig.from_dict(config("vae")), device=device, dtype=dtype,
                             impl=impl,
                             scheduler_config=config("scheduler", "scheduler_config.json")
                             if os.path.exists(sched) else None,
                             text_config_2=text[1] if xl else None)
            states = {
                "unet": mc.load_unet_diffusers(
                    os.path.join(path, "unet", "diffusion_pytorch_model.safetensors")),
                "vae": mc.load_vae_diffusers(
                    os.path.join(path, "vae", "diffusion_pytorch_model.safetensors")),
            }
            for sub in ("text_encoder", "text_encoder_2")[:1 + xl]:
                states[sub] = mc.load_text_encoder_diffusers(
                    os.path.join(path, sub, "model.safetensors"))
        for name in list(states):
            mc.load_into(getattr(pipe, name), states.pop(name))
        pipe.tokenizer = tokenizer
        return pipe

    def shard(self, mesh) -> "StableDiffusion":
        """Put the pipeline on ``mesh`` (``parallel.mesh.make_mesh``; JAX
        ``shard``): the UNet's and text tower's transformer linears keep
        this rank's slices over "model" (``shard_module_``), the VAE stays
        replicated, and requests then split their lanes over "data"."""
        if self.text_encoder_2 is not None:
            raise NotImplementedError("sharding an SDXL pipeline (two text towers) is not ported")
        for m in (self.unet, self.text_encoder):
            pmesh.shard_module_(m, mesh)
        self.mesh = mesh
        return self

    def tokenize(self, prompts: Sequence[str]) -> np.ndarray:
        """(B, 77) int64 token ids of ``prompts``: padded to 77 with the
        tokenizer's pad token and truncated, as JAX's ``tokenize`` asks its
        tokenizer."""
        if self.tokenizer is None:
            raise ValueError("this pipeline has no tokenizer: pass tokenizer= to from_pretrained "
                             "(tokenizer.load_tokenizer(dir)) or pass token ids")
        enc = self.tokenizer.batch_encode_plus(list(prompts), padding="max_length",
                                               max_length=MAX_TEXT_LEN, truncation=True)
        return np.asarray(enc.input_ids, dtype=np.int64)

    def make_schedule(self, use_cosine_schedule: bool = False) -> S.DiffusionSchedule:
        """The schedule of ``scheduler_config`` (JAX ``make_schedule``),
        linear or cosine."""
        cfg = self.scheduler_config or {}
        return S.make_schedule(num_train_timesteps=cfg.get("num_train_timesteps", 1000),
                               beta_start=cfg.get("beta_start", 0.00085),
                               beta_end=cfg.get("beta_end", 0.012),
                               use_cosine_schedule=use_cosine_schedule,
                               prediction_type=cfg.get("prediction_type", "epsilon"))

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.unet.parameters()).dtype

    def _device(self) -> torch.device:
        """The models' device; ``impl="cuda"`` refuses one that is not CUDA."""
        dev = self.device
        if self.impl == "cuda" and dev.type != "cuda":
            raise ValueError(f"impl='cuda' needs the models on a CUDA device, they are on {dev}")
        return dev

    @torch.no_grad()
    def encode_text(self, input_ids, *, return_pooled: bool = False):
        """(B, 77) token ids -> the text tower's (B, 77, D) context on the
        pipeline's device (JAX ``encode_text``).  With SDXL's second tower
        the same ids go through both and the context is their hidden
        states side by side (D = D1 + D2); ``return_pooled`` also returns
        the second tower's pooled state (B, P), None without one."""
        with span("text"):
            ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=self.device)
            context, pooled = self.text_encoder(ids, impl=self.impl), None
            if self.text_encoder_2 is not None:
                hidden, pooled = self.text_encoder_2(ids, impl=self.impl)
                context = torch.cat([context, hidden], dim=-1)
            return (context, pooled) if return_pooled else context

    def _context(self, first_ids, second_ids=None):
        """(context, pooled state or None) of the text towers on [first;
        second] token ids (second None: first alone)."""
        ids = [np.asarray(i) for i in (first_ids, second_ids) if i is not None]
        return self.encode_text(np.concatenate(ids, axis=0), return_pooled=True)

    def _added_cond(self, pooled, img_size) -> Optional[dict]:
        """The UNet's SDXL conditioning for a request at ``img_size``, one
        row a row of ``pooled``: the pooled text state and the time ids
        (original size, crop top-left (0, 0), target size), the original
        and target sizes being ``img_size``; None for a UNet without it."""
        if self.unet.cfg.addition_embed_type is None:
            return None
        if pooled is None:
            raise ValueError("an SDXL UNet needs the pooled text state: pass token ids or prompts, "
                             "not a precomputed context")
        h, w = img_size
        ids = torch.tensor([[h, w, 0, 0, h, w]], dtype=torch.float32, device=pooled.device)
        return {"text_embeds": pooled, "time_ids": ids.expand(pooled.shape[0], 6)}

    def _ids(self, cond_ids, uncond_ids, prompt, uncond_prompt, batch_size, do_cfg: bool, what: str):
        """(cond, uncond or None) token ids: those given, else the prompts'
        by :func:`_prompts`; the unconditional ids of ``uncond_prompt`` where
        CFG needs them and none are given."""
        if cond_ids is None:
            if prompt is None:
                raise ValueError(f"{what} needs a prompt, cond_ids or a context")
            prompts, uncond = _prompts(prompt, uncond_prompt, batch_size)
            cond_ids = self.tokenize(prompts)
        else:
            cond_ids = np.asarray(cond_ids)
            if batch_size is not None and int(batch_size) != cond_ids.shape[0]:
                raise ValueError(f"batch_size={batch_size} conflicts with {cond_ids.shape[0]} "
                                 "rows of cond_ids")
            _, uncond = _prompts([""] * cond_ids.shape[0], uncond_prompt, None)
        if do_cfg and uncond_ids is None:
            uncond_ids = self.tokenize(uncond)
        return cond_ids, None if uncond_ids is None else np.asarray(uncond_ids)

    def _timesteps(self, sched, inference_steps: int, sampler: str, strength: Optional[float]):
        """(ts, prev_ts): the sampler's sequence, strength-truncated when given."""
        if sampler not in ("ddim", "ddpm"):
            raise ValueError(f"sampler must be 'ddim' or 'ddpm', got {sampler!r}")
        ts = S.inference_timesteps(sched, inference_steps, kind=sampler)
        if strength is not None:
            ts = S.apply_strength(ts, strength)
        return ts, S.prev_timesteps(sched, ts, inference_steps)

    def _denoise(self, latents, context, ts, prev_ts, table, *, cfg_scale: float, do_cfg: bool,
                 order: str, sampler: str, prediction_type: str, eta: float, draws: _Draws,
                 step_noise=None, blend: Optional[Callable] = None,
                 deepcache_interval: int = 1, progress_callback: Optional[Callable] = None,
                 progress_every: int = 5, added_cond: Optional[dict] = None) -> torch.Tensor:
        """The denoise loop: CFG UNet step, ``blend(latents, t, eps)`` (inpaint),
        then the sampler's step; DDPM takes a fresh noise every step, DDIM
        one only when eta > 0.  With ``deepcache_interval`` k > 1 (JAX
        ``_denoise_scan``): the full UNet at steps i % k == 0, which also
        gives the deep feature to hold, and the cached pass on the held
        feature between them; the held feature starts as zeros.  With a
        ``progress_callback`` (JAX's progress mode) the steps run in
        segments of ``progress_every``, the callback called with (0, n) and
        then (steps done, n) after each; i counts from 0 again in each
        segment, so DeepCache restarts there.  ``added_cond`` (SDXL) goes
        to every UNet pass, its rows those of ``context``."""
        needs_noise = sampler == "ddpm" or eta > 0
        if step_noise is not None and needs_noise:
            want = (len(ts), *draws.full(latents.shape))
            step_noise = draws("step_noise", step_noise, want, lane_dim=1)
        n = len(ts)
        seg = max(1, int(progress_every)) if progress_callback is not None else max(n, 1)
        if progress_callback is not None:
            progress_callback(0, n)
        k = int(deepcache_interval)
        if k > 1:
            b, h, w = latents.shape[0] * (2 if do_cfg else 1), *latents.shape[1:3]
            deep = torch.zeros((b, h, w, self.unet.cfg.block_out_channels[1]),
                               dtype=latents.dtype, device=latents.device)
        kw = dict(added_cond=added_cond, impl=self.impl)
        for i, (t, pt) in enumerate(zip(ts.tolist(), prev_ts.tolist())):
            j = i % seg  # the step's index in its segment
            with span("denoise_step"):
                model_in = torch.cat([latents, latents], dim=0) if do_cfg else latents
                t_in = torch.full((1,), t, dtype=torch.long, device=latents.device)
                if k <= 1:
                    pred = self.unet(model_in, t_in, context, **kw)
                elif j % k == 0:
                    pred, deep = self.unet.forward_split(model_in, t_in, context, **kw)
                else:
                    pred = self.unet.forward_cached(model_in, t_in, context, deep, **kw)
                with span("sampler"):
                    eps = cfg_combine(pred, cfg_scale, order) if do_cfg else pred
                    if blend is not None:
                        latents = blend(latents, t, eps)
                    noise = None
                    if needs_noise:
                        noise = (step_noise[i] if step_noise is not None
                                 else draws("step noise", None, draws.full(latents.shape)))
                    latents = _sampler_step(table, latents, t, pt, eps, noise, sampler,
                                            prediction_type, eta)
            if progress_callback is not None and (j == seg - 1 or i == n - 1):
                progress_callback(i + 1, n)
        return latents

    @torch.no_grad()
    def generate(self, cond_ids=None, uncond_ids=None, *, prompt=None, uncond_prompt="",
                 batch_size: Optional[int] = None, input_image=None, input_latents=None,
                 img_size: Tuple[int, int] = (512, 512), do_cfg: bool = True,
                 cfg_scale: float = 7.5, strength: float = 0.8, inference_steps: int = 50,
                 sampler: str = "ddim", use_cosine_schedule: bool = False, eta: float = 0.0,
                 seed: int = 0, deepcache_interval: int = 1, context=None, initial_latents=None,
                 encode_noise=None, latent_noise=None, step_noise=None,
                 progress_callback: Optional[Callable] = None, progress_every: int = 5,
                 return_latents: bool = False, output_dtype: str = "float32") -> np.ndarray:
        """txt2img, or img2img with ``input_image`` (an (H, W, 3) array or PIL
        image, preprocessed to ``img_size`` and encoded) or ``input_latents``
        (the unscaled latent of one image, or of each lane).

        cond_ids / uncond_ids: (B, 77) token ids; or ``prompt`` /
        ``uncond_prompt`` (JAX's rules: a string repeated over
        ``batch_size`` lanes, default 1; a list one a lane, setting the
        batch; ``uncond_prompt`` "" by default), tokenized by the pipeline's
        tokenizer, as are the unconditional ids CFG needs when none are
        given.  ``context`` replaces both the ids and the text tower
        (class2img: a ``ClassEncoder`` embedding): (B', D) is taken as one
        token, (B', S, D) as it is; with CFG it holds the [uncond; cond]
        halves, B' = 2B.
        sampler: "ddim" (eta as given) or "ddpm"; ``use_cosine_schedule``
        picks the cosine tables.  img2img runs the last ``int(steps *
        strength)`` steps from the latent q-sampled at the first of them.
        ``deepcache_interval`` k > 1 runs the full UNet every k-th step and
        the DeepCache pass (the shallow stage around the held deep feature)
        between; k <= 1 is the exact loop.  ``progress_callback(done,
        total)``: JAX's progress mode (see :meth:`_denoise`).
        Injected draws: ``initial_latents`` (txt2img start), ``encode_noise``
        (1, H/8, W/8, 4), ``latent_noise`` (B, H/8, W/8, 4; img2img's
        q-sample), ``step_noise`` (steps run, B, H/8, W/8, 4); the others
        are drawn from ``torch.Generator().manual_seed(seed)`` on the device.
        Returns the latents (B, H/8, W/8, 4) f32 with ``return_latents``, else
        (B, H, W, 3) images: float32 in [0, 1], or uint8 when
        ``output_dtype="uint8"`` (which raises FloatingPointError rather
        than cast a non-finite value).  Under a mesh each rank computes its
        lanes and returns the whole batch.
        """
        dev, dtype, impl, mesh = self._device(), self.dtype, self.impl, self.mesh
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"output_dtype must be 'float32' or 'uint8', got {output_dtype!r}")
        pooled = None
        if context is not None:
            context = torch.as_tensor(context).to(device=dev, dtype=dtype)
            if context.dim() == 2:
                context = context[:, None, :]
            if do_cfg and context.shape[0] % 2:
                raise ValueError(f"with CFG the context holds [uncond; cond], got "
                                 f"{context.shape[0]} rows")
            b = context.shape[0] // (2 if do_cfg else 1)
            if mesh is not None:
                context = torch.cat([pmesh.data_sharding(h, mesh)
                                     for h in context.chunk(2 if do_cfg else 1)])
        else:
            cond_ids, uncond_ids = self._ids(cond_ids, uncond_ids, prompt, uncond_prompt,
                                             batch_size, do_cfg, "generate")
            b = cond_ids.shape[0]
            if mesh is not None:
                cond_ids, uncond_ids = (None if i is None else pmesh.data_sharding(i, mesh)
                                        for i in (cond_ids, uncond_ids))
            context, pooled = (self._context(uncond_ids, cond_ids) if do_cfg
                               else self._context(cond_ids))
        added_cond = self._added_cond(pooled, img_size)
        lanes = None if mesh is None else mesh.lanes(b)
        h, w = img_size
        lat_shape = (b, h // 8, w // 8, 4)
        is_img2img = input_image is not None or input_latents is not None
        sched = self.make_schedule(use_cosine_schedule)
        ts, prev_ts = self._timesteps(sched, inference_steps, sampler,
                                      strength if is_img2img else None)
        table = torch.as_tensor(sched.alphas_hat, device=dev)
        draws = _Draws(dev, dtype, seed, lanes, b)
        if is_img2img:
            if input_latents is None:
                img = torch.as_tensor(preprocess_image(input_image, img_size), device=dev,
                                      dtype=dtype)
                lat0 = self.vae.encode(img, noise=draws("encode_noise", encode_noise,
                                                        (1, *lat_shape[1:]), lane_dim=None),
                                       impl=impl)[0]
            else:
                lat0 = torch.tensor(np.asarray(input_latents), device=dev, dtype=dtype)
                if mesh is not None and lat0.shape[0] == b:
                    lat0 = pmesh.data_sharding(lat0, mesh)
            noise = draws("latent_noise", latent_noise, lat_shape)
            latents = S.forward_process(table, lat0, int(ts[0]), noise)
        else:
            latents = draws("initial_latents", initial_latents, lat_shape)

        latents = self._denoise(latents, context, ts, prev_ts, table, cfg_scale=cfg_scale,
                                do_cfg=do_cfg, order="uncond_first", sampler=sampler,
                                prediction_type=sched.prediction_type, eta=eta, draws=draws,
                                step_noise=step_noise, deepcache_interval=deepcache_interval,
                                progress_callback=progress_callback, progress_every=progress_every,
                                added_cond=added_cond)
        if return_latents:
            return self._gather(latents).float().cpu().numpy()
        return _finish(self._gather(self.vae.decode(latents, impl=impl)), output_dtype, "generate")

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's lanes of ``t``, on every rank (``t`` unsharded)."""
        return t if self.mesh is None else pmesh.replicate(t, self.mesh)

    @torch.no_grad()
    def generate_in_one_step(self, cond_ids=None, *, prompt=None,
                             img_size: Tuple[int, int] = (512, 512),
                             batch_size: Optional[int] = None, initial_latents=None, seed: int = 0,
                             output_dtype: str = "float32") -> np.ndarray:
        """SwiftBrush one-step txt2img: one UNet pass at t = 999 on the
        starting latents z, x0 = (z - sigma_T eps) / alpha_T with alpha_T^2
        = 0.0047, then the decode; no guidance.

        cond_ids: (R, 77) token ids, or ``prompt`` (a string: one row; a
        list: a row each), tokenized.  ``batch_size`` None gives one lane a
        row; a larger batch cycles the rows (row i % R on lane i); a batch
        smaller than R raises ``ValueError``.  ``initial_latents`` (B, H/8,
        W/8, 4) or drawn from ``torch.Generator().manual_seed(seed)`` on the
        device.  Images as :meth:`generate` returns them."""
        dev, dtype, impl, mesh = self._device(), self.dtype, self.impl, self.mesh
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"output_dtype must be 'float32' or 'uint8', got {output_dtype!r}")
        if cond_ids is None:
            if prompt is None:
                raise ValueError("generate_in_one_step needs a prompt or cond_ids")
            cond_ids = self.tokenize([prompt] if isinstance(prompt, str) else list(prompt))
        rows = int(np.asarray(cond_ids).shape[0])
        b = rows if batch_size is None else int(batch_size)
        if b < rows:
            raise ValueError(f"batch_size={b} is smaller than the {rows} rows of cond_ids; "
                             "pass at most batch_size rows or omit batch_size")
        context, _ = self._context(cond_ids)
        if b != rows:  # ceil-tile then slice: lane i takes row i % rows
            context = context.repeat(-(-b // rows), 1, 1)[:b]
        lanes = None if mesh is None else mesh.lanes(b)
        if mesh is not None:
            context = pmesh.data_sharding(context, mesh)
        h, w = img_size
        latents = _Draws(dev, dtype, seed, lanes, b)("initial_latents", initial_latents,
                                                     (b, h // 8, w // 8, 4))
        alpha_t, sigma_t = (torch.tensor(v, dtype=torch.float32).sqrt().to(device=dev, dtype=dtype)
                            for v in (ONE_STEP_ALPHA2, 1.0 - ONE_STEP_ALPHA2))
        t = torch.full((1,), ONE_STEP_T, dtype=torch.long, device=dev)
        with span("denoise_step"):
            eps = self.unet(latents, t, context, impl=impl)
            with span("sampler"):
                x0 = (latents - sigma_t * eps) / alpha_t
        return _finish(self._gather(self.vae.decode(x0, impl=impl)), output_dtype,
                       "generate_in_one_step")

    @torch.no_grad()
    def inpaint(self, cond_ids=None, uncond_ids=None, input_image=None, mask=None, *, prompt=None,
                uncond_prompt: str = "", img_size: Tuple[int, int] = (512, 512),
                do_cfg: bool = True, cfg_scale: float = 7.5, strength: float = 0.8,
                inference_steps: int = 50, sampler: str = "ddpm",
                use_cosine_schedule: bool = False, seed: int = 0, encode_noise=None,
                latent_noise=None, mask_noise=None, step_noise=None,
                progress_callback: Optional[Callable] = None, progress_every: int = 5,
                return_latents: bool = False) -> np.ndarray:
        """Mask-blended inpainting of one image: (H, W, 3) uint8.

        cond_ids / uncond_ids: (1, 77) token ids, or ``prompt`` /
        ``uncond_prompt`` strings, tokenized; ``mask`` (H, W), nonzero
        where the image is regenerated (see :func:`preprocess_mask`).  The
        image is encoded with ``encode_noise`` and q-sampled at the first
        strength-truncated step with ``latent_noise``; the masked region
        starts from ``mask_noise``; the sampler runs at eta 0 (DDPM draws
        ``step_noise``).  Each of the four draws is (1, H/8, W/8, 4) (the
        step noise one such a step run) or drawn, in that order, from the
        seeded generator.  ``progress_callback``: as :meth:`generate`'s.
        The image is the decode scaled to [0, 255], clamped and truncated
        to uint8, as JAX's; ``return_latents`` gives the final latents
        instead.  Under a mesh the one lane runs on every data rank.
        """
        dev, dtype, impl = self._device(), self.dtype, self.impl
        if input_image is None or mask is None:
            raise ValueError("inpaint needs input_image and mask")
        cond_ids, uncond_ids = self._ids(cond_ids, uncond_ids, prompt, uncond_prompt, None, do_cfg,
                                         "inpaint")
        context, pooled = (self._context(cond_ids, uncond_ids) if do_cfg
                           else self._context(cond_ids))
        added_cond = self._added_cond(pooled, img_size)
        h, w = img_size
        lat_shape = (1, h // 8, w // 8, 4)
        sched = self.make_schedule(use_cosine_schedule)
        ts, prev_ts = self._timesteps(sched, inference_steps, sampler, strength)
        table = torch.as_tensor(sched.alphas_hat, device=dev)
        img = torch.as_tensor(preprocess_image(input_image, img_size), device=dev, dtype=dtype)
        regen = torch.as_tensor(preprocess_mask(mask, img_size), device=dev)
        draws = _Draws(dev, dtype, seed)
        encoded = self.vae.encode(img, noise=draws("encode_noise", encode_noise, lat_shape),
                                  impl=impl)[0]
        latents = S.forward_process(table, encoded, int(ts[0]),
                                    draws("latent_noise", latent_noise, lat_shape))
        latents = torch.where(regen, draws("mask_noise", mask_noise, lat_shape), latents)

        def blend(lat, t, eps):  # outside the mask: the image re-noised with the predicted noise
            return torch.where(regen, lat, S.forward_process(table, encoded, t, eps))

        latents = self._denoise(latents, context, ts, prev_ts, table, cfg_scale=cfg_scale,
                                do_cfg=do_cfg, order="cond_first", sampler=sampler,
                                prediction_type=sched.prediction_type, eta=0.0, draws=draws,
                                step_noise=step_noise, blend=blend,
                                progress_callback=progress_callback, progress_every=progress_every,
                                added_cond=added_cond)
        if return_latents:
            return latents.float().cpu().numpy()
        imgs = self.vae.decode(latents, impl=impl).float()
        with span("to_host"):
            _refuse_non_finite(imgs, "inpaint")
            out = scale_img(imgs.cpu().numpy(), (-1.0, 1.0), (0.0, 255.0), clamp=True)
        return out[0].astype(np.uint8)

    def training_loss(self, unet_params, images, input_ids, t, noise) -> torch.Tensor:
        """The denoising loss of the UNet on ``unet_params`` (a name -> tensor
        mapping, e.g. ``dict(pipe.unet.named_parameters())``, reaching the
        UNet through ``torch.func.functional_call``): the frozen text
        encode, the frozen VAE encode with zero noise, ``forward_process``
        at ``t`` with ``noise``, and the MSE of the prediction against the
        noise or the v-target (JAX ``training_loss``).  ``images`` (B, H, W,
        3) in [-1, 1], ``input_ids`` (B, 77), ``t`` (B,), ``noise`` (B, H/8,
        W/8, 4).  After :meth:`shard` the parameters are the rank's shards;
        on a data axis of more than one, the rank takes its lanes and the
        loss is its lanes' share summed over "data" (the gradient through
        it is the rank's share: sum it over "data", as the train step does)."""
        dev, mesh, impl = self._device(), self.mesh, self.impl
        sched = self.make_schedule()
        table = torch.as_tensor(sched.alphas_hat, device=dev)
        images, noise = (torch.as_tensor(a, device=dev, dtype=self.dtype) for a in (images, noise))
        ids, t = (torch.as_tensor(a, device=dev, dtype=torch.long) for a in (input_ids, t))
        b = images.shape[0]
        if mesh is not None and mesh.data > 1:
            lanes = mesh.lanes(b)
            images, ids, t, noise = images[lanes], ids[lanes], t[lanes], noise[lanes]
        with torch.no_grad():
            text_emb = self.text_encoder(ids, impl=impl)
            latents = self.vae.encode(images, noise=torch.zeros_like(noise), impl=impl)[0]
        x_t = S.forward_process(table, latents, t, noise)
        pred = torch.func.functional_call(self.unet, dict(unet_params), (x_t, t, text_emb),
                                          {"impl": impl})
        if sched.prediction_type == "v_prediction":
            target = S.v_prediction_targets(table, latents, noise, t)
        else:
            target = noise
        if mesh is None or mesh.data == 1:
            return torch.mean((pred - target) ** 2)
        share = ((pred - target) ** 2).sum(dtype=torch.float32) / (b * pred[0].numel())
        return mesh.all_reduce(share.to(pred.dtype), pmesh.DATA_AXIS)


def _finish(decoded: torch.Tensor, output_dtype: str, what: str) -> np.ndarray:
    """A decode in [-1, 1] -> host images in [0, 1] f32, or uint8 rounded
    (refusing a non-finite value rather than casting it)."""
    with span("to_host"):
        imgs = (decoded.float() + 1.0) / 2.0
        if output_dtype == "uint8":
            _refuse_non_finite(imgs, what)
            imgs = torch.round(imgs.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        return imgs.cpu().numpy()


def _refuse_non_finite(imgs: torch.Tensor, what: str) -> None:
    """A uint8 image cannot show a NaN, so refuse to hide one."""
    if not bool(torch.isfinite(imgs).all()):
        raise FloatingPointError(f"{what} produced non-finite image values")
