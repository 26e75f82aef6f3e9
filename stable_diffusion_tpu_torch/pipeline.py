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
take token ids: :meth:`StableDiffusion.tokenize` makes them with the
pipeline's tokenizer (``tokenizer.py``, or any object with
``transformers``' ``batch_encode_plus``).  :meth:`StableDiffusion.from_pretrained`
loads a diffusers directory or a single LDM file
(``utils/model_converter.py``); the CLI is ``inference_torch.py`` at the
repository's root.

The pipeline carries its scheduler config, as JAX's does
(``scheduler_config``, ``make_schedule``), and denoises with that config's
``prediction_type``: :meth:`StableDiffusion.for_version` builds SD1.5
(ViT-L, epsilon) or SD2.1 (OpenCLIP ViT-H, v-prediction), mirroring the JAX
package's ``sd_version`` choice.  Without a config the schedule is SD1.5's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from stable_diffusion_tpu_torch.models.unet import UNet, UNetConfig
from stable_diffusion_tpu_torch.models.vae import VAE, VAEConfig
from stable_diffusion_tpu_torch.schedulers import schedule as S

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
    device."""

    def __init__(self, device, dtype, seed: int):
        self.device, self.dtype = device, dtype
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, name: str, given, shape) -> torch.Tensor:
        if given is None:
            return torch.randn(shape, generator=self.gen, device=self.device).to(self.dtype)
        t = (given.to(device=self.device, dtype=self.dtype) if isinstance(given, torch.Tensor)
             else torch.tensor(np.asarray(given), device=self.device, dtype=self.dtype))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} {tuple(t.shape)}, expected {tuple(shape)}")
        return t


@dataclasses.dataclass
class StableDiffusion:
    """The three models on one device, in one dtype, the ``impl`` switch and
    the scheduler config (None: SD1.5's)."""

    unet: UNet
    text_encoder: CLIPTextModel
    vae: VAE
    impl: str = "auto"
    scheduler_config: Optional[dict] = None
    tokenizer: Any = None

    @classmethod
    def build(cls, unet_config: UNetConfig, text_config: CLIPTextConfig,
              vae_config: VAEConfig = VAEConfig(), *, device="cuda", dtype=torch.float32,
              impl: str = "auto", scheduler_config: Optional[dict] = None) -> "StableDiffusion":
        """Uninitialised models on ``device`` (the card unless the caller asks
        for the CPU): load a state_dict into each
        (``utils.weights.from_jax_params``) or initialise them
        (``utils.weights.init_random_``) before generating.  On a CUDA device
        the kernels take bf16: build with ``dtype=torch.bfloat16``, or use
        ``impl="torch"`` for f32 (the kernels raise on f32 rather than fall
        back)."""
        from stable_diffusion_tpu_torch.utils.weights import build

        return cls(unet=build(UNet, unet_config, device=device, dtype=dtype),
                   text_encoder=build(CLIPTextModel, text_config, device=device, dtype=dtype),
                   vae=build(VAE, vae_config, device=device, dtype=dtype), impl=impl,
                   scheduler_config=scheduler_config)

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
        optional ``scheduler/scheduler_config.json``) or of a single
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
            pipe = cls.build(UNetConfig.from_dict(config("unet")),
                             CLIPTextConfig.from_dict(config("text_encoder")),
                             VAEConfig.from_dict(config("vae")), device=device, dtype=dtype,
                             impl=impl,
                             scheduler_config=config("scheduler", "scheduler_config.json")
                             if os.path.exists(sched) else None)
            states = {
                "unet": mc.load_unet_diffusers(
                    os.path.join(path, "unet", "diffusion_pytorch_model.safetensors")),
                "text_encoder": mc.load_text_encoder_diffusers(
                    os.path.join(path, "text_encoder", "model.safetensors")),
                "vae": mc.load_vae_diffusers(
                    os.path.join(path, "vae", "diffusion_pytorch_model.safetensors")),
            }
        for name in ("unet", "text_encoder", "vae"):
            mc.load_into(getattr(pipe, name), states.pop(name))
        pipe.tokenizer = tokenizer
        return pipe

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

    def _context(self, first_ids, second_ids=None) -> torch.Tensor:
        """The text tower on [first; second] token ids (second None: first alone)."""
        ids = [torch.as_tensor(np.asarray(i), dtype=torch.long, device=self.device)
               for i in (first_ids, second_ids) if i is not None]
        return self.text_encoder(torch.cat(ids, dim=0), impl=self.impl)

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
                 deepcache_interval: int = 1) -> torch.Tensor:
        """The denoise loop: CFG UNet step, ``blend(latents, t, eps)`` (inpaint),
        then the sampler's step; DDPM takes a fresh noise every step, DDIM
        one only when eta > 0.  With ``deepcache_interval`` k > 1 (JAX
        ``_denoise_scan``): the full UNet at steps i % k == 0, which also
        gives the deep feature to hold, and the cached pass on the held
        feature between them; the held feature starts as zeros."""
        needs_noise = sampler == "ddpm" or eta > 0
        if step_noise is not None and needs_noise:
            want = (len(ts), *latents.shape)
            step_noise = draws("step_noise", step_noise, want)
        k = int(deepcache_interval)
        if k > 1:
            b, h, w = latents.shape[0] * (2 if do_cfg else 1), *latents.shape[1:3]
            deep = torch.zeros((b, h, w, self.unet.cfg.block_out_channels[1]),
                               dtype=latents.dtype, device=latents.device)
        for i, (t, pt) in enumerate(zip(ts.tolist(), prev_ts.tolist())):
            model_in = torch.cat([latents, latents], dim=0) if do_cfg else latents
            t_in = torch.full((1,), t, dtype=torch.long, device=latents.device)
            if k <= 1:
                pred = self.unet(model_in, t_in, context, impl=self.impl)
            elif i % k == 0:
                pred, deep = self.unet.forward_split(model_in, t_in, context, impl=self.impl)
            else:
                pred = self.unet.forward_cached(model_in, t_in, context, deep, impl=self.impl)
            eps = cfg_combine(pred, cfg_scale, order) if do_cfg else pred
            if blend is not None:
                latents = blend(latents, t, eps)
            noise = None
            if needs_noise:
                noise = (step_noise[i] if step_noise is not None
                         else draws("step noise", None, latents.shape))
            latents = _sampler_step(table, latents, t, pt, eps, noise, sampler, prediction_type,
                                    eta)
        return latents

    @torch.no_grad()
    def generate(self, cond_ids=None, uncond_ids=None, *, input_image=None, input_latents=None,
                 img_size: Tuple[int, int] = (512, 512), do_cfg: bool = True,
                 cfg_scale: float = 7.5, strength: float = 0.8, inference_steps: int = 50,
                 sampler: str = "ddim", use_cosine_schedule: bool = False, eta: float = 0.0,
                 seed: int = 0, deepcache_interval: int = 1, context=None, initial_latents=None,
                 encode_noise=None, latent_noise=None, step_noise=None,
                 return_latents: bool = False, output_dtype: str = "float32") -> np.ndarray:
        """txt2img, or img2img with ``input_image`` (an (H, W, 3) array or PIL
        image, preprocessed to ``img_size`` and encoded) or ``input_latents``
        (the unscaled latent of one image, or of each lane).

        cond_ids / uncond_ids: (B, 77) token ids (uncond needed with CFG).
        ``context`` replaces both the ids and the text tower (class2img: a
        ``ClassEncoder`` embedding): (B', D) is taken as one token, (B', S,
        D) as it is; with CFG it holds the [uncond; cond] halves, B' = 2B.
        sampler: "ddim" (eta as given) or "ddpm"; ``use_cosine_schedule``
        picks the cosine tables.  img2img runs the last ``int(steps *
        strength)`` steps from the latent q-sampled at the first of them.
        ``deepcache_interval`` k > 1 runs the full UNet every k-th step and
        the DeepCache pass (the shallow stage around the held deep feature)
        between; k <= 1 is the exact loop.
        Injected draws: ``initial_latents`` (txt2img start), ``encode_noise``
        (1, H/8, W/8, 4), ``latent_noise`` (B, H/8, W/8, 4; img2img's
        q-sample), ``step_noise`` (steps run, B, H/8, W/8, 4); the others
        are drawn from ``torch.Generator().manual_seed(seed)`` on the device.
        Returns the latents (B, H/8, W/8, 4) f32 with ``return_latents``, else
        (B, H, W, 3) images: float32 in [0, 1], or uint8 when
        ``output_dtype="uint8"`` (which raises FloatingPointError rather
        than cast a non-finite value).
        """
        dev, dtype, impl = self._device(), self.dtype, self.impl
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"output_dtype must be 'float32' or 'uint8', got {output_dtype!r}")
        if context is not None:
            context = torch.as_tensor(context).to(device=dev, dtype=dtype)
            if context.dim() == 2:
                context = context[:, None, :]
            if do_cfg and context.shape[0] % 2:
                raise ValueError(f"with CFG the context holds [uncond; cond], got "
                                 f"{context.shape[0]} rows")
            b = context.shape[0] // (2 if do_cfg else 1)
        else:
            if cond_ids is None:
                raise ValueError("generate needs cond_ids or a context")
            if do_cfg and uncond_ids is None:
                raise ValueError("classifier-free guidance needs uncond_ids")
            context = self._context(uncond_ids, cond_ids) if do_cfg else self._context(cond_ids)
            b = int(np.asarray(cond_ids).shape[0])
        h, w = img_size
        lat_shape = (b, h // 8, w // 8, 4)
        is_img2img = input_image is not None or input_latents is not None
        sched = self.make_schedule(use_cosine_schedule)
        ts, prev_ts = self._timesteps(sched, inference_steps, sampler,
                                      strength if is_img2img else None)
        table = torch.as_tensor(sched.alphas_hat, device=dev)
        draws = _Draws(dev, dtype, seed)
        if is_img2img:
            if input_latents is None:
                img = torch.as_tensor(preprocess_image(input_image, img_size), device=dev,
                                      dtype=dtype)
                lat0 = self.vae.encode(img, noise=draws("encode_noise", encode_noise,
                                                        (1, *lat_shape[1:])), impl=impl)[0]
            else:
                lat0 = torch.tensor(np.asarray(input_latents), device=dev, dtype=dtype)
            noise = draws("latent_noise", latent_noise, lat_shape)
            latents = S.forward_process(table, lat0, int(ts[0]), noise)
        else:
            latents = draws("initial_latents", initial_latents, lat_shape)

        latents = self._denoise(latents, context, ts, prev_ts, table, cfg_scale=cfg_scale,
                                do_cfg=do_cfg, order="uncond_first", sampler=sampler,
                                prediction_type=sched.prediction_type, eta=eta, draws=draws,
                                step_noise=step_noise, deepcache_interval=deepcache_interval)
        if return_latents:
            return latents.float().cpu().numpy()
        return _finish(self.vae.decode(latents, impl=impl), output_dtype, "generate")

    @torch.no_grad()
    def generate_in_one_step(self, cond_ids, *, img_size: Tuple[int, int] = (512, 512),
                             batch_size: Optional[int] = None, initial_latents=None, seed: int = 0,
                             output_dtype: str = "float32") -> np.ndarray:
        """SwiftBrush one-step txt2img: one UNet pass at t = 999 on the
        starting latents z, x0 = (z - sigma_T eps) / alpha_T with alpha_T^2
        = 0.0047, then the decode; no guidance.

        cond_ids: (R, 77) token ids.  ``batch_size`` None gives one lane a
        row; a larger batch cycles the rows (row i % R on lane i); a batch
        smaller than R raises ``ValueError``.  ``initial_latents`` (B, H/8,
        W/8, 4) or drawn from ``torch.Generator().manual_seed(seed)`` on the
        device.  Images as :meth:`generate` returns them."""
        dev, dtype, impl = self._device(), self.dtype, self.impl
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"output_dtype must be 'float32' or 'uint8', got {output_dtype!r}")
        rows = int(np.asarray(cond_ids).shape[0])
        b = rows if batch_size is None else int(batch_size)
        if b < rows:
            raise ValueError(f"batch_size={b} is smaller than the {rows} rows of cond_ids; "
                             "pass at most batch_size rows or omit batch_size")
        context = self._context(cond_ids)
        if b != rows:  # ceil-tile then slice: lane i takes row i % rows
            context = context.repeat(-(-b // rows), 1, 1)[:b]
        h, w = img_size
        latents = _Draws(dev, dtype, seed)("initial_latents", initial_latents,
                                           (b, h // 8, w // 8, 4))
        alpha_t, sigma_t = (torch.tensor(v, dtype=torch.float32).sqrt().to(device=dev, dtype=dtype)
                            for v in (ONE_STEP_ALPHA2, 1.0 - ONE_STEP_ALPHA2))
        t = torch.full((1,), ONE_STEP_T, dtype=torch.long, device=dev)
        eps = self.unet(latents, t, context, impl=impl)
        x0 = (latents - sigma_t * eps) / alpha_t
        return _finish(self.vae.decode(x0, impl=impl), output_dtype, "generate_in_one_step")

    @torch.no_grad()
    def inpaint(self, cond_ids, uncond_ids, input_image, mask, *,
                img_size: Tuple[int, int] = (512, 512), do_cfg: bool = True,
                cfg_scale: float = 7.5, strength: float = 0.8, inference_steps: int = 50,
                sampler: str = "ddpm", use_cosine_schedule: bool = False, seed: int = 0,
                encode_noise=None, latent_noise=None, mask_noise=None, step_noise=None,
                return_latents: bool = False) -> np.ndarray:
        """Mask-blended inpainting of one image: (H, W, 3) uint8.

        cond_ids / uncond_ids: (1, 77) token ids; ``mask`` (H, W), nonzero
        where the image is regenerated (see :func:`preprocess_mask`).  The
        image is encoded with ``encode_noise`` and q-sampled at the first
        strength-truncated step with ``latent_noise``; the masked region
        starts from ``mask_noise``; the sampler runs at eta 0 (DDPM draws
        ``step_noise``).  Each of the four draws is (1, H/8, W/8, 4) (the
        step noise one such a step run) or drawn, in that order, from the
        seeded generator.  The image is the decode scaled to [0, 255],
        clamped and truncated to uint8, as JAX's; ``return_latents`` gives
        the final latents instead.
        """
        dev, dtype, impl = self._device(), self.dtype, self.impl
        if do_cfg and uncond_ids is None:
            raise ValueError("classifier-free guidance needs uncond_ids")
        context = self._context(cond_ids, uncond_ids) if do_cfg else self._context(cond_ids)
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
                                step_noise=step_noise, blend=blend)
        if return_latents:
            return latents.float().cpu().numpy()
        imgs = self.vae.decode(latents, impl=impl).float()
        _refuse_non_finite(imgs, "inpaint")
        out = scale_img(imgs.cpu().numpy(), (-1.0, 1.0), (0.0, 255.0), clamp=True)
        return out[0].astype(np.uint8)


def _finish(decoded: torch.Tensor, output_dtype: str, what: str) -> np.ndarray:
    """A decode in [-1, 1] -> host images in [0, 1] f32, or uint8 rounded
    (refusing a non-finite value rather than casting it)."""
    imgs = (decoded.float() + 1.0) / 2.0
    if output_dtype == "uint8":
        _refuse_non_finite(imgs, what)
        imgs = torch.round(imgs.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    return imgs.cpu().numpy()


def _refuse_non_finite(imgs: torch.Tensor, what: str) -> None:
    """A uint8 image cannot show a NaN, so refuse to hide one."""
    if not bool(torch.isfinite(imgs).all()):
        raise FloatingPointError(f"{what} produced non-finite image values")
