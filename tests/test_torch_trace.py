"""The port's spans (``utils/device.py`` ``span``, ``SPANS``) under
``torch.profiler`` on the CPU, on the tiny models: none while the recorder
is off; with it on, each span of a 2-step CFG ``generate``, a
``generate_in_one_step`` and one LoRA train step, counted exactly, nested
where the work nests, and counted by the recorder as the trace counts them.
(``tests/test_torch_gpu.py`` holds a K2 launch inside ``sd.K2`` on the card.)
"""

import collections

import pytest
import torch

from stable_diffusion_tpu_torch import training as T
from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig
from stable_diffusion_tpu_torch.models.unet import UNetConfig
from stable_diffusion_tpu_torch.models.vae import VAEConfig
from stable_diffusion_tpu_torch.pipeline import StableDiffusion
from stable_diffusion_tpu_torch.schedulers import schedule as S
from stable_diffusion_tpu_torch.utils.device import SPANS, span
from stable_diffusion_tpu_torch.utils.weights import init_random_
from tests import torch_checkpoints as C
from tests.torch_threads import one_thread  # noqa: F401

IDS = [[1] * 77]


@pytest.fixture(scope="module")
def pipe():
    p = StableDiffusion.build(UNetConfig(**C.TINY_UNET), CLIPTextConfig(**dict(C.TINY_TEXT,
                                                                              vocab_size=64)),
                              VAEConfig(**C.TINY_VAE), device="cpu", impl="torch")
    for i, m in enumerate((p.unet, p.text_encoder, p.vae)):
        init_random_(m, i)
    return p


def _generate(p):
    return p.generate(IDS, [[0] * 77], img_size=(32, 32), inference_steps=2,
                      output_dtype="uint8")


def _one_step(p):
    return p.generate_in_one_step(IDS, img_size=(32, 32), output_dtype="uint8")


def _train_step(p):
    cfg = T.TrainConfig(rank=2, alpha=2.0, grad_accum_steps=1, use_ema=True, ema_start=0,
                        lora_targets=("q_proj", "v_proj"))
    base = {"unet": p.unet}
    lora = T.init_train_state(torch.Generator().manual_seed(0), base, cfg)
    step = T.make_train_step(base, schedule=S.make_schedule(), train_cfg=cfg, impl="torch")
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randn((2, 4, 4, 4), generator=g)
             for k in ("noise", "vae_noise", "latent_mean", "latent_std")}
    batch["text_emb"] = torch.randn((2, 77, C.TINY_UNET["cross_attention_dim"]), generator=g)
    batch["t"] = torch.tensor([10, 900])
    return step(lora, batch)


def _spans(prof):
    """{name: [(start, end), ...]} of the trace's ``sd.*`` events (ns), read
    from the profiler's raw events (``prof.events()`` takes seconds to
    build its tree over a train step's ops)."""
    out = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("sd."):
            out[e.name()[3:]].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _profiled(fn, p):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn(p)
    return _spans(prof)


def test_spans_off_leave_no_trace(pipe):
    assert SPANS.calls is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _generate(pipe)
    assert not _spans(prof)
    assert span("unet") is span("vae_decode")  # the one shared null context


# the exact count of each span a call opens on the CPU (no kernel spans there);
# the tiny UNet has 16 transformer stacks (2 down and 3 up blocks at each of
# its three attention stages, and the bottleneck's)
STACKS = 16
WANT = {
    "generate": (_generate, {"text": 1, "denoise_step": 2, "unet": 2, "sampler": 2,
                             "vae_decode": 1, "to_host": 1, "transformer": 2 * STACKS}),
    "one_step": (_one_step, {"text": 1, "denoise_step": 1, "unet": 1, "sampler": 1,
                             "vae_decode": 1, "to_host": 1, "transformer": STACKS}),
    "train_step": (_train_step, {"train_step": 1, "lora_merge": 1, "unet": 1, "backward": 1,
                                 "optimizer": 1, "transformer": STACKS}),
}


@pytest.mark.parametrize("call", list(WANT))
def test_spans_counted_and_nested(pipe, call):
    fn, want = WANT[call]
    SPANS.record()
    try:
        spans = _profiled(fn, pipe)
    finally:
        recorded = SPANS.stop_recording()
    assert SPANS.calls is None
    assert {k: len(v) for k, v in spans.items()} == want
    assert recorded == collections.Counter(want)
    outer, inner = (("denoise_step", ("unet", "sampler")) if call != "train_step"
                    else ("train_step", ("lora_merge", "unet", "backward", "optimizer")))
    for name in inner:
        for s, e in spans[name]:
            assert any(s0 <= s and e <= e0 for s0, e0 in spans[outer]), (name, s, e)
    for s, e in spans["transformer"]:
        assert any(s0 <= s and e <= e0 for s0, e0 in spans["unet"]), ("transformer", s, e)
