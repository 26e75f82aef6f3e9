"""The port's ``impl`` switch and its independence from JAX.

``impl="cuda"`` on a CPU tensor raises in every kernel wrapper (nothing
falls back to the plain version), ``"auto"`` on the CPU runs the plain
version, and the package imports and runs a forward with ``jax`` blocked."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from stable_diffusion_tpu_torch.ops import conv, ffn, flash_attention, groupnorm
from stable_diffusion_tpu_torch.utils.device import use_kernel
from tests.torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _calls():
    x = torch.randn(1, 4, 4, 32)
    w, b = torch.ones(32), torch.zeros(32)
    cw = torch.randn(32, 32, 3, 3)
    q = torch.randn(1, 16, 2, 16)
    f1, f2 = torch.randn(256, 32), torch.randn(32, 128)
    tokens = torch.randn(1, 16, 32)
    return {
        "gn_scale_shift": lambda impl: groupnorm.gn_scale_shift(x, w, b, impl=impl),
        "group_norm_silu": lambda impl: groupnorm.group_norm_silu(x, w, b, impl=impl),
        "conv3x3": lambda impl: conv.conv3x3(x, cw, impl=impl),
        "gn_silu_conv3x3": lambda impl: conv.gn_silu_conv3x3(x, w, b, cw, impl=impl),
        "attention": lambda impl: flash_attention.attention(q, q, q, impl=impl),
        "geglu_ffn": lambda impl: ffn.geglu_ffn(tokens, w, b, f1, torch.zeros(256), f2,
                                                 torch.zeros(32), tokens, impl=impl),
    }


@pytest.mark.parametrize("name", sorted(_calls()))
def test_cuda_impl_on_cpu_tensor_raises(name):
    counters = [groupnorm.K1, conv.K2, flash_attention.K3, ffn.K4]
    before = [c.launches for c in counters]
    with pytest.raises(ValueError, match="CUDA tensor"):
        _calls()[name]("cuda")
    out = _calls()[name]("auto")  # the plain version, because the tensor is on the CPU
    assert torch.isfinite(out).all()
    assert [c.launches for c in counters] == before


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown impl"):
        use_kernel("pallas", torch.zeros(1))


def test_pipeline_refuses_cuda_impl_on_cpu():
    from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig
    from stable_diffusion_tpu_torch.models.unet import UNetConfig
    from stable_diffusion_tpu_torch.models.vae import VAEConfig
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion

    pipe = StableDiffusion.build(
        UNetConfig(block_out_channels=(32, 32), attention_head_dim=2, cross_attention_dim=16,
                   down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"), t_embed_dim=8),
        CLIPTextConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                       num_attention_heads=2, vocab_size=10),
        VAEConfig(ch_mult=(1,), base_channels=32), device="cpu", impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        pipe.generate([[1] * 77], [[0] * 77], img_size=(16, 16), inference_steps=1)


def test_port_runs_with_jax_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None  # any import of jax now raises ImportError
        sys.modules["stable_diffusion_tpu"] = None
        import numpy as np, torch
        from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig
        from stable_diffusion_tpu_torch.models.unet import UNetConfig
        from stable_diffusion_tpu_torch.models.vae import VAEConfig
        from stable_diffusion_tpu_torch.pipeline import StableDiffusion
        from stable_diffusion_tpu_torch.utils.weights import init_random_
        import stable_diffusion_tpu_torch.ops.attention, stable_diffusion_tpu_torch.ops.linear
        import stable_diffusion_tpu_torch.ops._cuda
        pipe = StableDiffusion.build(
            UNetConfig(block_out_channels=(32, 32), attention_head_dim=2, cross_attention_dim=16,
                       down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"), t_embed_dim=8),
            CLIPTextConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                           num_attention_heads=2, vocab_size=10),
            VAEConfig(ch_mult=(1, 1, 1, 1), base_channels=32), device="cpu")
        for m in (pipe.unet, pipe.text_encoder, pipe.vae):
            init_random_(m, 0)
        img = pipe.generate([[1] * 77], [[0] * 77], img_size=(16, 16), inference_steps=1,
                            output_dtype="uint8")
        assert img.shape == (1, 16, 16, 3) and img.dtype == np.uint8
        assert not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
