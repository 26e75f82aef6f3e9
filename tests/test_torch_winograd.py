"""K12's plain version (stable_diffusion_tpu_torch/ops/winograd.py) against
the JAX package's Winograd F(2x2, 3x3) conv, and the SD_TPU_WINOGRAD route.

The JAX side runs its Pallas kernel (``conv3x3_winograd``, and
``ops/conv._gn_silu_conv`` under SD_TPU_WINOGRAD=1) in
``pltpu.force_tpu_interpret_mode()``; the same numpy inputs go through the
port in f32 on the CPU.  Tolerance 1e-5 relative to the largest output, as
tests/test_winograd.py holds the JAX kernel against the XLA conv."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stable_diffusion_tpu.ops import conv as jconv
from stable_diffusion_tpu.ops import winograd as jwg
from stable_diffusion_tpu_torch.ops import conv as tconv
from stable_diffusion_tpu_torch.ops import winograd as twg
from tests.torch_threads import one_thread  # noqa: F401

TOL = 1e-5
SHAPES = [(1, 16, 16, 128, 128), (2, 8, 32, 320, 320), (1, 16, 16, 192, 256)]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err < tol, err


def _inputs(seed, b, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    bias = rng.standard_normal((cout,)).astype(np.float32)
    return x, k, bias


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("shape", SHAPES)
def test_k12_plain_matches_jax_winograd(shape):
    x, k, bias = _inputs(0, *shape)
    with pltpu.force_tpu_interpret_mode():
        want = jwg.conv3x3_winograd(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    got = twg.conv3x3_winograd_plain(torch.from_numpy(x), _oihw(k), torch.from_numpy(bias))
    _close(got, want)
    # and the function it must equal: the direct conv
    _close(got, tconv.conv3x3_plain(torch.from_numpy(x), _oihw(k), torch.from_numpy(bias)))


def test_k12_transform_kernel_matches_jax():
    _, k, _ = _inputs(1, 1, 2, 2, 24, 40)
    want = np.asarray(jwg.transform_kernel(jnp.asarray(k), 24))
    got = twg.transform_kernel(torch.from_numpy(k))
    assert got.shape == (16, 24, 40)
    _close(got, want, 1e-6)
    u = twg.u_tiles(_oihw(k))
    assert u.shape == (16, 40, 24) and u.is_contiguous()
    _close(u.transpose(1, 2), want, 1e-6)


@pytest.mark.parametrize("mode", ["0", "1"])
def test_route_matches_jax(monkeypatch, mode):
    """Where the TPU kernel's VMEM plan takes a shape, the port routes it
    exactly as JAX's ``route``; the port drops that plan (a TPU layout
    rule), so it also routes the wide shapes the plan refused."""
    monkeypatch.setenv("SD_TPU_WINOGRAD", mode)
    cases = [((1, 16, 16, 128), 128, 1, "SAME"), ((2, 96, 96, 320), 320, 1, "SAME"),
             ((2, 48, 48, 640), 640, 1, "SAME"), ((2, 24, 24, 1280), 1280, 1, "SAME"),
             ((2, 12, 12, 1280), 1280, 1, "SAME"), ((1, 15, 16, 64), 64, 1, "SAME"),
             ((1, 16, 14, 64), 64, 1, "SAME"), ((1, 16, 16, 64), 64, 2, "SAME"),
             ((1, 16, 16, 64), 64, 1, "VALID"), ((1, 16, 16, 64), 64, 1, 1)]
    planned = 0
    for shape, cout, stride, pad in cases:
        jx = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
        jk = jax.ShapeDtypeStruct((3, 3, shape[-1], cout), jnp.bfloat16)
        tx = torch.empty(shape, dtype=torch.bfloat16, device="meta")
        tk = torch.empty((cout, shape[-1], 3, 3), dtype=torch.bfloat16, device="meta")
        got = twg.route(tx, tk, stride, pad)
        assert twg.supported(tx, tk, stride, pad) == got
        if jwg._plan(*shape[1:], cout, 2)[0] > 0:  # the TPU plan takes the shape
            planned += 1
            assert got == jwg.route(jx, jk, stride, pad), (shape, stride, pad)
        with monkeypatch.context() as m:  # JAX's rule without its VMEM plan
            m.setattr(jwg, "_plan", lambda *a: (1, 1, 1))
            assert got == jwg.route(jx, jk, stride, pad), (shape, stride, pad)
    assert planned >= 6
    # the 768^2 VAE stages: the TPU plan has no tile row for W/2 = 384
    tx = torch.empty((1, 768, 768, 128), dtype=torch.bfloat16, device="meta")
    tk = torch.empty((128, 128, 3, 3), dtype=torch.bfloat16, device="meta")
    jx = jax.ShapeDtypeStruct((1, 768, 768, 128), jnp.bfloat16)
    jk = jax.ShapeDtypeStruct((3, 3, 128, 128), jnp.bfloat16)
    assert not jwg.route(jx, jk, 1, "SAME")
    assert twg.route(tx, tk) == (mode == "1")


def test_k12_gn_silu_prologue_matches_jax(monkeypatch):
    """The GroupNorm+SiLU prologue: the port's routed ``gn_silu_conv3x3``
    against JAX ``_gn_silu_conv`` (stats kernel + Winograd kernel)."""
    monkeypatch.setenv("SD_TPU_WINOGRAD", "1")
    b, h, w, cin, cout = 2, 16, 16, 128, 64
    x, k, bias = _inputs(2, b, h, w, cin, cout)
    rng = np.random.default_rng(3)
    gamma = (1 + 0.1 * rng.standard_normal(cin)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(cin)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jconv._gn_silu_conv(jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(x),
                                   jnp.asarray(k), jnp.asarray(bias), 32, 1e-5)
    args = (torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta), _oihw(k),
            torch.from_numpy(bias))
    _close(tconv.gn_silu_conv3x3(*args, impl="auto"), want)
    _close(tconv.gn_silu_conv3x3(*args, impl="torch"), want)
    monkeypatch.setenv("SD_TPU_WINOGRAD", "0")  # the direct route: the same function
    _close(tconv.gn_silu_conv3x3(*args, impl="auto"), want)


def test_k12_entries_route_and_keep_gradients(monkeypatch):
    """``conv3x3`` sends a routed shape to the Winograd form; under autograd
    its gradients are the direct conv's (the recompute VJP)."""
    x, k, bias = _inputs(4, 1, 16, 16, 32, 16)
    tx, tw, tb = (torch.from_numpy(a).double().requires_grad_() for a in (x, k, bias))
    w = tw.permute(3, 2, 0, 1)
    monkeypatch.setenv("SD_TPU_WINOGRAD", "1")
    y1 = tconv.conv3x3(tx, w, tb, impl="auto")
    g1 = torch.autograd.grad(y1.square().sum(), (tx, tw, tb))
    monkeypatch.setenv("SD_TPU_WINOGRAD", "0")
    y0 = tconv.conv3x3(tx, w, tb, impl="auto")
    g0 = torch.autograd.grad(y0.square().sum(), (tx, tw, tb))
    _close(y1.detach(), y0.detach(), 1e-12)
    for a, b in zip(g1, g0):
        _close(a, b, 1e-12)
