"""K10's and K11's plain versions (stable_diffusion_tpu_torch/ops/linear.py)
against the JAX package's bf16 fused matmuls, and the SD_TPU_FUSED_MM switch.

The JAX side runs its Pallas kernels (``ln_matmul`` / ``matmul_residual`` /
``gn_matmul`` with ``impl="pallas"``, SD_TPU_FUSED_MM=all) in
``pltpu.force_tpu_interpret_mode()`` and its XLA forms (``_mm_xla``,
``_gn_mm_xla``); the same numpy inputs go through the port in f32 on the
CPU.  Tolerance 1e-5 relative to the largest output: the same f32 maths
summed in another order."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stable_diffusion_tpu.ops import linear as jfl
from stable_diffusion_tpu_torch.ops import linear as tfl
from tests.torch_threads import one_thread  # noqa: F401

TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err < tol, err


def _inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return dict(x=f(2, m // 2, k), w=f(k, n, scale=0.05), b=f(n), res=f(2, m // 2, n),
                gamma=f(k), beta=f(k))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("m,k,n", [(256, 320, 960), (128, 640, 640)])
def test_k10_ln_matmul_plain_matches_jax(monkeypatch, m, k, n):
    monkeypatch.setenv("SD_TPU_FUSED_MM", "all")
    d = _inputs(0, m, k, n)
    ln = {"scale": jnp.asarray(d["gamma"]), "bias": jnp.asarray(d["beta"])}
    with pltpu.force_tpu_interpret_mode():
        kern = jfl.ln_matmul(ln, jnp.asarray(d["x"]), jnp.asarray(d["w"]), jnp.asarray(d["b"]),
                             impl="pallas")
    xla = jfl._mm_xla(jnp.asarray(d["x"]), ln["scale"], ln["bias"], jnp.asarray(d["w"]),
                      jnp.asarray(d["b"]), None, 1e-5)
    x, w, b = _t(d["x"]), _t(d["w"].T.copy()), _t(d["b"])
    plain = tfl.linear_plain(x, w, b, None, _t(d["gamma"]), _t(d["beta"]))
    entry = tfl.ln_matmul(_t(d["gamma"]), _t(d["beta"]), x, w, b, impl="torch")
    for got in (plain, entry):
        _close(got, kern)
        _close(got, xla)


@pytest.mark.parametrize("m,k,n", [(256, 512, 320), (128, 1280, 1280)])
def test_k10_matmul_residual_plain_matches_jax(monkeypatch, m, k, n):
    monkeypatch.setenv("SD_TPU_FUSED_MM", "all")
    d = _inputs(1, m, k, n)
    args = [jnp.asarray(d[name]) for name in ("x", "w", "b", "res")]
    with pltpu.force_tpu_interpret_mode():
        kern = jfl.matmul_residual(*args, impl="pallas")
    xla = jfl._mm_xla(args[0], None, None, args[1], args[2], args[3], 1e-5)
    x, w, b, res = _t(d["x"]), _t(d["w"].T.copy()), _t(d["b"]), _t(d["res"])
    for got in (tfl.linear_plain(x, w, b, res), tfl.matmul_residual(x, w, b, res, impl="torch")):
        _close(got, kern)
        _close(got, xla)


def test_k10_ln_matmul_without_bias(monkeypatch):
    monkeypatch.setenv("SD_TPU_FUSED_MM", "all")
    d = _inputs(2, 128, 320, 384)
    ln = {"scale": jnp.asarray(d["gamma"]), "bias": jnp.asarray(d["beta"])}
    with pltpu.force_tpu_interpret_mode():
        kern = jfl.ln_matmul(ln, jnp.asarray(d["x"]), jnp.asarray(d["w"]), None, impl="pallas")
    got = tfl.linear_plain(_t(d["x"]), _t(d["w"].T.copy()), None, None, _t(d["gamma"]),
                           _t(d["beta"]))
    _close(got, kern)


@pytest.mark.parametrize("b,h,w,c,n", [(2, 16, 16, 320, 320), (1, 16, 8, 640, 640)])
def test_k11_gn_matmul_plain_matches_jax(monkeypatch, b, h, w, c, n):
    monkeypatch.setenv("SD_TPU_FUSED_MM", "all")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wk = (rng.standard_normal((c, n)) * 0.05).astype(np.float32)
    bias = rng.standard_normal((n,)).astype(np.float32)
    gamma, beta = (rng.standard_normal((c,)).astype(np.float32) for _ in range(2))
    gn = {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    with pltpu.force_tpu_interpret_mode():
        kern = jfl.gn_matmul(gn, jnp.asarray(x), jnp.asarray(wk), jnp.asarray(bias), eps=1e-6,
                             impl="pallas")
    xla = jfl._gn_mm_xla(gn["scale"], gn["bias"], jnp.asarray(x), jnp.asarray(wk),
                         jnp.asarray(bias), 32, 1e-6)
    args = (_t(x), _t(gamma), _t(beta), _t(wk.T.copy()), _t(bias))
    for got in (tfl.gn_matmul_plain(*args, eps=1e-6), tfl.gn_matmul(*args, eps=1e-6, impl="torch")):
        _close(got, kern)
        _close(got, xla)


def test_k10_k11_plain_gradients_match_jax(monkeypatch):
    """The recompute backward differentiates the plain versions: their
    gradients against ``jax.grad`` of ``_mm_xla`` / ``_gn_mm_xla``."""
    d = _inputs(4, 64, 64, 48)
    ct = np.random.default_rng(5).standard_normal((2, 32, 48)).astype(np.float32)

    def jax_loss(x, g, be, w, b, res):
        return jnp.sum(jfl._mm_xla(x, g, be, w, b, res, 1e-5) * ct)

    names = ("x", "gamma", "beta", "w", "b", "res")
    want = jax.grad(jax_loss, argnums=tuple(range(6)))(*(jnp.asarray(d[k]) for k in names))
    ts = {k: _t(d[k].T.copy() if k == "w" else d[k]).requires_grad_() for k in names}
    out = tfl.linear_plain(ts["x"], ts["w"], ts["b"], ts["res"], ts["gamma"], ts["beta"])
    got = torch.autograd.grad((out * _t(ct)).sum(), [ts[k] for k in names])
    for k, g, wnt in zip(names, got, want):
        _close(g.T if k == "w" else g, wnt)

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 4, 64)).astype(np.float32)
    wk = (rng.standard_normal((64, 32)) * 0.1).astype(np.float32)
    gm, bt, bb = (rng.standard_normal(s).astype(np.float32) for s in ((64,), (64,), (32,)))
    ct = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jfl._gn_mm_xla(*a, 32, 1e-6) * ct), argnums=tuple(range(5)))(
        *map(jnp.asarray, (gm, bt, x, wk, bb)))
    ins = [_t(a).requires_grad_() for a in (x, gm, bt, wk.T.copy(), bb)]
    out = tfl.gn_matmul_plain(*ins, eps=1e-6)
    got = torch.autograd.grad((out * _t(ct)).sum(), ins)
    for g, wnt in zip(got, (want[2], want[0], want[1], want[3].T, want[4])):
        _close(g, wnt)


# (m, k, n) of every bf16 fused-matmul site of the SD2.1 UNet at 768^2, CFG
# (UNet batch 2): per stage the resblock shortcut, GN -> conv_input, LN ->
# fused QKV, LN -> cross q, the out projections and conv_output; and SD1.5's
# 512^2 b1 and W8A8 b8 stages.
_SITES = sorted({
    (2 * s, k, n)
    for s, c in ((9216, 320), (2304, 640), (576, 1280), (144, 1280),
                 (4096, 320), (1024, 640), (256, 1280), (64, 1280))
    for k, n in ((c, c), (c, 3 * c), (2 * c, c), (c // 2 + c, c), (3 * c, c))
} | {(8 * 4096, 320, 320), (8 * 256, 2560, 1280), (512, 2048, 1280), (128, 2560, 1280)})


@pytest.mark.parametrize("mode", ["0", "envelope", "all", "1"])
def test_switch_gives_jax_site_decision(monkeypatch, mode):
    monkeypatch.setenv("SD_TPU_FUSED_MM", mode)
    assert tfl.fused_mm_enabled() == jfl.fused_mm_enabled()
    for site in ("ln", "res", "gn"):
        for m, k, n in _SITES:
            want = jfl.fused_mm_enabled() and jfl._site_wins(site, m, k, n)
            assert tfl.site_wins(site, m, k, n) == jfl._site_wins(site, m, k, n), (site, m, k, n)
            assert tfl.fused_site(site, m, k, n, "auto") == want, (mode, site, m, k, n)
            # an explicit kernel impl takes every site once the switch is on
            assert tfl.fused_site(site, m, k, n, "cuda") == jfl.fused_mm_enabled()


def test_switched_entries_on_the_cpu_are_the_unswitched_functions(monkeypatch):
    """On a CPU tensor the switch changes nothing: each entry returns what it
    returns with the switch off."""
    d = _inputs(7, 64, 64, 32)
    x, w, b, res = _t(d["x"]), _t(d["w"].T.copy()), _t(d["b"]), _t(d["res"])
    g, be = _t(d["gamma"]), _t(d["beta"])
    xs = x.reshape(2, 4, 8, 64)
    outs = []
    for mode in ("0", "all"):
        monkeypatch.setenv("SD_TPU_FUSED_MM", mode)
        outs.append([tfl.ln_matmul(g, be, x, w, b, impl="auto"),
                     tfl.matmul_residual(x, w, b, res, impl="auto"),
                     tfl.gn_matmul(xs, g, be, w, b, impl="auto")])
    for off, on in zip(*outs):
        torch.testing.assert_close(off, on, rtol=0, atol=0)
