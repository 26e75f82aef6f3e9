"""The port's static-W8A8 text tower and calibration sweeps against the JAX
package's, on the CPU in f32.

``quantize_text_encoder_static`` at the tiny ``TEXT`` of
tests/test_torch_training.py, JAX-initialised and bridged: every act_scale
within 1e-6 relative of JAX's (absmaxes of the same f32 activations, summed
in another order), the int8 kernels and weight scales equal, q/k/v sharing
one scale (they read one input), each W8A8 linear given JAX's own input at
that site within 1e-6 of JAX's output, and the whole W8A8 tower against
JAX's with the code flips of ROADMAP §3 allowed for (see its test).
``calibrate_cond_encoder`` with one tokenizer (the port's, on a synthesized vocabulary) given to both, to 1e-6
relative.  ``calibrate_unet`` on JAX's own latents (key(seed) split, first
half), its denoise a 3-step DDIM of each package's pipeline, to 1e-5
relative.
"""

import copy

import numpy as np
import jax
import pytest
import torch

from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.utils import quantize_model as JQM
from stable_diffusion_tpu_torch.models import layers
from stable_diffusion_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from stable_diffusion_tpu_torch.tokenizer import load_tokenizer
from stable_diffusion_tpu_torch.utils import quantize_model as TQM
from stable_diffusion_tpu_torch.utils.weights import flatten_tree, from_jax_params, to_jax_params
from tests import torch_checkpoints as C
from tests.torch_threads import one_thread  # noqa: F401

TEXT = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=77, vocab_size=64)
SCALE_RTOL = 1e-6
OUT_TOL = 1e-5


def _tower(jparams, cfg):
    tower = CLIPTextModel(CLIPTextConfig(**cfg))
    tower.load_state_dict(from_jax_params(jparams), strict=True)
    return tower


@pytest.fixture(scope="module")
def quantized():
    jcfg = jclip.CLIPTextConfig(**TEXT)
    jparams = jclip.init_text_model(jax.random.key(0), jcfg)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 64, size=(2, 77)).astype(np.int64) for _ in range(3)]
    jq = JQM.quantize_text_encoder_static(jparams, jcfg, batches)
    tower = _tower(jparams, TEXT)
    tq = TQM.quantize_text_encoder_static(copy.deepcopy(tower), batches, impl="torch")
    return jparams, jq, tower, tq, batches


def test_act_scales_and_codes_match_jax(quantized):
    _, jq, _, tq, _ = quantized
    want = {k: np.asarray(v) for k, v in flatten_tree(jq).items()}
    got = flatten_tree(to_jax_params(tq))
    assert sorted(got) == sorted(want)
    scales = [k for k in want if k.endswith("act_scale")]
    assert len(scales) == len([k for k in want if k.endswith("kernel_q")]) == 12
    for k in scales:
        np.testing.assert_allclose(got[k], want[k], rtol=SCALE_RTOL, err_msg=k)
    for k in want:
        if k.endswith(("kernel_q", "kernel_scale")):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_every_linear_is_w8a8_and_qkv_share_a_scale(quantized):
    tq = quantized[3]
    holders = [m for m in tq.modules() if isinstance(m, layers.QLinear)]
    assert len(holders) == 12 and all(m.w8a8 for m in holders)
    assert not any(isinstance(m, torch.nn.Linear) for m in tq.modules())
    for layer in tq.encoder.layers.values():
        a = layer.self_attn
        assert a.q_proj.act_scale == a.k_proj.act_scale == a.v_proj.act_scale


def _jax_sites(jq, ids):
    """Each W8A8 linear of JAX's tower: its path, and its input and output
    in JAX's own forward (q, k and v apart, as JAX's calibration routes
    them: they read the same input)."""
    from stable_diffusion_tpu.models import layers as JL

    paths = {id(v): k[:-len(".kernel_q")] for k, v in _subtrees(jq)}
    seen = []
    orig = JL.linear

    def capturing(p, x):
        y = orig(p, x)
        seen.append((paths[id(p)], np.asarray(x), np.asarray(y)))
        return y

    JL.linear, JL.FORCE_UNFUSED_QKV = capturing, True
    try:
        out = np.asarray(jclip.text_model_apply(jq, ids, jclip.CLIPTextConfig(**TEXT), impl="xla"))
    finally:
        JL.linear, JL.FORCE_UNFUSED_QKV = orig, False
    return seen, out


def _subtrees(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            if "kernel_q" in v:
                yield path + ".kernel_q", v
            yield from _subtrees(v, path)


def test_w8a8_linears_match_jax_on_jax_inputs(quantized):
    """Every W8A8 linear of the tower, given the input JAX's forward gave its
    counterpart, returns JAX's output: the same codes, the same int32
    product, the same dequantization (to 1e-6 of the site's largest value)."""
    tq = quantized[3]
    ids = np.random.default_rng(5).integers(0, 64, size=(2, 77))
    seen, _ = _jax_sites(quantized[1], ids)
    assert len(seen) == 12
    for path, x, y in seen:
        with torch.no_grad():
            got = layers.linear(tq.get_submodule(path), torch.from_numpy(x.copy()), impl="torch").numpy()
        assert np.abs(got - y).max() <= 1e-6 * np.abs(y).max(), path


@pytest.mark.parametrize("seed", range(4))
def test_w8a8_tower_matches_jax(quantized, seed):
    """The whole W8A8 tower against JAX's.  The two packages' f32 sums differ
    by ~1e-7, which flips an int8 code at a near-tie: ~25k codes a forward
    make a flip likely on any input (ROADMAP §3); the flips of these inputs
    move the output by at most 6e-3 of its largest value and 2.1e-3 in
    relative L2.  So: the median element within 1e-6 of the largest
    |output|, fewer than a fifth of them beyond 1e-5, every one within
    1e-2, relative L2 within 5e-3; and the float tower at least twice that
    far (1.1e-2-1.2e-2: the quantization is in effect)."""
    _, jq, tower, tq, _ = quantized
    ids = np.random.default_rng(seed).integers(0, 64, size=(2, 77))
    want = np.asarray(jclip.text_model_apply(jq, ids, jclip.CLIPTextConfig(**TEXT), impl="xla"))
    with torch.no_grad():
        got = tq(torch.from_numpy(ids), impl="torch").numpy()
        base = tower(torch.from_numpy(ids), impl="torch").numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert np.median(err) <= 1e-6 * scale and np.mean(err > OUT_TOL * scale) < 0.2
    assert err.max() <= 1e-2 * scale
    rel = lambda a: np.linalg.norm(a - want) / np.linalg.norm(want)  # noqa: E731
    assert rel(got) <= 5e-3 and rel(base) > 1e-2


def test_calibrate_cond_encoder_matches_jax(tmp_path_factory):
    vocab = tmp_path_factory.mktemp("vocab")
    C.write_vocab(str(vocab))
    tok = load_tokenizer(str(vocab))
    cfg = dict(TEXT, vocab_size=49408)
    jcfg = jclip.CLIPTextConfig(**cfg)
    jparams = jclip.init_text_model(jax.random.key(1), jcfg)
    want = JQM.calibrate_cond_encoder(
        lambda p, ids: jclip.text_model_apply(p, ids, jcfg, impl="xla"), jparams, tok)
    got = TQM.calibrate_cond_encoder(lambda m, ids: m(ids, impl="torch"),
                                     _tower(jparams, cfg), tok)
    assert got["n_prompts"] == want["n_prompts"] == len(TQM.DEFAULT_CALIBRATION_PROMPTS)
    np.testing.assert_allclose(got["activation_absmax"], want["activation_absmax"], rtol=1e-6)


def test_calibrate_unet_on_jax_latents():
    from test_torch_img2img import TEXT as PTEXT, UNET, VAE, _ids, _jax, _port
    from stable_diffusion_tpu.models import clip as jc, unet as ju, vae as jv

    ks = jax.random.split(jax.random.key(3), 3)
    params = {"unet": ju.init_unet(ks[0], ju.UNetConfig(**UNET)),
              "text_encoder": jc.init_text_model(ks[1], jc.CLIPTextConfig(**PTEXT)),
              "vae": jv.init_vae(ks[2], jv.VAEConfig(**VAE))}
    ids, unc = _ids(1)
    kw = dict(img_size=(32, 32), inference_steps=3, cfg_scale=4.0, return_latents=True)
    jpipe, pipe = _jax(params), _port(params)
    shape, seed = (1, 4, 4, 4), 7
    want = JQM.calibrate_unet(
        lambda lat, key: jpipe.generate("", cond_ids=ids, uncond_ids=unc, initial_latents=lat,
                                        **kw),
        latent_shape=shape, steps=3, seed=seed)
    k1, _ = jax.random.split(jax.random.key(seed))
    latents = np.asarray(jax.random.normal(k1, shape))
    got = TQM.calibrate_unet(
        lambda lat, gen: pipe.generate(ids, unc, initial_latents=lat.numpy(), **kw),
        latent_shape=shape, steps=3, seed=seed, latents=latents, device="cpu")
    assert got["steps"] == want["steps"] == 3
    np.testing.assert_allclose(got["latent_absmax"], want["latent_absmax"], rtol=1e-5)
    # without the JAX latents: a seeded draw on the device, the same for one seed
    a, b = (TQM.calibrate_unet(lambda lat, gen: lat, latent_shape=shape, seed=s, device="cpu")
            for s in (1, 1))
    assert a == b and np.isfinite(a["latent_absmax"])
