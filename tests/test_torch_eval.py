"""The port's evaluation path against the JAX package's, on the CPU in f32:
the CLIP vision tower and score, Inception pool3 features, the Fréchet
distance and ``evaluation_torch.main``.

CLIP: a tiny HF ``CLIPModel`` written by ``transformers`` (as
tests/test_eval_quant.py does), read by the port's own safetensors reader
and by JAX's ``from_torch_state_dict``; the pooled vision output, both
projected embeddings and the score within 1e-5 of JAX's (the score
clamps at 0: the random towers' cosines are negative, so it is compared
again with the text projection negated in both).  Inception: JAX's
``init_inception`` tree with BatchNorm statistics drawn, bridged; each
block kind (the three pool variants: avg counting the padding, avg not
counting it, max) within 1e-5 of JAX's largest value, and
``pool3_features`` at b1 from a 512² image (downsampled with
antialiasing, as ``jax.image.resize``) within 1e-4 (f32 through ~95
convs); the resize itself to 1e-5 both ways.  FID: the same numbers as
JAX's (the same numpy and scipy calls) to 1e-10 relative.  The CLI: JAX's
flags and defaults (``--device`` cuda, ``--dtype`` added), JAX's results
keys from ``main`` on a tiny diffusers directory, and the scorer and both
feature functions equal to JAX's on the same arrays.
"""

import json
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stable_diffusion_tpu import fid as jfid
from stable_diffusion_tpu.models import clip as jclip
from stable_diffusion_tpu.models import inception as jinc
from stable_diffusion_tpu.utils.torch_interop import from_torch_state_dict
from stable_diffusion_tpu_torch import fid as tfid
from stable_diffusion_tpu_torch.models import clip as tclip
from stable_diffusion_tpu_torch.models import inception as tinc
from stable_diffusion_tpu_torch.utils import safetensors_io
from stable_diffusion_tpu_torch.utils.weights import from_jax_params
from test_torch_inference_cli import model_dir  # noqa: F401  (the tiny diffusers directory)
from tests.torch_threads import one_thread  # noqa: F401

TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _hf_clip_dir(root, *, image_size=28, patch_size=14, vocab_size=100, positions=16):
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig

    torch.manual_seed(0)
    CLIPModel(CLIPConfig(
        text_config=CLIPTextConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=positions, vocab_size=vocab_size, hidden_act="quick_gelu",
            projection_dim=24).to_dict(),
        vision_config=CLIPVisionConfig(
            hidden_size=40, intermediate_size=80, num_hidden_layers=2, num_attention_heads=4,
            image_size=image_size, patch_size=patch_size, hidden_act="quick_gelu",
            projection_dim=24).to_dict(),
        projection_dim=24,
    )).save_pretrained(str(root), safe_serialization=True)
    return root


def _jax_clip(root):
    flat = safetensors_io.load_file(str(root / "model.safetensors"))
    cfg = json.loads((root / "config.json").read_text())
    return (from_torch_state_dict({k: v.numpy() for k, v in flat.items()}),
            jclip.CLIPTextConfig.from_dict(cfg["text_config"]),
            jclip.CLIPVisionConfig.from_dict(cfg["vision_config"]))


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    return _hf_clip_dir(tmp_path_factory.mktemp("clip"))


def test_vision_tower_and_clip_score_match_jax(clip_dir):
    params, tcfg, vcfg = _jax_clip(clip_dir)
    model = tfid.load_clip_model(str(clip_dir), device="cpu")
    assert model.vision_model.cfg == tclip.CLIPVisionConfig.from_dict(
        json.loads((clip_dir / "config.json").read_text())["vision_config"])
    rng = np.random.default_rng(0)
    px = rng.standard_normal((4, 28, 28, 3)).astype(np.float32)
    with torch.no_grad():
        pooled = tclip.vision_model_apply(model.vision_model, torch.from_numpy(px), impl="torch")
    _close(pooled, jclip.vision_model_apply(params["vision_model"], jnp.asarray(px), vcfg,
                                            impl="xla"))

    raw = (rng.random((4, 28, 28, 3)) * 255).astype(np.float32)
    ids = rng.integers(1, 100, size=(4, 16))
    ids[:, 5] = 99  # ties at the maximum: the EOT token is the first of them
    want = np.asarray(jclip.clip_score(params, jnp.asarray(raw), jnp.asarray(ids), vcfg, tcfg,
                                       impl="xla"))
    with torch.no_grad():
        got = tclip.clip_score(model, torch.from_numpy(raw), torch.from_numpy(ids), impl="torch")
        txt = tclip.clip_text_embed(model, torch.from_numpy(ids), impl="torch")
    _close(txt, jclip.clip_text_embed(params, jnp.asarray(ids), tcfg, impl="xla"))
    _close(got, want)
    # these random towers give negative cosines, which the score clamps to 0:
    # the text projection negated in both makes them positive
    with torch.no_grad():
        model.text_projection.weight.neg_()
        got = tclip.clip_score(model, torch.from_numpy(raw), torch.from_numpy(ids), impl="torch")
    params["text_projection"]["kernel"] = -params["text_projection"]["kernel"]
    flipped = np.asarray(jclip.clip_score(params, jnp.asarray(raw), jnp.asarray(ids), vcfg, tcfg,
                                          impl="xla"))
    assert (want == 0).all() and (flipped > 0).all()
    _close(got, flipped)


@pytest.fixture(scope="module")
def inception():
    params = jinc.init_inception(jax.random.key(1))
    rng = np.random.default_rng(1)
    for top in params.values():
        for sub in ([top] if "bn" in top else top.values()):
            n = sub["bn"]["scale"].shape[0]
            sub["bn"]["running_mean"] = jnp.asarray(rng.standard_normal(n) * 0.1, jnp.float32)
            sub["bn"]["running_var"] = jnp.asarray(rng.random(n) + 0.5, jnp.float32)
            sub["bn"]["bias"] = jnp.asarray(rng.standard_normal(n) * 0.1, jnp.float32)
    model = tinc.InceptionV3()
    model.load_state_dict(from_jax_params(params), strict=True)
    return params, model


@pytest.mark.parametrize("name,kind,fid_variant", [
    ("Mixed_5b", "a", True), ("Mixed_5b", "a", False), ("Mixed_6a", "b", True),
    ("Mixed_6b", "c", True), ("Mixed_6b", "c", False), ("Mixed_7a", "d", True),
    ("Mixed_7b", "e_avg", True), ("Mixed_7c", "e_max", True), ("Mixed_7c", "e_avg", False),
])
def test_inception_blocks_match_jax(inception, name, kind, fid_variant):
    params, model = inception
    cin = {"Mixed_5b": 192, "Mixed_6a": 288, "Mixed_6b": 768, "Mixed_7a": 768,
           "Mixed_7b": 1280, "Mixed_7c": 2048}[name]
    x = np.random.default_rng(2).standard_normal((1, 9, 9, cin)).astype(np.float32)
    p, spec, mod = params[name], jinc.SPEC[name], getattr(model, name)
    jx = jnp.asarray(x)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if kind in ("a", "c"):
        want = getattr(jinc, f"_block_{kind}")(p, jx, spec, fid_variant)
        got = getattr(tinc, f"block_{kind}")(mod, xt, fid_variant)
    elif kind in ("b", "d"):
        want = getattr(jinc, f"_block_{kind}")(p, jx, spec)
        got = getattr(tinc, f"block_{kind}")(mod, xt)
    else:
        pool = kind[2:]
        want = jinc._block_e(p, jx, spec, fid_variant, pool)
        got = tinc.block_e(mod, xt, fid_variant, pool)
    _close(got.detach().permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("hw", [512, 224])
def test_resize_is_jax_image_resize(hw):
    img = np.random.default_rng(3).random((1, hw, hw, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(img), (1, 299, 299, 3), "bilinear")
    _close(tinc.resize_bilinear(torch.from_numpy(img), (299, 299)), want)


def test_pool3_features_match_jax(inception):
    params, model = inception
    img = np.random.default_rng(4).random((1, 512, 512, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jinc.pool3_features)(params, jnp.asarray(img)))
    with torch.no_grad():
        got = tinc.pool3_features(model, torch.from_numpy(img)).numpy()
    assert got.shape == (1, 2048) and np.isfinite(got).all()
    _close(got, want, 1e-4)


def test_frechet_distance_is_jax_s():
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((40, 12)), rng.standard_normal((40, 12)) + 0.3
    np.testing.assert_allclose(tfid.fid_from_features(a, b), jfid.fid_from_features(a, b),
                               rtol=1e-10)
    mu1, s1 = tfid.feature_stats(a)
    mu2, s2 = tfid.feature_stats(b)
    np.testing.assert_allclose(tfid.frechet_distance(mu1, s1, mu2, s2),
                               jfid.frechet_distance(mu1, s1, mu2, s2), rtol=1e-10)
    assert tfid.frechet_distance([1.0], [[4.0]], [3.0], [[9.0]]) == pytest.approx(5.0)
    with pytest.raises(ValueError):
        tfid.make_feature_fn("nope", device="cpu")


def test_flags_are_evaluation_py_s():
    import evaluation as jev
    import evaluation_torch as tev

    def flags(parser):
        return {a.dest: a.default for a in parser._actions if a.dest != "help"}

    want, got = flags(jev.build_parser()), flags(tev.build_parser())
    assert got.pop("device") == "cuda" and want.pop("device") == "tpu"
    assert got.pop("dtype") == "bfloat16"
    assert got == want
    assert tev.TEST_CONFIGS == jev.TEST_CONFIGS and tev.CFG_SCALES == jev.CFG_SCALES


def test_evaluation_main_end_to_end(model_dir, tmp_path, monkeypatch):  # noqa: F811
    """``evaluation_torch.main`` through argv on the CPU with the CLIP score
    and CLIP-FID: JAX's results keys; then the scorer and the CLIP and
    Inception feature functions against JAX's on the same arrays."""
    from PIL import Image

    import evaluation as jev
    import evaluation_torch as tev
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion

    clip_dir = _hf_clip_dir(tmp_path / "clip", image_size=224, patch_size=56, vocab_size=49408,
                            positions=77)
    rng = np.random.default_rng(6)
    (tmp_path / "imgs").mkdir()
    for i in (1, 2):
        Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(
            tmp_path / "imgs" / f"{i}.jpg")
    label = {"images": [{"id": i, "file_name": f"{i}.jpg"} for i in (1, 2)],
             "annotations": [{"image_id": 1, "id": 10, "caption": "a photo of a cat"},
                             {"image_id": 2, "id": 20, "caption": "a cat"}]}
    (tmp_path / "captions.json").write_text(json.dumps(label))
    monkeypatch.setattr(tev, "TEST_CONFIGS", [{"sampler": "ddim", "use_cosine_schedule": False}])
    monkeypatch.setattr(tev, "CFG_SCALES", [3.0])
    orig = StableDiffusion.generate
    monkeypatch.setattr(StableDiffusion, "generate",
                        lambda self, *a, **kw: orig(self, *a, **dict(kw, img_size=(32, 32))))
    # importing torch.utils.tensorboard loads TensorFlow: a recording stand-in
    logged = []
    writer = types.SimpleNamespace(add_scalars=lambda *a: logged.append(a), close=lambda: None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=lambda log_dir: writer))
    monkeypatch.chdir(tmp_path)
    results = tev.main([
        "--model_path", str(model_dir), "--tokenizer_dir", str(model_dir / "tokenizer"),
        "--device", "cpu", "--dtype", "float32", "--do_cfg", "--sampler", "ddim",
        "--num_inference_steps", "2", "--original_imgs_dir", str(tmp_path / "imgs"),
        "--label_file", str(tmp_path / "captions.json"), "--clip_model_dir", str(clip_dir),
        "--fid_backbone", "clip", "--num_samples", "2", "--save_dir", str(tmp_path / "out"),
        "--seed", "0"])
    tag = "3.0_ddim_linearSchedule"
    assert sorted(results) == [tag, f"{tag}/fid"]
    assert all(np.isfinite(v) for v in results.values())
    assert sorted(a[0] for a in logged) == ["CLIP Score", "FID"]
    out = tmp_path / "out"
    for stem in ("1_10", "2_20"):
        assert (out / "fake" / tag / f"{stem}.jpg").exists()
        assert (out / "original" / f"{stem}.jpg").exists()
    assert (out / "1_10.txt").read_text() == "a photo of a cat"

    ids = rng.integers(0, 49408, size=(2, 77))
    img224 = (rng.random((2, 224, 224, 3)) * 255).astype(np.float32)
    _close(tev.load_clip_scorer(str(clip_dir), device="cpu")(img224, ids),
           jev.load_clip_scorer(str(clip_dir))(jnp.asarray(img224), jnp.asarray(ids)))
    imgs = rng.random((2, 40, 48, 3)).astype(np.float32)
    _close(tfid.make_feature_fn("clip", clip_model_dir=str(clip_dir), device="cpu")(imgs),
           jfid.make_feature_fn("clip", clip_model_dir=str(clip_dir))(jnp.asarray(imgs)))
    state = from_jax_params(jinc.init_inception(jax.random.key(2)))
    weights = tmp_path / "inception.safetensors"
    safetensors_io.save_file(dict(state, **{"fc.weight": torch.zeros(10, 2048)}), str(weights))
    torch.save(dict(state, **{"Conv2d_1a_3x3.bn.num_batches_tracked": torch.tensor(0)}),
               tmp_path / "inception.pth")
    small = rng.random((1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jfid.make_feature_fn("inception", weights_path=str(weights))(small))
    for path in (weights, tmp_path / "inception.pth"):
        _close(tfid.make_feature_fn("inception", weights_path=str(path), device="cpu")(small),
               want, 1e-4)
