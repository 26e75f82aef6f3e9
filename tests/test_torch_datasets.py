"""The port's copies of the JAX package's numpy-side modules, against the
originals on the same inputs: ``utils/datasets.py`` (the batches, their
order, ``pixel_values`` and ``input_ids``, with a ``FakeTok`` and with the
port's tokenizer) and ``utils/native.py`` (the C++ library and the numpy
path).  Both sides are numpy and PIL, so they agree bit for bit."""

import numpy as np
import pytest

from stable_diffusion_tpu.utils import datasets as jds
from stable_diffusion_tpu.utils import native as jnative
from stable_diffusion_tpu_torch.tokenizer import load_tokenizer
from stable_diffusion_tpu_torch.utils import datasets as tds
from stable_diffusion_tpu_torch.utils import native as tnative
from tests import torch_checkpoints as C


class FakeTok:
    """tests/test_train_cli.py's stand-in: three ids a prompt, zero padding."""

    def __call__(self, prompt, **kw):
        class R:
            input_ids = [1, 2, 3]

        return R()

    def pad(self, enc, *, padding, max_length, return_tensors):
        ids = np.zeros((len(enc["input_ids"]), max_length), np.int64)
        for i, row in enumerate(enc["input_ids"]):
            ids[i, : len(row)] = row
        return {"input_ids": ids}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """5 instance and 3 prior images of mixed sizes and modes."""
    from PIL import Image

    root = tmp_path_factory.mktemp("dreambooth")
    rng = np.random.default_rng(0)
    for d, label, n in (("instance_data", "a photo of sks dog", 5),
                        ("class_prior_data", "a photo of a dog", 3)):
        (root / d).mkdir()
        for i in range(n):
            arr = (rng.random((18 + 3 * i, 24, 3)) * 255).astype(np.uint8)
            img = Image.fromarray(arr)
            (img.convert("L") if i == 1 else img).save(root / d / f"{i}.png")
        (root / d / "label.txt").write_text(label)
    return root


def _loaders(mod, tok, data_dir, batch_size, n_prior):
    return mod.create_dataloaders(tok, str(data_dir / "instance_data"),
                                  str(data_dir / "class_prior_data"), train_test_split=1.0,
                                  batch_size=batch_size, num_workers=0, img_size=(16, 12),
                                  num_class_prior_images=n_prior)


@pytest.mark.parametrize("batch_size,n_prior", [(2, None), (3, 2), (8, None)])
def test_dataloaders_match_jax(data_dir, batch_size, n_prior):
    """Two epochs of the shuffled train loader and one of the test loader:
    the same indices, pixel values and ids (batch 8 > the 5 examples: the
    dataset repeated to fill one batch)."""
    tok = FakeTok()
    ours, theirs = (_loaders(m, tok, data_dir, batch_size, n_prior) for m in (tds, jds))
    for mine, want in zip(ours, theirs):
        assert len(mine) == len(want)
        for _ in range(2):
            assert list(mine.iter_indices()) == list(want.iter_indices())
        for a, b in zip(mine, want):
            assert a["pixel_values"].shape == (2 * batch_size, 16, 12, 3)
            assert a["pixel_values"].dtype == np.float32 and a["input_ids"].dtype == np.int32
            np.testing.assert_array_equal(a["pixel_values"], b["pixel_values"])
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    ds = ours[0].dataset
    assert ds.num_instance == 5 and ds.num_class == (n_prior or 3)
    np.testing.assert_array_equal(ds.class_pixels(1), theirs[0].dataset.class_pixels(1))


def test_port_tokenizer_drives_both_datasets(data_dir, tmp_path):
    """The port's tokenizer (its ``__call__`` and ``pad``, held against
    ``transformers`` in tests/test_torch_tokenizer.py) in the port's dataset
    and in JAX's: the same padded ids, bos and eos in place, pad after."""
    C.write_vocab(str(tmp_path))
    tok = load_tokenizer(str(tmp_path))
    ours = _loaders(tds, tok, data_dir, 2, None)[1]
    theirs = _loaders(jds, tok, data_dir, 2, None)[1]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        ids = a["input_ids"]
        assert (ids[:, 0] == tok.bos_token_id).all() and (ids[:, -1] == tok.pad_token_id).all()
        assert len(set(ids[:, 4].tolist())) == 2  # "sks" / "a": the two prompts differ


def test_custom_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    np.save(tmp_path / "sprites.npy", (rng.random((3, 16, 16, 3)) * 255).astype(np.uint8))
    np.save(tmp_path / "sprites_labels.npy", rng.random((3, 5)).astype(np.float32))
    ours, theirs = tds.CustomDataset(str(tmp_path), (8, 8)), jds.CustomDataset(str(tmp_path), (8, 8))
    assert len(ours) == len(theirs) == 3 and ours.num_classes == theirs.num_classes
    for i in range(3):
        (a, la), (b, lb) = ours[i], theirs[i]
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(tds.scale_img(np.arange(5.0), (0, 4), (-1, 1), clamp=True),
                                  jds.scale_img(np.arange(5.0), (0, 4), (-1, 1), clamp=True))


def _numpy_path(mod, fn, *args, **kw):
    """``fn`` with ``mod``'s library set aside (its numpy path)."""
    lib, tried = mod._lib, mod._tried
    mod._lib, mod._tried = None, True
    try:
        return fn(*args, **kw)
    finally:
        mod._lib, mod._tried = lib, tried


@pytest.mark.parametrize("path", ["library", "numpy"])
def test_native_matches_jax(path):
    """The same uint8 batch through the port's and JAX's bindings, by the
    C++ library and by the numpy path."""
    imgs = (np.random.default_rng(2).random((3, 37, 53, 3)) * 255).astype(np.uint8)
    x = np.random.default_rng(3).random(100).astype(np.float32) * 300 - 20
    if path == "library":
        assert tnative.available() and jnative.available()
        run = lambda mod, fn, *a, **kw: fn(*a, **kw)  # noqa: E731
    else:
        run = _numpy_path
    got = run(tnative, tnative.resize_normalize_batch, imgs, 16, 24)
    want = run(jnative, jnative.resize_normalize_batch, imgs, 16, 24)
    assert got.shape == (3, 16, 24, 3) and got.min() >= -1.0 and got.max() <= 1.0
    np.testing.assert_array_equal(got, want)
    got = run(tnative, tnative.scale_img_inplace, x.copy(), (0, 255), (0, 1), clamp=True)
    want = run(jnative, jnative.scale_img_inplace, x.copy(), (0, 255), (0, 1), clamp=True)
    np.testing.assert_array_equal(got, want)
    # the library and the numpy path compute one function
    np.testing.assert_allclose(_numpy_path(tnative, tnative.resize_normalize_batch, imgs, 16, 24),
                               tnative.resize_normalize_batch(imgs, 16, 24), atol=1e-4)


def test_native_builds_into_build_when_the_checked_in_library_does_not_load(tmp_path,
                                                                              monkeypatch):
    """A library that does not load (here a file that is no ELF) is built
    from native/image_ops.cpp into the second path (build/native/ in the
    checkout); native/ is not written."""
    bad, built = tmp_path / "native" / "libimage_ops.so", tmp_path / "build" / "libimage_ops.so"
    bad.parent.mkdir()
    bad.write_bytes(b"not a library")
    monkeypatch.setattr(tnative, "_LIB_PATHS", (str(bad), str(built)))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    assert tnative.available() and built.exists()
    assert bad.read_bytes() == b"not a library"
    imgs = (np.random.default_rng(4).random((2, 9, 7, 3)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tnative.resize_normalize_batch(imgs, 5, 4),
                                  jnative.resize_normalize_batch(imgs, 5, 4))
