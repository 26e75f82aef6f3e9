"""Datasets and data loading for the trainer (port of
stable_diffusion_tpu/utils/datasets.py; numpy and PIL, no torch).

* ``scale_img``, the linear rescale (``pipeline.scale_img``);
* ``CustomDataset``, the sprites ``.npy`` toy set for class-conditional
  training;
* ``DreamBoothDataset``, instance and class-prior images, each set
  captioned by its directory's ``label.txt``;
* ``collate``, which stacks [instance; class], the layout the DreamBooth
  loss splits in two;
* ``DataLoader`` (``iter_indices``: the batches' dataset indices) and
  ``create_dataloaders``, a shuffled train and an unshuffled test loader
  over the same dataset.

Images come out NHWC float32 in [-1, 1] (PIL's bilinear resize, then
``(x / 255 - 0.5) / 0.5``), the same ``random.Random(seed)`` shuffles and
the same drop-last rule as JAX's, so the batches come in JAX's order.  The
tokenizer is the port's ``tokenizer.CLIPTokenizer`` or anything with
``transformers``' ``__call__`` and ``pad``.
"""

from __future__ import annotations

import os
import random
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from stable_diffusion_tpu_torch.pipeline import scale_img


def _load_and_transform(path_or_img, img_size: Tuple[int, int]) -> np.ndarray:
    """-> (H, W, 3) float32 in [-1, 1]: RGB, bilinear resize, normalized."""
    from PIL import Image

    img = Image.open(path_or_img) if isinstance(path_or_img, (str, Path)) else path_or_img
    img = img.convert("RGB").resize((img_size[1], img_size[0]), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - 0.5) / 0.5


class CustomDataset:
    """Sprites toy set: {data_dir}/sprites.npy + sprites_labels.npy."""

    def __init__(self, data_dir: str, img_size: Tuple[int, int]):
        self.imgs = np.load(os.path.join(data_dir, "sprites.npy"))
        self.labels = np.load(os.path.join(data_dir, "sprites_labels.npy"))
        self.num_classes = len(self.labels)
        self.img_size = img_size

    def __len__(self):
        return self.imgs.shape[0]

    def __getitem__(self, index: int):
        from PIL import Image

        img = Image.fromarray(self.imgs[index]).resize((self.img_size[1], self.img_size[0]))
        arr = scale_img(np.asarray(img, dtype=np.float32), (0, 255), (-1, 1))
        return arr, self.labels[index]


class DreamBoothDataset:
    """Instance + class-prior pairs; prompts read from {dir}/label.txt."""

    def __init__(self, tokenizer, instance_data_dir: str, class_data_dir: str,
                 img_size: Tuple[int, int], num_class_prior_images: Optional[int] = None,
                 seed: int = 0):
        self.instance_imgs, self.instance_prompt = self._load(instance_data_dir)
        random.Random(seed).shuffle(self.instance_imgs)
        self.class_imgs, self.class_prompt = self._load(class_data_dir)
        self.class_imgs = self.class_imgs[:num_class_prior_images]
        self.img_size = img_size
        self.tokenizer = tokenizer
        self.length = max(len(self.instance_imgs), len(self.class_imgs))

    @staticmethod
    def _load(data_dir: str):
        paths = sorted(x for x in Path(data_dir).iterdir()
                       if x.is_file() and not str(x).endswith(".txt"))
        with open(Path(data_dir) / "label.txt") as f:
            label = f.read()
        return list(paths), label

    def _tokenize(self, prompt: str) -> List[int]:
        return self.tokenizer(prompt, padding="do_not_pad", truncation=True,
                              max_length=77).input_ids

    def __len__(self):
        return self.length

    @property
    def num_instance(self) -> int:
        return len(self.instance_imgs)

    @property
    def num_class(self) -> int:
        return len(self.class_imgs)

    def instance_pixels(self, i: int) -> np.ndarray:
        """Instance image i, transformed: deterministic (resize only), so
        the trainer's cache of the frozen encoder's moments is exact."""
        return _load_and_transform(self.instance_imgs[i], self.img_size)

    def class_pixels(self, i: int) -> np.ndarray:
        return _load_and_transform(self.class_imgs[i], self.img_size)

    def __getitem__(self, index: int):
        return {
            "instance_img": self.instance_pixels(index % len(self.instance_imgs)),
            "instance_prompt_ids": self._tokenize(self.instance_prompt),
            "class_img": self.class_pixels(index % len(self.class_imgs)),
            "class_prompt_ids": self._tokenize(self.class_prompt),
        }


def collate(examples: Sequence[dict], tokenizer) -> dict:
    """[instance; class] stacking, the prompts padded to 77 ids."""
    pixel_values = np.stack(
        [e["instance_img"] for e in examples] + [e["class_img"] for e in examples]
    ).astype(np.float32)
    ids = [e["instance_prompt_ids"] for e in examples] + [e["class_prompt_ids"] for e in examples]
    padded = tokenizer.pad({"input_ids": ids}, padding="max_length", max_length=77,
                           return_tensors="np")
    return {"pixel_values": pixel_values, "input_ids": padded["input_ids"].astype(np.int32)}


class DataLoader:
    """An epoch iterator: shuffle, batch, collate; fixed batch shapes (the
    last partial batch is dropped; a dataset smaller than the batch is
    repeated to fill one)."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool, tokenizer, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.tokenizer = tokenizer
        self._rng = random.Random(seed)

    def __len__(self):
        return max(len(self.dataset) // self.batch_size, 1)

    def iter_indices(self) -> Iterator[List[int]]:
        """The dataset indices of each batch (the image path and the cached
        encoders' path share them, so both see one batch order)."""
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(order)
        n = len(self.dataset)
        bs = self.batch_size
        for start in range(0, n - bs + 1, bs) if n >= bs else [0]:
            idx = order[start: start + bs] if n >= bs else order * ((bs // n) + 1)
            yield idx[:bs]

    def __iter__(self) -> Iterator[dict]:
        for idx in self.iter_indices():
            yield collate([self.dataset[i] for i in idx], self.tokenizer)


def create_dataloaders(tokenizer, instance_data_dir: str, class_data_dir: str,
                       train_test_split: float, batch_size: int, num_workers: int,
                       img_size: Tuple[int, int], num_class_prior_images: Optional[int] = None):
    """A shuffled train and an unshuffled test loader over one dataset;
    ``train_test_split`` and ``num_workers`` are accepted for parity."""
    del train_test_split, num_workers
    ds = DreamBoothDataset(tokenizer=tokenizer, instance_data_dir=instance_data_dir,
                           class_data_dir=class_data_dir, img_size=img_size,
                           num_class_prior_images=num_class_prior_images)
    train = DataLoader(ds, batch_size, shuffle=True, tokenizer=tokenizer)
    test = DataLoader(ds, batch_size, shuffle=False, tokenizer=tokenizer)
    return train, test
