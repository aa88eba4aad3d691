"""Image datasets: host-side numpy, channel-last HWC float32 in [0, 1].

Counterpart of lmic_tpu/datasets/image.py:44-109, 275-335 (reference
compressai/datasets/image.py:69-124):

- `ImageFolder`: rootdir/{train,test}/ flat image dirs, random crop +
  horizontal flip for training, center crop for testing;
- `DataLoader`: shuffles and batches into stacked numpy arrays, dropping
  the last partial batch (lmic_tpu's default, the only one its trainer
  uses). It
  assembles batches in the calling thread; `datasets.prefetch` moves that
  to a background thread (lmic_tpu's loader has a thread of its own as
  well, which `prefetch` makes redundant).

The train loop moves a batch to the device and to NCHW itself. PIL is
imported where an image is decoded, so the package imports without it.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

IMG_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".tiff", ".webp"}


def _open_rgb(path):
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True  # survive corrupt JPEGs
    return Image.open(path).convert("RGB")


def _to_float(img) -> np.ndarray:
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _list_images(d: Path):
    return sorted(
        f for f in d.iterdir()
        if f.is_file() and f.suffix.lower() in IMG_EXTENSIONS
    )


def random_crop(arr: np.ndarray, size: Tuple[int, int], rng: random.Random):
    h, w = size
    if arr.shape[0] < h or arr.shape[1] < w:
        raise ValueError(f"image {arr.shape} smaller than crop {size}")
    y = rng.randint(0, arr.shape[0] - h)
    x = rng.randint(0, arr.shape[1] - w)
    return arr[y:y + h, x:x + w]


def center_crop(arr: np.ndarray, size: Tuple[int, int]):
    h, w = size
    y = (arr.shape[0] - h) // 2
    x = (arr.shape[1] - w) // 2
    return arr[y:y + h, x:x + w]


class ImageFolder:
    """rootdir/{split}/ image files; training crop+flip pipeline."""

    def __init__(
        self,
        root,
        split: str = "train",
        patch_size: Tuple[int, int] = (256, 256),
        train: bool = True,
        seed: Optional[int] = None,
    ):
        splitdir = Path(root) / split
        if not splitdir.is_dir():
            raise RuntimeError(f'Invalid directory "{root}"')
        self.samples = _list_images(splitdir)
        self.patch_size = patch_size
        self.train = train
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int) -> np.ndarray:
        arr = _to_float(_open_rgb(self.samples[index]))
        if self.train:
            arr = random_crop(arr, self.patch_size, self._rng)
            if self._rng.random() > 0.5:
                arr = arr[:, ::-1].copy()
        else:
            arr = center_crop(arr, self.patch_size)
        return arr


class DataLoader:
    """Minimal shuffling/batching loader producing stacked numpy batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            if len(chunk) < self.batch_size:
                return
            yield np.stack([self.dataset[j] for j in chunk])
