"""Image datasets: host-side numpy, channel-last HWC float32 in [0, 1].

Counterpart of lmic_tpu/datasets/image.py:44-272, 275-335 (reference
compressai/datasets/image.py:69-124, image_rgbt_t.py:57-110,
image_rgbt_rgb.py:40-150):

- `ImageFolder`: rootdir/{train,test}/ flat image dirs, an optional
  resize, random crop + horizontal flip for training, center crop for
  testing;
- `ImageFolderT`: one FLIR modality, RGB resized to 1024x1280, thermal
  kept as 8-bit grayscale (one channel);
- `ImageFolderRGB`: FLIR (master, guide) pairs, the guide's directory
  found by swapping `RGB` and `thermal_8_bit` in the path; a random scale,
  a crop keeping the 2:1 ratio and a shared flip (3-channel master), or
  whole frames and the flip alone (1-channel master);
- `ImageFolderTest`: the 20 fixed FLIR validation pairs
  (image_rgbt_test.py:40-128), center-cropped: the RGB side to twice the
  crop, the thermal side to the crop;
- `DataLoader`: shuffles and batches into stacked numpy arrays (a tuple
  of arrays for paired items), dropping the last partial batch
  (lmic_tpu's default, the only one its trainer uses). It assembles
  batches in the calling thread; `datasets.prefetch` moves that to a
  background thread (lmic_tpu's loader has a thread of its own as well,
  which `prefetch` makes redundant).

Every loader draws from its own `random.Random(seed)` in lmic_tpu's
order, so one seed gives lmic_tpu's crops, scales and flips.

The train loop moves a batch to the device and to NCHW itself. PIL is
imported where an image is decoded, so the package imports without it.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

IMG_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".tiff", ".webp"}


# FLIR's RGB frames are resized to this (W, H) against the 640x512
# thermal frames (image_rgbt_t.py, image_rgbt_rgb.py)
FLIR_RGB_SIZE = (1280, 1024)
TRAIN_SCALE_ARRAY = [1, 1.2, 1.4, 1.6, 1.8]  # image_rgbt_rgb.py:49

# FLIR ADAS validation ids fixed by the reference eval protocol
# (image_rgbt_test.py:40-61)
FLIR_TEST_IDS = [
    "08865", "08868", "08872", "08885", "08897", "08909", "08921", "08933",
    "08945", "08957", "08969", "08981", "08993", "09005", "09017", "09029",
    "09041", "09053", "09065", "09077",
]


def _open(path, mode=None):
    """PIL image of `path`, converted to `mode` when given."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True  # survive corrupt JPEGs
    img = Image.open(path)
    return img if mode is None else img.convert(mode)


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

    _mode = "RGB"  # the PIL mode images are converted to

    def __init__(
        self,
        root,
        split: str = "train",
        patch_size: Tuple[int, int] = (256, 256),
        train: bool = True,
        resize: Optional[Tuple[int, int]] = None,
        seed: Optional[int] = None,
    ):
        splitdir = Path(root) / split
        if not splitdir.is_dir():
            raise RuntimeError(f'Invalid directory "{root}"')
        self.samples = _list_images(splitdir)
        self.patch_size = patch_size
        self.train = train
        self.resize = resize  # (H, W)
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.samples)

    def _load(self, index: int) -> np.ndarray:
        img = _open(self.samples[index], self._mode)
        if self.resize is not None:
            img = img.resize(self.resize[::-1])  # PIL takes (W, H)
        return _to_float(img)

    def _augment(self, arr: np.ndarray) -> np.ndarray:
        """Training: random crop, then a flip with probability 1/2."""
        arr = random_crop(arr, self.patch_size, self._rng)
        if self._rng.random() > 0.5:
            arr = arr[:, ::-1].copy()
        return arr

    def __getitem__(self, index: int) -> np.ndarray:
        arr = self._load(index)
        if self.train:
            return self._augment(arr)
        return center_crop(arr, self.patch_size)


class ImageFolderT(ImageFolder):
    """One FLIR modality: 3 channels are RGB resized to 1024x1280, 1 is
    8-bit grayscale (thermal) at its own size. Unlike `ImageFolder`, the
    test split is not center-cropped (image_rgbt_t.py:57-110)."""

    def __init__(self, root, split="train", patch_size=(256, 256),
                 train=True, channel: int = 3, seed=None):
        self.channel = channel
        self._mode = "RGB" if channel == 3 else "L"
        resize = FLIR_RGB_SIZE[::-1] if channel == 3 else None
        super().__init__(root, split, patch_size, train, resize, seed)

    def __getitem__(self, index: int) -> np.ndarray:
        arr = self._load(index)
        return self._augment(arr) if self.train else arr


def _guide_dir(root: str, channel: int) -> Path:
    """The guide modality's directory beside a FLIR `root`."""
    if channel == 3:
        return Path(root.replace("RGB", "thermal_8_bit"))
    return Path(root.replace("thermal_8_bit", "RGB"))


class ImageFolderRGB:
    """FLIR (master, guide) training pairs (image_rgbt_rgb.py:40-150).

    channel=3: the master is the RGB frame at twice the guide's
    resolution, the guide the thermal frame; one random scale from
    TRAIN_SCALE_ARRAY, a random `crop_size` crop of the guide with the
    master's crop at twice its offsets and size, one shared flip.
    channel=1: the master is the thermal frame, the guide the RGB frame
    resized to 1024x1280; whole frames, one shared flip (the reference
    crops nothing here)."""

    def __init__(self, root, crop_size=(512, 640), channel: int = 3,
                 seed=None):
        self.root = str(root)
        self.channel = channel
        guided_dir = _guide_dir(self.root, channel)
        if not Path(self.root).is_dir() or not guided_dir.is_dir():
            raise RuntimeError(f'Invalid directory "{root}"')
        self.samples = _list_images(Path(self.root))
        self.guided_samples = _list_images(guided_dir)
        self.crop_size = crop_size
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.samples)

    def _load_pair(self, index: int):
        if self.channel == 3:
            img = _open(self.samples[index], "RGB")
            guided = _open(self.guided_samples[index])
        else:
            img = _open(self.samples[index])
            guided = _open(self.guided_samples[index], "RGB").resize(
                FLIR_RGB_SIZE)
        return _to_float(img), _to_float(guided)

    def __getitem__(self, index: int):
        x, guided = self._load_pair(index)
        rng = self._rng
        if self.channel == 3:
            H, W = self.crop_size
            # the guide scaled, the master kept at exactly twice its size
            scale = rng.choice(TRAIN_SCALE_ARRAY)
            sh = int(guided.shape[0] * scale)
            sw = int(guided.shape[1] * scale)
            guided = _resize_np(guided, (sh, sw))
            x = _resize_np(x, (2 * sh, 2 * sw))
            cy = rng.randint(0, guided.shape[0] - H)
            cx = rng.randint(0, guided.shape[1] - W)
            guided = guided[cy:cy + H, cx:cx + W]
            x = x[2 * cy:2 * (cy + H), 2 * cx:2 * (cx + W)]
        if rng.random() > 0.5:
            guided = guided[:, ::-1].copy()
            x = x[:, ::-1].copy()
        return x, guided


class ImageFolderTest:
    """Fixed FLIR validation pairs (image_rgbt_test.py:40-128): (master,
    guide), the RGB side center-cropped to twice `crop_size`, the thermal
    side to `crop_size`. `test_ids`: id substrings a file stem must hold
    (default FLIR_TEST_IDS)."""

    def __init__(self, root, crop_size=(512, 640), channel: int = 3,
                 test_ids: Optional[Sequence[str]] = None):
        self.root = str(root)
        self.channel = channel
        ids = list(test_ids) if test_ids is not None else FLIR_TEST_IDS
        self.samples = [f for f in _list_images(Path(self.root))
                        if any(i in f.stem for i in ids)]
        self.guided_samples = [
            f for f in _list_images(_guide_dir(self.root, channel))
            if any(i in f.stem for i in ids)]
        self.crop_size = crop_size

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int):
        if self.channel == 3:
            x = _to_float(_open(self.samples[index], "RGB"))
            guided = _to_float(_open(self.guided_samples[index]))
        else:
            x = _to_float(_open(self.samples[index]))
            guided = _to_float(_open(self.guided_samples[index], "RGB")
                               .resize(FLIR_RGB_SIZE))
        H, W = self.crop_size
        if self.channel == 3:
            return (center_crop(x, (2 * H, 2 * W)),
                    center_crop(guided, (H, W)))
        return center_crop(x, (H, W)), center_crop(guided, (2 * H, 2 * W))


def _resize_np(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of (H, W, C) floats in [0, 1] to `size` (H, W),
    channel by channel through 8-bit PIL images, as lmic_tpu does."""
    from PIL import Image

    h, w = size
    chans = []
    for c in range(arr.shape[-1]):
        img = Image.fromarray((arr[..., c] * 255).astype(np.uint8))
        chans.append(
            np.asarray(img.resize((w, h), Image.BILINEAR), np.float32) / 255.0
        )
    return np.stack(chans, axis=-1)


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
            items = [self.dataset[j] for j in chunk]
            if isinstance(items[0], tuple):  # (master, guide) pairs
                yield tuple(np.stack(a) for a in zip(*items))
            else:
                yield np.stack(items)
