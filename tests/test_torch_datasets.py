"""The port's image data pipeline against lmic_tpu's: the same PNGs and
seeds give the same crops, flips, batches and order; the background
prefetch keeps order, surfaces errors and stops early."""

import numpy as np
import pytest

from lmic_tpu import datasets as jds
from lmic_tpu.datasets import image as jimage
from lmic_tpu_torch import datasets as tds


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for split, n in (("train", 10), ("test", 3)):
        (root / split).mkdir()
        for i in range(n):
            h, w = rng.integers(40, 56, 2)
            arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(root / split / f"img_{i:02d}.png")
        (root / split / "notes.txt").write_text("not an image")
    return root


@pytest.mark.parametrize("split,train", [("train", True), ("test", False)])
def test_image_folder_matches_lmic_tpu(image_root, split, train):
    kw = dict(patch_size=(32, 24), train=train, seed=5)
    ours = tds.ImageFolder(image_root, split, **kw)
    theirs = jds.ImageFolder(image_root, split, **kw)
    assert len(ours) == len(theirs) == (10 if train else 3)
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.dtype == np.float32 and a.shape == (32, 24, 3)
        np.testing.assert_array_equal(a, b)


def test_image_folder_errors(tmp_path):
    with pytest.raises(RuntimeError):
        tds.ImageFolder(tmp_path, "train")
    with pytest.raises(ValueError):
        tds.random_crop(np.zeros((8, 8, 3)), (9, 8), __import__("random")
                        .Random(0))


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("shuffle", [True, False])
def test_data_loader_matches_lmic_tpu(image_root, prefetch, shuffle):
    """Two epochs of batches, the last partial one dropped, as lmic_tpu's
    loader gives them with its own thread or without; the port's through
    `prefetch` or without."""
    def batches(mod):
        ds = mod.ImageFolder(image_root, "train", (32, 32), seed=3)
        if mod is jds:
            dl = mod.DataLoader(ds, 4, shuffle=shuffle, seed=9,
                                prefetch=prefetch)
            return len(dl), [b for _ in range(2) for b in dl]
        dl = mod.DataLoader(ds, 4, shuffle=shuffle, seed=9)
        epoch = (lambda: tds.prefetch(iter(dl), prefetch)) if prefetch \
            else (lambda: dl)
        return len(dl), [b for _ in range(2) for b in epoch()]

    (n_ours, ours), (n_theirs, theirs) = batches(tds), batches(jds)
    assert n_ours == n_theirs == 2
    assert len(ours) == len(theirs) == 2 * n_ours
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_crops_match_lmic_tpu():
    import random

    arr = np.arange(20 * 30 * 3, dtype=np.float32).reshape(20, 30, 3)
    np.testing.assert_array_equal(tds.center_crop(arr, (7, 9)),
                                  jimage.center_crop(arr, (7, 9)))
    np.testing.assert_array_equal(
        tds.random_crop(arr, (7, 9), random.Random(4)),
        jimage.random_crop(arr, (7, 9), random.Random(4)))


def test_prefetch_order_errors_and_early_stop():
    assert list(tds.prefetch(iter(range(50)), size=3)) == list(range(50))

    def boom():
        yield 1
        raise KeyError("late")

    it = tds.prefetch(boom(), size=1)
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)
    it = tds.prefetch(iter(range(1000)), size=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()  # the worker is released, not left blocked on a full queue


def test_package_imports_without_pil():
    import subprocess
    import sys

    code = ("import sys; sys.modules['PIL'] = None\n"
            "import lmic_tpu_torch.datasets, lmic_tpu_torch.utils.train_cli\n")
    root = __import__("pathlib").Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
