"""Vimeo-90k style video dataset.

Counterpart of lmic_tpu/datasets/video.py (reference
compressai/datasets/video.py:42-132): list files of septuplet
directories, a random frame interval and temporal order, a synchronized
spatial crop and flip; returns (T, H, W, 3) float32 clips in [0, 1]. It
draws from its own `random.Random(seed)` in lmic_tpu's order, so one seed
gives lmic_tpu's clips. PIL is imported where a frame is decoded, so the
package imports without it."""

from __future__ import annotations

import random
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


class VideoFolder:
    """Loads `root/sequences/<clip>/im1.png..im7.png` triplets listed in
    `root/sep_trainlist.txt` (or test list)."""

    def __init__(
        self,
        root,
        rnd_interval: bool = False,
        rnd_temp_order: bool = False,
        split: str = "train",
        num_frames: int = 3,
        patch_size: Tuple[int, int] = (256, 256),
        train: bool = True,
        seed: Optional[int] = None,
        max_frames: int = 7,
    ):
        root = Path(root)
        list_path = root / f"sep_{split}list.txt"
        seq_dir = root / "sequences"
        if not list_path.is_file() or not seq_dir.is_dir():
            raise RuntimeError(f'Invalid directory "{root}"')
        with open(list_path) as f:
            clips = [line.strip() for line in f if line.strip()]
        self.sample_folders = [seq_dir / c for c in clips]
        self.num_frames = num_frames
        self.max_frames = max_frames
        self.rnd_interval = rnd_interval
        self.rnd_temp_order = rnd_temp_order
        self.patch_size = patch_size
        self.train = train
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.sample_folders)

    def __getitem__(self, index: int) -> np.ndarray:
        folder = self.sample_folders[index]
        frame_paths = sorted(folder.glob("*.png"))[: self.max_frames]
        if len(frame_paths) < self.num_frames:
            raise RuntimeError(f"Not enough frames in {folder}")

        max_interval = (len(frame_paths) + 2) // self.num_frames
        interval = (
            self._rng.randint(1, max_interval) if self.rnd_interval else 1
        )
        paths = frame_paths[:: interval][: self.num_frames]

        from PIL import Image

        frames = [
            np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
            for p in paths
        ]
        h, w = self.patch_size
        H, W = frames[0].shape[:2]
        if self.train:
            y = self._rng.randint(0, H - h)
            x = self._rng.randint(0, W - w)
        else:
            y, x = (H - h) // 2, (W - w) // 2
        frames = [f[y : y + h, x : x + w] for f in frames]
        if self.train and self._rng.random() > 0.5:
            frames = [f[:, ::-1].copy() for f in frames]
        if self.rnd_temp_order and self._rng.random() < 0.5:
            frames = frames[::-1]
        return np.stack(frames)
