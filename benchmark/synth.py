"""The traffic generator: seeded synthetic photographs made on the device,
and the seeded schedules of crops and batches drawn from them.

An image is 128 + 40 x (a sum of four sinusoids of random frequency,
phase and amplitude over the frame) + a per-channel tint of up to 24
levels + N(0, 12) noise, rounded and clipped to uint8: smooth structure
at every scale plus sensor-like noise.
"""

from __future__ import annotations

import numpy as np
import torch


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent NumPy generator for one use (`stream`) of a run's
    seed."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def torch_seed(seed: int, stream: int) -> int:
    return int(rng(seed, stream).integers(0, 1 << 62))


@torch.no_grad()
def image_pool(n: int, height: int, width: int, seed: int, device):
    """n uint8 images (n, 3, height, width) on `device`."""
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, 1))
    p = torch.rand((n, 4, 4), generator=g, device=device)
    amp = (2 * p[..., 0] - 1)[..., None, None]
    fy = (1 + 11 * p[..., 1])[..., None, None]
    fx = (1 + 11 * p[..., 2])[..., None, None]
    ph = (6 * p[..., 3])[..., None, None]
    scale = max(height, width)
    yy = (torch.arange(height, device=device) / scale)[:, None]
    xx = (torch.arange(width, device=device) / scale)[None, :]
    base = (amp * torch.sin(fy * yy + fx * xx + ph)).sum(1)  # (n, H, W)
    tint = 48 * torch.rand((n, 3, 1, 1), generator=g, device=device) - 24
    noise = torch.randn((n, 3, height, width), generator=g, device=device)
    img = 128 + 40 * base[:, None] + tint + 12 * noise
    return img.round_().clamp_(0, 255).to(torch.uint8)


def crop_schedule(n_steps: int, batch: int, pool: int, height: int,
                  width: int, crop, seed: int) -> np.ndarray:
    """(n_steps, batch, 3) of (image, top, left) crops. The first
    ceil(pool / batch) steps take every image at most once, so the rows
    of the first steps all differ."""
    r = rng(seed, 2)
    img = np.concatenate([r.permutation(pool)
                          for _ in range(-(-n_steps * batch // pool))])
    img = img[:n_steps * batch]
    top = r.integers(0, height - crop[0] + 1, n_steps * batch)
    left = r.integers(0, width - crop[1] + 1, n_steps * batch)
    return np.stack([img, top, left], -1).reshape(n_steps, batch, 3)


def batch_schedule(n_batches: int, batch: int, pool: int,
                   seed: int) -> np.ndarray:
    """(n_batches, batch) image indices: successive seeded permutations of
    the pool cut into batches, so the images of a batch all differ."""
    r = rng(seed, 3)
    per = pool // batch
    perms = [r.permutation(pool)[:per * batch].reshape(per, batch)
             for _ in range(-(-n_batches // per))]
    return np.concatenate(perms)[:n_batches]
