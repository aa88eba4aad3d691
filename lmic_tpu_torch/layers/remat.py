"""Rematerialization of the transform blocks: lmic_tpu's `--remat`.

lmic_tpu wraps the whole training forward in `jax.checkpoint`
(lmic_tpu/utils/train.py:112-125), and XLA schedules the recompute. Here
each transform block runs under a non-reentrant
`torch.utils.checkpoint.checkpoint` while `rematerialize()` is on and a
gradient is being recorded: the forward keeps only the block's inputs,
and the backward runs the block again to rebuild what its own backward
needs, one block at a time. One checkpoint around the whole forward would
compute the same gradients, but its recompute rebuilds every activation
before the backward frees any, so the peak would barely move. The blocks:

- each conv + GDN pair of a `GDNStack` (the g_a/g_s of the GDN codecs,
  the master's g_a), the stack's last conv joining the last pair, and the
  same pairs of the RGB-T pair's tapped transforms (`GuidedEncoder`,
  `GuidedDecoder`, `MasterDecoder`);
- each hyper transform, `h_a` and `h_s`, whole (`Block`);
- cheng2020's residual and attention blocks;
- the master's feature encoders and decoder, each branch of its channel
  aligner (the shared trunk and a head) and each Swin cross block.

No block draws noise: training's quantization noise comes from an
explicit `torch.Generator`, which a checkpoint does not replay, and is
drawn in the entropy models, outside every block (so the checkpoints keep
no RNG state). Blocks do not nest: one reached inside another runs
plainly, in the forward and in the recompute alike. Nothing is wrapped,
so the `state_dict` keys stay CompressAI's.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils.checkpoint import checkpoint

from lmic_tpu_torch.ops import precision

_STATE = threading.local()


@contextlib.contextmanager
def rematerialize(on: bool = True):
    """Within the block, the forwards of this thread checkpoint their
    transform blocks (when `on` and a gradient is being recorded)."""
    prev = getattr(_STATE, "on", False)
    _STATE.on = bool(on)
    try:
        yield
    finally:
        _STATE.on = prev


def _depth() -> int:
    return getattr(_STATE, "depth", 0)


def _inside(fn, *args):
    _STATE.depth = _depth() + 1
    try:
        return fn(*args)
    finally:
        _STATE.depth -= 1


def run(fn, *args):
    """`fn(*args)` as one block: checkpointed under `rematerialize()` when
    a gradient is being recorded and no block encloses it, else plainly.
    The recompute runs in the backward's thread, where `_inside` marks it
    as a block too, so its inner blocks run plainly there as well, and
    where it re-enters the matmul precision of the forward
    (`ops/precision.py`), so it rebuilds the same tensors."""
    if (torch.is_grad_enabled() and getattr(_STATE, "on", False)
            and _depth() == 0):
        mode = precision.current()
        return checkpoint(
            _inside, fn, *args, use_reentrant=False,
            preserve_rng_state=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                precision.matmul_precision(mode)))
    return fn(*args)


def _through(layers, x):
    for layer in layers:
        x = layer(x)
    return x


def sequence(layers, x):
    """`x` through `layers` in order, as one block."""
    return run(_through, tuple(layers), x)
