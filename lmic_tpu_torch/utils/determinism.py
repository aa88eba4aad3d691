"""Deterministic numerics for wire-determining graphs.

The analysis transform's output becomes the coded symbols and the hyper
synthesis picks the Gaussian scale buckets: a one-ulp change at a rounding
or bucket edge changes the bitstream (or desyncs it, for the indexes). So
every such graph runs in full f32 (no TF32 in matmuls or convolutions) and
with cuDNN algorithms that are deterministic and not chosen by timing.
"""

from __future__ import annotations

import torch


def set_wire_determinism() -> None:
    """Turn TF32 off for matmul and cuDNN, force deterministic cuDNN
    algorithms, and disable cuDNN autotuning; on the CPU, give the calling
    thread the process's intra-op thread count. Idempotent."""
    # OpenMP keeps the team size per calling thread, and CPU convolutions
    # split their sums by it: without this a server's handler thread and
    # the main thread compute different last bits from the same input
    torch.set_num_threads(torch.get_num_threads())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
