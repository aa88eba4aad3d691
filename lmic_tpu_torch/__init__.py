"""lmic_tpu_torch — the PyTorch/CUDA port of lmic_tpu.

A second package beside the JAX one, written for an NVIDIA H100: serving
and training of the non-autoregressive image codecs (bmshj2018-factorized,
bmshj2018-hyperprior, mbt2018-mean), serving of the autoregressive ones
(mbt2018, cheng2020-anchor, cheng2020-attn) and of the RGB-T guided/master
pair, evaluation (RD metrics, lmic_tpu's eval goldens) and file coding in
lmic_tpu's and the reference app's containers, with its own host rANS
coder, its own HTTP server, and the GDN/IGDN
forward and backward as hand-written CUDA kernels (`csrc/gdn_fwd.cu`,
`csrc/gdn_bwd.cu`, the counterparts of `lmic_tpu/ops/pallas_gdn.py`).

Layout: activations are NCHW tensors in `torch.channels_last` memory
format, so the GDN kernel sees a contiguous `(N*H*W, C)` view. Entry
points run on CUDA unless the caller asks for `device="cpu"`; without a
GPU and without that request they raise instead of drifting to the CPU.

This package never imports jax, flax or lmic_tpu: it keeps its own copy
of what it needs, so it installs and runs on a machine without JAX.
"""

__version__ = "0.1.0"

import torch

_entropy_coder = "rans"


def available_entropy_coders():
    """Names of usable entropy coders (reference: compressai/__init__.py:50)."""
    return ["rans"]


def get_entropy_coder():
    return _entropy_coder


def set_entropy_coder(name):
    global _entropy_coder
    if name not in available_entropy_coders():
        raise ValueError(
            f'Invalid entropy coder "{name}", choose from '
            f"({', '.join(available_entropy_coders())})"
        )
    _entropy_coder = name


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else CUDA.

    Raises when no GPU is present and the caller did not ask for the CPU
    explicitly, so a serving process never falls back to the CPU unseen.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "lmic_tpu_torch runs on CUDA and no GPU is available; "
            'pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda")
