"""Carry weights and coding state across from the JAX package.

`state_dict_from_jax(arch, params)` is the inverse of the JAX package's
reference importer (lmic_tpu/zoo/pretrained.py:85-156): it takes the
`variables["params"]` tree of an lmic_tpu image codec, as nested dicts of
numpy arrays, and returns this package's `state_dict` (CompressAI keys):

- conv kernels HWIO -> OIHW;
- deconv kernels: lmic_tpu's input-dilated correlation kernel
  (kh, kw, I, O), spatially flipped, -> ConvTranspose2d (I, O, kh, kw);
- `layers_{i}` of a flax Sequential -> `{prefix}.{i}`;
- entropy bottleneck `matrix_{k}/bias_{k}/factor_{k}` ->
  `_matrix{k}/_bias{k}/_factor{k}`; `quantiles` as is.

`coding_state_from_numpy(codec, eb=..., gc=...)` installs carried integer
CDF tables, medians and the scale table, so both packages code with the
same tables (recomputed tables may differ by one in a few entries: the
pmfs are float functions evaluated by two frameworks).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from lmic_tpu_torch.entropy.coder import CdfTable
from lmic_tpu_torch.entropy.entropy_models import EBState, GCState

# sequence -> indices of its transposed convolutions, per architecture
_DECONVS = {
    "bmshj2018-factorized": {"g_a": (), "g_s": (0, 2, 4, 6)},
    "bmshj2018-hyperprior": {"g_a": (), "g_s": (0, 2, 4, 6),
                             "h_a": (), "h_s": (0, 2)},
}
_DECONVS["mbt2018-mean"] = _DECONVS["bmshj2018-hyperprior"]


def _conv_weight(kernel: np.ndarray) -> np.ndarray:
    """HWIO -> OIHW."""
    return kernel.transpose(3, 2, 0, 1)


def _deconv_weight(kernel: np.ndarray) -> np.ndarray:
    """Flipped (kh, kw, I, O) correlation kernel -> (I, O, kh, kw)."""
    return kernel[::-1, ::-1].transpose(2, 3, 0, 1)


def state_dict_from_jax(arch: str, params: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """lmic_tpu `variables["params"]` (numpy leaves) -> this package's
    `state_dict` for `arch`, in the leaves' dtype. The map is linear, so it
    carries a gradient tree of the same structure across too."""
    if arch not in _DECONVS:
        raise ValueError(f"no converter for '{arch}'")
    out: Dict[str, np.ndarray] = {}
    for seq, deconvs in _DECONVS[arch].items():
        for name, layer in params[f"{seq}_net"].items():
            i = int(name[len("layers_"):])
            if "Conv_0" in layer:
                k = np.asarray(layer["Conv_0"]["kernel"])
                out[f"{seq}.{i}.weight"] = (
                    _deconv_weight(k) if i in deconvs else _conv_weight(k)
                )
                out[f"{seq}.{i}.bias"] = np.asarray(layer["Conv_0"]["bias"])
            else:
                out[f"{seq}.{i}.beta"] = np.asarray(layer["beta"])
                out[f"{seq}.{i}.gamma"] = np.asarray(layer["gamma"])
    for name, v in params["entropy_bottleneck"].items():
        if name != "quantiles":
            kind, k = name.rsplit("_", 1)
            name = f"_{kind}{k}"
        out[f"entropy_bottleneck.{name}"] = np.asarray(v)
    return {
        k: torch.from_numpy(np.array(v))  # own copy
        for k, v in out.items()
    }


def coding_state_from_numpy(codec, eb: Mapping[str, np.ndarray],
                            gc: Optional[Mapping[str, np.ndarray]] = None):
    """Install carried coding state on `codec`.

    eb: {"cdf", "cdf_length", "offset", "medians"} of the entropy
    bottleneck; gc: {"cdf", "cdf_length", "offset", "scale_table"} of the
    Gaussian conditional (hyperprior codecs only).
    """
    codec.eb_state = EBState(
        table=CdfTable(eb["cdf"], eb["cdf_length"], eb["offset"]),
        medians=np.asarray(eb["medians"], np.float32).reshape(-1),
    )
    if gc is not None:
        codec.gc_state = GCState(
            table=CdfTable(gc["cdf"], gc["cdf_length"], gc["offset"]),
            scale_table=np.asarray(gc["scale_table"], np.float32),
        )
    return codec
