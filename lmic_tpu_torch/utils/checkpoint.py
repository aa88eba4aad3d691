"""Checkpoints in torch's own format: the training state (params, both
optimizer states, step) and finalized deployment checkpoints.

Counterpart of lmic_tpu/utils/checkpoint.py (reference examples/train.py:
276-282 for the save with optimizers and the best-loss copy;
compressai/utils/update_model/__main__.py:128-206 for the CDF baking and
the sha256[:8] name). A training checkpoint is a `torch.save` of
`{"params", "main", "aux", "step", "extra"}`: the module's and the two
optimizers' `state_dict`s, the step count and the caller's metadata. A
deployment checkpoint holds the params and the coding tables as tensors;
ssf2020's three sub-codecs' tables go under `hp_states`, {which: {"eb",
"gc"}}, as in lmic_tpu (lmic_tpu/utils/checkpoint.py:108-127, 163-176).
Bare params (`save_params`, lmic_tpu's `--no-update` output) are a
`torch.save` of the `state_dict`. All load with `weights_only=True`.
lmic_tpu's flax-msgpack files are another format and are not read here.
"""

from __future__ import annotations

import hashlib
import io
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from lmic_tpu_torch.zoo.convert import (
    eb_state_from_numpy,
    gc_state_from_numpy,
)

_TABLE_KEYS = ("cdf", "cdf_length", "offset")


def _device_of(module) -> torch.device:
    return next(module.parameters()).device


def save_checkpoint(path: str, state, extra: Optional[Dict[str, Any]] = None,
                    is_best: bool = False):
    """Write `state` (a utils.train.TrainState) and `extra` to `path`,
    atomically (a temporary file, then `os.replace`); with `is_best`, copy
    it to `<stem>_best_loss.ckpt` beside it."""
    payload = dict(state.state_dict(), extra=dict(extra or {}))
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if is_best:
        best = os.path.join(
            parent or ".",
            os.path.basename(path).replace(".ckpt", "") + "_best_loss.ckpt",
        )
        shutil.copyfile(path, best)


def load_checkpoint(path: str, state):
    """Restore a training checkpoint into `state` (a TrainState built for
    the same architecture, on any device). Returns (state, extra)."""
    payload = torch.load(path, map_location=_device_of(state.module),
                         weights_only=True)
    state.load_state_dict(payload)
    return state, payload.get("extra", {})


def load_train_params(path: str, module):
    """Restore only the params of a training checkpoint into `module`,
    whatever optimizer settings it was saved with. Returns (module,
    extra)."""
    payload = torch.load(path, map_location=_device_of(module),
                         weights_only=True)
    module.load_state_dict(payload["params"])
    return module, payload.get("extra", {})


def _table_tensors(state, last: str) -> Dict[str, torch.Tensor]:
    arrays = {k: getattr(state.table, k) for k in _TABLE_KEYS}
    arrays[last] = getattr(state, last)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in arrays.items()}


def save_params(path: str, module):
    """Write the bare params (`module.state_dict()`), what lmic_tpu's
    `save_params` writes and `update_model_cli --no-update` leaves."""
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()},
               path)


def load_params(path: str, module):
    """Restore bare params written by `save_params` into `module` (any
    device). Returns the module."""
    module.load_state_dict(torch.load(path, map_location=_device_of(module),
                                      weights_only=True))
    return module


def update_model_file(out_dir: str, codec, name: str,
                      update: bool = True) -> str:
    """Finalize a deployment checkpoint: run `codec.update(force=True)`,
    store the params and coding tables, and name the file
    `<name>-<sha256[:8] of its bytes>.ckpt` in `out_dir`. `update=False`
    keeps the tables the codec holds (e.g. adopted from a reference
    file's baked buffers, zoo/pretrained.py)."""
    if update:
        codec.update(force=True)
    blob: Dict[str, Any] = {
        "params": {k: v.detach().cpu()
                   for k, v in codec.module.state_dict().items()},
    }
    if codec.eb_state is not None:
        blob["eb_state"] = _table_tensors(codec.eb_state, "medians")
    if codec.gc_state is not None:
        blob["gc_state"] = _table_tensors(codec.gc_state, "scale_table")
    if getattr(codec, "hp_states", None):
        blob["hp_states"] = {
            which: {"eb": _table_tensors(hp.eb_state, "medians"),
                    "gc": _table_tensors(hp.gc_state, "scale_table")}
            for which, hp in codec.hp_states.items()}
    buf = io.BytesIO()
    torch.save(blob, buf)
    data = buf.getvalue()
    digest = hashlib.sha256(data).hexdigest()[:8]
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{name}-{digest}.ckpt")
    with open(out_path, "wb") as f:
        f.write(data)
    return out_path


def load_updated_model(path: str, codec):
    """Load a deployment checkpoint written by `update_model_file` into a
    codec of the right architecture (its params and coding tables).
    Returns the codec."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    codec.module.load_state_dict(blob["params"])
    if "eb_state" in blob:
        codec.eb_state = eb_state_from_numpy(_numpy(blob["eb_state"]))
    if "gc_state" in blob:
        codec.gc_state = gc_state_from_numpy(_numpy(blob["gc_state"]))
    if "hp_states" in blob:
        codec.install_tables({
            which: (eb_state_from_numpy(_numpy(s["eb"])),
                    gc_state_from_numpy(_numpy(s["gc"])))
            for which, s in blob["hp_states"].items()})
    return codec


def _numpy(tensors):
    return {k: v.numpy() for k, v in tensors.items()}
