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

`load_train_params`, `load_params` and `load_updated_model` also read
lmic_tpu's files, without flax or JAX (lmic_tpu/utils/checkpoint.py): its
training checkpoint (a pickle of `{"state": flax msgpack, "extra"}`, the
params read alone), its bare params (flax msgpack) and its deployment
file (a pickle of the `{"params": ...}` msgpack and numpy tables). The
first bytes tell the formats apart: a `torch.save` zip (`PK`), a pickle
(0x80 and its protocol), a msgpack map. The pickles go through an
unpickler that admits only numpy's array and scalar constructors and
builtin types, the msgpack through `msgpack` (imported when such a file
is read) with flax's extension types; the numpy params then become the
module's `state_dict` through `zoo/convert.py::state_dict_from_jax`.
"""

from __future__ import annotations

import hashlib
import io
import os
import pickle
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from lmic_tpu_torch.zoo.convert import (
    eb_state_from_numpy,
    gc_state_from_numpy,
    state_dict_from_jax,
    video_coding_state_from_numpy,
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
    extra). Reads lmic_tpu's training checkpoints too."""
    if _file_kind(path) == "pickle":
        payload = _unpickle(path)
        _load_flax_params(module, _msgpack_restore(payload["state"])["params"])
        return module, payload.get("extra", {})
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
    """Restore bare params written by `save_params` (or lmic_tpu's) into
    `module` (any device). Returns the module."""
    if _file_kind(path) == "msgpack":
        with open(path, "rb") as f:
            _load_flax_params(module, _msgpack_restore(f.read()))
        return module
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
    """Load a deployment checkpoint written by `update_model_file` (or by
    lmic_tpu's) into a codec of the right architecture (its params and
    coding tables). Returns the codec."""
    if _file_kind(path) == "pickle":
        blob = _unpickle(path)
        _load_flax_params(codec.module,
                          _msgpack_restore(blob["params"])["params"])
    else:
        blob = torch.load(path, map_location="cpu", weights_only=True)
        codec.module.load_state_dict(blob["params"])
    tables = _numpy({k: v for k, v in blob.items() if k != "params"})
    if "eb_state" in tables:
        codec.eb_state = eb_state_from_numpy(tables["eb_state"])
    if "gc_state" in tables:
        codec.gc_state = gc_state_from_numpy(tables["gc_state"])
    if "hp_states" in tables:
        video_coding_state_from_numpy(codec, {
            which: (s["eb"], s["gc"])
            for which, s in tables["hp_states"].items()})
    return codec


def _numpy(tree):
    """A tree of dicts with tensor or numpy leaves, all numpy (bf16
    tensors widened exactly to f32: numpy has no bf16)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return (tree.float() if tree.dtype == torch.bfloat16 else tree
                ).numpy()
    return tree


def _file_kind(path: str) -> str:
    """"torch" (a `torch.save` zip), "pickle" (lmic_tpu's training and
    deployment files) or "msgpack" (lmic_tpu's bare params), from the
    first bytes."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"PK":
        return "torch"
    if len(head) == 2 and head[0] == 0x80 and 2 <= head[1] <= 5:
        return "pickle"
    if head and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return "msgpack"
    raise ValueError(f"{path}: neither a torch.save file nor one of "
                     "lmic_tpu's checkpoint files")


# the globals a pickle of lmic_tpu's may name: numpy's array and scalar
# constructors (numpy 1 and 2 module paths; pickle protocols 2 to 5) and
# builtin types
_PICKLE_GLOBALS = frozenset(
    [(m, n) for m in ("numpy.core.multiarray", "numpy._core.multiarray")
     for n in ("_reconstruct", "scalar")]
    + [(m, "_frombuffer") for m in ("numpy.core.numeric",
                                    "numpy._core.numeric")]
    + [("numpy", "ndarray"), ("numpy", "dtype")]
    + [("builtins", n) for n in ("dict", "list", "tuple", "set",
                                 "frozenset", "int", "float", "complex",
                                 "bool", "str", "bytes", "bytearray")])


class _NumpyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) not in _PICKLE_GLOBALS:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not allowed in a checkpoint (only "
                "numpy arrays and scalars and builtin types are)")
        return super().find_class(module, name)


def _unpickle(path: str):
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()


def _msgpack_restore(data: bytes):
    """flax's `msgpack_restore` without flax: the tree of dicts with numpy
    leaves (bfloat16 arrays as torch bf16 tensors: numpy has no bf16),
    its chunked arrays joined."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError("reading lmic_tpu's flax-msgpack checkpoints "
                          "needs the `msgpack` package") from e

    def array(payload):
        shape, dtype, buf = msgpack.unpackb(payload, raw=True)
        if dtype == b"bfloat16":
            return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16
                                    ).reshape(shape)
        return np.frombuffer(buf, dtype=np.dtype(dtype.decode())
                             ).reshape(shape)

    def ext_hook(code, payload):
        if code == 1:  # ndarray
            return array(payload)
        if code == 2:  # complex
            real, imag = msgpack.unpackb(payload)
            return complex(real, imag)
        if code == 3:  # numpy scalar
            return array(payload)[()]
        return msgpack.ExtType(code, payload)

    return _unchunk(msgpack.unpackb(data, ext_hook=ext_hook, raw=False))


def _unchunk(tree):
    """Join flax's `__msgpack_chunked_array__` dicts (arrays of 2^30 bytes
    or more, written as flat chunks) back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        chunks, shape = tree["chunks"], tree["shape"]
        flat = np.concatenate([chunks[str(i)] for i in range(len(chunks))])
        return flat.reshape([shape[str(i)] for i in range(len(shape))])
    return {k: _unchunk(v) for k, v in tree.items()}


def _arch_of(module) -> str:
    """The zoo architecture whose module class `module` is."""
    from lmic_tpu_torch import zoo

    for table in (zoo.model_architectures, zoo.video_architectures):
        for arch, (cls, _) in table.items():
            if type(module) is cls:
                return arch
    raise ValueError(f"{type(module).__name__} is no zoo architecture")


def _load_flax_params(module, params):
    """Load lmic_tpu's params tree into `module` (f32 parameters, so a
    bf16 leaf loads as its exact f32 widening)."""
    module.load_state_dict(state_dict_from_jax(_arch_of(module),
                                               _numpy(params)))
