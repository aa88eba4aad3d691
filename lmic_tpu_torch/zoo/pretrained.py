"""Load CompressAI-format PyTorch checkpoints: the reference's published
weights and its deployment files.

Counterpart of lmic_tpu/zoo/pretrained.py (`rename_reference_keys` :53,
`load_torch_state_dict` :73, `import_reference_state_dict` :313,
`import_reference_coding_state` :363,
`import_reference_video_coding_state` :445, `load_reference_checkpoint`
:467). The port's modules carry CompressAI's key names and tensor
layouts (OIHW convs, (I, O, kh, kw) transposed convs, the GDN's
sqrt-reparametrized beta/gamma, the bottleneck's `_matrix{k}`), so an
import converts no layout: it renames old spellings and keeps the keys
the module has.

- Renames (reference compressai/zoo/pretrained.py:35-57): strip
  `module.` (DataParallel), `downsample` -> `skip` in the old residual
  blocks, and the ParameterList-era `_matrices.{k}`, `_biases.{k}`,
  `_factors.{k}` -> `_matrix{k}`, `_bias{k}`, `_factor{k}`.
- Strictness: every key of the module must be in the file with the
  module's shape (`KeyError`, `ValueError`). Keys the module lacks are
  dropped, as lmic_tpu's importers drop them: the reference's
  non-parameter buffers (`*.beta_reparam.pedestal`,
  `*.lower_bound.bound`, `context_prediction.mask`, the bottleneck's
  `_quantized_cdf/_offset/_cdf_length/target`, `likelihood_lower_bound`,
  `gaussian_conditional.scale_table/lower_bound_scale`), the unused
  modules the RGB-T classes inherit, and anything else.
- Baked tables: a deployment file carries the integer coding tables;
  adopting them (instead of `update(force=True)`) makes the port code the
  reference's and lmic_tpu's bytes, whatever the float drift of a
  recomputed table (ROADMAP.md, queue C).
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from lmic_tpu_torch.entropy.coder import CdfTable
from lmic_tpu_torch.entropy.entropy_models import EBState, GCState

__all__ = [
    "IMPORTABLE",
    "rename_reference_keys",
    "load_torch_state_dict",
    "import_reference_state_dict",
    "import_reference_coding_state",
    "import_reference_video_coding_state",
    "adopt_coding_state",
    "load_reference_checkpoint",
]

# the architectures lmic_tpu's `_IMPORTERS` covers
IMPORTABLE = (
    "bmshj2018-factorized", "bmshj2018-hyperprior", "mbt2018-mean",
    "mbt2018", "cheng2020-anchor", "cheng2020-attn", "ssf2020", "guided",
    "master", "mbt2018_R", "mbt2018_D", "cheng2020-anchor_R",
    "cheng2020-anchor_D", "cheng2020-attn_R", "cheng2020-attn_D",
)


def rename_reference_keys(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """The reference `load_pretrained`'s renames (see the module doc); the
    values are passed through."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if ".downsample." in k:
            k = k.replace("downsample", "skip")
        k = re.sub(r"(.*)\._?matrices\.(\d+)$", r"\1._matrix\2", k)
        k = re.sub(r"(.*)\._?biases\.(\d+)$", r"\1._bias\2", k)
        k = re.sub(r"(.*)\._?factors\.(\d+)$", r"\1._factor\2", k)
        out[k] = v
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference .pth(.tar) file into {renamed key: CPU tensor}. The
    file is a bare state_dict or a training checkpoint with a
    'state_dict' entry (reference examples/train.py:276-282)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return rename_reference_keys(blob)


def import_reference_state_dict(arch: str, state_dict: Dict[str, Any],
                                module: torch.nn.Module
                                ) -> Dict[str, torch.Tensor]:
    """The keys of `module` (an `arch` module of the widths the file was
    trained at) from a reference state_dict, renamed first, in the
    module's dtypes: what `module.load_state_dict` (strict) takes. Raises
    KeyError for a key of the module the file lacks, ValueError for one of
    another shape; drops the file's other keys."""
    if arch not in IMPORTABLE:
        raise ValueError(f"no reference importer for '{arch}' "
                         f"(available: {sorted(IMPORTABLE)})")
    sd = rename_reference_keys(state_dict)
    out = {}
    for key, want in module.state_dict().items():
        if key not in sd:
            raise KeyError(f"{arch}: the checkpoint has no '{key}'")
        got = torch.as_tensor(sd[key])
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"{arch}: shape mismatch at '{key}': "
                             f"checkpoint {tuple(got.shape)} vs model "
                             f"{tuple(want.shape)}")
        out[key] = got.detach().to("cpu", want.dtype)
    return out


def _buffer(state_dict, name):
    """A buffer of the file as numpy, or None when absent or empty (a
    non-deployment save carries empty companions)."""
    v = state_dict.get(name)
    if v is None:
        return None
    v = np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
    return v if v.size else None


def _table(cdf, cdf_length, offset) -> CdfTable:
    return CdfTable(cdf.astype(np.int32), cdf_length.astype(np.int32),
                    offset.reshape(-1).astype(np.int32))


def _baked_states(state_dict, eb_prefix, gc_prefix, need_gc: bool):
    """(EBState, GCState or None) from the file's baked buffers, or None
    when they are missing or partial."""
    eb = [_buffer(state_dict, f"{eb_prefix}.{n}") for n in
          ("_quantized_cdf", "_cdf_length", "_offset", "quantiles")]
    if any(v is None for v in eb):
        return None
    gc = [_buffer(state_dict, f"{gc_prefix}.{n}") for n in
          ("_quantized_cdf", "_cdf_length", "_offset", "scale_table")]
    if gc[0] is not None and any(v is None for v in gc):
        return None
    if gc[0] is None and need_gc:
        return None
    eb_state = EBState(table=_table(*eb[:3]),
                       medians=eb[3][:, 0, 1].astype(np.float32))
    gc_state = None
    if gc[0] is not None:
        gc_state = GCState(table=_table(*gc[:3]),
                           scale_table=gc[3].astype(np.float32))
    return eb_state, gc_state


def _invalidate(codec):
    """Forget every fast-path module built from the old tables: the
    `_ensure` cache and what it made."""
    for name in ("_built_for", "_enc_u8", "_enc_u8_packed", "_dec_u8",
                 "_analyze_u8", "_params_from_zsym", "_ysym", "_pack_enc",
                 "_synth_u8", "_analyze_u8_ar", "_g_s_u8"):
        codec.__dict__.pop(name, None)


def import_reference_coding_state(state_dict: Dict[str, Any], codec,
                                  eb_prefix: str = "entropy_bottleneck",
                                  gc_prefix: str = "gaussian_conditional",
                                  ) -> bool:
    """Adopt the baked integer coding tables of a reference deployment
    file (`_quantized_cdf/_offset/_cdf_length`, the medians
    `quantiles[:, 0, 1]`, `scale_table`). Returns True when installed;
    False, with the codec untouched, when the file has none or only some
    (a codec with a Gaussian conditional needs its tables too; the
    factorized prior has none): then call `codec.update(force=True)`."""
    from lmic_tpu_torch.models.codec import FactorizedPriorCodec

    states = _baked_states(state_dict, eb_prefix, gc_prefix,
                           not isinstance(codec, FactorizedPriorCodec))
    if states is None:
        return False
    codec.eb_state, gc_state = states
    if gc_state is not None:
        codec.gc_state = gc_state
    _invalidate(codec)
    return True


def import_reference_video_coding_state(state_dict: Dict[str, Any],
                                        codec) -> bool:
    """ssf2020: adopt the baked tables of all three hyperprior sub-codecs
    (img/motion/res, reference video/google.py:200-208) through
    `install_tables`. False, with the codec untouched, unless all three
    are complete."""
    tables = {}
    for which in codec.SUB_CODECS:
        states = _baked_states(
            state_dict, f"{which}_hyperprior.entropy_bottleneck",
            f"{which}_hyperprior.gaussian_conditional", True)
        if states is None:
            return False
        tables[which] = states
    codec.install_tables(tables)
    return True


def adopt_coding_state(arch: str, state_dict: Dict[str, Any], codec) -> bool:
    """`import_reference_video_coding_state` for ssf2020, else
    `import_reference_coding_state`."""
    if arch == "ssf2020":
        return import_reference_video_coding_state(state_dict, codec)
    return import_reference_coding_state(state_dict, codec)


def load_reference_checkpoint(arch: str, path: str, quality: int = 1,
                              channel: int = 3, update: bool = True,
                              device=None, **kwargs):
    """A reference .pth(.tar) file -> a codec on `device` (CUDA unless
    told otherwise): read and rename, keep the module's keys, load them,
    and (by default) adopt the file's baked tables, or bake fresh ones
    when it has none. `kwargs` go to `zoo.create_model` (e.g.
    `first_stride` of a guide)."""
    from lmic_tpu_torch import zoo

    if arch in zoo.video_architectures:
        codec = zoo.create_video_model(arch, quality, device=device)
    else:
        codec = zoo.create_model(arch, quality, channel=channel,
                                 device=device, **kwargs)
    sd = load_torch_state_dict(path)
    codec.module.load_state_dict(
        import_reference_state_dict(arch, sd, codec.module))
    if update and not adopt_coding_state(arch, sd, codec):
        codec.update(force=True)
    return codec
