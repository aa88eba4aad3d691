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
  `_matrix{k}/_bias{k}/_factor{k}`; `quantiles` as is;
- mbt2018's `entropy_parameters_net` -> `entropy_parameters`, and
  `context_prediction` (the raw kernel; both sides mask it at call time);
- cheng2020's residual and attention blocks: flax's auto-named subtrees
  (`ResidualBlockWithStride_0/Conv_0/Conv_0/kernel`, ...) -> CompressAI's
  submodule names (`g_a.0.conv1.weight`, ...), the inverse of lmic_tpu's
  `_import_cheng` (lmic_tpu/zoo/pretrained.py:169-316; `block_state_dict`
  converts one block);
- the RGB-T pair (`guided`, `master`): flax's auto-names (`GDN_i`,
  `Conv_i`, `Deconv_i`, `_ResBlock64_i`, `block_i`,
  `WindowCrossAttention_0`, `Dense_i`) -> CompressAI's (`enc1.g_a_gdn1`,
  `decoder.downsample1`, `ch_aligner.conv5`,
  `decoder.sp_aligner1.blocks.0.attn.qkv1`, `...mlp.fc1`, ...), the
  inverse of lmic_tpu's `_import_guided`/`_import_master`
  (lmic_tpu/zoo/pretrained.py:567-737); dense kernels (in, out) -> Linear
  weights (out, in), LayerNorm `scale` -> `weight`.

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
_DECONVS["mbt2018"] = dict(_DECONVS["bmshj2018-hyperprior"],
                           entropy_parameters=())

# cheng2020 block kinds: flax path of each conv ("kernel"/"bias") or GDN
# ("beta"/"gamma") subtree -> CompressAI submodule name ("" for the layer
# itself); a `skip` is there only when the block changes shape
_CHENG_BLOCKS = {
    "rbs": {"Conv_0/Conv_0": "conv1", "Conv_1/Conv_0": "conv2",
            "GDN_0": "gdn", "Conv_2/Conv_0": "skip"},
    "rb": {"Conv_0/Conv_0": "conv1", "Conv_1/Conv_0": "conv2",
           "Conv_2/Conv_0": "skip"},
    "rbu": {"SubpelConv3x3_0/Conv_0/Conv_0": "subpel_conv.0",
            "Conv_0/Conv_0": "conv", "GDN_0": "igdn",
            "SubpelConv3x3_1/Conv_0/Conv_0": "upsample.0"},
    "attn": {
        **{f"_ResidualUnit_{3 * b + j}/Conv_{k}/Conv_0":
           f"conv_{'ab'[b]}.{j}.conv.{2 * k}"
           for b in (0, 1) for j in range(3) for k in range(3)},
        "Conv_0/Conv_0": "conv_b.3",
    },
    "conv": {"Conv_0": ""},
    "subpel": {"Conv_0/Conv_0": "0"},
}
_CHENG_HYPER = {
    "h_a": {0: "conv", 2: "conv", 4: "conv", 6: "conv", 8: "conv"},
    "h_s": {0: "conv", 2: "subpel", 4: "conv", 6: "subpel", 8: "conv"},
}
_CHENG = {
    "cheng2020-anchor": {
        "g_a": ("rbs", "rb", "rbs", "rb", "rbs", "rb", "conv"),
        "g_s": ("rb", "rbu", "rb", "rbu", "rb", "rbu", "rb", "subpel"),
    },
    "cheng2020-attn": {
        "g_a": ("rbs", "rb", "rbs", "attn", "rb", "rbs", "rb", "conv",
                "attn"),
        "g_s": ("attn", "rb", "rbu", "rb", "rbu", "attn", "rb", "rbu", "rb",
                "subpel"),
    },
}


def _conv_weight(kernel: np.ndarray) -> np.ndarray:
    """HWIO -> OIHW."""
    return kernel.transpose(3, 2, 0, 1)


def _deconv_weight(kernel: np.ndarray) -> np.ndarray:
    """Flipped (kh, kw, I, O) correlation kernel -> (I, O, kh, kw)."""
    return kernel[::-1, ::-1].transpose(2, 3, 0, 1)


def block_state_dict(kind: str, tree: Mapping[str, Any], prefix: str = ""
                     ) -> Dict[str, np.ndarray]:
    """One cheng2020 block's flax params -> its CompressAI keys under
    `prefix` (numpy leaves). Raises if a leaf of `tree` is left over."""
    out: Dict[str, np.ndarray] = {}
    seen = 0
    for path, name in _CHENG_BLOCKS[kind].items():
        node = tree
        for part in path.split("/"):
            node = node.get(part) if isinstance(node, Mapping) else None
        if node is None:
            continue  # an absent skip
        for leaf, value in node.items():
            if leaf == "kernel":
                leaf, value = "weight", _conv_weight(np.asarray(value))
            key = ".".join(p for p in (prefix, name, leaf) if p)
            out[key] = np.asarray(value)
            seen += 1
    if seen != _count_leaves(tree):
        raise ValueError(f"unconverted params in a '{kind}' block")
    return out


def _count_leaves(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def _cheng_state(arch: str, params: Mapping[str, Any]
                 ) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    schedules = {seq: dict(enumerate(kinds))
                 for seq, kinds in _CHENG[arch].items()}
    for seq, schedule in {**schedules, **_CHENG_HYPER}.items():
        layers = params[f"{seq}_net"]
        if set(layers) != {f"layers_{i}" for i in schedule}:
            raise ValueError(f"{seq}: layers {sorted(layers)}")
        for i, kind in schedule.items():
            out.update(block_state_dict(kind, layers[f"layers_{i}"],
                                        f"{seq}.{i}"))
    return out


def _sequence_state(sequences: Mapping[str, tuple],
                    params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax Sequentials of convs, deconvs (at the given indices) and GDNs
    -> `{seq}.{i}.*` keys."""
    out: Dict[str, np.ndarray] = {}
    for seq, deconvs in sequences.items():
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
    return out


# RGB-T: (flax path, CompressAI name, kind) of each converted subtree; a
# kind says how its leaves map (see _rgbt_leaves)
_SWIN_BLOCK = (
    ("norm1", "norm1", "ln"), ("norm2", "norm2", "ln"),
    ("WindowCrossAttention_0/qkv1", "attn.qkv1", "dense"),
    ("WindowCrossAttention_0/qkv2", "attn.qkv2", "dense"),
    ("WindowCrossAttention_0/proj", "attn.proj", "dense"),
    ("WindowCrossAttention_0", "attn", "table"),
    ("Dense_0", "mlp.fc1", "dense"), ("Dense_1", "mlp.fc2", "dense"),
)


def _resblock64(path, name):
    return [(f"{path}/{sub}", f"{name}.{conv}", "conv")
            for sub, conv in _CHENG_BLOCKS["rb"].items()]


def _rgbt_table(arch: str):
    if arch == "guided":
        return (
            [(f"g_a_net/Conv_{i}/Conv_0", f"enc1.g_a_conv{i + 1}", "conv")
             for i in range(4)]
            + [(f"g_a_net/GDN_{i}", f"enc1.g_a_gdn{i + 1}", "gdn")
               for i in range(3)]
            + [(f"g_s_net/Deconv_{i}/Conv_0", f"dec1.g_s_conv{i + 1}",
                "deconv") for i in range(4)]
            + [(f"g_s_net/GDN_{i}", f"dec1.g_s_gdn{i + 1}", "gdn")
               for i in range(3)])
    table = []
    for i in range(3):
        sa, name = f"g_s_net/sp_aligner{i + 1}", f"decoder.sp_aligner{i + 1}"
        table += [
            (f"g_s_net/Deconv_{i}/Conv_0", f"decoder.g_s_conv{i + 1}",
             "deconv"),
            (f"g_s_net/GDN_{i}", f"decoder.g_s_gdn{i + 1}", "gdn"),
            # only with a 1-channel master (the guide at 2x)
            (f"g_s_net/Conv_{i}/Conv_0", f"decoder.downsample{i + 1}",
             "conv"),
            (f"{sa}/patch_embed1", f"{name}.patch_embeding1.proj", "conv"),
            (f"{sa}/patch_embed2", f"{name}.patch_embeding2.proj", "conv"),
            (f"{sa}/recovery/Conv_0", f"{name}.recovery", "deconv"),
        ] + [(f"{sa}/block_{b}/{path}", f"{name}.blocks.{b}.{sub}", kind)
             for b in range(2) for path, sub, kind in _SWIN_BLOCK]
    table.append(("g_s_net/Deconv_3/Conv_0", "decoder.g_s_conv4", "deconv"))
    for j in (1, 2):
        table.append((f"fencoder{j}/Conv_0/Conv_0", f"fencoder{j}.conv1",
                      "conv"))
        for i in range(3):
            table += _resblock64(f"fencoder{j}/_ResBlock64_{i}",
                                 f"fencoder{j}.resblock{i + 1}")
    for i in range(3):
        table += _resblock64(f"fdecoder/_ResBlock64_{i}",
                             f"fdecoder.resblock{i + 1}")
    table += [("fdecoder/Conv_0/Conv_0", "fdecoder.conv", "conv"),
              ("fdecoder/Deconv_0/Conv_0", "fdecoder.deconv1", "deconv")]
    table += [(f"ch_aligner/Conv_{i}/Conv_0", f"ch_aligner.conv{i + 1}",
               "conv") for i in range(6)]
    return table


def _rgbt_leaves(node, kind):
    """One subtree's leaves -> {CompressAI leaf name: array}."""
    if kind == "gdn":
        return {"beta": node["beta"], "gamma": node["gamma"]}
    if kind == "ln":
        return {"weight": node["scale"], "bias": node["bias"]}
    if kind == "table":
        return {"relative_position_bias_table":
                node["relative_position_bias_table"]}
    k = np.asarray(node["kernel"])
    weight = {"conv": _conv_weight, "deconv": _deconv_weight,
              "dense": np.transpose}[kind](k)
    return {"weight": weight, "bias": node["bias"]}


def _rgbt_state(arch: str, params: Mapping[str, Any]
                ) -> Dict[str, np.ndarray]:
    """The RGB-T transforms' leaves, and the mbt2018 machinery both
    compressers inherit. Raises if a leaf of `params` is left over."""
    out: Dict[str, np.ndarray] = {}
    for path, name, kind in _rgbt_table(arch):
        node = params
        for part in path.split("/"):
            node = node.get(part) if isinstance(node, Mapping) else None
        if node is None:
            continue  # an absent skip or downsample
        for leaf, value in _rgbt_leaves(node, kind).items():
            out[f"{name}.{leaf}"] = np.asarray(value)
    seqs = dict(_DECONVS["mbt2018"])
    if arch == "guided":
        del seqs["g_a"], seqs["g_s"]
    else:
        del seqs["g_s"]
    out.update(_sequence_state(seqs, params))
    want = _count_leaves({k: v for k, v in params.items() if k not in (
        "entropy_bottleneck", "context_prediction")})
    if len(out) != want:
        raise ValueError(f"{arch}: converted {len(out)} of {want} params")
    return out


def state_dict_from_jax(arch: str, params: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """lmic_tpu `variables["params"]` (numpy leaves) -> this package's
    `state_dict` for `arch`, in the leaves' dtype. The map is linear, so it
    carries a gradient tree of the same structure across too."""
    if arch in ("guided", "master"):
        out = _rgbt_state(arch, params)
    elif arch in _CHENG:
        out = _cheng_state(arch, params)
        out.update(_sequence_state({"entropy_parameters": ()}, params))
    elif arch in _DECONVS:
        out = _sequence_state(_DECONVS[arch], params)
    else:
        raise ValueError(f"no converter for '{arch}'")
    if "context_prediction" in params:
        cp = params["context_prediction"]
        out["context_prediction.weight"] = _conv_weight(
            np.asarray(cp["kernel"]))
        out["context_prediction.bias"] = np.asarray(cp["bias"])
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
        medians=np.array(eb["medians"], np.float32).reshape(-1),  # own copy
    )
    if gc is not None:
        codec.gc_state = GCState(
            table=CdfTable(gc["cdf"], gc["cdf_length"], gc["offset"]),
            scale_table=np.asarray(gc["scale_table"], np.float32),
        )
    return codec
