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
  weights (out, in), LayerNorm `scale` -> `weight`;
- the paired RGB-T archs (`mbt2018_R`/`_D`, `cheng2020-anchor_R`/`_D`,
  `cheng2020-attn_R`/`_D`): the inverses of lmic_tpu's `_import_guided`,
  `_import_jahp_d`, `_import_cheng_anchor_r`, `_import_cheng_attn_r`,
  `_import_cheng_anchor_d` and `_import_cheng_attn_d` with their parts
  `_esa`, `_edge_fuse` and `_cheng_h_nets`
  (lmic_tpu/zoo/pretrained.py:743-921): `enc_fuse_{i}`/`dec_fuse_{i}`
  -> `eg_ext{k}.0`, `tran_conv{k}`, `attention{k}.conv1..conv4`;
  `pic2_ga_convs_{i}` -> `pic2_g_a_conv{i+1}`; cheng2020-attn_R's
  `g_a_net`/`g_s_net` blocks -> `enc.res_stride1`, `dec.atten1`, ...;
  cheng2020-attn_D's `ga_blocks_pre_0` -> `g_a_rbs1`;
- ssf2020: each sub-codec's `Conv_{j}`/`Deconv_{j}` stacks ->
  `{img,res,motion}_encoder.{2j}` / `..._decoder.{2j}`, its hyperprior's
  `hyper_encoder`/`hyper_decoder_mean` -> `.{2j}` and
  `hyper_decoder_scale` -> `.deconv{j+1}`, and its bottleneck under
  `{which}_hyperprior.entropy_bottleneck`, the inverse of lmic_tpu's
  `_import_ssf2020` (lmic_tpu/zoo/pretrained.py:502-559).

`coding_state_from_numpy(codec, eb=..., gc=...)` installs carried integer
CDF tables, medians and the scale table, so both packages code with the
same tables (recomputed tables may differ by one in a few entries: the
pmfs are float functions evaluated by two frameworks);
`video_coding_state_from_numpy(codec, {which: (eb, gc)})` does the same
for ssf2020's three sub-codecs.
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


def _cheng_state(schedules: Mapping[str, Mapping[int, str]],
                 params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax Sequentials of cheng2020 blocks, `{seq: {index: kind}}` ->
    `{seq}.{i}.*` keys."""
    out: Dict[str, np.ndarray] = {}
    for seq, schedule in schedules.items():
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


# the paired RGB-T archs (lmic_tpu/zoo/pretrained.py:743-921): the guide
# codecs and the dependent codecs, which read the guide's maps
_PAIRED_R = ("mbt2018_R", "cheng2020-anchor_R", "cheng2020-attn_R")
_PAIRED_D = ("mbt2018_D", "cheng2020-anchor_D", "cheng2020-attn_D")
# cheng2020-attn_R's tapped transforms (waseda.py:409-460): flax
# auto-name -> CompressAI name under `enc`/`dec`, block kind
_CHENG_ENC_HIDDEN = (
    ("ResidualBlockWithStride_0", "res_stride1", "rbs"),
    ("ResidualBlock_0", "res1", "rb"),
    ("ResidualBlockWithStride_1", "res_stride2", "rbs"),
    ("AttentionBlock_0", "atten1", "attn"),
    ("ResidualBlock_1", "res2", "rb"),
    ("ResidualBlockWithStride_2", "res_stride3", "rbs"),
    ("ResidualBlock_2", "res3", "rb"),
    ("Conv_0/Conv_0", "conv", "conv"),
    ("AttentionBlock_1", "atten2", "attn"),
)
_CHENG_DEC_HIDDEN = (
    ("AttentionBlock_0", "atten1", "attn"),
    ("ResidualBlock_0", "res1", "rb"),
    ("ResidualBlockUpsample_0", "res_stride1", "rbu"),
    ("ResidualBlock_1", "res2", "rb"),
    ("ResidualBlockUpsample_1", "res_stride2", "rbu"),
    ("AttentionBlock_1", "atten2", "attn"),
    ("ResidualBlock_2", "res3", "rb"),
    ("ResidualBlockUpsample_2", "res_stride3", "rbu"),
    ("ResidualBlock_3", "res4", "rb"),
    ("SubpelConv3x3_0/Conv_0/Conv_0", "conv.0", "conv"),
)
# cheng2020-attn_D's fused transforms (waseda.py:533-694): lmic_tpu's
# attribute -> CompressAI's, block kind
_CHENG_ATTN_D = (
    ("ga_blocks_pre_0", "g_a_rbs1", "rbs"), ("g_a_rb1", "g_a_rb1", "rb"),
    ("g_a_rbs2", "g_a_rbs2", "rbs"), ("g_a_att1", "g_a_att1", "attn"),
    ("g_a_rb2", "g_a_rb2", "rb"), ("g_a_rbs3", "g_a_rbs3", "rbs"),
    ("g_a_rb3", "g_a_rb3", "rb"), ("g_a_conv/Conv_0", "g_a_conv", "conv"),
    ("g_a_att2", "g_a_att2", "attn"), ("g_s_att1", "g_s_att1", "attn"),
    ("g_s_rb1", "g_s_rb1", "rb"), ("g_s_rbs1", "g_s_rbs1", "rbu"),
    ("g_s_rb2", "g_s_rb2", "rb"), ("g_s_rbs2", "g_s_rbs2", "rbu"),
    ("g_s_att2", "g_s_att2", "attn"), ("g_s_rb3", "g_s_rb3", "rb"),
    ("g_s_rbs3", "g_s_rbs3", "rbu"), ("g_s_rb4", "g_s_rb4", "rb"),
    ("g_s_conv/Conv_0/Conv_0", "g_s_conv.0", "conv"),
)
# ESA's convs in lmic_tpu's call order (flax auto-names Conv_0..6; conv2
# is a raw nn.Conv, the others lmic_tpu Convs around one)
_ESA = ("conv1", "conv2", "conv_max", "conv3", "conv3_", "conv_f", "conv4")


def _guided_table(enc="enc1", dec="dec1"):
    """mbt2018's tapped transforms (Encoder1/Decoder1)."""
    return (
        [(f"g_a_net/Conv_{i}/Conv_0", f"{enc}.g_a_conv{i + 1}", "conv")
         for i in range(4)]
        + [(f"g_a_net/GDN_{i}", f"{enc}.g_a_gdn{i + 1}", "gdn")
           for i in range(3)]
        + [(f"g_s_net/Deconv_{i}/Conv_0", f"{dec}.g_s_conv{i + 1}",
            "deconv") for i in range(4)]
        + [(f"g_s_net/GDN_{i}", f"{dec}.g_s_gdn{i + 1}", "gdn")
           for i in range(3)])


def _edge_fuse_table(path, eg_x, eg_h, k):
    """One `_EdgeFuse` level (lmic_tpu/zoo/pretrained.py:772-781):
    eg_ext{eg_x} on the master stream, eg_ext{eg_h} on the guide's map,
    tran_conv{k}, attention{k}."""
    esa = f"{path}/ESA_0"
    return [(f"{path}/Conv_0/Conv_0", f"eg_ext{eg_x}.0", "conv"),
            (f"{path}/Conv_1/Conv_0", f"eg_ext{eg_h}.0", "conv"),
            (f"{path}/Conv_2/Conv_0", f"tran_conv{k}", "conv")] + [
        (f"{esa}/Conv_{j}" + ("" if j == 1 else "/Conv_0"),
         f"attention{k}.{name}", "conv") for j, name in enumerate(_ESA)]


def _paired_table(arch: str):
    """The `_R`/`_D` archs' own transforms (their hyper pairs and the
    mbt2018 machinery come from `_rgbt_state`)."""
    if arch == "cheng2020-attn_R":
        return ([(f"g_a_net/{p}", f"enc.{n}", k)
                 for p, n, k in _CHENG_ENC_HIDDEN]
                + [(f"g_s_net/{p}", f"dec.{n}", k)
                   for p, n, k in _CHENG_DEC_HIDDEN])
    if arch in _PAIRED_R:
        return _guided_table()
    table = []
    for i in range(3):
        table += _edge_fuse_table(f"enc_fuse_{i}", 2 * i + 1, 2 * i + 2,
                                  i + 1)
        table += _edge_fuse_table(f"dec_fuse_{i}", 2 * i + 7, 2 * i + 8,
                                  i + 4)
    if arch == "cheng2020-attn_D":
        return table + list(_CHENG_ATTN_D)
    for i in range(4):
        table += [
            (f"pic2_ga_convs_{i}/Conv_0", f"pic2_g_a_conv{i + 1}", "conv"),
            (f"pic2_gs_convs_{i}/Conv_0", f"pic2_g_s_conv{i + 1}",
             "deconv")]
    for i in range(3):
        table += [(f"pic2_ga_gdns_{i}", f"pic2_g_a_gdn{i + 1}", "gdn"),
                  (f"pic2_gs_gdns_{i}", f"pic2_g_s_gdn{i + 1}", "gdn")]
    return table


def _rgbt_table(arch: str):
    if arch == "guided":
        return _guided_table()
    if arch in _PAIRED_R + _PAIRED_D:
        return _paired_table(arch)
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
    """The RGB-T transforms' leaves (the pair's and the paired archs'),
    and the mbt2018 machinery they inherit, with cheng2020's hyper pair
    where they have it. Raises if a leaf of `params` is left over."""
    out: Dict[str, np.ndarray] = {}
    for path, name, kind in _rgbt_table(arch):
        node = params
        for part in path.split("/"):
            node = node.get(part) if isinstance(node, Mapping) else None
        if node is None:
            continue  # an absent skip or downsample
        if kind in ("rbs", "rb", "rbu", "attn"):
            out.update(block_state_dict(kind, node, name))
            continue
        for leaf, value in _rgbt_leaves(node, kind).items():
            out[f"{name}.{leaf}"] = np.asarray(value)
    seqs = dict(_DECONVS["mbt2018"])
    del seqs["g_s"]
    if arch != "master":
        del seqs["g_a"]
    if arch.startswith("cheng2020"):
        del seqs["h_a"], seqs["h_s"]
        out.update(_cheng_state(_CHENG_HYPER, params))
    out.update(_sequence_state(seqs, params))
    want = _count_leaves({k: v for k, v in params.items() if k not in (
        "entropy_bottleneck", "context_prediction")})
    if len(out) != want:
        raise ValueError(f"{arch}: converted {len(out)} of {want} params")
    return out


# ssf2020: the sub-codecs, and per hyperprior sequence its flax kind and
# CompressAI's name of the j-th conv
_SSF_SUB_CODECS = ("img", "res", "motion")
_SSF_HYPER = (("hyper_encoder", "Conv", lambda j: str(2 * j)),
              ("hyper_decoder_mean", "Deconv", lambda j: str(2 * j)),
              ("hyper_decoder_scale", "Deconv", lambda j: f"deconv{j + 1}"))


def _eb_state(tree: Mapping[str, Any], prefix: str
              ) -> Dict[str, np.ndarray]:
    """An entropy bottleneck's `matrix_{k}/bias_{k}/factor_{k}` and
    `quantiles` -> `{prefix}._matrix{k}`, ..."""
    out = {}
    for name, v in tree.items():
        if name != "quantiles":
            kind, k = name.rsplit("_", 1)
            name = f"_{kind}{k}"
        out[f"{prefix}.{name}"] = np.asarray(v)
    return out


def _video_state(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """ssf2020's leaves. Raises if a leaf of `params` is left over."""
    out: Dict[str, np.ndarray] = {}

    def conv(node, kind, key):
        k = np.asarray(node["Conv_0"]["kernel"])
        out[f"{key}.weight"] = (_deconv_weight(k) if kind == "Deconv"
                                else _conv_weight(k))
        out[f"{key}.bias"] = np.asarray(node["Conv_0"]["bias"])

    for which in _SSF_SUB_CODECS:
        for seq, kind in (("encoder", "Conv"), ("decoder", "Deconv")):
            for j in range(4):
                conv(params[f"{which}_{seq}"][f"{kind}_{j}"], kind,
                     f"{which}_{seq}.{2 * j}")
        hp = params[f"{which}_hyperprior"]
        for seq, kind, name in _SSF_HYPER:
            for j in range(3):
                conv(hp[seq][f"{kind}_{j}"], kind,
                     f"{which}_hyperprior.{seq}.{name(j)}")
        out.update(_eb_state(hp["entropy_bottleneck"],
                             f"{which}_hyperprior.entropy_bottleneck"))
    if len(out) != _count_leaves(params):
        raise ValueError(f"ssf2020: converted {len(out)} of "
                         f"{_count_leaves(params)} params")
    return out


def state_dict_from_jax(arch: str, params: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """lmic_tpu `variables["params"]` (numpy leaves) -> this package's
    `state_dict` for `arch`, in the leaves' dtype. The map is linear, so it
    carries a gradient tree of the same structure across too."""
    if arch == "ssf2020":
        return {k: torch.from_numpy(np.array(v))
                for k, v in _video_state(params).items()}
    if arch in ("guided", "master") + _PAIRED_R + _PAIRED_D:
        out = _rgbt_state(arch, params)
    elif arch in _CHENG:
        out = _cheng_state({**{seq: dict(enumerate(kinds))
                               for seq, kinds in _CHENG[arch].items()},
                            **_CHENG_HYPER}, params)
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
    out.update(_eb_state(params["entropy_bottleneck"], "entropy_bottleneck"))
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
    codec.eb_state = eb_state_from_numpy(eb)
    if gc is not None:
        codec.gc_state = gc_state_from_numpy(gc)
    return codec


def eb_state_from_numpy(eb: Mapping[str, np.ndarray]) -> EBState:
    return EBState(
        table=CdfTable(eb["cdf"], eb["cdf_length"], eb["offset"]),
        medians=np.array(eb["medians"], np.float32).reshape(-1),  # own copy
    )


def gc_state_from_numpy(gc: Mapping[str, np.ndarray]) -> GCState:
    return GCState(
        table=CdfTable(gc["cdf"], gc["cdf_length"], gc["offset"]),
        scale_table=np.array(gc["scale_table"], np.float32),
    )


def video_coding_state_from_numpy(codec, tables):
    """Install carried coding state on an ssf2020 codec: `tables` maps
    each sub-codec ("img", "motion", "res") to its (eb, gc) dicts, keyed
    as in `coding_state_from_numpy`."""
    codec.install_tables({
        which: (eb_state_from_numpy(eb), gc_state_from_numpy(gc))
        for which, (eb, gc) in tables.items()})
    return codec
