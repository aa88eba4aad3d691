"""Serving bundles: the codecs' uint8 fast-path graphs, `torch.export`ed.

Counterpart of lmic_tpu/utils/aot.py: `export_serving_bundle` freezes an
updated codec's uint8 fast-path device functions (models/codec.py
`_build_u8_fns`, models/video.py's GOP modules) into `torch.export`
programs plus the baked integer coding tables, and `load_serving_bundle`
reconstitutes a working codec from the bundle without the model zoo, the
model classes' weights file or any training code. The loaded codec serves
`compress`/`compress_async`/`decompress`/`decompress_async` on the uint8
path with the live codec's bytes and pixels (tests/test_torch_aot.py), so
a serving fleet ships one directory per (arch, quality, shape).

Supported: the factorized and hyperprior families (the non-AR image
codecs) and ssf2020 (a 5-dim `input_shape` (1, T, H, W, C) exports the
whole GOP chain of its three sub-codecs, fixed to that GOP length; one
sequence a call, as the live codec runs one chain a sequence). The AR
codecs, the RGB-T pair and the `_R`/`_D` archs are refused, as in
lmic_tpu: their decode loop reads host symbols at every wavefront.

A graph records the device branches taken while it was traced (the GDN
operator's kernel or plain version, `layers.Conv`'s GEMM route on the
card), so a bundle is exported under `torch.no_grad()` on the device that
will serve it, and the loader refuses any other device rather than serve
another op sequence. The GDN forward stays one node of each graph, the
operator `lmic_tpu_torch::gdn_fwd` (ops/gdn.py), which the loader
registers by importing that module before it loads a graph.

lmic_tpu's bundles (`fns/*.bin`, StableHLO) and this package's are not
interchangeable: each loader refuses the other's.

Bundle layout:
    meta.json   format version, family, (B, H, W, C), N/M widths, the
                downsampling factor, fn list, the mesh size of a sharded
                codec (`nr_devices`, 1 otherwise), the device type the
                graphs were exported on, torch version
    state.npz   EB/GC integer CDF tables, medians, scale tables
    fns/*.pt2   one `torch.export.save`d program per device graph (B = 1
                per-image graphs get a `__one` suffix, dtype variants
                `__i8`/`__i16`)
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from lmic_tpu_torch.ops import precision

# Per-family format version of this package's bundles (torch.export
# programs; lmic_tpu's, StableHLO, are format 2 and refused by name).
FAMILY_FORMAT = {"factorized": 1, "hyperprior": 1, "video": 1}

__all__ = ["export_serving_bundle", "load_serving_bundle"]


def _family(codec) -> str:
    from lmic_tpu_torch.models.codec import (
        FactorizedPriorCodec,
        HyperpriorCodec,
    )
    from lmic_tpu_torch.models.joint import JointARCodec
    from lmic_tpu_torch.models.video import ScaleSpaceFlowCodec

    if isinstance(codec, FactorizedPriorCodec):
        return "factorized"
    if isinstance(codec, HyperpriorCodec) and not isinstance(
            codec, JointARCodec):
        return "hyperprior"
    if isinstance(codec, ScaleSpaceFlowCodec):
        return "video"
    raise ValueError(
        f"{type(codec).__name__} is not AOT-exportable: only the "
        "factorized/hyperprior family and ssf2020 have callback-free "
        "codec graphs (the AR decode wavefront streams host symbols step "
        "by step, lmic_tpu's io_callback)"
    )


def _plan(codec, family, input_shape):
    """{name: (module, example args)} of the image families' graphs, the
    examples chained through the live functions, so each graph is traced
    on the shapes, dtypes and memory layouts it is served with. The
    per-image graphs (`_PerItem`s in the live codec) export their shared
    B = 1 inner module as `__one` (the loader re-wraps it); the batched
    layout and synthesis graphs export at the bundle's B; on a sharded
    codec (`parallel.shard_codec`) the batch-safe ones export the graph
    of one row block, at B over the mesh size."""
    from lmic_tpu_torch.models.codec import _PerItem, _Sharded

    def block(fn, *args):
        n = len(fn.devices) if isinstance(fn, _Sharded) else 1
        return (fn.inner if n > 1 else fn,
                tuple(a[:a.shape[0] // n] for a in args))

    B, H, W, C = input_shape
    x = torch.zeros((B, H, W, C), dtype=torch.uint8, device=codec.device)
    x1 = x[:1]
    if family == "factorized":
        enc = codec._enc_u8_packed
        sym8, ovf = _PerItem(enc.inner)(x)
        return {
            "_enc_u8_packed__one": (enc.inner, (x1,)),
            "_enc_u8_packed__post": (enc.post, (sym8, ovf)),
            "_enc_u8__one": (codec._enc_u8.inner, (x1,)),
            "_dec_u8__i8": block(codec._dec_u8, sym8),
            "_dec_u8__i16": block(codec._dec_u8, sym8.to(torch.int16)),
        }
    y, z8, zovf = codec._analyze_u8(x)
    idx, means = codec._params_from_zsym(z8)
    y8, y16, yovf = codec._ysym(y, means)
    m = () if means is None else (means,)
    return {
        "_analyze_u8__one": (codec._analyze_u8.inner, (x1,)),
        "_params_from_zsym__one": (codec._params_from_zsym.inner,
                                   (z8[:1],)),
        "_ysym": block(codec._ysym, y, *m),
        "_pack_enc": (codec._pack_enc, (z8, idx, y8, zovf, yovf)),
        "_synth_u8__i8": block(codec._synth_u8, y8, *m),
        "_synth_u8__i16": block(codec._synth_u8, y16, *m),
    }


def _video_plan(codec, input_shape):
    """ssf2020's graphs for one T-frame sequence: the pixel ingest, the
    whole-GOP encode to its packed buffer, the decoder's parameters (int8
    z symbols, as lmic_tpu's), its frame chain (int8 and int16 y symbols)
    and the pixel egress, chained through the live functions."""
    from lmic_tpu_torch.models.video import PLANES

    _, T, H, W, C = input_shape
    x = codec._ingest_u8(torch.zeros(input_shape, dtype=torch.uint8,
                                     device=codec.device))
    K, f = 2 * T - 1, codec._FACTOR
    z8 = torch.zeros((K, PLANES, H // f, W // f), dtype=torch.int8,
                     device=codec.device)
    y8 = torch.zeros((K, PLANES, H // 16, W // 16), dtype=torch.int8,
                     device=codec.device)
    _, means = codec._gop_params(z8)
    frames = codec._gop_frames(y8, means)
    return {
        "_ingest_u8": (codec._ingest_u8, (torch.zeros(
            input_shape, dtype=torch.uint8, device=codec.device),)),
        "_gop_encode": (codec._gop_encode, (x,)),
        "_gop_params": (codec._gop_params, (z8,)),
        "_gop_frames__i8": (codec._gop_frames, (y8, means)),
        "_gop_frames__i16": (codec._gop_frames,
                             (y8.to(torch.int16), means)),
        "_egress_u8": (codec._egress_u8, (frames,)),
    }


def export_serving_bundle(codec, out_dir, input_shape) -> str:
    """Export `codec`'s uint8 fast-path graphs for `input_shape` — (B, H,
    W, C) for the image families, (B, T, H, W, C) for ssf2020 — into
    `out_dir`, on the codec's device. The codec must be `update()`d; the
    graphs are the live codec's own device functions, so the bundle codes
    the live codec's bytes. It refuses to run under the bf16 matmul
    precision (`ops/precision.py`): a bundle would bake that mode in
    unseen, and lmic_tpu exports none under `--half`."""
    if precision.current() is not None:
        raise RuntimeError(
            f"export_serving_bundle under matmul precision "
            f"{precision.current()!r}: a bundle would code that mode's "
            "strings silently; export outside the mode")
    codec._check_updated()
    family = _family(codec)
    if family == "video":
        if len(input_shape) != 5:
            raise ValueError("ssf2020 bundles take (B, T, H, W, C)")
        B, T, H, W, C = map(int, input_shape)
        if T < 2:
            raise ValueError("ssf2020 bundles need a GOP of >= 2 frames")
        if B != 1:
            raise ValueError(
                "ssf2020 bundles are per-sequence (B=1): the live codec "
                "runs multi-sequence batches as per-sequence GOP chains "
                "(batch grouping must not leak into the wire) — export "
                "B=1 and fan out at the caller"
            )
    else:
        if len(input_shape) != 4:
            raise ValueError("image bundles take (B, H, W, C)")
        B, H, W, C = map(int, input_shape)
    # hyperprior: 4 encoder + 2 hyper stride-2 convs -> 64; ssf2020: 4
    # encoder + 3 hyper stride-2 convs -> 128
    mult = {"hyperprior": 64, "video": 128}.get(family)
    if mult and (H % mult or W % mult):
        raise ValueError(f"{family} bundles need {mult}-multiple H, W")
    input_shape = tuple(map(int, input_shape))

    os.makedirs(os.path.join(out_dir, "fns"), exist_ok=True)
    with torch.no_grad(), warnings.catch_warnings():
        # channels_last weights do not look contiguous to the archive
        # writer, which then saves their whole storage and says so
        warnings.filterwarnings("ignore", "No complete tensor found")
        if family != "video":
            codec._ensure("_build_u8_fns")
        plan = (_video_plan(codec, input_shape) if family == "video"
                else _plan(codec, family, input_shape))
        for name, (fn, args) in plan.items():
            program = torch.export.export(fn, args)
            # the archive would keep the example tensors (at B = 16 of
            # 768x512 or a 1080p GOP, more bytes than the weights)
            program.example_inputs = None
            torch.export.save(program,
                              os.path.join(out_dir, "fns", name + ".pt2"))

    state: Dict[str, Any] = {}

    def save_tables(prefix, eb_state, gc_state):
        state[f"{prefix}eb_cdf"] = eb_state.table.cdf
        state[f"{prefix}eb_cdf_length"] = eb_state.table.cdf_length
        state[f"{prefix}eb_offset"] = eb_state.table.offset
        state[f"{prefix}eb_medians"] = np.asarray(eb_state.medians)
        if gc_state is not None:
            state[f"{prefix}gc_cdf"] = gc_state.table.cdf
            state[f"{prefix}gc_cdf_length"] = gc_state.table.cdf_length
            state[f"{prefix}gc_offset"] = gc_state.table.offset
            state[f"{prefix}gc_scale_table"] = np.asarray(
                gc_state.scale_table)

    if family == "video":
        for which, st in codec.hp_states.items():
            save_tables(f"{which}__", st.eb_state, st.gc_state)
    else:
        save_tables("", codec.eb_state, codec.gc_state)
    np.savez(os.path.join(out_dir, "state.npz"), **state)

    module = codec.module
    spec = getattr(codec, "_shard_spec", None)
    meta = {
        "format": FAMILY_FORMAT[family],
        "family": family,
        "input_shape": list(input_shape),
        "N": int(getattr(module, "N", 0)),
        "M": int(getattr(module, "M", 0)),
        "downsampling_factor": int(
            getattr(module, "downsampling_factor", 0)),
        "fns": list(plan),
        "nr_devices": 1 if spec is None else spec.size,
        "device": codec.device.type,
        "torch_version": torch.__version__,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


class _ModuleShim(nn.Module):
    """Width metadata the codec host logic reads off `self.module`."""

    def __init__(self, N, M, downsampling_factor):
        super().__init__()
        self.N = N
        self.M = M
        if downsampling_factor:
            self.downsampling_factor = downsampling_factor


def _frozen(*_a, **_k):
    raise RuntimeError(
        "AOT serving bundle: graphs are frozen at export; rebuild the "
        "bundle from the live codec instead"
    )


class _Graph:
    """A loaded graph called as the live function is: None arguments (the
    scale-only hyperprior's means) are dropped, as they were at export;
    with `by_dtype`, the first argument's integer dtype picks the variant
    (`__i8`/`__i16`), and a dtype with none (an escape past int16, or z
    past int8) needs the live codec."""

    def __init__(self, fns, by_dtype=None):
        self.fns = fns if by_dtype else {None: fns}
        self.by_dtype = by_dtype

    def __call__(self, *args):
        key = args[0].dtype if self.by_dtype else None
        fn = self.fns.get(key)
        if fn is None:
            _frozen()
        return fn(*(a for a in args if a is not None))


def _restrict_to_u8(codec, meta):
    """Frozen-bundle API guards, shared by all families: uint8 fast path
    only, input fixed to the exported shape. Installed over compress,
    decompress, AND their async variants — the async entry points reuse
    the same exported graphs and would otherwise bypass the checks and
    die deep inside an exported program with an opaque error."""
    fixed = tuple(meta["input_shape"])

    def check_x(x):
        x = np.asarray(x)
        if x.dtype != np.uint8:
            raise RuntimeError(
                "AOT serving bundle codes the uint8 fast path only"
            )
        if tuple(x.shape) != fixed:
            raise ValueError(
                f"bundle is fixed to input shape {meta['input_shape']}; "
                f"got {list(x.shape)}"
            )
        return x

    inner_c, inner_ca = codec.compress, codec.compress_async
    codec.compress = lambda x: inner_c(check_x(x))
    codec.compress_async = lambda x: inner_ca(check_x(x))

    inner_d = codec.decompress
    # the decode-side analogue of check_x: the exported graphs are fixed
    # to the latent geometry of `input_shape`
    if meta["family"] == "factorized":
        dec_shape = (-(-fixed[1] // 16), -(-fixed[2] // 16))
    elif meta["family"] == "hyperprior":
        dec_shape = (-(-fixed[1] // 64), -(-fixed[2] // 64))
    else:
        dec_shape = None

    def check_strings(strings, shape):
        if dec_shape is None:  # video: per-frame strings/shape structure
            T, B = fixed[1], fixed[0]
            if len(strings) != T:
                raise ValueError(
                    f"bundle is fixed to {T}-frame GOPs; got "
                    f"{len(strings)} frame bodies"
                )

            def batch_of(s):
                while isinstance(s, dict):
                    s = next(iter(s.values()))
                return len(s[0])

            batches = [batch_of(s) for s in strings]
            if any(b != B for b in batches):
                raise ValueError(
                    f"bundle is fixed to batch size {B}; got per-frame "
                    f"batches {batches}"
                )
            return
        if tuple(map(int, shape)) != dec_shape:
            raise ValueError(
                f"bundle is fixed to input shape {meta['input_shape']} "
                f"(latent shape {list(dec_shape)}); got shape {list(shape)}"
            )
        if any(len(part) != fixed[0] for part in strings):
            raise ValueError(
                f"bundle is fixed to batch size {fixed[0]}; got "
                f"{[len(p) for p in strings]} streams"
            )

    def decompress(strings, shape, u8=False):
        # the escape inside the uint8 decode (z past int8) calls THIS
        # method with u8 unset expecting the float path: it raises here
        if not u8:
            raise RuntimeError(
                "AOT serving bundle decodes the uint8 fast path only "
                "(pass u8=True; escape fallbacks need the live codec)"
            )
        check_strings(strings, shape)
        return inner_d(strings, shape, u8=True)

    codec.decompress = decompress
    inner_da = codec.decompress_async
    if dec_shape is not None:
        def image_decompress_async(strings, shape):
            check_strings(strings, shape)
            return inner_da(strings, shape)

        codec.decompress_async = image_decompress_async
    else:
        def decompress_async(strings, shapes, u8=True):
            if not u8:
                raise RuntimeError(
                    "AOT serving bundle decodes the uint8 fast path only"
                )
            check_strings(strings, shapes)
            return inner_da(strings, shapes, u8=True)

        codec.decompress_async = decompress_async


def _tables(state, prefix):
    from lmic_tpu_torch.entropy.coder import CdfTable
    from lmic_tpu_torch.entropy.entropy_models import EBState, GCState

    eb = EBState(
        table=CdfTable(state[prefix + "eb_cdf"],
                       state[prefix + "eb_cdf_length"],
                       state[prefix + "eb_offset"]),
        medians=state[prefix + "eb_medians"],
    )
    gc = None
    if prefix + "gc_cdf" in state:
        gc = GCState(
            table=CdfTable(state[prefix + "gc_cdf"],
                           state[prefix + "gc_cdf_length"],
                           state[prefix + "gc_offset"]),
            scale_table=state[prefix + "gc_scale_table"],
        )
    return eb, gc


def _load_video_bundle(codec, fns, state):
    """ssf2020: three sub-codec states holding the saved tables (their
    device halves frozen), every device graph a loaded program; the host
    GOP orchestration (models/video.py) runs unchanged on top."""
    from lmic_tpu_torch.models.video import _HyperpriorState

    codec.hp_states = {}
    for which in codec.SUB_CODECS:
        st = object.__new__(_HyperpriorState)
        st.which = which
        st.eb_state, st.gc_state = _tables(state, f"{which}__")
        # the per-frame chain (the escape paths) needs the live codec
        st.compress = st.decompress = st.device_part = _frozen
        st.params_from_zsym = _frozen
        codec.hp_states[which] = st
    codec._ingest_u8 = _Graph(fns["_ingest_u8"])
    codec._gop_encode = _Graph(fns["_gop_encode"])
    codec._gop_params = _Graph({torch.int8: fns["_gop_params"]}, True)
    codec._gop_frames = _Graph({torch.int8: fns["_gop_frames__i8"],
                                torch.int16: fns["_gop_frames__i16"]}, True)
    codec._egress_u8 = _Graph(fns["_egress_u8"])
    codec.install_tables = _frozen


def _modules_on(program, devices):
    """The program's module on each of `devices`, one module a distinct
    device: the program as loaded where it was saved (and on devices of
    no tensor), moved for any other (`torch.export` programs keep their
    constants on the device they were exported on)."""
    from torch.export.passes import move_to_device_pass

    here = next((t.device for t in (*program.state_dict.values(),
                                    *program.constants.values())
                 if isinstance(t, torch.Tensor)), None)
    mods = {}
    for d in devices:
        if d not in mods:
            mods[d] = (program if here is None or here == d
                       else move_to_device_pass(program, d)).module()
    return [mods[d] for d in devices]


def load_serving_bundle(path, device=None, mesh=None):
    """Reconstitute a serving codec from an exported bundle: a
    `FactorizedPriorCodec`/`HyperpriorCodec`/`ScaleSpaceFlowCodec` whose
    device functions are the loaded programs — uint8 fast path only,
    fixed to the bundle's input shape, on `device` (CUDA by default),
    which must be the device type the bundle was exported on.

    A bundle exported from a `shard_codec`-sharded codec records the mesh
    size (`nr_devices`) and serves over a `mesh` of that size (default:
    `parallel.make_mesh(nr_devices)`), as the live sharded codec does; a
    mesh of another size, or a mesh for an unsharded bundle, is refused."""
    from lmic_tpu_torch import default_device
    from lmic_tpu_torch.models.codec import (
        CompressionCodec,
        FactorizedPriorCodec,
        HyperpriorCodec,
        _PerItem,
        _Sharded,
    )
    from lmic_tpu_torch.models.video import ScaleSpaceFlowCodec
    # registers the operator lmic_tpu_torch::gdn_fwd that the graphs call
    from lmic_tpu_torch.ops import gdn  # noqa: F401
    from lmic_tpu_torch.utils.determinism import set_wire_determinism

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    fns_dir = os.path.join(path, "fns")
    if "jax_version" in meta or (os.path.isdir(fns_dir) and any(
            n.endswith(".bin") for n in os.listdir(fns_dir))):
        raise ValueError(
            "unsupported bundle: an lmic_tpu bundle (jax.export StableHLO, "
            "fns/*.bin); lmic_tpu_torch loads only its own torch.export "
            "bundles (fns/*.pt2) — export one from the port's codec"
        )
    expected = FAMILY_FORMAT.get(meta.get("family"))
    if expected is None or meta.get("format") != expected:
        raise ValueError(
            f"unsupported bundle: family {meta.get('family')!r} format "
            f"{meta.get('format')!r} (supported: {FAMILY_FORMAT})"
        )
    if meta["family"] == "video" and int(meta["input_shape"][0]) != 1:
        raise ValueError(
            "unsupported bundle: multi-sequence (B>1) video bundles are "
            "not interchangeable with per-sequence codecs; re-export with "
            "B=1 and fan out at the caller"
        )
    nr_devices = int(meta.get("nr_devices", 1))
    if nr_devices == 1:
        if mesh is not None:
            raise ValueError(
                "bundle was exported from an unsharded codec; it runs on "
                "one device (shard the live codec before export for a "
                "bundle that serves over a mesh)")
    else:
        if mesh is None:
            from lmic_tpu_torch.parallel import make_mesh

            mesh = make_mesh(nr_devices, device=device)
        if mesh.size != nr_devices:
            raise ValueError(
                f"bundle was exported for {nr_devices} devices; got a "
                f"{mesh.size}-device mesh")
        if device is None:
            device = mesh.devices[0]
        elif torch.device(device).type != mesh.devices[0].type:
            raise ValueError(f"a {mesh.devices[0].type} mesh for a bundle "
                             f"loaded on {torch.device(device).type}")
    device = default_device(device)
    if device.type != meta.get("device"):
        raise ValueError(
            f"bundle was exported on {meta.get('device')!r} and is loaded "
            f"on {device.type!r}: its graphs hold the op sequence of the "
            "device they were traced on (the GDN kernel or its plain "
            "version, the conv routes); load it there or re-export it on "
            "this device"
        )
    set_wire_determinism()
    # each graph's module on each mesh device (one device unsharded)
    fns = {}
    for name in meta["fns"]:
        program = torch.export.load(os.path.join(fns_dir, name + ".pt2"))
        fns[name] = (_modules_on(program, mesh.devices) if mesh is not None
                     else [program.module()])
    state = dict(np.load(os.path.join(path, "state.npz")))

    family = meta["family"]
    cls = {"factorized": FactorizedPriorCodec, "hyperprior": HyperpriorCodec,
           "video": ScaleSpaceFlowCodec}[family]
    codec = object.__new__(cls)
    CompressionCodec.__init__(
        codec,
        _ModuleShim(meta["N"], meta["M"], meta["downsampling_factor"]),
        device,
    )

    def per_item(name, post=None):
        # the B = 1 graphs: round-robin over a mesh, as the live codec's
        fn = _PerItem(fns[name][0], post=post)
        if mesh is not None:
            fn.place(mesh.devices, fns[name])
        return fn

    def batched(graph):
        # graph(k): the graph on device k; over a mesh, one row block each
        if mesh is None:
            return graph(0)
        return _Sharded(mesh.devices, [graph(k) for k in range(mesh.size)])

    def by_dtype(prefix):
        return lambda k: _Graph({torch.int8: fns[prefix + "__i8"][k],
                                 torch.int16: fns[prefix + "__i16"][k]},
                                True)

    if family == "video":
        _load_video_bundle(codec, {k: v[0] for k, v in fns.items()}, state)
        codec.fanout = _frozen
    else:
        codec.eb_state, codec.gc_state = _tables(state, "")
        if family == "factorized":
            codec._enc_u8_packed = per_item(
                "_enc_u8_packed__one", post=fns["_enc_u8_packed__post"][0])
            codec._enc_u8 = per_item("_enc_u8__one")
            codec._dec_u8 = batched(by_dtype("_dec_u8"))
        else:
            codec._analyze_u8 = per_item("_analyze_u8__one")
            codec._params_from_zsym = per_item("_params_from_zsym__one")
            codec._ysym = batched(lambda k: _Graph(fns["_ysym"][k]))
            codec._pack_enc = _Graph(fns["_pack_enc"][0])
            codec._synth_u8 = batched(by_dtype("_synth_u8"))
        # everything that would rebuild a graph is frozen, and the plain
        # path (a symbol past the exported dtypes) needs the live codec
        codec._build_u8_fns = _frozen
        codec._plain_symbols = _frozen
        codec._built_for = {"_build_u8_fns": (codec.eb_state,
                                              codec.gc_state)}
    codec.update = _frozen
    _restrict_to_u8(codec, meta)
    codec.bundle_meta = meta
    return codec
