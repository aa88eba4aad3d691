"""Shared set-up of the lmic_tpu_torch parity tests: the same weights and
coding tables in the JAX package and in the port, made from a seed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmic_tpu import zoo as jzoo
from lmic_tpu.entropy import entropy_models as jem
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.entropy import entropy_models as tem
from lmic_tpu_torch.utils.checkpoint import _table_tensors
from lmic_tpu_torch.zoo.convert import (
    coding_state_from_numpy,
    state_dict_from_jax,
)

ARCHS = ("bmshj2018-factorized", "bmshj2018-hyperprior", "mbt2018-mean")
N, M = 16, 24
# the autoregressive family at these widths, (arch, N, M): cheng2020 has
# M = N
AR_TRAIN = (("mbt2018", N, M), ("cheng2020-anchor", N, N),
            ("cheng2020-attn", N, N))
IMAGE = (2, 64, 128, 3)  # H, W multiples of 64 (the hyperprior factor)


def pixels(shape=IMAGE, seed=0):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


def _perturb_gammas(tree, rng):
    """Push every GDN gamma in `tree` off the diagonal, also those nested
    in blocks (cheng2020), in the tree's order."""
    for node in tree.values():
        if not isinstance(node, dict):
            continue
        if "gamma" in node:
            node["gamma"] = (node["gamma"] + rng.uniform(
                0, 0.05, node["gamma"].shape)).astype(np.float32)
        else:
            _perturb_gammas(node, rng)


def jax_params(arch, seed=0, n=N, m=M, channel=3, input_size=IMAGE[1:3],
               jit=False):
    """lmic_tpu init for `arch` at n/m, as numpy, with GDN gammas pushed
    off the diagonal (so the channel mixing is exercised) and the
    bottleneck medians moved off zero (so they matter in the symbols).
    `channel` is the image's channel count (the master's modality for
    the RGB-T master, whose init also traces its guide at `input_size`).
    With `jit` (an image arch) lmic_tpu's `create_model` init runs traced
    once: the same params, which a wide model inits op by op slowly."""
    if jit:
        key = jax.random.key(seed)
        module = jzoo.make_module(arch, 1, N=n, M=m, channel=channel)
        variables = jax.jit(module.init)(
            {"params": key, "noise": jax.random.fold_in(key, 1)},
            jnp.zeros((1, *input_size, channel), jnp.float32))
    else:
        variables = jzoo.create_model(arch, 1, key=jax.random.key(seed),
                                      input_size=input_size, N=n, M=m,
                                      channel=channel).variables
    params = jax.tree.map(np.asarray, variables["params"])
    rng = np.random.default_rng(seed)
    for seq in ("g_a_net", "g_s_net"):
        _perturb_gammas(params[seq], rng)
    q = params["entropy_bottleneck"]["quantiles"].copy()
    q[:, :, 1] += rng.uniform(-0.3, 0.3, q.shape[0])[:, None]
    params["entropy_bottleneck"]["quantiles"] = q.astype(np.float32)
    return params


def jax_codec(arch, params, n=N, m=M, channel=3):
    codec = jzoo.create_model(arch, 1, variables={"params": params},
                              N=n, M=m, channel=channel)
    codec.update(force=True)
    return codec


def port_codec(arch, params, n=N, m=M, channel=3):
    return tzoo.create_model(arch, 1, device="cpu", N=n, M=m,
                             channel=channel,
                             state_dict=state_dict_from_jax(arch, params))


# the RGB-T pair at test widths; the master's role -> (master (H, W), guide
# (H, W)): channel 1 codes a thermal master with an RGB guide at 2x, channel
# 3 an RGB master with a thermal guide at half (its factor is 128)
RGBT_N, RGBT_M = 32, 48
RGBT_GEOMETRY = {1: ((64, 64), (128, 128)), 3: ((128, 128), (64, 64))}
# the subtrees of the pair's own modules, whose biases and LayerNorm scales
# init to constants: perturbed, so a swapped or dropped leaf shows
_RGBT_OWN = ("sp_aligner", "ch_aligner", "fencoder", "fdecoder")


def _perturb_leaves(tree, rng, own=False):
    for k, node in tree.items():
        if isinstance(node, dict):
            _perturb_leaves(node, rng, own or k.startswith(_RGBT_OWN))
        elif own and k in ("bias", "scale"):
            tree[k] = (node + rng.uniform(-0.1, 0.1, node.shape)).astype(
                np.float32)


@functools.lru_cache(maxsize=None)
def rgbt_pair(role):
    """lmic_tpu's guided and master codecs for a master of `role` channels
    at RGBT_N/RGBT_M from seeds, their params, and the port's codecs on the
    converted weights with the tables carried across:
    (guided (jc, pc, params), master (jc, pc, params)). Shared by the
    tests; do not change them."""
    out = []
    for arch, channel, size, seed in (("guided", 4 - role, (64, 64), 0),
                                      ("master", role,
                                       RGBT_GEOMETRY[role][0], 1)):
        params = jax_params(arch, seed, RGBT_N, RGBT_M, channel, size)
        _perturb_leaves(params, np.random.default_rng(seed + 10))
        jc = jax_codec(arch, params, RGBT_N, RGBT_M, channel)
        pc = carry_tables(jc, port_codec(arch, params, RGBT_N, RGBT_M,
                                         channel))
        out.append((jc, pc, params))
    return tuple(out)


# ssf2020 at its one width on a 128x128 GOP (H, W multiples of 128)
VIDEO_GOP = (1, 3, 128, 128, 3)


@functools.lru_cache(maxsize=None)
def video_codecs(seed=0):
    """lmic_tpu's ssf2020 from `seed`, with its conv biases and bottleneck
    medians moved off their constant inits (so a swapped or dropped leaf
    shows), its params, and the port's codec on the converted weights
    with the three sub-codecs' tables carried across: (jc, pc, params).
    Shared by the tests; do not change them."""
    from lmic_tpu.models.video import ScaleSpaceFlowCodec

    codec = jzoo.create_video_model("ssf2020", 1, key=jax.random.key(seed),
                                    input_size=VIDEO_GOP[2:4])
    params = jax.tree.map(np.asarray, codec.variables["params"])
    rng = np.random.default_rng(seed + 20)
    _perturb_video(params, rng)
    jc = ScaleSpaceFlowCodec(codec.module, {"params": params})
    jc.update(force=True)
    pc = carry_video_tables(jc, tzoo.create_video_model(
        device="cpu", state_dict=state_dict_from_jax("ssf2020", params)))
    return jc, pc, params


@functools.lru_cache(maxsize=None)
def default_codecs(arch, quality, channel=3, input_size=(64, 64)):
    """lmic_tpu's codec on its default key (what its eval CLI builds) with
    fresh tables, and the port's codec on the converted weights with those
    tables carried across. Cached per process: do not mutate. The params
    do not depend on `input_size`, the shape flax traces the init at
    (equal at 64x64 and the CLI's 256x256; the `_D` archs need 128)."""
    jc = jzoo.create_model(arch, quality, channel=channel,
                           input_size=input_size)
    jc.update(force=True)
    params = jax.tree.map(np.asarray, jc.variables["params"])
    pc = tzoo.create_model(arch, quality, channel=channel, device="cpu",
                           state_dict=state_dict_from_jax(arch, params))
    return jc, carry_tables(jc, pc)


@pytest.fixture
def one_thread():
    """Run a test on one CPU thread: the CPU's convolutions split their
    sums by the thread count, so a result pinned at rtol 1e-4 reproduces
    only at a fixed count. cheng2020-attn q1's default-key weights reach
    |x_hat| ~ 16,500 before the clip, and its ms-ssim (0.0153) moves by
    1.1e-4 between 1 and 2 threads (ROADMAP.md, queue C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# how far lmic_tpu's f32 MS-SSIM lands from the f64 definition, at most
# (tests/test_torch_eval.py::test_metrics_match_the_definition_and_lmic_tpu;
# the port's is within 1e-14 of it)
MS_SSIM_F32 = 3.0e-6


def match_eval(got, want, exact_bpp, timings=False):
    """An eval function's dict against lmic_tpu's: the keys; the real
    coder's bpp exactly (byte-identical strings), else within 1e-5
    relative; psnr within 1e-5 relative; ms-ssim within 1e-5 relative plus
    lmic_tpu's own f32 error (MS_SSIM_F32; small ms-ssim values of random
    weights make a relative bar alone tighter than lmic_tpu's metric)."""
    keys = {"psnr", "ms-ssim", "bpp"} | (
        {"encoding_time", "decoding_time"} if timings else set())
    assert set(got) == set(want) == keys
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-5)
    np.testing.assert_allclose(got["ms-ssim"], want["ms-ssim"], rtol=1e-5,
                               atol=MS_SSIM_F32)
    if exact_bpp:
        assert got["bpp"] == want["bpp"]
    else:
        np.testing.assert_allclose(got["bpp"], want["bpp"], rtol=1e-5)


def deployment_checkpoint(path, codec):
    """`update_model_file`'s layout without its `update()`: the codec's
    params and the tables it holds (here lmic_tpu's)."""
    blob = {"params": dict(codec.module.state_dict())}
    if codec.eb_state is not None:
        blob["eb_state"] = _table_tensors(codec.eb_state, "medians")
    if codec.gc_state is not None:
        blob["gc_state"] = _table_tensors(codec.gc_state, "scale_table")
    torch.save(blob, path)
    return str(path)


def carry_video_tables(jc, pc):
    """Install lmic_tpu's ssf2020 codec's three sub-codecs' tables on the
    port's."""
    from lmic_tpu_torch.zoo.convert import video_coding_state_from_numpy

    def table(t):
        return {"cdf": t.cdf, "cdf_length": t.cdf_length, "offset": t.offset}

    return video_coding_state_from_numpy(pc, {
        w: (dict(table(hp.eb_state.table), medians=hp.eb_state.medians),
            dict(table(hp.gc_state.table),
                 scale_table=hp.gc_state.scale_table))
        for w, hp in jc.hp_states.items()})


def _perturb_video(tree, rng):
    for k, node in tree.items():
        if isinstance(node, dict):
            _perturb_video(node, rng)
        elif k == "bias" and node.ndim == 1:
            tree[k] = (node + rng.uniform(-0.05, 0.05, node.shape)).astype(
                np.float32)
        elif k == "quantiles":
            q = node.copy()
            q[:, :, 1] += rng.uniform(-0.3, 0.3, q.shape[0])[:, None]
            tree[k] = q.astype(np.float32)


def write_images(d, n, size, seed=0, channels=3):
    """`n` seeded PNGs of `size` (H, W) in `d`: RGB, or 8-bit grayscale
    for channels=1."""
    from PIL import Image

    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        arr = (rng.random((*size, channels)) * 255).astype(np.uint8)
        Image.fromarray(arr[..., 0] if channels == 1 else arr).save(
            d / f"img_{i:03d}.png")


def noise(nchw_shape):
    """U(-0.5, 0.5) noise for a port-layout shape, from the shape alone."""
    rng = np.random.default_rng([11, *nchw_shape])
    return rng.uniform(-0.5, 0.5, nchw_shape)


def _jax_layout_noise(shape):
    """`noise` for a shape of lmic_tpu's: NHWC transposed from the port's
    NCHW; the entropy bottleneck's (C, 1, B*H*W) the same in both."""
    if len(shape) == 4:
        n = noise((shape[0], shape[3], shape[1], shape[2]))
        return n.transpose(0, 2, 3, 1)
    return noise(shape)


def patch_same_noise(monkeypatch):
    """Within a test, both packages add the same numpy noise of a given
    shape wherever training quantizes: `quantize_noise` in both entropy
    modules, and lmic_tpu's inline `jax.random.uniform(key, shape, dtype,
    -0.5, 0.5)` draw of the AR context's input (models/joint.py,
    models/rgbt.py), which the port draws through `quantize_noise`.
    Keyed by shape, so the context's noise equals the Gaussian
    conditional's (y's shape) in both packages: the same draw on both
    sides, which is what parity needs."""
    uniform = jax.random.uniform

    def jax_uniform(key, shape=(), dtype=float, minval=0.0, maxval=1.0):
        if len(shape) == 4 and (minval, maxval) == (-0.5, 0.5):
            return jnp.asarray(_jax_layout_noise(tuple(shape)), dtype)
        return uniform(key, shape, dtype, minval, maxval)

    monkeypatch.setattr(jax.random, "uniform", jax_uniform)
    monkeypatch.setattr(jem, "quantize_noise", lambda x, key: x + jnp.asarray(
        _jax_layout_noise(tuple(x.shape)), x.dtype))
    monkeypatch.setattr(tem, "quantize_noise", lambda x, generator=None: (
        x + torch.from_numpy(noise(tuple(x.shape))).to(x.dtype)))


def carry_tables(jc, pc):
    """Install the JAX codec's coding tables on the port codec."""
    def table(t):
        return {"cdf": t.cdf, "cdf_length": t.cdf_length, "offset": t.offset}

    gc = None
    if jc.gc_state is not None:
        gc = dict(table(jc.gc_state.table),
                  scale_table=jc.gc_state.scale_table)
    return coding_state_from_numpy(
        pc, eb=dict(table(jc.eb_state.table), medians=jc.eb_state.medians),
        gc=gc,
    )


def table_drift(got, want):
    """How far two CdfTables of one geometry are apart: (rows that differ,
    share of entries that differ, largest entry difference)."""
    diff = np.abs(got.cdf.astype(np.int64) - want.cdf)
    return (int((diff != 0).any(1).sum()), float((diff != 0).mean()),
            int(diff.max()))


# -- bf16 matmul precision: lmic_tpu's graph with its rounding made explicit

# the ops `jax.default_matmul_precision("bfloat16")` rounds when their
# precision is None (XLA on the CPU ignores the setting)
_ROUNDED_OPS = ("dot_general", "conv_general_dilated")
# call-like higher-order primitives: (the param holding the body, whether
# its first operands are the body's consts); evaluated through
_CALLS = {"jit": "jaxpr", "pjit": "jaxpr", "closed_call": "call_jaxpr",
          "core_call": "call_jaxpr", "custom_jvp_call": "call_jaxpr",
          "custom_vjp_call": "call_jaxpr",
          "custom_vjp_call_jaxpr": "fun_jaxpr", "checkpoint": "jaxpr",
          "remat": "jaxpr", "remat2": "jaxpr"}


def _jaxprs_in(params):
    from jax.extend.core import ClosedJaxpr, Jaxpr

    for v in params.values():
        for item in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(item, ClosedJaxpr):
                yield item.jaxpr
            elif isinstance(item, Jaxpr):
                yield item


def _rounds(jaxpr) -> bool:
    """Whether `jaxpr` holds a default-precision product, at any depth."""
    return any(
        (e.primitive.name in _ROUNDED_OPS and e.params["precision"] is None)
        or any(_rounds(j) for j in _jaxprs_in(e.params))
        for e in jaxpr.eqns)


def _round_bf16_jax(x):
    if x.dtype != jnp.float32:
        return x
    # not astype(bf16).astype(f32): XLA may drop that pair of converts
    return jax.lax.reduce_precision(x, exponent_bits=8, mantissa_bits=7)


def _eval_rounded(jaxpr, consts, args, rounded):
    from jax.extend.core import ClosedJaxpr, Literal

    env = {}

    def read(v):
        return v.val if isinstance(v, Literal) else env[v]

    env.update(zip(jaxpr.constvars, consts))
    env.update(zip(jaxpr.invars, args))
    for e in jaxpr.eqns:
        vals = [read(v) for v in e.invars]
        name = e.primitive.name
        if name in _ROUNDED_OPS and e.params["precision"] is None:
            rounded.append((name, int(np.prod(e.outvars[0].aval.shape))))
            outs = e.primitive.bind(*map(_round_bf16_jax, vals), **e.params)
        elif name in _CALLS:
            body = e.params[_CALLS[name]]
            if isinstance(body, ClosedJaxpr):
                outs = _eval_rounded(body.jaxpr, body.consts, vals, rounded)
            else:
                outs = _eval_rounded(body, (), vals, rounded)
        else:
            if any(_rounds(j) for j in _jaxprs_in(e.params)):
                raise NotImplementedError(
                    f"{name} holds a default-precision product: the bf16 "
                    "reference does not evaluate through it")
            outs = e.primitive.bind(*vals, **e.params)
        if not e.primitive.multiple_results and name not in _CALLS:
            outs = [outs]
        for v, o in zip(e.outvars, outs):
            env[v] = o
    return [read(v) for v in jaxpr.outvars]


def bf16_reference(fn, *args):
    """`fn(*args)` as lmic_tpu computes it on a TPU under
    `jax.default_matmul_precision("bfloat16")`, on the CPU: the jaxpr of
    `fn` evaluated (under one `jax.jit`) with the f32 operands of every
    `dot_general`/`conv_general_dilated` whose precision is None rounded
    to bf16 (round to nearest even); HIGHEST ops stay f32. It goes into
    jit, custom_jvp/custom_vjp calls and checkpoints, and raises on any
    other higher-order primitive holding such an op. Returns (fn's
    output, (name, output elements) of each op it rounded)."""
    closed = jax.make_jaxpr(fn)(*args)
    flat = jax.tree.leaves(args)
    rounded = []

    def run(*flat_args):
        rounded.clear()
        return _eval_rounded(closed.jaxpr, closed.consts, flat_args, rounded)

    outs = jax.jit(run)(*flat)
    out_tree = jax.tree.structure(jax.eval_shape(fn, *args))
    return jax.tree.unflatten(out_tree, outs), list(rounded)


def nchw(a):
    """NHWC numpy -> NCHW channels_last torch tensor."""
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


if __name__ == "__main__":
    # the port's own update() tables against lmic_tpu's, per arch:
    #   JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/torch_port_helpers.py
    for arch in ARCHS:
        params = jax_params(arch)
        jc, pc = jax_codec(arch, params), port_codec(arch, params)
        pc.update()
        for name in ("eb_state", "gc_state"):
            want = getattr(jc, name)
            if want is not None:
                rows, share, worst = table_drift(getattr(pc, name).table,
                                                 want.table)
                print(f"{arch} {name}: {rows} of {len(want.table.cdf)} rows, "
                      f"{share:.4%} of entries, max |diff| {worst}")
