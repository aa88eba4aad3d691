"""The port's pipelined codec API (`compress_async` / `decompress_async`)
against lmic_tpu on the CPU, on weights converted with
`state_dict_from_jax` and coding tables carried across: pipelined two
deep (batch i+1's compress dispatched before batch i's finalize, as
bench.py's `bench_pipelined` runs it), the strings are lmic_tpu's byte for
byte and the pixels the port's synchronous decode's, with the decode's host
half inline and on the worker thread (LMIC_DECODE_THREAD=1), for the three
non-AR archs, mbt2018 and ssf2020. A symbol outside int8 takes the escape
and gives the bytes of the plain path."""

import numpy as np
import pytest
import torch

from lmic_tpu_torch.ops import gdn
from torch_port_helpers import (
    ARCHS,
    IMAGE,
    carry_tables,
    jax_codec,
    jax_params,
    pixels,
    port_codec,
    video_codecs,
)

torch.set_num_threads(2)

AR_WIDTH = 16


def _pipelined(pc, batches, decompress=True):
    """bench_pipelined's loop: compress_async of batch i+1, then the
    finalize of batch i, then decompress_async of batch i. Returns the
    compress outputs and the decoded pixels of every batch."""
    outs, recs = [], []
    pending = pc.compress_async(batches[0])
    prev_dec = None
    for i in range(len(batches)):
        nxt = pc.compress_async(batches[i + 1]) if i + 1 < len(batches) \
            else None
        out = pending()
        outs.append(out)
        if decompress:
            dec = pc.decompress_async(out["strings"], out["shape"])
            if prev_dec is not None:
                recs.append(prev_dec()["x_hat"])
            prev_dec = dec
        pending = nxt
    if decompress:
        recs.append(prev_dec()["x_hat"])
    return outs, recs


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    params = jax_params(arch)
    jc = jax_codec(arch, params)
    return arch, jc, carry_tables(jc, port_codec(arch, params))


@pytest.mark.parametrize("threaded", ["0", "1"])
def test_pipelined_pair_matches_lmic_tpu(pair, threaded, monkeypatch):
    _, jc, pc = pair
    monkeypatch.setenv("LMIC_DECODE_THREAD", threaded)
    batches = [pixels(IMAGE, seed=20 + i) for i in range(3)]
    before = dict(gdn.LAUNCHES)
    outs, recs = _pipelined(pc, batches)
    assert gdn.LAUNCHES == before  # the CPU runs the plain versions
    for x, out, rec in zip(batches, outs, recs):
        want = jc.compress(x)
        assert out["strings"] == want["strings"]
        assert tuple(out["shape"]) == tuple(want["shape"])
        sync = pc.decompress(out["strings"], out["shape"], u8=True)["x_hat"]
        assert rec.dtype == np.uint8 and rec.shape == x.shape
        np.testing.assert_array_equal(rec, sync)
    # the synchronous uint8 call runs the same functions
    assert pc.compress(batches[0])["strings"] == outs[0]["strings"]


def test_async_takes_uint8_only(pair):
    _, _, pc = pair
    x = pixels(IMAGE).astype(np.float32) / 255.0
    with pytest.raises(ValueError, match="uint8 fast path only"):
        pc.compress_async(x)
    with pytest.raises(ValueError, match="string group"):
        pc.decompress_async([[b""]] * 3, (4, 8))


def _shift(params, path, sl, by):
    node = params
    for k in path[:-1]:
        node = node[k]
    a = node[path[-1]].copy()
    a[sl] += by
    node[path[-1]] = a.astype(np.float32)


# (arch, what overflows, the param moved, by how much): the bottleneck's
# medians move the factorized y and the hyperprior z symbols by -200;
# mbt2018-mean's mean channels (the second half of h_s's last bias) move y;
# the "-int16" cases move them past int16, which the plain path's int32
# symbols carry (lmic_tpu's int16 symbols would wrap)
OVERFLOW = {
    "factorized-y": ("bmshj2018-factorized",
                     ("entropy_bottleneck", "quantiles"),
                     np.s_[:, :, :], 200.0),
    "factorized-y-int16": ("bmshj2018-factorized",
                           ("entropy_bottleneck", "quantiles"),
                           np.s_[:, :, :], 40000.0),
    "hyperprior-z": ("bmshj2018-hyperprior",
                     ("entropy_bottleneck", "quantiles"),
                     np.s_[:, :, :], 200.0),
    "mean-y": ("mbt2018-mean", ("h_s_net", "layers_4", "Conv_0", "bias"),
               np.s_[24:], 200.0),
    "mean-y-int16": ("mbt2018-mean",
                     ("h_s_net", "layers_4", "Conv_0", "bias"),
                     np.s_[24:], 40000.0),
}


@pytest.mark.parametrize("case", sorted(OVERFLOW))
def test_int8_overflow_escape(case):
    """A symbol outside int8 goes through the escape (the int16 symbols,
    or the plain path for z and for a symbol past int16) and gives the
    plain path's bytes; the uint8 decode recovers the plain decode's
    levels."""
    arch, path, sl, by = OVERFLOW[case]
    params = jax_params(arch)
    _shift(params, path, sl, by)
    jc = jax_codec(arch, params)
    pc = carry_tables(jc, port_codec(arch, params))
    x = pixels(IMAGE, seed=3)
    out = pc.compress_async(x)()
    with torch.inference_mode():
        if arch == "bmshj2018-factorized":
            y = torch.cat([pc.module.g_a(pc._pixels(x[i:i + 1]))
                           for i in range(x.shape[0])])
            sym = torch.round(y - pc._medians(pc.eb_state))
        else:
            ys, z_sym = pc._analyze(x)
            if case == "hyperprior-z":
                sym = torch.from_numpy(z_sym)
            else:
                _, means = pc._params_for_wire_z(z_sym)
                sym = torch.round(torch.cat(ys) - means)
    assert sym.abs().max() > (32767 if by > 1000 else 127), \
        "the case does not overflow"
    plain = pc.compress(x.astype(np.float32) / 255.0)
    assert out["strings"] == plain["strings"]
    rec = pc.decompress_async(out["strings"], out["shape"])()["x_hat"]
    levels = np.round(pc.decompress(out["strings"], out["shape"])["x_hat"]
                      * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(rec, levels)


def test_fast_path_follows_the_tables(pair):
    """The fast path's device functions hold the tables' medians (and
    scale table): tables installed after a call, here with the medians
    moved, are what the next uint8 call codes with, as the plain path
    does."""
    arch, jc, _ = pair
    params = jax_params(arch)
    pc = port_codec(arch, params)
    pc.update()
    x = pixels(IMAGE, seed=8)
    pc.compress_async(x)()
    _shift(params, ("entropy_bottleneck", "quantiles"), np.s_[:, :, :], 3.0)
    carry_tables(jax_codec(arch, params), pc)
    out = pc.compress_async(x)()
    assert out["strings"] == pc.compress(x.astype(np.float32) / 255.0)[
        "strings"]
    np.testing.assert_array_equal(
        pc.decompress_async(out["strings"], out["shape"])()["x_hat"],
        np.round(pc.decompress(out["strings"], out["shape"])["x_hat"]
                 * 255.0).astype(np.uint8))


@pytest.fixture(scope="module")
def ar_pair():
    params = jax_params("mbt2018", n=AR_WIDTH, m=AR_WIDTH)
    jc = jax_codec("mbt2018", params, AR_WIDTH, AR_WIDTH)
    return jc, carry_tables(jc, port_codec("mbt2018", params, AR_WIDTH,
                                           AR_WIDTH))


def test_ar_async_pair_matches_lmic_tpu(ar_pair):
    """mbt2018: the analysis dispatched, the wavefront loop and the coder
    in the finalizer; the decode loop inline, the synthesis's pixels in
    the finalizer."""
    jc, pc = ar_pair
    batches = [pixels((1, 64, 64, 3), seed=30 + i) for i in range(2)]
    outs, recs = _pipelined(pc, batches)
    for x, out, rec in zip(batches, outs, recs):
        assert out["strings"] == jc.compress(x)["strings"]
        np.testing.assert_array_equal(
            rec, pc.decompress(out["strings"], out["shape"], u8=True)[
                "x_hat"])
    # float pixels and the float decode go the same way
    x = batches[0].astype(np.float32) / 255.0
    out = pc.compress_async(x)()
    assert out["strings"] == outs[0]["strings"]
    np.testing.assert_array_equal(
        pc.decompress_async(out["strings"], out["shape"], u8=False)()[
            "x_hat"],
        pc.decompress(out["strings"], out["shape"])["x_hat"])


def test_video_async_pair_matches_lmic_tpu():
    """ssf2020: the whole GOP chain dispatched and its packed buffer's
    copy started; the host rANS in the finalizer; the decode's host halves
    inline and the frames in the finalizer."""
    jc, pc, _ = video_codecs()
    gops = [pixels((1, 3, 128, 128, 3), seed=40 + i) for i in range(2)]
    pending = pc.compress_async(gops[0])
    nxt = pc.compress_async(gops[1])
    first = pending()
    dec = pc.decompress_async(*first)
    second = nxt()
    for gop, (strings, shapes) in zip(gops, (first, second)):
        assert (strings, shapes) == tuple(jc.compress(gop))
    np.testing.assert_array_equal(
        dec(), pc.decompress(*first, u8=True))
    np.testing.assert_array_equal(
        pc.decompress_async(*second, u8=False)(),
        pc.decompress(*second))
