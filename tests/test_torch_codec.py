"""The port's codecs write lmic_tpu's bitstreams: with the JAX codec's
coding tables carried across, compressed strings are byte-identical for
the three non-AR archs on the uint8 and float paths, and streams
cross-decode both ways. The port's own tables are checked separately."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from lmic_tpu.entropy.entropy_models import EntropyBottleneck as JEB
from lmic_tpu.entropy.entropy_models import _standardized_cumulative as _phi
from lmic_tpu.entropy.entropy_models import get_scale_table
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.models.codec import HyperpriorCodec
from lmic_tpu_torch.ops.cdf import batched_pmf_to_quantized_cdf
from torch_port_helpers import (
    ARCHS,
    N,
    M,
    carry_tables,
    jax_codec,
    jax_params,
    pixels,
    port_codec,
    table_drift,
)

torch.set_num_threads(2)

# decoded images: the same symbols through g_s in two frameworks (f32
# convolutions in another summation order)
X_ATOL = 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    params = jax_params(arch)
    jc = jax_codec(arch, params)
    pc = carry_tables(jc, port_codec(arch, params))
    return arch, params, jc, pc


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_strings_byte_identical(pair, kind):
    _, _, jc, pc = pair
    x = pixels()
    if kind == "float":
        x = x.astype(np.float32) / 255.0
    want = jc.compress(x)
    got = pc.compress(x)
    assert tuple(got["shape"]) == tuple(want["shape"])
    assert got["strings"] == want["strings"]


def test_cross_decode_both_ways(pair):
    _, _, jc, pc = pair
    x = pixels(seed=1)
    from_jax, from_port = jc.compress(x), pc.compress(x)
    for u8 in (False, True):
        # each package decodes the other's stream as the other does its own
        for enc, dec, own in ((from_jax, pc, jc), (from_port, jc, pc)):
            got = dec.decompress(enc["strings"], enc["shape"], u8=u8)["x_hat"]
            want = own.decompress(enc["strings"], enc["shape"],
                                  u8=u8)["x_hat"]
            assert got.shape == want.shape and got.dtype == want.dtype
            if u8:  # a rounding edge may flip one level
                assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(got, want, atol=X_ATOL)


def test_batch_composition_invariance(pair):
    _, _, _, pc = pair
    x = pixels(seed=2)
    whole = pc.compress(x)["strings"]
    for i in range(x.shape[0]):
        one = pc.compress(x[i:i + 1])["strings"]
        assert [g[0] for g in one] == [g[i] for g in whole]


def _jax_pmfs(arch, params):
    """lmic_tpu's pmfs, as its update() evaluates them: the bottleneck's
    (pmf, tail_mass) and, for the hyperprior archs, the Gaussian's."""
    C = M if arch == "bmshj2018-factorized" else N
    pmf, tail, length, _, _ = JEB(channels=C).apply(
        {"params": params["entropy_bottleneck"]}, method=JEB.pmf_data
    )
    out = {"eb": (np.asarray(pmf), np.asarray(tail), np.asarray(length))}
    if arch != "bmshj2018-factorized":  # lmic_tpu GaussianConditional.update
        st = get_scale_table()
        center = np.ceil(
            st * -scipy.stats.norm.ppf(1e-9 / 2)
        ).astype(np.int32)
        length = 2 * center + 1
        samples = np.abs(np.arange(int(length.max()), dtype=np.int32)
                         - center[:, None]).astype(np.float32)
        upper, lower = (np.asarray(_phi(jnp.asarray((h - samples)
                                                    / st[:, None])))
                        for h in (0.5, -0.5))
        out["gc"] = (upper - lower, 2 * lower[:, 0], length)
    return out


def test_port_pmfs_match_lmic_tpu(pair):
    """Both packages evaluate the same f32 formulas (softplus, tanh,
    sigmoid, erfc) with their own implementations: a few ulps apart."""
    arch, params, _, pc = pair
    want = _jax_pmfs(arch, params)
    got = {"eb": pc.module.entropy_bottleneck.pmf_data()}
    if "gc" in want:
        got["gc"] = HyperpriorCodec.gc.pmf_data(get_scale_table())
    for k, (pmf, tail, length) in want.items():
        np.testing.assert_array_equal(got[k][2], length)
        np.testing.assert_allclose(got[k][0], pmf, rtol=0, atol=2e-7)
        np.testing.assert_allclose(got[k][1], tail, rtol=0, atol=2e-7)


def test_port_quantizer_on_jax_pmfs(pair):
    """Fed lmic_tpu's own pmfs, the port's quantizer rebuilds lmic_tpu's
    tables exactly."""
    arch, params, jc, _ = pair
    tables = {"eb": jc.eb_state.table}
    if jc.gc_state is not None:
        tables["gc"] = jc.gc_state.table
    for k, (pmf, tail, length) in _jax_pmfs(arch, params).items():
        cdf = batched_pmf_to_quantized_cdf(pmf, tail, length,
                                           int(length.max()))
        np.testing.assert_array_equal(cdf, tables[k].cdf)


def test_port_update_tables_close_to_lmic_tpu(pair):
    """The port's own update(): same geometry as lmic_tpu's tables, and
    few rows apart. An ulp of pmf can move one frequency by one; when that
    changes a row's total, the quantizer's renormalization shifts the whole
    row (measured: 1-2 rows of the bottleneck's 16-24, 2 of the Gaussian's
    64, one entry off by up to 134), which is why bitstream parity carries
    the tables across."""
    arch, params, jc, _ = pair
    pc = port_codec(arch, params)
    pc.update()
    states = [(pc.eb_state, jc.eb_state)]
    if jc.gc_state is not None:
        states.append((pc.gc_state, jc.gc_state))
        np.testing.assert_array_equal(pc.gc_state.scale_table,
                                      jc.gc_state.scale_table)
    np.testing.assert_array_equal(pc.eb_state.medians, jc.eb_state.medians)
    for got, want in states:
        assert got.table.cdf.shape == want.table.cdf.shape
        np.testing.assert_array_equal(got.table.cdf_length,
                                      want.table.cdf_length)
        np.testing.assert_array_equal(got.table.offset, want.table.offset)
        rows, _, _ = table_drift(got.table, want.table)
        assert rows <= len(want.table.cdf) / 8


def test_create_model_needs_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tzoo.create_model("bmshj2018-factorized", 1, N=N, M=M)
    codec = tzoo.create_model("bmshj2018-factorized", 1, N=N, M=M,
                              device="cpu")
    assert codec.device.type == "cpu"
    # the same seed gives the same weights
    again = tzoo.create_model("bmshj2018-factorized", 1, N=N, M=M,
                              device="cpu")
    for a, b in zip(codec.module.state_dict().values(),
                    again.module.state_dict().values()):
        assert torch.equal(a, b)


def test_errors():
    codec = tzoo.create_model("mbt2018-mean", 1, N=N, M=M, device="cpu")
    with pytest.raises(RuntimeError, match="update"):
        codec.compress(pixels())
    codec.update()
    with pytest.raises(ValueError, match="multiples of 64"):
        codec.compress(pixels((1, 48, 64, 3)))
    # the image zoo has every lmic_tpu image arch; ssf2020 is a video
    # model (`create_video_model` in lmic_tpu), not one of them
    with pytest.raises(ValueError, match="Invalid architecture"):
        tzoo.create_model("ssf2020", 1, device="cpu")
