"""The port's copy of the rANS coder writes lmic_tpu's stream format: it
reproduces the frozen golden stream of tests/test_bitstream_golden.py,
and streams cross-decode between the two packages in both directions."""

import hashlib

import numpy as np
import pytest
import torch

from lmic_tpu.entropy import coder as jcoder
from lmic_tpu.entropy.entropy_models import GaussianConditional as JGC
from lmic_tpu.entropy.entropy_models import get_scale_table
from lmic_tpu_torch.entropy import coder as tcoder
from lmic_tpu_torch.ops import _build

torch.set_num_threads(2)

# the frozen stream of tests/test_bitstream_golden.py
GOLDEN_MD5 = "1041ca195d5f8f37b8c25f968fdaa16c"
GOLDEN_LEN = 4864


def _fixture(mod):
    cdf = np.array(
        [
            [0, 16000, 40000, 60000, 65536, 0],
            [0, 30000, 50000, 64000, 65536, 0],
            [0, 8000, 20000, 52000, 65536, 0],
        ],
        np.int32,
    )
    table = mod.CdfTable(cdf, np.array([5, 5, 5], np.int32),
                         np.array([-2, 0, 1], np.int32))
    rng = np.random.default_rng(1234)
    symbols = rng.integers(-6, 9, 4096).astype(np.int32)  # escapes too
    indexes = rng.integers(0, 3, 4096).astype(np.int32)
    return table, symbols, indexes


def test_golden_stream():
    table, symbols, indexes = _fixture(tcoder)
    s = tcoder.encode_with_indexes(symbols, indexes, table)
    assert len(s) == GOLDEN_LEN
    assert hashlib.md5(s).hexdigest() == GOLDEN_MD5
    np.testing.assert_array_equal(
        tcoder.decode_with_indexes(s, indexes, table), symbols
    )
    dec = tcoder.RansDecoder()
    dec.set_stream(s)
    parts = [dec.decode_stream(indexes[i:i + 512], table)
             for i in range(0, len(indexes), 512)]
    np.testing.assert_array_equal(np.concatenate(parts), symbols)


def test_builds_into_own_directory():
    lib = _build.library_path("lmic_rans.cc")
    assert lib.startswith(_build.BUILD_DIR)
    tcoder._load()
    import os

    assert os.path.exists(lib)
    assert "lmic_tpu_torch" in lib and "/lmic_tpu/" not in lib


@pytest.fixture(scope="module")
def gc_tables():
    st = JGC().update(get_scale_table())
    t = st.table
    return t, tcoder.CdfTable(t.cdf, t.cdf_length, t.offset)


def _gc_data(seed, B=3, n=3000):
    rng = np.random.default_rng(seed)
    sym = np.round(rng.normal(0, 6, (B, n))).astype(np.int32)
    sym[:, :5] = [400, -400, 70000, -70000, 0]  # bypass escapes
    idx = rng.integers(0, 64, (B, n)).astype(np.int32)
    return sym, idx


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_decode_both_ways(gc_tables, seed):
    jt, tt = gc_tables
    sym, idx = _gc_data(seed)
    from_port = tcoder.encode_batch(sym, idx, tt)
    from_jax = jcoder.encode_batch(sym, idx, jt)
    assert from_port == from_jax
    np.testing.assert_array_equal(jcoder.decode_batch(from_port, idx, jt), sym)
    np.testing.assert_array_equal(tcoder.decode_batch(from_jax, idx, tt), sym)


def test_shared_indexes(gc_tables):
    jt, tt = gc_tables
    sym, idx = _gc_data(2)
    shared = idx[0]
    streams = tcoder.encode_batch(sym, shared, tt)
    assert streams == jcoder.encode_batch(sym, shared, jt)
    np.testing.assert_array_equal(
        tcoder.decode_batch(streams, shared, tt), sym
    )
