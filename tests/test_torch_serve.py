"""The port's HTTP server speaks lmic_tpu's wire: on the same weights and
tables both servers return identical /compress bodies (mbt2018-mean, and
the autoregressive mbt2018), and the port's
/decompress round-trips to its direct codec call; bad requests are 400s."""

import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch

from lmic_tpu.utils.serve import make_server as jax_make_server
from lmic_tpu_torch.utils.codec_cli import read_body
from lmic_tpu_torch.utils.serve import (
    _read_pixels,
    _write_pixels,
    main,
    make_server,
)
from torch_port_helpers import (
    carry_tables,
    jax_codec,
    jax_params,
    pixels,
    port_codec,
)

torch.set_num_threads(2)

ARCH = "mbt2018-mean"


def _serve(make, codec):
    server = make(codec, {"family": "image", "input_shape": None})
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.fixture(scope="module")
def servers():
    params = jax_params(ARCH)
    jc = jax_codec(ARCH, params)
    pc = carry_tables(jc, port_codec(ARCH, params))
    ours, theirs = _serve(make_server, pc), _serve(jax_make_server, jc)
    yield pc, ours.server_address[1], theirs.server_address[1]
    for s in (ours, theirs):
        s.shutdown()
        s.server_close()


def _post(port, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=payload)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _pixel_payload(x):
    f = io.BytesIO()
    _write_pixels(f, x)
    return f.getvalue()


@pytest.mark.parametrize("seed", [0, 1])
def test_same_bodies_as_lmic_tpu_and_round_trip(servers, seed):
    pc, ours, theirs = servers
    x = pixels(seed=seed)
    status, body = _post(ours, "/compress", _pixel_payload(x))
    assert status == 200
    assert _post(theirs, "/compress", _pixel_payload(x)) == (200, body)
    status, rec = _post(ours, "/decompress", body)
    assert status == 200
    shape, groups = read_body(io.BytesIO(body))
    want = pc.decompress(groups, shape, u8=True)["x_hat"]
    np.testing.assert_array_equal(_read_pixels(io.BytesIO(rec)), want)


def test_meta_and_bad_requests(servers):
    _, ours, _ = servers
    conn = http.client.HTTPConnection("127.0.0.1", ours, timeout=30)
    conn.request("GET", "/meta")
    resp = conn.getresponse()
    assert resp.status == 200
    assert json.loads(resp.read())["family"] == "image"
    conn.close()
    assert _post(ours, "/compress", b"\x04garbage")[0] == 400
    assert _post(ours, "/decompress", b"\x00\x00")[0] == 400
    assert _post(ours, "/nope", b"")[0] == 404
    x = pixels((1, 48, 64, 3))  # not a multiple of 64: the codec refuses
    status, body = _post(ours, "/compress", _pixel_payload(x))
    assert status == 400 and b"multiples of 64" in body


@pytest.fixture(scope="module")
def ar_servers():
    """An mbt2018 (autoregressive) codec behind both servers, N = M = 16."""
    params = jax_params("mbt2018", n=16, m=16)
    jc = jax_codec("mbt2018", params, 16, 16)
    pc = carry_tables(jc, port_codec("mbt2018", params, 16, 16))
    ours, theirs = _serve(make_server, pc), _serve(jax_make_server, jc)
    yield pc, ours.server_address[1], theirs.server_address[1]
    for s in (ours, theirs):
        s.shutdown()
        s.server_close()


def test_ar_codec_same_bodies_as_lmic_tpu_and_round_trip(ar_servers):
    pc, ours, theirs = ar_servers
    x = pixels((2, 64, 128, 3), seed=3)
    status, body = _post(ours, "/compress", _pixel_payload(x))
    assert status == 200
    assert _post(theirs, "/compress", _pixel_payload(x)) == (200, body)
    status, rec = _post(ours, "/decompress", body)
    assert status == 200
    shape, groups = read_body(io.BytesIO(body))
    want = pc.decompress(groups, shape, u8=True)["x_hat"]
    np.testing.assert_array_equal(_read_pixels(io.BytesIO(rec)), want)


@pytest.mark.parametrize("family", ["video", "rgbt"])
def test_later_families_not_implemented(family):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_server(None, {"family": family})


@pytest.mark.parametrize("flag", ["--bundle", "--checkpoint"])
def test_cli_sources_not_implemented(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main([flag, "somewhere"])
