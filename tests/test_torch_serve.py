"""The port's HTTP server speaks lmic_tpu's wire: on the same weights and
tables both servers return identical /compress bodies (mbt2018-mean, the
autoregressive mbt2018, the RGB-T pair's master streams with beta and
gamma, and ssf2020's GOPs), and the port's /decompress round-trips to its
direct codec call; bad requests are 400s. `main --checkpoint` serves
port-finalized files."""

import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch

from lmic_tpu.utils.serve import make_server as jax_make_server
from lmic_tpu_torch import zoo
from lmic_tpu_torch.utils.checkpoint import update_model_file
from lmic_tpu_torch.utils.codec_cli import read_body, read_floats
from lmic_tpu_torch.utils.serve import (
    _decode_request,
    _read_pixels,
    _write_pixels,
    load_rgbt_codecs,
    main,
    make_server,
)
from torch_port_helpers import (
    RGBT_GEOMETRY,
    carry_tables,
    jax_codec,
    jax_params,
    pixels,
    port_codec,
    rgbt_pair,
    video_codecs,
)

torch.set_num_threads(2)

ARCH = "mbt2018-mean"


def _serve(make, codec, family="image"):
    server = make(codec, {"family": family, "input_shape": None})
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


@pytest.fixture(scope="module")
def rgbt_servers():
    """The RGB-T pair (a 64x64 thermal master, a 128x128 RGB guide) behind
    both servers, on the same weights and tables."""
    (jg, pg, _), (jm, pm, _) = rgbt_pair(1)
    ours = _serve(make_server, (pg, pm), "rgbt")
    theirs = _serve(jax_make_server, (jg, jm), "rgbt")
    yield (pg, pm), ours.server_address[1], theirs.server_address[1]
    for s in (ours, theirs):
        s.shutdown()
        s.server_close()


def _rgbt_payload(seed, B=1):
    (mH, mW), (gH, gW) = RGBT_GEOMETRY[1]
    return (pixels((B, mH, mW, 1), seed=seed),
            pixels((B, gH, gW, 3), seed=seed + 100))


def _parse_rgbt(body):
    f = io.BytesIO(body)
    shape, groups = read_body(f)
    beta, gamma = (np.asarray(read_floats(f, 64)) for _ in range(2))
    assert f.read() == b""
    return shape, groups, beta, gamma


def test_rgbt_same_master_streams_as_lmic_tpu_and_round_trip(rgbt_servers):
    """/compress: the master's strings equal lmic_tpu's, beta/gamma within
    1e-5; both legs equal the direct calls."""
    (pg, pm), ours, theirs = rgbt_servers
    x, guide = _rgbt_payload(5)
    payload = _pixel_payload(x) + _pixel_payload(guide)
    status, body = _post(ours, "/compress", payload)
    assert status == 200
    status, want = _post(theirs, "/compress", payload)
    assert status == 200
    got, want = _parse_rgbt(body), _parse_rgbt(want)
    assert tuple(got[0]) == tuple(want[0]) and got[1] == want[1]
    for a, b in zip(got[2:], want[2:]):
        assert np.abs(a - b).max() / max(1.0, np.abs(b).max()) < 1e-5
    g_out = pg.compress(guide, hidden=False, reconstruct=True)
    direct = pm.compress(x, g_out["x_hat"])
    assert direct["strings"] == got[1]
    np.testing.assert_array_equal(direct["beta"].reshape(-1), got[2])
    np.testing.assert_array_equal(direct["gamma"].reshape(-1), got[3])
    status, rec = _post(ours, "/decompress", body + _pixel_payload(guide))
    assert status == 200
    g_dec = pg.decompress(g_out["strings"], g_out["shape"])
    want_px = pm.decompress(direct, g_dec, u8=True)["x_hat"]
    got_px = _read_pixels(io.BytesIO(rec))
    assert got_px.shape == x.shape
    np.testing.assert_array_equal(got_px, want_px)


def test_rgbt_bad_requests_are_400(rgbt_servers):
    _, ours, _ = rgbt_servers
    x, guide = _rgbt_payload(6)
    status, msg = _post(ours, "/compress", _pixel_payload(x)
                        + _pixel_payload(guide[:, :64]))
    assert status == 400 and b"guide image must be 128x128" in msg
    status, msg = _post(ours, "/compress", _pixel_payload(x[:, :32])
                        + _pixel_payload(guide))
    assert status == 400 and b"multiples of 64" in msg
    x2, guide2 = _rgbt_payload(6, B=2)
    status, msg = _post(ours, "/compress", _pixel_payload(x2)
                        + _pixel_payload(guide2))
    assert status == 400 and b"B=1" in msg
    status, body = _post(ours, "/compress", _pixel_payload(x)
                         + _pixel_payload(guide))
    status, msg = _post(ours, "/decompress",
                        body + _pixel_payload(guide[:, :64, :64]))
    assert status == 400 and b"guide image must be" in msg


@pytest.mark.parametrize("cache", ["2", "0"])
def test_rgbt_guide_cache(monkeypatch, cache):
    """With the LRU on, the decompress leg reuses the compress leg's guide;
    with LMIC_SERVE_GUIDE_CACHE=0 it codes the guide again."""
    monkeypatch.setenv("LMIC_SERVE_GUIDE_CACHE", cache)
    (pg, pm), meta = load_rgbt_codecs(1, channel=1, device="cpu", N=16,
                                      M=16)
    assert meta["family"] == "rgbt" and pm.module.channel == 1
    assert pg.module.channel == 3
    calls = []
    compress = pg.compress
    monkeypatch.setattr(pg, "compress",
                        lambda *a, **k: calls.append(1) or compress(*a, **k))
    server = _serve(make_server, (pg, pm), "rgbt")
    try:
        x, guide = _rgbt_payload(7)
        port = server.server_address[1]
        status, body = _post(port, "/compress", _pixel_payload(x)
                             + _pixel_payload(guide))
        assert status == 200 and len(calls) == 1
        status, rec = _post(port, "/decompress", body
                            + _pixel_payload(guide))
        assert status == 200 and _read_pixels(io.BytesIO(rec)).shape == \
            x.shape
        assert len(calls) == (1 if cache == "2" else 2)
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("family", ["video"])
def test_later_families_not_implemented(family):
    """The video family, which an earlier slice refused: for the same GOP
    and weights the port's server returns lmic_tpu's server's /compress
    body byte for byte, its /decompress the direct call's uint8 frames,
    and 400 on a truncated body."""
    jc, pc, _ = video_codecs(0)
    ours, theirs = (_serve(make_server, pc, family),
                    _serve(jax_make_server, jc, family))
    try:
        x = pixels((1, 3, 128, 128, 3), seed=11)
        status, body = _post(ours.server_address[1], "/compress",
                             _pixel_payload(x))
        assert status == 200
        assert _post(theirs.server_address[1], "/compress",
                     _pixel_payload(x)) == (200, body)
        strings, shapes = _decode_request(io.BytesIO(body), video=True)
        assert len(strings) == 3 and isinstance(strings[1], dict)
        status, rec = _post(ours.server_address[1], "/decompress", body)
        assert status == 200
        np.testing.assert_array_equal(
            _read_pixels(io.BytesIO(rec)),
            pc.decompress(strings, shapes, u8=True))
        status, msg = _post(ours.server_address[1], "/decompress",
                            body[:-7])
        assert status == 400 and b"corrupt container" in msg
    finally:
        for s in (ours, theirs):
            s.shutdown()
            s.server_close()


def _serve_main(argv):
    """Run `main(argv)` in a thread; returns (server, thread)."""
    started = []
    ready = threading.Event()
    thread = threading.Thread(target=main, args=(argv,), kwargs={
        "started": lambda s: (started.append(s), ready.set())}, daemon=True)
    thread.start()
    assert ready.wait(120)
    return started[0], thread


@pytest.mark.parametrize("flag", ["--bundle", "--checkpoint"])
def test_cli_sources_not_implemented(flag, tmp_path, monkeypatch):
    """`--bundle` serves a CPU serving bundle of mbt2018-mean, its bodies
    and pixels equal to the live codec's; `--checkpoint` serves a
    port-finalized ssf2020 and mbt2018-mean, each /compress equal to the
    finalized codec's own call; `-a master --guided-checkpoint` serves the
    RGB-T pair from its two finalized checkpoints, its bodies equal to the
    direct calls."""
    if flag == "--bundle":
        _serves_a_bundle(tmp_path)
        _serves_the_master_pair(tmp_path, monkeypatch)
        return
    for arch, x in (("ssf2020", pixels((1, 2, 128, 128, 3), seed=12)),
                    ("mbt2018-mean", pixels((1, 64, 64, 3), seed=13))):
        codec = (zoo.create_video_model(seed=1, device="cpu")
                 if arch == "ssf2020"
                 else zoo.create_model(arch, 1, seed=1, device="cpu"))
        path = update_model_file(str(tmp_path), codec, arch)
        server, thread = _serve_main([flag, path, "-a", arch, "--port", "0",
                                      "--device", "cpu"])
        try:
            port = server.server_address[1]
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("GET", "/meta")
            meta = json.loads(conn.getresponse().read())
            conn.close()
            assert meta["arch"] == arch
            status, body = _post(port, "/compress", _pixel_payload(x))
            assert status == 200
            video = arch == "ssf2020"
            strings, shapes = _decode_request(io.BytesIO(body), video)
            direct = codec.compress(x)
            assert (strings, shapes) == (direct if video else (
                direct["strings"], direct["shape"]))
            status, rec = _post(port, "/decompress", body)
            assert status == 200
            assert _read_pixels(io.BytesIO(rec)).shape == x.shape
        finally:
            server.shutdown()
            thread.join(30)
        assert not thread.is_alive()


def _serves_a_bundle(tmp_path):
    from lmic_tpu_torch.utils.aot import export_serving_bundle

    x = pixels((1, 64, 64, 3), seed=14)
    live = zoo.create_model(ARCH, 1, seed=1, device="cpu")
    live.update()
    bundle = export_serving_bundle(live, str(tmp_path / "bundle"), x.shape)
    with pytest.raises(ValueError, match="exported on 'cpu'"):
        main(["--bundle", bundle, "--device", "meta"])
    server, thread = _serve_main(["--bundle", bundle, "--port", "0",
                                  "--device", "cpu"])
    try:
        port = server.server_address[1]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/meta")
        meta = json.loads(conn.getresponse().read())
        conn.close()
        assert meta["family"] == "hyperprior"
        assert meta["input_shape"] == list(x.shape)
        status, body = _post(port, "/compress", _pixel_payload(x))
        assert status == 200
        strings, shape = _decode_request(io.BytesIO(body), False)
        direct = live.compress(x)
        assert (strings, tuple(shape)) == (direct["strings"],
                                           tuple(direct["shape"]))
        status, rec = _post(port, "/decompress", body)
        assert status == 200
        np.testing.assert_array_equal(
            _read_pixels(io.BytesIO(rec)),
            live.decompress(strings, shape, u8=True)["x_hat"])
        # the bundle is fixed to its shape: another one is a 400
        status, msg = _post(port, "/compress",
                            _pixel_payload(pixels((1, 128, 64, 3))))
        assert status == 400 and b"fixed to input shape" in msg
    finally:
        server.shutdown()
        thread.join(30)
    assert not thread.is_alive()


def _serves_the_master_pair(tmp_path, monkeypatch):
    for arch in ("guided", "master"):
        monkeypatch.setitem(zoo.cfgs, arch, {1: (16, 16)})
    guided = zoo.create_model("guided", 1, seed=3, channel=3, device="cpu")
    master = zoo.create_model("master", 1, seed=4, channel=1, device="cpu")
    paths = [update_model_file(str(tmp_path), c, a)
             for c, a in ((guided, "guided"), (master, "master"))]
    with pytest.raises(SystemExit, match="needs --guided-checkpoint"):
        main(["--checkpoint", paths[1], "-a", "master", "--device", "cpu"])
    server, thread = _serve_main([
        "--checkpoint", paths[1], "-a", "master", "--guided-checkpoint",
        paths[0], "--channel", "1", "--port", "0", "--device", "cpu"])
    try:
        port = server.server_address[1]
        served_guided, served_master = server.codec
        assert served_master.module.channel == 1
        assert served_guided.module.channel == 3
        x, guide = _rgbt_payload(9)
        status, body = _post(port, "/compress", _pixel_payload(x)
                             + _pixel_payload(guide))
        assert status == 200
        g_out = guided.compress(guide, hidden=False, reconstruct=True)
        direct = master.compress(x, g_out["x_hat"])
        shape, strings, beta, gamma = _parse_rgbt(body)
        assert strings == direct["strings"]
        assert tuple(shape) == tuple(direct["shape"])
        np.testing.assert_array_equal(beta, direct["beta"].reshape(-1))
        np.testing.assert_array_equal(gamma, direct["gamma"].reshape(-1))
        status, rec = _post(port, "/decompress", body
                            + _pixel_payload(guide))
        assert status == 200
        np.testing.assert_array_equal(
            _read_pixels(io.BytesIO(rec)),
            master.decompress(direct, {"x_hat": g_out["x_hat"],
                                       "hidden": g_out["hidden_dec"]},
                              u8=True)["x_hat"])
    finally:
        server.shutdown()
        thread.join(30)
    assert not thread.is_alive()
