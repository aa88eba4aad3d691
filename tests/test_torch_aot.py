"""Serving bundles of the port (utils/aot.py) on the CPU: a bundle exported
from the port's codec, on weights converted with `state_dict_from_jax` and
lmic_tpu's coding tables carried across, codes lmic_tpu's strings and the
live port codec's strings byte for byte and decodes to the live codec's
pixels, at lmic_tpu's test shapes ((2, 64, 64, 3); ssf2020 (1, 3, 128,
128, 3)), through the synchronous and the pipelined API. The guards,
export-time shape checks and refusals keep lmic_tpu's messages; the
loader imports no zoo; the GDN forward is one operator node of each
graph."""

import functools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from lmic_tpu.utils.aot import export_serving_bundle as jax_export
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.ops import gdn
from lmic_tpu_torch.utils.aot import (
    export_serving_bundle,
    load_serving_bundle,
)
from torch_port_helpers import (
    ARCHS,
    carry_tables,
    jax_codec,
    jax_params,
    pixels,
    port_codec,
    video_codecs,
)

torch.set_num_threads(2)

SHAPE = (2, 64, 64, 3)
GOP = (1, 3, 128, 128, 3)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# gdn_fwd nodes of each graph that holds GDN: three GDN in g_a, three
# IGDN in g_s
GDN_NODES = {
    "bmshj2018-factorized": {"_enc_u8_packed__one": 3, "_enc_u8__one": 3,
                             "_dec_u8__i8": 3, "_dec_u8__i16": 3},
    "bmshj2018-hyperprior": {"_analyze_u8__one": 3, "_synth_u8__i8": 3,
                             "_synth_u8__i16": 3},
}
GDN_NODES["mbt2018-mean"] = GDN_NODES["bmshj2018-hyperprior"]


def _gdn_nodes(path, name):
    program = torch.export.load(os.path.join(path, "fns", name + ".pt2"))
    return sum(n.target == torch.ops.lmic_tpu_torch.gdn_fwd.default
               for n in program.graph.nodes)


@functools.lru_cache(maxsize=None)
def _codecs(arch):
    """lmic_tpu's codec and the port's on its converted weights and
    carried tables, shared by the tests (do not mutate them)."""
    params = jax_params(arch)
    jc = jax_codec(arch, params)
    return jc, carry_tables(jc, port_codec(arch, params))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """arch -> the path of the port codec's bundle at SHAPE, exported once
    a module."""
    paths = {}

    def get(arch):
        if arch not in paths:
            paths[arch] = str(tmp_path_factory.mktemp(arch) / "bundle")
            export_serving_bundle(_codecs(arch)[1], paths[arch], SHAPE)
        return paths[arch]

    return get


@pytest.fixture(params=ARCHS)
def bundle(request, exported):
    arch = request.param
    jc, pc = _codecs(arch)
    path = exported(arch)
    return arch, jc, pc, path, load_serving_bundle(path, device="cpu")


def test_bundle_codes_like_the_live_codec_and_lmic_tpu(bundle):
    arch, jc, pc, path, served = bundle
    x = pixels(SHAPE, seed=1)
    want = jc.compress(x)
    live = pc.compress(x)
    got = served.compress(x)
    assert got["strings"] == live["strings"] == want["strings"]
    assert tuple(got["shape"]) == tuple(want["shape"])
    rec = served.decompress(got["strings"], got["shape"], u8=True)["x_hat"]
    np.testing.assert_array_equal(
        rec, pc.decompress(live["strings"], live["shape"], u8=True)["x_hat"])
    # the pipelined API rides the same graphs: batch 2's compress is
    # dispatched before batch 1's finalize
    x2 = pixels(SHAPE, seed=2)
    first, second = served.compress_async(x), served.compress_async(x2)
    out = first()
    dec = served.decompress_async(out["strings"], out["shape"])
    assert out["strings"] == want["strings"]
    assert second()["strings"] == jc.compress(x2)["strings"]
    np.testing.assert_array_equal(dec()["x_hat"], rec)
    meta = served.bundle_meta
    assert meta["family"] == ("factorized" if arch.endswith("factorized")
                              else "hyperprior")
    assert meta["device"] == "cpu" and meta["input_shape"] == list(SHAPE)
    for name, n in GDN_NODES[arch].items():
        assert _gdn_nodes(path, name) == n, name


def test_bundle_guards(exported):
    """lmic_tpu's frozen-bundle guards (tests/test_aot.py TestBundleGuards),
    on the sync and the async entry points."""
    served = load_serving_bundle(exported("bmshj2018-factorized"),
                                 device="cpu")
    with pytest.raises(ValueError, match="fixed to input shape"):
        served.compress(np.zeros((1, 64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="fixed to input shape"):
        served.compress_async(np.zeros((1, 64, 64, 3), np.uint8))
    for fn in (served.compress, served.compress_async):
        with pytest.raises(RuntimeError, match="uint8 fast path"):
            fn(np.zeros(SHAPE, np.float32))
    with pytest.raises(RuntimeError, match="uint8 fast path"):
        served.decompress([[b""]], (4, 4))
    with pytest.raises(RuntimeError, match="frozen"):
        served.update(force=True)
    out = served.compress(pixels(SHAPE))
    with pytest.raises(ValueError, match="latent shape"):
        served.decompress(out["strings"], (5, 5), u8=True)
    with pytest.raises(ValueError, match="latent shape"):
        served.decompress_async(out["strings"], (5, 5))
    with pytest.raises(ValueError, match="batch size"):
        served.decompress([out["strings"][0][:1]], out["shape"], u8=True)
    rec = served.decompress(out["strings"], out["shape"], u8=True)
    assert rec["x_hat"].shape == SHAPE


def test_video_bundle(tmp_path):
    """ssf2020: the whole GOP chain, bit-equal to the live codec and to
    lmic_tpu, fixed to the (1, T, H, W, C) GOP shape."""
    jc, pc, _ = video_codecs()
    frames = pixels(GOP, seed=3)
    want_s, want_sh = jc.compress(frames)
    live_s, live_sh = pc.compress(frames)
    assert live_s == want_s
    want_rec = pc.decompress(live_s, live_sh, u8=True)
    bundle_dir = str(tmp_path / "bundle")
    export_serving_bundle(pc, bundle_dir, GOP)
    served = load_serving_bundle(bundle_dir, device="cpu")
    got_s, got_sh = served.compress(frames)
    assert got_s == want_s and got_sh == live_sh
    np.testing.assert_array_equal(
        served.decompress(got_s, got_sh, u8=True), want_rec)
    assert served.compress_async(frames)()[0] == want_s
    np.testing.assert_array_equal(
        served.decompress_async(got_s, got_sh, u8=True)(), want_rec)
    with pytest.raises(RuntimeError, match="uint8 fast path"):
        served.compress(frames.astype(np.float32))
    with pytest.raises(ValueError, match="fixed to input shape"):
        served.compress(frames[:, :2])
    with pytest.raises(RuntimeError, match="uint8 fast path"):
        served.decompress(got_s, got_sh)
    with pytest.raises(ValueError, match="3-frame GOPs"):
        served.decompress(got_s[:2], got_sh[:2], u8=True)
    with pytest.raises(RuntimeError, match="uint8 fast path"):
        served.compress_async(frames.astype(np.float32))
    with pytest.raises(RuntimeError, match="uint8 fast path"):
        served.decompress_async(got_s, got_sh, u8=False)
    with pytest.raises(RuntimeError, match="frozen"):
        served.update(force=True)
    # ssf2020 has no GDN
    assert all(_gdn_nodes(bundle_dir, n) == 0
               for n in served.bundle_meta["fns"])


def test_export_shape_errors(tmp_path):
    _, pc, _ = video_codecs()
    with pytest.raises(ValueError, match="GOP of >= 2"):
        export_serving_bundle(pc, str(tmp_path / "b"), (1, 1, 128, 128, 3))
    with pytest.raises(ValueError, match="B, T, H, W, C"):
        export_serving_bundle(pc, str(tmp_path / "b"), (1, 128, 128, 3))
    with pytest.raises(ValueError, match="128-multiple"):
        export_serving_bundle(pc, str(tmp_path / "b"), (1, 2, 1088, 1920, 3))
    with pytest.raises(ValueError, match="per-sequence"):
        export_serving_bundle(pc, str(tmp_path / "b"), (2, 2, 128, 128, 3))
    hp = tzoo.create_model("mbt2018-mean", 1, device="cpu", N=16, M=24)
    hp.update()
    with pytest.raises(ValueError, match="64-multiple"):
        export_serving_bundle(hp, str(tmp_path / "b"), (1, 96, 64, 3))
    with pytest.raises(ValueError, match="B, H, W, C"):
        export_serving_bundle(hp, str(tmp_path / "b"), (64, 64, 3))
    assert not os.path.exists(tmp_path / "b")


def _edit_meta(path, **changes):
    meta_path = os.path.join(path, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta.update(changes)
    with open(meta_path, "w") as f:
        json.dump(meta, f)


def test_refusals(exported, tmp_path):
    """The AR codecs are not exportable; an lmic_tpu bundle, a wrong
    format or family, and a bundle exported on another device are each
    refused."""
    ar = tzoo.create_model("mbt2018", 1, device="cpu", N=16, M=24)
    ar.update()
    with pytest.raises(ValueError, match="not AOT-exportable"):
        export_serving_bundle(ar, str(tmp_path / "ar"), SHAPE)
    jc, _ = _codecs("bmshj2018-factorized")
    theirs = str(tmp_path / "lmic_tpu")
    jax_export(jc, theirs, SHAPE)
    with pytest.raises(ValueError, match="an lmic_tpu bundle"):
        load_serving_bundle(theirs, device="cpu")
    ours = str(tmp_path / "ours")
    shutil.copytree(exported("bmshj2018-factorized"), ours)
    with pytest.raises(ValueError, match="exported on 'cpu'"):
        load_serving_bundle(ours, device="meta")
    _edit_meta(ours, device="cuda")
    with pytest.raises(ValueError, match="exported on 'cuda'"):
        load_serving_bundle(ours, device="cpu")
    _edit_meta(ours, device="cpu", format=999)
    with pytest.raises(ValueError, match="unsupported bundle"):
        load_serving_bundle(ours, device="cpu")
    _edit_meta(ours, format=1, family="video")
    with pytest.raises(ValueError, match="unsupported bundle"):
        load_serving_bundle(ours, device="cpu")


def test_loader_imports_no_zoo(exported, tmp_path):
    """A fresh process loads a bundle and codes with it without the model
    zoo (or JAX): the live codec's strings and pixels."""
    _, pc = _codecs("mbt2018-mean")
    path = exported("mbt2018-mean")
    x = pixels(SHAPE, seed=5)
    np.save(tmp_path / "x.npy", x)
    script = (
        "import sys, numpy as np\n"
        "from lmic_tpu_torch.utils.aot import load_serving_bundle\n"
        f"c = load_serving_bundle({path!r}, device='cpu')\n"
        f"x = np.load({str(tmp_path / 'x.npy')!r})\n"
        "out = c.compress(x)\n"
        "rec = c.decompress(out['strings'], out['shape'], u8=True)\n"
        f"np.save({str(tmp_path / 'rec.npy')!r}, rec['x_hat'])\n"
        "import pickle\n"
        f"pickle.dump(out, open({str(tmp_path / 'out.pkl')!r}, 'wb'))\n"
        "bad = [m for m in sys.modules if m.startswith("
        "('lmic_tpu_torch.zoo', 'jax', 'lmic_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", script], check=True, env=env,
                   timeout=120)
    import pickle

    with open(tmp_path / "out.pkl", "rb") as f:
        out = pickle.load(f)
    live = pc.compress(x)
    assert out["strings"] == live["strings"]
    np.testing.assert_array_equal(
        np.load(tmp_path / "rec.npy"),
        pc.decompress(live["strings"], live["shape"], u8=True)["x_hat"])


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_operator(inverse):
    """`torch.ops.lmic_tpu_torch.gdn_fwd` on the CPU is `gdn_reference`
    exactly, is what `gdn_core` runs, and stays one node of an exported
    graph."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 5, 7, 16), np.float32))
    beta = torch.from_numpy(rng.uniform(0.5, 1.5, 16).astype(np.float32))
    gamma = torch.from_numpy(rng.uniform(0, 0.1, (16, 16)).astype(
        np.float32))
    want = gdn.gdn_reference(x, beta, gamma, inverse)
    assert torch.equal(
        torch.ops.lmic_tpu_torch.gdn_fwd(x, beta, gamma, inverse), want)
    assert torch.equal(gdn.gdn_core(x, beta, gamma, inverse), want)
    layer = tzoo.make_module("bmshj2018-factorized", 1, N=16, M=24).g_a[1]
    program = torch.export.export(
        layer, (torch.rand(1, 16, 8, 8).contiguous(
            memory_format=torch.channels_last),))
    assert [n.target for n in program.graph.nodes
            if "gdn_fwd" in str(n.target)] == [
                torch.ops.lmic_tpu_torch.gdn_fwd.default]
