"""The port's file containers against lmic_tpu's: on the same weights,
coding tables and input, every native and reference file (the non-AR
image archs, the AR family in the raster order, the RGB-T master pair in
the raster order, ssf2020) is byte-identical to lmic_tpu's (a master
file's 128 beta/gamma floats to 1e-5), and a file written by either
package decodes in the other to the same pixels (8-bit images within a
level at rounding edges). The
raster order's streams equal lmic_tpu's `compress_raster`, and its decoder
recovers the encoder's latents. The read guards of
tests/test_container_hardening.py fail the same way, and the CLI turns a
corrupt file into a clean SystemExit."""

import io
import struct

import numpy as np
import pytest
import torch

from lmic_tpu.utils import codec_cli as jcc
from lmic_tpu_torch import zoo as tzoo
from lmic_tpu_torch.utils import codec_cli as cc
from lmic_tpu_torch.utils.checkpoint import update_model_file
from torch_port_helpers import (
    AR_TRAIN,
    ARCHS,
    M,
    N,
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

WIDTHS = {arch: (N, M) for arch in ARCHS}
WIDTHS.update({arch: (n, m) for arch, n, m in AR_TRAIN})
CONTAINERS = ("lmic", "reference")


_CODECS = {}


def _codecs(arch):
    """(lmic_tpu codec, port codec with its tables carried), cached."""
    if arch not in _CODECS:
        n, m = WIDTHS[arch]
        params = jax_params(arch, n=n, m=m)
        jc = jax_codec(arch, params, n, m)
        _CODECS[arch] = (jc, carry_tables(jc, port_codec(arch, params, n,
                                                         m)))
    return _CODECS[arch]


def _png(path, arr):
    from PIL import Image

    Image.fromarray(arr[0, ..., 0] if arr.shape[-1] == 1 else arr[0]).save(
        path)
    return path


def _read_png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def _encoders(container):
    if container == "reference":
        return jcc.encode_image_ref, cc.encode_image_ref
    return jcc.encode_image, cc.encode_image


def _decode(mod, path, out, codec, container, arch):
    """Decode an image file with `mod`'s CLI functions and `codec`."""
    make = lambda a, q: codec  # noqa: E731
    if container == "reference":
        with open(path, "rb") as f:
            mod.read_uchars(f, 2)
            mod.decode_image_ref(f, out, make, arch, 1)
    else:
        mod.decode_image(path, out, make)
    return _read_png(out)


@pytest.mark.parametrize("container", CONTAINERS)
@pytest.mark.parametrize("arch", sorted(WIDTHS))
def test_image_files_byte_identical_and_cross_decode(tmp_path, arch,
                                                     container):
    """Same bytes from both packages; each decodes the other's file to the
    same pixels. The reference container codes the AR archs in the raster
    order, so its files differ from the native ones there."""
    jc, pc = _codecs(arch)
    src = _png(tmp_path / "in.png", pixels((1, 64, 128, 3), seed=3))
    jenc, tenc = _encoders(container)
    theirs, ours = tmp_path / "j.bin", tmp_path / "t.bin"
    jenc(src, theirs, jc, arch, 1)
    tenc(src, ours, pc, arch, 1)
    data = ours.read_bytes()
    assert data == theirs.read_bytes()
    if container == "reference":
        assert data[0] == cc.REF_MODEL_IDS[arch]
    j_pixels = _decode(jcc, ours, tmp_path / "j.png", jc, container, arch)
    t_pixels = _decode(cc, theirs, tmp_path / "t.png", pc, container, arch)
    assert t_pixels.shape == j_pixels.shape == (64, 128, 3)
    _same_pixels(t_pixels, j_pixels)


def _same_pixels(got, want):
    """Equal 8-bit pixels, but for a level at a rounding edge: the two
    frameworks' f32 synthesis transforms sum in other orders (~1e-6 apart
    on these random weights), so a value near k + 0.5 may round either
    way; the latents each decoder recovers are equal."""
    diff = np.abs(got.astype(np.int32) - want)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (
        diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("arch", [a for a, _, _ in AR_TRAIN])
def test_raster_streams_equal_lmic_tpu_and_decode_exactly(arch):
    """`compress(x, order="raster")` equals lmic_tpu's `compress_raster`
    string for string (the reference app's per-pixel order, which is not
    the wavefront order), and the raster decoder recovers exactly the
    latents the raster encoder coded."""
    jc, pc = _codecs(arch)
    x = pixels((2, 64, 128, 3), seed=5)
    ours = pc.compress(x, order="raster")
    theirs = jc.compress_raster(x)
    assert ours["strings"] == theirs["strings"]
    assert ours["strings"][0] != pc.compress(x)["strings"][0]
    with torch.inference_mode():
        ys, z_sym = pc._analyze(x)
        enc = pc._code_y_z(ys, z_sym, keep_y_hat=True, order="raster")
        dec = pc._decode_y_hat(enc["strings"], enc["shape"], order="raster")
    assert enc["strings"] == ours["strings"]
    torch.testing.assert_close(dec, enc["y_hat_latent"], rtol=0, atol=0)
    # the latents lmic_tpu decodes are the same symbols plus its f32 means
    np.testing.assert_allclose(
        dec.permute(0, 2, 3, 1).numpy(),
        jc._decode_y_hat(theirs["strings"], list(theirs["shape"]),
                         order="raster"), rtol=1e-5, atol=1e-5)
    _same_pixels(
        pc.decompress(ours["strings"], ours["shape"], u8=True,
                      order="raster")["x_hat"],
        np.asarray(jc.decompress_raster(theirs["strings"], theirs["shape"],
                                        u8=True)["x_hat"]))


def _rgbt_files(tmp_path, role):
    (jg, pg, _), (jm, pm, _) = rgbt_pair(role)
    master_hw, guide_hw = RGBT_GEOMETRY[role]
    x = pixels((1, *master_hw, role), seed=8)
    guide = pixels((1, *guide_hw, 4 - role), seed=9)
    return (jg, pg, jm, pm, _png(tmp_path / "m.png", x),
            _png(tmp_path / "g.png", guide))


@pytest.mark.parametrize("container", CONTAINERS)
@pytest.mark.parametrize("role", [1, 3])
def test_rgbt_files_byte_identical_and_cross_decode(tmp_path, role,
                                                    container):
    """The master container (its beta/gamma header and the master's AR
    streams, in the raster order for the reference container) equals
    lmic_tpu's byte for byte, both master roles; each package decodes the
    other's file, coding the guide from its own image, to the same
    pixels."""
    jg, pg, jm, pm, src, guide = _rgbt_files(tmp_path, role)
    theirs, ours = tmp_path / "j.bin", tmp_path / "t.bin"
    ref = container == "reference"
    (jcc.encode_rgbt_ref if ref else jcc.encode_rgbt)(
        src, guide, theirs, jg, jm, 1, channel=role)
    (cc.encode_rgbt_ref if ref else cc.encode_rgbt)(
        src, guide, ours, pg, pm, 1, channel=role)
    _same_master_file(ours.read_bytes(), theirs.read_bytes(),
                      11 if ref else 16)
    got = {}
    for name, mod, g, m, path in (("j", jcc, jg, jm, ours),
                                  ("t", cc, pg, pm, theirs)):
        out = tmp_path / f"{name}.png"
        if ref:
            with open(path, "rb") as f:
                mod.read_uchars(f, 2)
                mod.decode_rgbt_ref(f, guide, out, lambda ch: g,
                                    lambda ch: m, channel=role)
        else:
            mod.decode_rgbt(path, guide, out, lambda ch: g, lambda ch: m)
        got[name] = _read_png(out)
    _same_pixels(got["t"], got["j"])


def _same_master_file(got, want, side_at):
    """Every byte equal but beta/gamma's 128 f32 values (512 bytes at
    `side_at`): the channel aligner's conv sums give them in each
    framework's f32 rounding, within 1e-5 of each other (as
    tests/test_torch_rgbt.py holds them); the header and the master's
    streams are byte-identical."""
    end = side_at + 8 * cc.SIDE
    assert len(got) == len(want)
    assert got[:side_at] == want[:side_at] and got[end:] == want[end:]
    a, b = (np.frombuffer(d[side_at:end], ">f4") for d in (got, want))
    assert np.abs(a - b).max() / max(1.0, np.abs(b).max()) < 1e-5


def test_rgbt_decode_refuses_a_wrong_guide(tmp_path):
    _, pg, _, pm, src, guide = _rgbt_files(tmp_path, 1)
    cc.encode_rgbt(src, guide, tmp_path / "t.bin", pg, pm, 1, channel=1)
    small = _png(tmp_path / "s.png", pixels((1, 64, 64, 3), seed=1))
    with pytest.raises(SystemExit, match="guide image must be 128x128"):
        cc.decode_rgbt(tmp_path / "t.bin", small, tmp_path / "o.png",
                       lambda ch: pg, lambda ch: pm)


def _yuv_clip(tmp_path, frames=3, size=128, seed=4):
    rng = np.random.default_rng(seed)
    n = frames * (size * size + 2 * (size // 2) ** 2)
    path = tmp_path / f"clip_{size}x{size}_30_yuv420.yuv"
    rng.integers(0, 255, n, dtype=np.uint8).tofile(path)
    return path


@pytest.mark.parametrize("container", CONTAINERS)
def test_video_files_byte_identical_and_cross_decode(tmp_path, container):
    """ssf2020 files of a 3-frame 128x128 YUV420 clip (one reference chain,
    the in-loop frames clipped to [0, 1] between frames): the same bytes
    from both packages, and each decodes the other's file to the same
    YUV420 planes."""
    jc, pc, _ = video_codecs(0)
    clip = _yuv_clip(tmp_path)
    ref = container == "reference"
    theirs, ours = tmp_path / "j.bin", tmp_path / "t.bin"
    jcc.encode_video(clip, theirs, jc, 1, container="reference" if ref
                     else "native")
    cc.encode_video(clip, ours, pc, 1, container="reference" if ref
                    else "native")
    assert ours.read_bytes() == theirs.read_bytes()
    planes = {}
    for name, mod, codec, path in (("j", jcc, jc, ours), ("t", cc, pc,
                                                           theirs)):
        out = tmp_path / f"{name}.yuv"
        with open(path, "rb") as f:
            mod.read_uchars(f, 2 if ref else 6)
            n = (mod.decode_video_ref(f, out, lambda a, q: codec, 1) if ref
                 else mod.decode_video(f, out, lambda a, q: codec, 1))
        assert n == 3
        planes[name] = np.fromfile(out, np.uint8)
    assert planes["t"].size == 3 * (128 * 128 + 2 * 64 * 64)
    np.testing.assert_array_equal(planes["t"], planes["j"])


def test_video_decode_equals_the_encoders_in_loop_frames(tmp_path):
    """The decoded planes are `_rgb_to_yuv420_planes` of the encoder's
    clipped in-loop reconstructions, frame by frame."""
    from lmic_tpu_torch.datasets.rawvideo import RawVideoSequence

    _, pc, _ = video_codecs(0)
    clip = _yuv_clip(tmp_path, seed=6)
    cc.encode_video(clip, tmp_path / "t.bin", pc, 1)
    seq = RawVideoSequence.from_file(str(clip))
    want = [p for x_ref, _ in cc.code_frames(pc, seq, 3)
            for p in cc._rgb_to_yuv420_planes(
                cc.crop_center(x_ref.permute(0, 2, 3, 1), 128, 128))]
    seq.close()
    with open(tmp_path / "t.bin", "rb") as f:
        cc.read_uints(f, 1)
        cc.read_uchars(f, 2)
        cc.decode_video(f, tmp_path / "t.yuv", lambda a, q: pc, 1)
    np.testing.assert_array_equal(np.fromfile(tmp_path / "t.yuv", np.uint8),
                                  np.concatenate([p.ravel() for p in want]))


# ---------------------------------------------------------------------------
# Read guards: the cases of tests/test_container_hardening.py on the port
# ---------------------------------------------------------------------------


def _body_bytes(shape=(4, 4), groups=((b"abc", b"de"), (b"xyz",))):
    f = io.BytesIO()
    cc.write_body(f, shape, [list(g) for g in groups])
    return f.getvalue()


def _body_ref_bytes(shape=(4, 4), streams=(b"abcdef", b"gh")):
    f = io.BytesIO()
    cc.write_body_ref(f, shape, [[s] for s in streams])
    return f.getvalue()


def test_read_body_roundtrip_and_same_bytes_as_lmic_tpu():
    assert cc.read_body(io.BytesIO(_body_bytes())) == (
        (4, 4), [[b"abc", b"de"], [b"xyz"]])
    assert cc.read_body_ref(io.BytesIO(_body_ref_bytes())) == (
        (4, 4), [[b"abcdef"], [b"gh"]])
    for write in ("write_body", "write_body_ref"):
        ours, theirs = io.BytesIO(), io.BytesIO()
        getattr(cc, write)(ours, (3, 5), [[b"xy"], [b"z" * 300]])
        getattr(jcc, write)(theirs, (3, 5), [[b"xy"], [b"z" * 300]])
        assert ours.getvalue() == theirs.getvalue()
    for name in ("MAGIC", "RETIRED_MAGICS", "MODEL_IDS", "REF_MODEL_IDS",
                 "REF_INTEROP_ARCHS", "METRIC_IDS"):
        assert getattr(cc, name) == getattr(jcc, name), name


def _patched(buf, offset, value):
    buf = bytearray(buf)
    struct.pack_into(">I", buf, offset, value)
    return bytes(buf)


MALFORMED = [
    # (reader, bytes, message): lmic_tpu's hardening cases
    ("read_body", _patched(_body_bytes(), 10, 0xFFFFFFFF),
     "corrupt container.*length"),
    ("read_body", _patched(_body_bytes(), 0, 1 << 31), "implausible shape"),
    ("read_body", _patched(_body_bytes(), 4, 0), "implausible shape"),
    ("read_body_ref", struct.pack(">3I", 4, 4, 1 << 30), "stream count"),
    ("read_body_ref", _patched(_body_ref_bytes(), 12, 0x7FFFFFFF),
     "corrupt container.*length"),
] + [("read_body", _body_bytes()[:-cut], "corrupt container")
     for cut in (1, 5, 9, 13)]


@pytest.mark.parametrize("reader,data,match", MALFORMED)
def test_malformed_bodies_raise_value_error(reader, data, match):
    with pytest.raises(ValueError, match=match):
        getattr(cc, reader)(io.BytesIO(data))
    with pytest.raises(ValueError, match=match):
        getattr(jcc, reader)(io.BytesIO(data))


@pytest.mark.parametrize("reader,seed", [("read_body", 0),
                                         ("read_body_ref", 1)])
def test_fuzz_byte_flips_and_truncations(reader, seed):
    """A single flipped byte or a cut: the parse succeeds (the flip hit a
    payload) or raises the clean ValueError, as lmic_tpu's does."""
    base = (_body_bytes(shape=(8, 6),
                        groups=((b"0123456789" * 3, b"ab"), (b"curl",)))
            if reader == "read_body"
            else _body_ref_bytes(streams=(b"0123456789abcdef", b"zz")))
    rng = np.random.default_rng(seed)
    cases = [base[:cut] for cut in range(1, len(base))]
    for _ in range(300):
        buf = bytearray(base)
        buf[int(rng.integers(len(buf)))] ^= int(rng.integers(1, 256))
        cases.append(bytes(buf))
    for data in cases:
        outcomes = []
        for mod in (cc, jcc):
            try:
                outcomes.append(getattr(mod, reader)(io.BytesIO(data)))
            except ValueError as e:
                assert "corrupt container" in str(e)
                outcomes.append("corrupt")
        assert outcomes[0] == outcomes[1]


def _native_header(arch_id=0):
    f = io.BytesIO()
    cc.write_uints(f, (cc.MAGIC,))
    cc.write_uchars(f, (arch_id, 0))
    cc.write_uints(f, (64, 64))
    cc.write_uchars(f, (8,))
    return f.getvalue()


@pytest.mark.parametrize("case", ["oversized", "truncated", "retired",
                                  "unknown_ref_arch"])
def test_corrupt_file_is_a_clean_cli_error(tmp_path, case):
    p = tmp_path / "bad.bin"
    match = "corrupt container"
    if case == "oversized":
        p.write_bytes(_native_header()
                      + _patched(_body_bytes(), 10, 0xFFFFFFFF))
    elif case == "truncated":
        p.write_bytes(struct.pack(">I", cc.MAGIC) + b"\x00")
    elif case == "retired":
        p.write_bytes(struct.pack(">I", 0x1C1C) + b"\x00" * 16)
        match = "older lmic-codec"
    else:
        p.write_bytes(bytes([9, 0]) + b"\x00" * 16)
        match = "outside the interop family"
    with pytest.raises(SystemExit, match=match):
        cc.main(["decode", str(p), "-o", str(tmp_path / "o.png"),
                 "--device", "cpu"])


# ---------------------------------------------------------------------------
# The CLI end to end, on deployment checkpoints at narrow widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("container", CONTAINERS)
@pytest.mark.parametrize("arch", ["mbt2018-mean", "mbt2018"])
def test_cli_round_trip_equals_the_codec(tmp_path, monkeypatch, arch,
                                         container):
    """`main encode` then `main decode` with --checkpoint: the file holds
    the finalized codec's own strings (raster for the AR arch in the
    reference container) and decodes to its pixels, on an image whose
    sides are not multiples of 64 for the native container (padded,
    cropped back)."""
    monkeypatch.setitem(tzoo.cfgs, arch, {1: WIDTHS[arch]})
    codec = tzoo.create_model(arch, 1, seed=2, device="cpu")
    ckpt = update_model_file(str(tmp_path), codec, arch)
    ref = container == "reference"
    hw = (64, 128) if ref else (50, 70)
    x = pixels((1, *hw, 3), seed=4)
    src = _png(tmp_path / "in.png", x)
    out = tmp_path / "o.bin"
    cc.main(["encode", str(src), "-o", str(out), "--arch", arch,
             "--checkpoint", ckpt, "--container", container,
             "--device", "cpu"])
    xf = x.astype(np.float32) / 255
    with open(out, "rb") as f:
        if ref:
            assert cc.read_uchars(f, 2) == (cc.REF_MODEL_IDS[arch], 0)
            cc.read_uints(f, 2)
            cc.read_uchars(f, 1)
            shape, strings = cc.read_body_ref(f)
            direct = codec.compress(xf, **({"order": "raster"}
                                           if arch == "mbt2018" else {}))
        else:
            cc.read_uints(f, 1)
            cc.read_uchars(f, 2)
            assert cc.read_uints(f, 2) == hw
            cc.read_uchars(f, 1)
            shape, strings = cc.read_body(f)
            direct = codec.compress(cc.pad_to(xf)[0])
    assert strings == direct["strings"]
    rec = tmp_path / "rec.png"
    cc.main(["decode", str(out), "-o", str(rec), "--checkpoint", ckpt,
             "--device", "cpu"])
    want = codec.decompress(direct["strings"], direct["shape"],
                            **({"order": "raster"}
                               if ref and arch == "mbt2018" else {}))
    np.testing.assert_array_equal(
        _read_png(rec), cc._to_u8(cc.crop_center(want["x_hat"], *hw)))


def test_cli_master_both_containers(tmp_path, monkeypatch):
    """`main encode --arch master --guide` and `main decode --guide` from
    the pair's two deployment checkpoints, in both containers: each file
    decodes to the master's direct decompress."""
    for arch in ("guided", "master"):
        monkeypatch.setitem(tzoo.cfgs, arch, {1: (16, 16)})
    guided = tzoo.create_model("guided", 1, seed=0, channel=3, device="cpu")
    master = tzoo.create_model("master", 1, seed=1, channel=1, device="cpu")
    gk = update_model_file(str(tmp_path), guided, "guided")
    mk = update_model_file(str(tmp_path), master, "master")
    x = pixels((1, 64, 64, 1), seed=2)
    g = pixels((1, 128, 128, 3), seed=3)
    src, gsrc = _png(tmp_path / "m.png", x), _png(tmp_path / "g.png", g)
    out = {}
    for container in CONTAINERS:
        path = tmp_path / f"{container}.bin"
        cc.main(["encode", str(src), "--guide", str(gsrc), "-o", str(path),
                 "--checkpoint", mk, "--guided-checkpoint", gk,
                 "--channel", "1", "--container", container,
                 "--device", "cpu"])
        rec = tmp_path / f"{container}.png"
        cc.main(["decode", str(path), "-o", str(rec), "--guide", str(gsrc),
                 "--checkpoint", mk, "--guided-checkpoint", gk,
                 "--channel", "1", "--device", "cpu"])
        out[container] = _read_png(rec)
        order = "raster" if container == "reference" else "wavefront"
        g_dec = cc._code_guide(guided, g)
        m_out = master.compress(x, g_dec["x_hat"], order=order)
        want = master.decompress(m_out, g_dec, order=order)["x_hat"]
        np.testing.assert_array_equal(out[container], cc._to_u8(want))
    np.testing.assert_array_equal(out["lmic"], out["reference"])
