"""File codec CLI (the examples/codec_rgbt.py equivalent), its two
containers, and the body framing shared with the HTTP wire.

Counterpart of lmic_tpu/utils/codec_cli.py, byte for byte. The native
container (mirroring codec_rgbt.py:141-249):

  header:  magic u32 | model-id u8 | (metric<<4 | quality-1) u8
  size:    original (h, w) as u32 pair, bitdepth u8
  master:  a master-channel u8, 64 float32 beta + 64 float32 gamma
           (lossless side info, codec_rgbt.py:377-380)
  video:   u32 frame count, then per frame one body (keyframe) or two
           (inter: motion, residual)
  body:    latent shape (h, w) u32 pair, then per stream group: number of
           strings u8, then per string u32 length + raw bytes

The reference container (`--container reference`) is the reference app's
own layout (codec_rgbt.py:141-249, 355-386): no magic, its model ids
(`REF_MODEL_IDS`), no channel byte, and per body u32 (h, w, n_strings)
with per stream u32 length + bytes. Its AR streams (mbt2018, cheng2020,
the master) are in the reference's raster symbol order.

Like the reference decoder (codec_rgbt.py:511-554), an RGB-T master file
does not embed the guide's stream: both sides code the guide from its own
image and use its reconstruction and hidden maps.

Each image and RGB-T coder is an array-level core (`write_*`/`read_*`:
pixels in, a file object out, and the reverse) under the file edge
(`encode_*`/`decode_*`: image paths, PIL inside), so the cores run
without PIL and write the same bytes. Reads are exact and bounded by the
bytes actually left, because every length and shape field comes from
outside the program.

Usage:
  lmic-torch-codec encode img.png -o out.bin --arch mbt2018 -q 3 \
      [--container reference] [--device cpu]
  lmic-torch-codec decode out.bin -o rec.png [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import struct
import sys
import time
from pathlib import Path

import numpy as np
import torch

from lmic_tpu_torch.utils.eval_model import load_image

# The magic doubles as a layout version: bumped whenever the header layout
# changes, so files of an older layout are rejected instead of misparsed.
# 0x1C1D: the RGB-T header grew a master-channel byte and padding became
# centred (the reference's convention).
MAGIC = 0x1C1D
# earlier layouts, recognized only to fail loudly (the auto-detect would
# otherwise misparse them as reference-container files)
RETIRED_MAGICS = {0x1C1C}
MODEL_IDS = {
    "bmshj2018-factorized": 0,
    "bmshj2018-hyperprior": 1,
    "mbt2018-mean": 2,
    "mbt2018": 3,
    "cheng2020-anchor": 4,
    "cheng2020-attn": 5,
    "guided": 6,
    "master": 7,
    "ssf2020": 8,
}
ID_TO_MODEL = {v: k for k, v in MODEL_IDS.items()}
METRIC_IDS = {"mse": 0, "ms-ssim": 1}
# the reference app's ids: its `models` dict in enumeration order
# (codec_rgbt.py:71-72)
REF_MODEL_IDS = {
    "bmshj2018-factorized": 0,
    "bmshj2018-hyperprior": 1,
    "mbt2018-mean": 2,
    "mbt2018": 3,
    "cheng2020-anchor": 4,
    "cheng2020-attn": 5,
    "ssf2020": 6,
    "master": 7,
    "guided": 8,
}
REF_ID_TO_MODEL = {v: k for k, v in REF_MODEL_IDS.items()}
# the image archs the reference container writes, ssf2020 beside them (the
# master has its own path)
REF_INTEROP_ARCHS = {
    "bmshj2018-factorized", "bmshj2018-hyperprior", "mbt2018-mean",
    "mbt2018", "cheng2020-anchor", "cheng2020-attn",
    "ssf2020",
}
SIDE = 64  # beta and gamma: the channel aligner's width

# latent shape dims are bounded at 2^16 (a >4M-pixel image side)
_MAX_SHAPE = 1 << 16


def _read_exact(f, n):
    buf = f.read(n)
    if len(buf) != n:
        raise ValueError(
            f"corrupt container: wanted {n} bytes, file ends after "
            f"{len(buf)}"
        )
    return buf


def _read_stream(f, ln):
    pos = f.tell()
    end = f.seek(0, 2)
    f.seek(pos)
    if ln > end - pos:
        raise ValueError(
            f"corrupt container: stream length {ln} exceeds the "
            f"{end - pos} bytes left in the file"
        )
    return _read_exact(f, ln)


def _check_shape(shape):
    if any(not 0 < s <= _MAX_SHAPE for s in shape):
        raise ValueError(f"corrupt container: implausible shape {shape}")
    return shape


def write_uchars(f, values):
    f.write(struct.pack(f">{len(values)}B", *values))


def read_uchars(f, n):
    return struct.unpack(f">{n}B", _read_exact(f, n))


def write_uints(f, values):
    f.write(struct.pack(f">{len(values)}I", *values))


def read_uints(f, n):
    return struct.unpack(f">{n}I", _read_exact(f, 4 * n))


def write_floats(f, values):
    f.write(struct.pack(f">{len(values)}f", *values))


def read_floats(f, n):
    return struct.unpack(f">{n}f", _read_exact(f, 4 * n))


def write_body(f, shape, string_groups):
    write_uints(f, (shape[0], shape[1]))
    write_uchars(f, (len(string_groups),))
    for group in string_groups:
        write_uchars(f, (len(group),))
        for s in group:
            write_uints(f, (len(s),))
            f.write(s)


def read_body(f):
    shape = _check_shape(read_uints(f, 2))
    (n_groups,) = read_uchars(f, 1)
    groups = []
    for _ in range(n_groups):
        (n,) = read_uchars(f, 1)
        group = []
        for _ in range(n):
            (ln,) = read_uints(f, 1)
            group.append(_read_stream(f, ln))
        groups.append(group)
    return shape, groups


def write_body_ref(f, shape, string_groups):
    write_uints(f, (shape[0], shape[1], len(string_groups)))
    for group in string_groups:
        if len(group) != 1:
            raise ValueError("the reference container holds one image")
        write_uints(f, (len(group[0]),))
        f.write(group[0])


def read_body_ref(f):
    h, w, n = read_uints(f, 3)
    _check_shape((h, w))
    if n > 255:  # the reference writes a few streams a body
        raise ValueError(f"corrupt container: implausible stream count {n}")
    return (h, w), [
        [_read_stream(f, read_uints(f, 1)[0])] for _ in range(n)
    ]


def _mq(metric, quality):
    return (METRIC_IDS[metric] << 4) | (quality - 1)


def _is_ar(codec) -> bool:
    """Whether `codec` has the AR symbol orders (mbt2018, cheng2020)."""
    from lmic_tpu_torch.models.joint import JointARCodec

    return isinstance(codec, JointARCodec)


def pad_to(x, p=64):
    """Centred zero pad of (1, H, W, C) to a multiple of p (the
    reference's convention, codec_rgbt.py:279-293)."""
    H, W = x.shape[1:3]
    nh, nw = -(-H // p) * p, -(-W // p) * p
    left, top = (nw - W) // 2, (nh - H) // 2
    return np.pad(
        x, ((0, 0), (top, nh - H - top), (left, nw - W - left), (0, 0))
    ), (H, W)


def crop_center(x, H, W):
    """Centred crop back to (H, W), the inverse of pad_to
    (codec_rgbt.py:296-308)."""
    Hp, Wp = x.shape[1:3]
    top, left = (Hp - H) // 2, (Wp - W) // 2
    return x[:, top:top + H, left:left + W]


# ---------------------------------------------------------------------------
# Array-level cores: (1, H, W, C) float pixels in [0, 1] <-> a file object
# ---------------------------------------------------------------------------


def write_image(f, x, codec, arch, quality, metric="mse"):
    """The native container of image `x`, centre-padded to 64."""
    xp, (H, W) = pad_to(x)
    out = codec.compress(xp)
    write_uints(f, (MAGIC,))
    write_uchars(f, (MODEL_IDS[arch], _mq(metric, quality)))
    write_uints(f, (H, W))
    write_uchars(f, (8,))  # bitdepth
    write_body(f, out["shape"], out["strings"])


def read_image(f, make_codec):
    """A native image file from its start -> (x_hat (1, H, W, C) in
    [0, 1], arch, quality); `make_codec(arch, quality)` builds the
    codec."""
    (magic,) = read_uints(f, 1)
    if magic != MAGIC:
        raise ValueError(f"corrupt container: magic 0x{magic:08X}")
    model_id, mq = read_uchars(f, 2)
    quality = (mq & 0x0F) + 1
    arch = ID_TO_MODEL.get(model_id)
    if arch is None:
        raise ValueError(f"corrupt container: model id {model_id}")
    H, W = _check_shape(read_uints(f, 2))
    read_uchars(f, 1)  # bitdepth
    shape, strings = read_body(f)
    rec = make_codec(arch, quality).decompress(strings, shape)
    return crop_center(rec["x_hat"], H, W), arch, quality


def write_image_ref(f, x, codec, arch, quality, metric="mse"):
    """A file the reference app's decode_image reads byte for byte. As in
    the reference encoder (codec_rgbt.py:355, its pad call commented out)
    the image is coded unpadded: its sides must be multiples of 64. The
    AR codecs write the reference's raster symbol order; the non-AR
    family's order is the reference's already."""
    H, W = x.shape[1:3]
    if H % 64 or W % 64:
        raise SystemExit(
            "reference container encodes unpadded images; dimensions must "
            f"be multiples of 64 (got {H}x{W})"
        )
    out = (codec.compress(x, order="raster") if _is_ar(codec)
           else codec.compress(x))
    write_uchars(f, (REF_MODEL_IDS[arch], _mq(metric, quality)))
    write_uints(f, (H, W))
    write_uchars(f, (8,))
    write_body_ref(f, out["shape"], out["strings"])


def read_image_ref(f, make_codec, arch, quality):
    """A reference image file after its two id bytes -> x_hat (1, H, W,
    C) in [0, 1]."""
    H, W = _check_shape(read_uints(f, 2))
    read_uchars(f, 1)  # bitdepth
    shape, strings = read_body_ref(f)
    codec = make_codec(arch, quality)
    rec = (codec.decompress(strings, shape, order="raster")
           if _is_ar(codec) else codec.decompress(strings, shape))
    return crop_center(rec["x_hat"], H, W)


def _code_guide(guided_codec, guided):
    """The guide's reconstruction and decoder maps from its one-pass
    reconstruct, equal bit for bit to a decode of its streams."""
    g_out = guided_codec.compress(guided, hidden=False, reconstruct=True)
    return {"x_hat": g_out["x_hat"], "hidden": g_out["hidden_dec"]}


def _beta_gamma(m_out):
    return (np.asarray(m_out["beta"], np.float32).reshape(-1).tolist(),
            np.asarray(m_out["gamma"], np.float32).reshape(-1).tolist())


def _encode_master(x, guided, guided_codec, master_codec, order):
    try:
        master_codec.check_geometry(*x.shape[1:3], tuple(guided.shape[1:3]),
                                    guide_what="guide image")
    except ValueError as e:
        raise SystemExit(str(e))
    g = _code_guide(guided_codec, guided)
    return master_codec.compress(x, g["x_hat"], order=order)


def write_rgbt(f, x, guided, guided_codec, master_codec, quality,
               metric="mse", channel=1):
    """The native master container: the master `x` (`channel` channels)
    coded against the guide's reconstruction (the complementary 4 -
    channel modality), beta/gamma in the header (codec_rgbt.py:328-386).
    The channel byte lets decoding rebuild the same pair whatever the
    decoder's --channel."""
    m_out = _encode_master(x, guided, guided_codec, master_codec,
                           "wavefront")
    beta, gamma = _beta_gamma(m_out)
    write_uints(f, (MAGIC,))
    write_uchars(f, (MODEL_IDS["master"], _mq(metric, quality)))
    write_uints(f, (x.shape[1], x.shape[2]))
    write_uchars(f, (8, channel))
    write_floats(f, beta)
    write_floats(f, gamma)
    write_body(f, m_out["shape"], m_out["strings"])


def _decode_master(H, W, channel, beta, gamma, shape, strings, load_guide,
                   build_guided, build_master, order):
    guided_codec = build_guided(4 - channel)
    master_codec = build_master(channel)
    # the header's geometry on its own first: a corrupt or foreign stream
    # is blamed on the stream, not on the guide image
    try:
        gH, gW = master_codec.check_geometry(H, W)
    except ValueError as e:
        raise SystemExit(f"corrupt or incompatible RGBT bitstream: {e}")
    guided = load_guide(4 - channel)
    if tuple(guided.shape[1:3]) != (gH, gW):
        raise SystemExit(
            f"guide image must be {gH}x{gW} for this {H}x{W} master "
            f"bitstream at channel={channel}; got "
            f"{guided.shape[1]}x{guided.shape[2]} — use the guide the "
            "stream was encoded with (or a same-size copy)"
        )
    rec = master_codec.decompress(
        {"strings": strings, "shape": shape, "beta": beta, "gamma": gamma},
        _code_guide(guided_codec, guided), order=order,
    )
    return crop_center(rec["x_hat"], H, W)


def _side(f):
    return (np.asarray(read_floats(f, SIDE), np.float32),
            np.asarray(read_floats(f, SIDE), np.float32))


def read_rgbt(f, load_guide, build_guided, build_master):
    """A native master file from its start -> x_hat (1, H, W, C) in
    [0, 1]. The decoder codes the guide from its own image
    (codec_rgbt.py:538-544): `load_guide(channels)` gives it as (1, H, W,
    C) pixels; `build_guided`/`build_master` are channel -> codec
    factories, the master's channel count read from the header."""
    (magic,) = read_uints(f, 1)
    if magic != MAGIC:
        raise ValueError(f"corrupt container: magic 0x{magic:08X}")
    read_uchars(f, 2)  # model id, metric and quality
    H, W = _check_shape(read_uints(f, 2))
    _, channel = read_uchars(f, 2)
    if channel not in (1, 3):
        raise ValueError(f"corrupt container: master channel {channel}")
    beta, gamma = _side(f)
    shape, strings = read_body(f)
    return _decode_master(H, W, channel, beta, gamma, shape, strings,
                          load_guide, build_guided, build_master,
                          "wavefront")


def write_rgbt_ref(f, x, guided, guided_codec, master_codec, quality,
                   metric="mse", channel=1):
    """The reference master container (codec_rgbt.py:328-386): its bare
    header, (h, w), bitdepth, 64 beta + 64 gamma floats and the body, the
    master's AR streams in the raster order. The guide is coded on both
    sides and never stored, as in the reference app."""
    m_out = _encode_master(x, guided, guided_codec, master_codec, "raster")
    beta, gamma = _beta_gamma(m_out)
    write_uchars(f, (REF_MODEL_IDS["master"], _mq(metric, quality)))
    write_uints(f, (x.shape[1], x.shape[2]))
    write_uchars(f, (8,))
    write_floats(f, beta)
    write_floats(f, gamma)
    write_body_ref(f, m_out["shape"], m_out["strings"])


def read_rgbt_ref(f, load_guide, build_guided, build_master, channel=1):
    """A reference master file after its two id bytes -> x_hat. The
    reference header does not carry the master's channel count (its app
    takes it from the command line, codec_rgbt.py:511-524): `channel` must
    be the encoder's."""
    H, W = _check_shape(read_uints(f, 2))
    read_uchars(f, 1)  # bitdepth
    beta, gamma = _side(f)
    shape, strings = read_body_ref(f)
    return _decode_master(H, W, channel, beta, gamma, shape, strings,
                          load_guide, build_guided, build_master, "raster")


# ---------------------------------------------------------------------------
# The file edge: image paths (PIL inside)
# ---------------------------------------------------------------------------


def _to_u8(arr) -> np.ndarray:
    """(1, H, W, C) float -> (H, W[, C]) uint8. nan_to_num: a corrupt
    stream decodes to garbage symbols and can reach the transforms as NaN;
    black pixels, not a cast warning."""
    arr = np.clip(np.nan_to_num(np.asarray(arr)[0]) * 255.0 + 0.5, 0, 255
                  ).astype(np.uint8)
    return arr[..., 0] if arr.shape[-1] == 1 else arr


def _save(arr, path):
    from PIL import Image

    Image.fromarray(_to_u8(arr)).save(path)


def encode_image(input_path, output_path, codec, arch, quality,
                 metric="mse"):
    with open(output_path, "wb") as f:
        write_image(f, load_image(input_path), codec, arch, quality, metric)
    return Path(output_path).stat().st_size


def decode_image(input_path, output_path, make_codec):
    with open(input_path, "rb") as f:
        x_hat, arch, quality = read_image(f, make_codec)
    _save(x_hat, output_path)
    return arch, quality


def encode_image_ref(input_path, output_path, codec, arch, quality,
                     metric="mse"):
    x = load_image(input_path)
    with open(output_path, "wb") as f:
        write_image_ref(f, x, codec, arch, quality, metric)
    return Path(output_path).stat().st_size


def decode_image_ref(f, output_path, make_codec, arch, quality):
    _save(read_image_ref(f, make_codec, arch, quality), output_path)


def encode_rgbt(master_path, guide_path, output_path, guided_codec,
                master_codec, quality, metric="mse", channel=1):
    """`channel` is the master's channel count; the guide is the
    complementary modality (the eval CLI's convention)."""
    x = load_image(master_path, channel=channel)
    guided = load_image(guide_path, channel=4 - channel)
    with open(output_path, "wb") as f:
        write_rgbt(f, x, guided, guided_codec, master_codec, quality, metric,
                   channel)
    return Path(output_path).stat().st_size


def decode_rgbt(input_path, guide_path, output_path, build_guided,
                build_master):
    with open(input_path, "rb") as f:
        x_hat = read_rgbt(f, lambda ch: load_image(guide_path, ch), build_guided,
                          build_master)
    _save(x_hat, output_path)


def encode_rgbt_ref(master_path, guide_path, output_path, guided_codec,
                    master_codec, quality, metric="mse", channel=1):
    x = load_image(master_path, channel=channel)
    guided = load_image(guide_path, channel=4 - channel)
    with open(output_path, "wb") as f:
        write_rgbt_ref(f, x, guided, guided_codec, master_codec, quality,
                       metric, channel)
    return Path(output_path).stat().st_size


def decode_rgbt_ref(f, guide_path, output_path, build_guided, build_master,
                    channel=1):
    _save(read_rgbt_ref(f, lambda ch: load_image(guide_path, ch), build_guided,
                        build_master, channel), output_path)


# ---------------------------------------------------------------------------
# Video: raw YUV420 in and out, no PIL
# ---------------------------------------------------------------------------


def code_frames(codec, seq, n):
    """ssf2020's frame chain over the first `n` frames of a raw sequence,
    one reference chain over the whole sequence: yields (the clipped
    in-loop reconstruction (1, 3, H, W) on the device, the frame's coded
    output), the keyframe's a body, an inter frame's "motion" and
    "residual" ones."""
    from lmic_tpu_torch.utils.video_eval import pad_frames, yuv420_frame_to_rgb

    x_ref = None
    for i in range(n):
        x, _ = pad_frames(yuv420_frame_to_rgb(seq[i], seq.bitdepth,
                                              codec.device), p=128)
        x = x.permute(0, 3, 1, 2)  # channels_last, as codec._frames
        if i == 0:
            x_ref, out = codec.encode_keyframe(x)
        else:
            x_ref, out = codec.encode_inter(x, x_ref)
        x_ref = torch.clamp(x_ref, 0.0, 1.0)
        yield x_ref, out


def encode_video(input_path, output_path, codec, quality, metric="mse",
                 num_frames: int = -1, container: str = "native"):
    """ssf2020 file coding of a raw YUV420 sequence (codec_rgbt.py:
    389-450). container="reference" writes the reference's bare header
    and body layout (byte-compatible with its decode_video)."""
    from lmic_tpu_torch.datasets.rawvideo import RawVideoSequence, VideoFormat

    ref = container == "reference"
    body_writer = write_body_ref if ref else write_body
    seq = RawVideoSequence.from_file(str(input_path))
    try:
        if seq.video_format != VideoFormat.YUV420:
            raise NotImplementedError(
                f"unsupported format: {seq.video_format}")
        n = len(seq) if num_frames < 0 else min(num_frames, len(seq))
        with open(output_path, "wb") as f:
            if not ref:
                write_uints(f, (MAGIC,))
            write_uchars(f, ((REF_MODEL_IDS if ref else MODEL_IDS)["ssf2020"],
                             _mq(metric, quality)))
            write_uints(f, (seq.height, seq.width))
            write_uchars(f, (seq.bitdepth,))
            write_uints(f, (n,))
            for i, (_, out) in enumerate(code_frames(codec, seq, n)):
                if i == 0:
                    body_writer(f, out["shape"], out["strings"])
                else:
                    for part in ("motion", "residual"):
                        body_writer(f, out["shape"][part],
                                    out["strings"][part])
    finally:
        seq.close()
    return Path(output_path).stat().st_size


def encode_video_ref(input_path, output_path, codec, quality, metric="mse",
                     num_frames: int = -1):
    """The reference video container (codec_rgbt.py:389-450)."""
    return encode_video(input_path, output_path, codec, quality, metric,
                        num_frames, container="reference")


def _rgb_to_yuv420_planes(rgb: torch.Tensor, bitdepth=8):
    """(1, H, W, 3) float RGB -> (y, u, v) integer numpy planes (BT.709,
    2x2 average-pool chroma, as the reference's convert_rgb_yuv420)."""
    from lmic_tpu_torch.transforms import rgb2ycbcr, yuv_444_to_420

    max_val = 2**bitdepth - 1
    dtype = np.uint8 if bitdepth == 8 else np.uint16
    return tuple(
        torch.clamp(torch.round(t[0, :, :, 0] * max_val), 0, max_val)
        .cpu().numpy().astype(dtype)
        for t in yuv_444_to_420(rgb2ycbcr(rgb))
    )


def decode_video(f, output_path, make_codec, quality,
                 body_reader=read_body):
    """Mirror of encode_video from after the two id bytes (and the magic);
    writes the reconstruction as raw YUV420 (or the last frame as an image
    for other outputs). `body_reader` is the container's body layout."""
    H, W = _check_shape(read_uints(f, 2))
    (bitdepth,) = read_uchars(f, 1)
    (n,) = read_uints(f, 1)
    if n > 1_000_000:
        raise ValueError(f"corrupt container: implausible frame count {n}")
    codec = make_codec("ssf2020", quality)
    out_is_yuv = str(output_path).endswith(".yuv")
    img = None
    with (open(output_path, "wb") if out_is_yuv
          else contextlib.nullcontext()) as fout:
        for i in range(n):
            if i == 0:
                shape, strings = body_reader(f)
                x_ref = codec.decode_keyframe(strings, shape)
            else:
                mshape, mstrings = body_reader(f)
                rshape, rstrings = body_reader(f)
                x_ref = codec.decode_inter(
                    x_ref, {"motion": mstrings, "residual": rstrings},
                    {"motion": mshape, "residual": rshape})
            x_ref = torch.clamp(x_ref, 0.0, 1.0)
            img = crop_center(x_ref.permute(0, 2, 3, 1), H, W)
            if out_is_yuv:
                for plane in _rgb_to_yuv420_planes(img, bitdepth):
                    plane.tofile(fout)
    if not out_is_yuv and img is not None:
        _save(img.cpu().numpy(), output_path)
    return n


def decode_video_ref(f, output_path, make_codec, quality):
    """Mirror of encode_video_ref, the reference's decode_video."""
    return decode_video(f, output_path, make_codec, quality,
                        body_reader=read_body_ref)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def parse_args(argv):
    p = argparse.ArgumentParser("lmic-torch-codec",
                                description="lmic_tpu_torch file codec")
    sub = p.add_subparsers(dest="command", required=True)
    e = sub.add_parser("encode")
    e.add_argument("input", help="image, .yuv sequence (ssf2020), or the "
                                 "master image when --guide is given")
    e.add_argument("-o", "--output", default="out.bin")
    e.add_argument("--arch", default="bmshj2018-factorized")
    e.add_argument("-q", "--quality", type=int, default=1)
    e.add_argument("--checkpoint", default=None)
    e.add_argument("--frames", type=int, default=-1,
                   help="ssf2020: number of frames to code (-1 = all)")
    e.add_argument("--guide", default=None,
                   help="RGBT: guide-image path (arch becomes master)")
    e.add_argument("--guided-checkpoint", default=None,
                   help="RGBT: deployment checkpoint for the guide codec")
    e.add_argument("--channel", type=int, default=1,
                   help="RGBT: master channel count")
    e.add_argument("--container", choices=["lmic", "reference"],
                   default="lmic",
                   help="bitstream container: this framework's (default) "
                        "or the reference codec app's byte-compatible "
                        "layout (codec_rgbt.py:188-249). Decode "
                        "auto-detects.")
    d = sub.add_parser("decode")
    d.add_argument("input")
    d.add_argument("-o", "--output", default="out.png",
                   help="image path, or .yuv for video bitstreams")
    d.add_argument("--checkpoint", default=None)
    d.add_argument("--guide", default=None,
                   help="RGBT: guide-image path (the master file does not "
                        "embed the guide bitstream; codec_rgbt.py:538-544)")
    d.add_argument("--guided-checkpoint", default=None)
    # --channel matters only for reference-container master files, whose
    # header does not record the master's channel count (its app takes it
    # from the command line, codec_rgbt.py:511-524); native master files
    # carry a channel byte
    d.add_argument("--channel", type=int, default=1,
                   help="reference-container master files: the master "
                        "channel count used at encode (1=thermal master)")
    for s in (e, d):
        s.add_argument("--device", default=None,
                       help="torch device (default: CUDA; raises without a "
                            "GPU unless 'cpu' is given)")
    return p.parse_args(argv)


def _build(arch, quality, checkpoint=None, channel=3, device=None):
    """The codec of `arch` at `quality` on `device`: a deployment
    checkpoint's params and tables, or seed 0's weights and fresh
    tables."""
    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.utils.checkpoint import load_updated_model

    if arch == "ssf2020":
        codec = zoo.create_video_model("ssf2020", quality, device=device)
    else:
        codec = zoo.create_model(arch, quality, channel=channel,
                                 device=device)
    if checkpoint:
        return load_updated_model(checkpoint, codec)
    codec.update(force=True)
    return codec


def _encode(args):
    reference = args.container == "reference"
    dev = args.device
    if args.guide is not None or args.arch == "master":
        if args.guide is None:
            raise SystemExit("encode --arch master requires --guide")
        guided = _build("guided", args.quality, args.guided_checkpoint,
                        4 - args.channel, dev)
        master = _build("master", args.quality, args.checkpoint,
                        args.channel, dev)
        enc = encode_rgbt_ref if reference else encode_rgbt
        return enc(args.input, args.guide, args.output, guided, master,
                   args.quality, channel=args.channel)
    if args.arch == "ssf2020":
        codec = _build("ssf2020", args.quality, args.checkpoint, device=dev)
        enc = encode_video_ref if reference else encode_video
        return enc(args.input, args.output, codec, args.quality,
                   num_frames=args.frames)
    if args.arch not in MODEL_IDS:
        raise SystemExit(
            f"arch {args.arch!r} has no container id; file coding "
            f"supports: {', '.join(sorted(MODEL_IDS))}"
        )
    if reference and args.arch not in REF_INTEROP_ARCHS:
        raise SystemExit(
            "reference container supports the byte-interop family "
            f"only: {', '.join(sorted(REF_INTEROP_ARCHS))}"
        )
    codec = _build(args.arch, args.quality, args.checkpoint, device=dev)
    enc = encode_image_ref if reference else encode_image
    return enc(args.input, args.output, codec, args.arch, args.quality)


def _decode(args):
    """Decode with the container auto-detected: the native one leads with
    a u32 magic; the reference's first byte is a small model id whose
    following bytes parse as (h, w), far below the magic."""
    dev = args.device

    def make_codec(a, q):
        return _build(a, q, args.checkpoint, device=dev)

    def pair(quality):
        return (lambda ch: _build("guided", quality, args.guided_checkpoint,
                                  ch, dev),
                lambda ch: _build("master", quality, args.checkpoint, ch,
                                  dev))

    with open(args.input, "rb") as f:
        head = f.read(4)
        word = struct.unpack(">I", head)[0] if len(head) == 4 else None
        if word in RETIRED_MAGICS:
            raise SystemExit(
                f"{args.input}: written by an older lmic-codec container "
                f"version (magic 0x{word:04X}); re-encode with this version"
            )
        if word == MAGIC:
            model_id, mq = read_uchars(f, 2)
            quality = (mq & 0x0F) + 1
            arch = ID_TO_MODEL.get(model_id)
            if arch == "ssf2020":
                decode_video(f, args.output, make_codec, quality)
                return arch, quality
        else:  # the reference container
            f.seek(0)
            model_id, mq = read_uchars(f, 2)
            quality = (mq & 0x0F) + 1
            arch = REF_ID_TO_MODEL.get(model_id)
            if arch not in REF_INTEROP_ARCHS | {"master"}:
                raise SystemExit(
                    f"reference-container arch {arch!r} is outside the "
                    "interop family: "
                    f"{', '.join(sorted(REF_INTEROP_ARCHS))}, master"
                )
            if arch == "master" and args.guide is None:
                raise SystemExit("decoding a master file requires --guide")
            if arch == "ssf2020":
                decode_video_ref(f, args.output, make_codec, quality)
            elif arch == "master":
                decode_rgbt_ref(f, args.guide, args.output, *pair(quality),
                                channel=args.channel)
            else:
                decode_image_ref(f, args.output, make_codec, arch, quality)
            return arch, quality
    if arch == "master":
        if args.guide is None:
            raise SystemExit("decoding a master file requires --guide")
        decode_rgbt(args.input, args.guide, args.output, *pair(quality))
    else:
        arch, quality = decode_image(args.input, args.output, make_codec)
    return arch, quality


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    t0 = time.perf_counter()
    if args.command == "encode":
        size = _encode(args)
        print(f"encoded {size} bytes in {time.perf_counter() - t0:.2f}s")
        return
    try:
        arch, quality = _decode(args)
    except ValueError as e:
        # the container's read guards raise ValueError with a "corrupt
        # container" message: a clean CLI error, not a traceback
        if "corrupt container" not in str(e):
            raise
        raise SystemExit(f"{args.input}: {e}")
    print(f"decoded [{arch} q={quality}] in {time.perf_counter() - t0:.2f}s")


if __name__ == "__main__":
    main()
