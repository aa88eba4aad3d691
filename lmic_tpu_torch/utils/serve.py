"""HTTP serving of an image or video codec's uint8 path, and of the RGB-T
pair.

Counterpart of lmic_tpu/utils/serve.py, with the same wire format
(big-endian, framed by utils/codec_cli.py):

  POST /compress   request : u8 ndim, ndim x u32 dims, raw uint8 pixels
                             (video: a (B, T, H, W, 3) GOP)
                   response: image -> one body (write_body: u32 h, w; u8
                             n_groups; per group u8 n, per string u32 len
                             + bytes); video -> u32 n_frames, then per
                             frame a u8 body count and 1 body (keyframe)
                             or 2 (inter: motion, residual)
  POST /decompress request : the /compress response, echoed back
                   response: u8 ndim, ndim x u32 dims, raw uint8 pixels
  GET  /meta       response: JSON meta

The RGB-T pair (family "rgbt", `codec` a (guided, master) pair, one image
a request): /compress takes two pixel blocks, the master then the guide,
and returns the master's body + 64 f32 beta + 64 f32 gamma (the guide's
stream is not sent: the decoder codes the guide from its own source);
/decompress takes that payload with the guide's pixel block appended and
returns the master's pixels. Both legs code the guide with its one-pass
reconstruct; a content-keyed LRU of `LMIC_SERVE_GUIDE_CACHE` guides
(default 2, 0 turns it off) skips the second.

Any failure of a request maps to a 400 with the error's text. Requests are
serialized through one lock around the codec work (socket reads and
writes stay outside it). `main --checkpoint <file> -a <arch>` serves a
deployment checkpoint that `utils/checkpoint.py::update_model_file` wrote
(`SERVABLE_ARCHS`); `-a master --checkpoint <master> --guided-checkpoint
<guide> --channel <1|3>` serves the RGB-T pair from its two finalized
checkpoints; `--bundle <dir>` serves a serving bundle (utils/aot.py:
`load_serving_bundle`, whose meta the server returns on GET /meta) on
`--device`, which must be the device the bundle was exported on.
"""

from __future__ import annotations

import collections
import hashlib
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from lmic_tpu_torch.utils.codec_cli import (
    SIDE,
    read_body,
    read_floats,
    read_uchars,
    read_uints,
    write_body,
    write_floats,
    write_uchars,
    write_uints,
)

__all__ = ["make_server", "load_checkpoint_codec", "load_rgbt_codecs",
           "main"]

def _write_pixels(f, arr):
    write_uchars(f, (arr.ndim,))
    write_uints(f, arr.shape)
    f.write(arr.tobytes())


def _read_pixels(f):
    (ndim,) = read_uchars(f, 1)
    shape = read_uints(f, ndim)
    n = int(np.prod(shape))
    buf = f.read(n)
    if len(buf) != n:
        raise ValueError(f"expected {n} pixel bytes, got {len(buf)}")
    return np.frombuffer(buf, np.uint8).reshape(shape)


def _encode_response(out, video):
    f = io.BytesIO()
    if video:
        # per GOP frame: keyframe -> one body; inter -> motion + residual
        strings, shapes = out
        write_uints(f, (len(strings),))
        for frame_strings, frame_shape in zip(strings, shapes):
            if isinstance(frame_strings, dict):
                write_uchars(f, (2,))
                for part in ("motion", "residual"):
                    write_body(f, frame_shape[part], frame_strings[part])
            else:
                write_uchars(f, (1,))
                write_body(f, frame_shape, frame_strings)
    else:
        write_body(f, out["shape"], out["strings"])
    return f.getvalue()


def _decode_request(f, video):
    """A /decompress body -> (strings, shapes) for the codec."""
    if not video:
        shape, groups = read_body(f)
        return groups, shape
    (n_frames,) = read_uints(f, 1)
    strings, shapes = [], []
    for _ in range(n_frames):
        (n_bodies,) = read_uchars(f, 1)
        if n_bodies == 2:
            mshape, mstrings = read_body(f)
            rshape, rstrings = read_body(f)
            strings.append({"motion": mstrings, "residual": rstrings})
            shapes.append({"motion": mshape, "residual": rshape})
        elif n_bodies == 1:
            shape, groups = read_body(f)
            strings.append(groups)
            shapes.append(shape)
        else:
            raise ValueError(f"a frame has 1 or 2 bodies, not {n_bodies}")
    return strings, shapes


def _codec_handlers(codec, video):
    """compress/decompress closures for one image or video codec."""

    def compress(f):
        return _encode_response(codec.compress(_read_pixels(f)), video)

    def decompress(f):
        strings, shapes = _decode_request(f, video)
        rec = codec.decompress(strings, shapes, u8=True)
        buf = io.BytesIO()
        _write_pixels(buf, np.asarray(rec if video else rec["x_hat"]))
        return buf.getvalue()

    return compress, decompress


def _rgbt_handlers(guided_codec, master_codec):
    """compress/decompress closures for the RGB-T pair."""

    def one_image(pix):
        if pix.shape[0] != 1:
            raise ValueError(
                f"RGBT serving is single-image (B=1); got B={pix.shape[0]}"
            )
        return pix

    # The decompress leg codes the same guide the compress leg just coded;
    # the entries hold device tensors (x_hat and the gs* maps), hence few.
    # Handlers run under the server lock.
    cache_n = int(os.environ.get("LMIC_SERVE_GUIDE_CACHE", "2"))
    guide_cache = collections.OrderedDict()

    def run_guide(guide_u8):
        # keyed on the wire's uint8 pixels by SHA-256: request pixels come
        # from outside, and a collision would reconstruct against the
        # wrong guide
        key = None
        if cache_n > 0:
            key = (guide_u8.shape,
                   hashlib.sha256(guide_u8.tobytes()).hexdigest())
            hit = guide_cache.get(key)
            if hit is not None:
                guide_cache.move_to_end(key)
                return hit
        g_out = guided_codec.compress(one_image(guide_u8), hidden=False,
                                      reconstruct=True)
        g_dec = {"x_hat": g_out["x_hat"], "hidden": g_out["hidden_dec"]}
        if key is not None:
            guide_cache[key] = g_dec
            while len(guide_cache) > cache_n:
                guide_cache.popitem(last=False)
        return g_dec

    def compress(f):
        x = one_image(_read_pixels(f))
        guide_u8 = _read_pixels(f)
        # validate before the guide's coding runs under the server lock
        master_codec.check_geometry(
            int(x.shape[1]), int(x.shape[2]),
            tuple(map(int, guide_u8.shape[1:3])), guide_what="guide image",
        )
        m_out = master_codec.compress(x, run_guide(guide_u8)["x_hat"])
        beta = np.asarray(m_out["beta"], np.float32).reshape(-1)
        gamma = np.asarray(m_out["gamma"], np.float32).reshape(-1)
        if beta.size != SIDE or gamma.size != SIDE:
            raise ValueError(f"expected {SIDE}+{SIDE} beta/gamma floats, "
                             f"got {beta.size}+{gamma.size}")
        out = io.BytesIO()
        write_body(out, m_out["shape"], m_out["strings"])
        write_floats(out, beta.tolist())
        write_floats(out, gamma.tolist())
        return out.getvalue()

    def decompress(f):
        shape, strings = read_body(f)
        beta = np.asarray(read_floats(f, SIDE), np.float32)
        gamma = np.asarray(read_floats(f, SIDE), np.float32)
        guide_u8 = _read_pixels(f)
        # the body's z shape pins the master's geometry (H = z * factor)
        factor = master_codec.module.downsampling_factor
        master_codec.check_geometry(
            int(shape[0]) * factor, int(shape[1]) * factor,
            tuple(map(int, guide_u8.shape[1:3])), guide_what="guide image",
        )
        rec = master_codec.decompress(
            {"strings": strings, "shape": shape, "beta": beta,
             "gamma": gamma},
            run_guide(guide_u8), u8=True,
        )
        out = io.BytesIO()
        _write_pixels(out, rec["x_hat"])
        return out.getvalue()

    return compress, decompress


def load_rgbt_codecs(quality, channel=1, seed=0, device=None,
                     guided_checkpoint=None, master_checkpoint=None,
                     **widths):
    """The (guided, master) pair for RGB-T serving: the master takes
    `channel` channels, the guide the complementary 4 - channel. From the
    two finalized checkpoints when they are given (through
    `codec_cli._build`, as lmic_tpu/utils/serve.py:370-384 builds them),
    else with weights drawn from `seed` and fresh coding tables, `widths`
    (N=, M=) overriding the quality table's."""
    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.utils.codec_cli import _build

    if guided_checkpoint or master_checkpoint:
        guided = _build("guided", quality, guided_checkpoint, 4 - channel,
                        device)
        master = _build("master", quality, master_checkpoint, channel,
                        device)
    else:
        guided = zoo.create_model("guided", quality, seed=seed,
                                  channel=4 - channel, device=device,
                                  **widths)
        master = zoo.create_model("master", quality, seed=seed,
                                  channel=channel, device=device, **widths)
        guided.update()
        master.update()
    meta = {"family": "rgbt", "input_shape": None, "channel": channel,
            "quality": quality}
    return (guided, master), meta


# archs with a standalone compress(x)/decompress(..., u8=True) surface
# (lmic_tpu/utils/serve.py:336-339); the RGB-T archs need side inputs
SERVABLE_ARCHS = {
    "bmshj2018-factorized", "bmshj2018-hyperprior", "mbt2018-mean",
    "mbt2018", "cheng2020-anchor", "cheng2020-attn", "ssf2020",
}


def load_checkpoint_codec(checkpoint, arch, quality=1, device=None):
    """The serving codec for --checkpoint: the zoo's codec for `arch` with
    the deployment checkpoint's params and coding tables, and its meta."""
    if arch not in SERVABLE_ARCHS:
        raise SystemExit(
            f"{arch} is not servable (needs side inputs or has no uint8 "
            f"decode path); servable: {sorted(SERVABLE_ARCHS)}")
    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.utils.checkpoint import load_updated_model

    video = arch in zoo.video_architectures
    codec = (zoo.create_video_model(arch, quality, device=device) if video
             else zoo.create_model(arch, quality, device=device))
    codec = load_updated_model(checkpoint, codec)
    meta = {"family": "video" if video else "image", "input_shape": None,
            "arch": arch, "quality": quality}
    return codec, meta


def make_server(codec, meta, host="127.0.0.1", port=0):
    """Build a ThreadingHTTPServer serving `codec` (its `codec`
    attribute). `meta` is a {"family", "input_shape", ...} dict returned
    by GET /meta; family "video" serves a video codec's GOPs, family
    "rgbt" takes `codec` as a (guided, master) pair."""
    family = meta.get("family")
    if family == "rgbt":
        compress_fn, decompress_fn = _rgbt_handlers(*codec)
    else:
        compress_fn, decompress_fn = _codec_handlers(codec,
                                                     family == "video")
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *_a):  # quiet by default
            pass

        def _reply(self, code, body, ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return io.BytesIO(self.rfile.read(n))

        def do_GET(self):
            if self.path != "/meta":
                return self._reply(404, b"not found", "text/plain")
            self._reply(200, json.dumps(meta).encode(), "application/json")

        def do_POST(self):
            try:
                # drain the body BEFORE routing: on HTTP/1.1 keep-alive a
                # 404 that leaves Content-Length bytes unread would desync
                # the next request on the same socket
                body = self._body()
                fn = {"/compress": compress_fn,
                      "/decompress": decompress_fn}.get(self.path)
                if fn is None:
                    return self._reply(404, b"not found", "text/plain")
                with lock:
                    payload = fn(body)
                return self._reply(200, payload)
            except Exception as e:  # noqa: BLE001
                # any failure (malformed framing reaches the codec as
                # Value/Type/IndexError) is a protocol-valid 400
                return self._reply(
                    400, f"{type(e).__name__}: {e}".encode(), "text/plain"
                )

    server = ThreadingHTTPServer((host, port), Handler)
    server.codec = codec  # what it serves, for a caller to read its stats
    return server


def main(argv=None, started=None):
    """Serve until interrupted. `started(server)`, when given, is called
    with the bound server before it serves: a caller that runs `main` in a
    thread stops it with `server.shutdown()`."""
    import argparse

    p = argparse.ArgumentParser(
        "lmic-torch-serve",
        description="Serve a codec's uint8 path over HTTP.",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--bundle", help="serving bundle directory")
    src.add_argument("--checkpoint", help="deployment checkpoint "
                     "(utils/update_model_cli.py output)")
    p.add_argument("-a", "--arch", help="architecture (checkpoint mode); "
                                        "'master' serves the RGB-T pair")
    p.add_argument("-q", "--quality", type=int, default=1)
    p.add_argument("--guided-checkpoint",
                   help="the guided codec's deployment checkpoint (with "
                        "-a master; --checkpoint is then the master's)")
    p.add_argument("--channel", type=int, default=1,
                   help="the master's channel count for the RGB-T pair "
                        "(the guide gets the complementary modality)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8752)
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA; raises without a GPU "
                        "unless 'cpu' is given)")
    args = p.parse_args(argv)
    if args.bundle:
        from lmic_tpu_torch.utils.aot import load_serving_bundle

        codec = load_serving_bundle(args.bundle, device=args.device)
        meta = dict(codec.bundle_meta)
    elif args.arch == "master":
        if not args.guided_checkpoint:
            raise SystemExit("-a master needs --guided-checkpoint")
        if args.channel not in (1, 3):
            raise SystemExit(
                f"--channel must be 1 or 3 (the master's modality; the "
                f"guide gets the complementary one), got {args.channel}")
        codec, meta = load_rgbt_codecs(
            args.quality, args.channel, device=args.device,
            guided_checkpoint=args.guided_checkpoint,
            master_checkpoint=args.checkpoint)
    elif not args.arch:
        raise SystemExit("--checkpoint mode needs --arch")
    else:
        codec, meta = load_checkpoint_codec(args.checkpoint, args.arch,
                                            args.quality, args.device)
    server = make_server(codec, meta, args.host, args.port)
    host, port = server.server_address[:2]
    print(f"lmic-torch-serve: {meta['family']} codec on http://{host}:"
          f"{port} (POST /compress, POST /decompress, GET /meta)",
          flush=True)
    if started is not None:
        started(server)
    try:
        server.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover - interactive stop
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
