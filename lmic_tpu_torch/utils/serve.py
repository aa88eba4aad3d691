"""HTTP serving of an image codec's uint8 path.

Counterpart of lmic_tpu/utils/serve.py:62-134, 247-304, with the same wire
format (big-endian, framed by utils/codec_cli.py):

  POST /compress   request : u8 ndim, ndim x u32 dims, raw uint8 pixels
                   response: write_body (u32 h, w; u8 n_groups; per group
                             u8 n, per string u32 len + bytes)
  POST /decompress request : the /compress response, echoed back
                   response: u8 ndim, ndim x u32 dims, raw uint8 pixels
  GET  /meta       response: JSON meta

Any failure of a request maps to a 400 with the error's text. Requests are
serialized through one lock around the codec work (socket reads and
writes stay outside it). The video and RGB-T families, and the
`--bundle`/`--checkpoint` command line, are ported with later slices.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from lmic_tpu_torch.utils.codec_cli import (
    read_body,
    read_uchars,
    read_uints,
    write_body,
    write_uchars,
    write_uints,
)

__all__ = ["make_server"]

_LATER = ("is ported with a later slice of lmic_tpu_torch "
          "(ROADMAP.md, queue A)")


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


def _codec_handlers(codec):
    """compress/decompress closures for one image codec."""

    def compress(f):
        out = codec.compress(_read_pixels(f))
        buf = io.BytesIO()
        write_body(buf, out["shape"], out["strings"])
        return buf.getvalue()

    def decompress(f):
        shape, groups = read_body(f)
        rec = codec.decompress(groups, shape, u8=True)
        buf = io.BytesIO()
        _write_pixels(buf, np.asarray(rec["x_hat"]))
        return buf.getvalue()

    return compress, decompress


def make_server(codec, meta, host="127.0.0.1", port=0):
    """Build a ThreadingHTTPServer serving the image `codec`. `meta` is a
    {"family", "input_shape", ...} dict returned by GET /meta."""
    family = meta.get("family")
    if family in ("video", "rgbt"):
        raise NotImplementedError(f"serving the {family} family {_LATER}")
    compress_fn, decompress_fn = _codec_handlers(codec)
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

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        "lmic-torch-serve",
        description="Serve a codec's uint8 path over HTTP.",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--bundle", help="serving bundle directory")
    src.add_argument("--checkpoint", help="updated deployment checkpoint")
    args = p.parse_args(argv)
    what = "--bundle" if args.bundle else "--checkpoint"
    raise NotImplementedError(f"{what} {_LATER}")
