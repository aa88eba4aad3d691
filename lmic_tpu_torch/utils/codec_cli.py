"""Body framing of the codec container and the HTTP wire.

Counterpart of lmic_tpu/utils/codec_cli.py:85-140 (the big-endian struct
helpers shared with lmic-serve); the file container and its CLI are ported
with a later slice. Reads are exact and bounded by the bytes actually left,
because every length and shape field comes from outside the program.
"""

from __future__ import annotations

import struct

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
