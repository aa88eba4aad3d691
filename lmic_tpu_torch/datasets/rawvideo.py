"""Memory-mapped raw YUV sequence reader, numpy only.

Counterpart of lmic_tpu/datasets/rawvideo.py (reference
compressai/datasets/rawvideo.py:39-321): deduce (width, height,
framerate, bitdepth, format) from the filename, memory-map the planar
file, index frames as structured records with y/u/v planes.
"""

from __future__ import annotations

import enum
import os
import re
from fractions import Fraction
from typing import Any, Dict, Optional

import numpy as np


class VideoFormat(enum.Enum):
    YUV400 = "yuv400"
    YUV420 = "yuv420"
    YUV422 = "yuv422"
    YUV444 = "yuv444"
    RGB = "rgb"


VIDEO_FORMATS = {
    "yuv400": VideoFormat.YUV400,
    "yuv420": VideoFormat.YUV420,
    "420": VideoFormat.YUV420,
    "p420": VideoFormat.YUV420,
    "i420": VideoFormat.YUV420,
    "yuv422": VideoFormat.YUV422,
    "p422": VideoFormat.YUV422,
    "i422": VideoFormat.YUV422,
    "y42B": VideoFormat.YUV422,
    "yuv444": VideoFormat.YUV444,
    "p444": VideoFormat.YUV444,
    "y444": VideoFormat.YUV444,
}

FRAMERATE_TO_FRACTION = {
    "23.98": Fraction(24000, 1001),
    "23.976": Fraction(24000, 1001),
    "29.97": Fraction(30000, 1001),
    "59.94": Fraction(60000, 1001),
}

SUBSAMPLING = {
    VideoFormat.YUV400: (0, 0),
    VideoFormat.YUV420: (2, 2),
    VideoFormat.YUV422: (2, 1),
    VideoFormat.YUV444: (1, 1),
}

BITDEPTH_TO_DTYPE = {
    8: np.uint8,
    10: np.uint16,
    12: np.uint16,
    14: np.uint16,
    16: np.uint16,
}


def make_frame_dtype(video_format: VideoFormat, value_type, width, height):
    w_sub, h_sub = SUBSAMPLING[video_format]
    sub_height = (height + 1) // h_sub if h_sub > 1 else (
        round(height / h_sub) if h_sub else 0
    )
    sub_width = (width + 1) // w_sub if w_sub > 1 else (
        round(width / w_sub) if w_sub else 0
    )
    return np.dtype(
        [
            ("y", value_type, (height, width)),
            ("u", value_type, (sub_height, sub_width)),
            ("v", value_type, (sub_height, sub_width)),
        ]
    )


def get_raw_video_file_info(filename: str) -> Dict[str, Any]:
    """Parse `<name>_WxH_FPS[_FORMAT][_Nbit].yuv` style names
    (reference rawvideo.py:123-211).

    Only the basename is read, so digits in a directory never become a
    size or a framerate. The framerate is a number that follows a `_` and
    ends at the next `_`, `.` or the end (an `fps`/`Hz` suffix allowed),
    and is not itself a format name such as `420`; lmic_tpu searches the
    whole path for any run of digits, so the width, or a directory's
    digits, became its framerate."""
    name = os.path.basename(filename)
    size_pattern = r"(?P<width>\d+)x(?P<height>\d+)"
    bitdepth_pattern = r"(?P<bitdepth>\d+)bit"
    formats = "|".join(VIDEO_FORMATS.keys())
    format_pattern = (
        rf"(?P<format>{formats})(?:[p_]?(?P<bitdepth2>\d+)(LE|BE))?"
    )

    info: Dict[str, Any] = {}
    for pattern in (size_pattern, bitdepth_pattern, format_pattern):
        m = re.search(pattern, name)
        if m:
            info.update(m.groupdict())
    for m in re.finditer(r"_(\d+(?:\.\d+)?)(?:fps|Hz)?(?=[_.]|$)", name):
        if m.group(1) not in VIDEO_FORMATS:
            info["framerate"] = m.group(1)
            break

    if info.get("bitdepth2"):
        info["bitdepth"] = info["bitdepth2"]
    info.pop("bitdepth2", None)

    out: Dict[str, Any] = {}
    for key in ("width", "height", "bitdepth"):
        if info.get(key) is not None:
            out[key] = int(info[key])
    if info.get("framerate") is not None:
        fr = info["framerate"]
        out["framerate"] = FRAMERATE_TO_FRACTION.get(fr, Fraction(fr))
    if info.get("format") is not None:
        out["format"] = VIDEO_FORMATS[info["format"]]
    return out


class RawVideoSequence:
    """Frame-indexable memory-mapped raw video."""

    def __init__(self, mmap, width: int, height: int, bitdepth: int,
                 video_format: VideoFormat,
                 framerate: Optional[Fraction] = None):
        self.width = width
        self.height = height
        self.bitdepth = bitdepth
        self.video_format = video_format
        self.framerate = framerate
        value_type = BITDEPTH_TO_DTYPE[bitdepth]
        self.dtype = make_frame_dtype(video_format, value_type, width, height)
        self.data = mmap.view(self.dtype)

    @classmethod
    def from_file(cls, filename: str, width: Optional[int] = None,
                  height: Optional[int] = None,
                  bitdepth: Optional[int] = None,
                  video_format: Optional[VideoFormat] = None
                  ) -> "RawVideoSequence":
        info = get_raw_video_file_info(filename)
        width = width or info.get("width")
        height = height or info.get("height")
        bitdepth = bitdepth or info.get("bitdepth", 8)
        video_format = video_format or info.get("format", VideoFormat.YUV420)
        if width is None or height is None:
            raise ValueError(f"Could not deduce size from '{filename}'")
        mmap = np.memmap(filename, dtype=BITDEPTH_TO_DTYPE[bitdepth],
                         mode="r")
        return cls(mmap, width, height, bitdepth, video_format,
                   info.get("framerate"))

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        return self.data[index]

    def close(self):
        del self.data
