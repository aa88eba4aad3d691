"""Callable class wrappers over the functional colour transforms.

Counterpart of lmic_tpu/transforms/transforms.py (reference
compressai/transforms/transforms.py:11-118): thin classes, so the
conversions compose in dataset `transform=` pipelines.
"""

from lmic_tpu_torch.transforms.functional import (
    rgb2ycbcr,
    ycbcr2rgb,
    yuv_420_to_444,
    yuv_444_to_420,
)

__all__ = ["RGB2YCbCr", "YCbCr2RGB", "YUV444To420", "YUV420To444"]


class RGB2YCbCr:
    """(..., 3) RGB -> YCbCr (BT.709)."""

    def __call__(self, rgb):
        return rgb2ycbcr(rgb)

    def __repr__(self):
        return f"{self.__class__.__name__}()"


class YCbCr2RGB:
    """(..., 3) YCbCr -> RGB (BT.709)."""

    def __call__(self, ycbcr):
        return ycbcr2rgb(ycbcr)

    def __repr__(self):
        return f"{self.__class__.__name__}()"


class YUV444To420:
    """(N, H, W, 3) 444 -> ((N,H,W,1), (N,H/2,W/2,1), (N,H/2,W/2,1))."""

    def __init__(self, mode: str = "avg_pool"):
        self.mode = mode

    def __call__(self, yuv):
        return yuv_444_to_420(yuv, mode=self.mode)

    def __repr__(self):
        return f"{self.__class__.__name__}(mode={self.mode!r})"


class YUV420To444:
    """((N,H,W,1), (N,H/2,W/2,1), (N,H/2,W/2,1)) -> (N, H, W, 3)."""

    def __init__(self, mode: str = "bilinear", return_tuple: bool = False):
        self.mode = mode
        self.return_tuple = return_tuple

    def __call__(self, yuv):
        return yuv_420_to_444(
            yuv, mode=self.mode, return_tuple=self.return_tuple
        )

    def __repr__(self):
        return (f"{self.__class__.__name__}(mode={self.mode!r}, "
                f"return_tuple={self.return_tuple})")
