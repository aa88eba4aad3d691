from lmic_tpu_torch.transforms.functional import (
    rgb2ycbcr,
    ycbcr2rgb,
    yuv_420_to_444,
    yuv_444_to_420,
)
from lmic_tpu_torch.transforms.transforms import (
    RGB2YCbCr,
    YCbCr2RGB,
    YUV420To444,
    YUV444To420,
)

__all__ = [
    "rgb2ycbcr", "ycbcr2rgb", "yuv_420_to_444", "yuv_444_to_420",
    "RGB2YCbCr", "YCbCr2RGB", "YUV444To420", "YUV420To444",
]
