"""The GDN kernels' share of their roofline in the codec cells: the least
time of every launch of the traced window (yardstick's operations and
bytes at its rows and channels, against the FP32 peak and the memory
bandwidth) over the GDN kernels' device time, each kernel's recorded time
scaled by its C ABI launches over its records."""

from benchmark import gdn_roofline


def read(run):
    if run.kind != "codec":
        return None
    return gdn_roofline.share(run)
