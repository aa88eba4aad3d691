"""The program's GDN launch counts, as its C ABI counts them where each
launch succeeds (`lmic_tpu_torch.ops.gdn.kernel_launches`), by kernel and
by launch class; and the GDN kernels' profiler time scaled to those
counts (a profiler session can lose records; the counts are exact)."""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, Optional

from benchmark import yardstick


def program_counts() -> Dict[str, int]:
    from lmic_tpu_torch.ops import gdn

    return dict(gdn.kernel_launches())


def delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def by_class(counts: Dict[str, int]) -> Dict[str, int]:
    out = Counter()
    for name, n in counts.items():
        cls = yardstick.gdn_class(name)
        if cls is not None:
            out[cls] += n
    return dict(out)


def scaled_seconds(kernels: Dict[str, list],
                   counts: Dict[str, int]) -> Optional[float]:
    """The device seconds of the launches in `counts` ({kernel: launches
    over the traced window}) from the trace's {name: [seconds,
    records]}: each kernel's recorded time times launches over records.
    None when a kernel that launched has no record."""
    total = 0.0
    for kernel, n in counts.items():
        if n <= 0:
            continue
        pat = re.compile(r"\b" + re.escape(kernel) + r"\b")
        sec = rec = 0
        for name, (s, r) in kernels.items():
            if pat.search(name):
                sec += s
                rec += r
        if rec == 0:
            return None
        total += sec * n / rec
    return total
