"""What a driver hands the per-layer readers."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from benchmark.devtrace import Summary


@dataclasses.dataclass
class Run:
    kind: str                 # the traffic kind: "train" or "codec"
    device_kind: str          # torch.cuda.get_device_name()
    window_s: float           # the measured window, host clock
    counters: Dict[str, float]
    trace: Optional[Summary] = None
