"""What one run recorded, for the metric readers, and the device clock it
recorded it with."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from port_bench.trace import Trace


class Clock:
    """Marks on the compute stream: CUDA events on the card (no host
    synchronisation until :meth:`sync`), the host clock on the CPU."""

    def __init__(self, device: str):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter() * 1e3
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def ms(self, start, marks) -> List[float]:
        """Each mark's time in ms after ``start`` (after :meth:`sync`)."""
        if not self.cuda:
            return [m - start for m in marks]
        return [start.elapsed_time(m) for m in marks]


@dataclass
class Run:
    """One run of one cell: the cell's files, the arguments, and what the
    set-up, the window and the traced part recorded."""

    cell: object  # bench.Cell
    seed: int
    seconds: float
    traced: bool
    device: str
    device_name: str = ""
    loop: str = ""  # "train" or "eval"
    setup_s: float = 0.0
    window_ms: float = 0.0  # window start to the last unit's completion
    unit_ends_ms: List[float] = field(default_factory=list)  # each step's or batch's end
    window_images: int = 0
    data_wait_s: List[float] = field(default_factory=list)  # per window step
    peak_bytes: int = 0
    trace: Optional[Trace] = None
    attempted: int = 0
    failed: int = 0
    checks: Dict[str, Dict[str, float]] = field(default_factory=dict)
    notes: Dict[str, object] = field(default_factory=dict)
