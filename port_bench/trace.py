"""What a profiled part of a run saw: the device's operations and the
host's, read from ``torch.profiler``; the device's busy time, its idle
gaps and the time of named kernels, for the per-layer metrics."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

# lower-cased kernel-name fragments -> group, first match wins
GROUPS = [
    ("E at C = 96 (E96)", ("conv_dw96_kernel",)),
    ("E at C = 48 (E48)", ("conv_dw48_kernel",)),
    ("D at C = 96 (D96 and its weight pack)", ("conv_d96_kernel", "pack_wg_kernel<96>")),
    ("D at C = 48 (D48 and its weight pack)", ("conv_d48_kernel", "pack_wg_kernel<48>")),
    ("stem kernels (B, C)", ("stem_fwd_kernel", "stem_dw_kernel", "reduce_partials_kernel")),
    ("branch conv kernels (D's conv_fwd_kernel, E; both D's reduction)",
     ("conv_fwd_kernel", "conv_dw_kernel", "reduce_rows_kernel", "reduce_dk_kernel")),
    ("cutmix kernel (A)", ("_cutmix_normalize_kernel",)),
    ("cuDNN layout transforms", ("nchwtonhwc", "nhwctonchw")),
    ("conv / GEMM (cuDNN, cuBLAS)", ("cudnn", "conv", "xmma", "gemm", "cutlass", "sm90",
                                      "wgrad", "dgrad", "winograd")),
    ("batch norm", ("batch_norm", "batchnorm")),
    ("bilinear resize", ("upsample",)),
    ("memcpy / memset", ("memcpy", "memset")),
    ("reductions", ("reduce",)),
]
OTHER = "other elementwise / indexing"


@dataclass
class Trace:
    """Device operations and host operations of the profiled part, in
    microseconds on the profiler's clock; ``wall_s`` is the host clock
    across it (synchronised at both ends); ``units`` the steps or val
    batches it covered and ``images`` their images."""

    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    wall_s: float = 0.0
    units: int = 0
    images: int = 0

    @classmethod
    def from_profiler(cls, prof, wall_s: float, units: int, images: int) -> "Trace":
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in prof.events():
            span = (e.name, float(e.time_range.start), float(e.time_range.end))
            if getattr(e, "is_user_annotation", False):
                continue  # a record_function range, mirrored on the device's timeline
            if e.device_type == DeviceType.CUDA:
                dev.append(span)
            elif e.device_type == DeviceType.CPU:
                host.append(span)
        dev.sort(key=lambda s: s[1])
        return cls(dev, host, wall_s, units, images)

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [k for k in self.device if not k[0].lower().startswith(("memcpy", "memset"))]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        return sum(b - a for a, b in _union(self.device)) / 1e6

    def device_s(self, fragments: Sequence[str] = ()) -> float:
        """Summed seconds of the kernels whose lower-cased name holds one of
        ``fragments`` (every kernel where none are given)."""
        return sum(b - a for n, a, b in self.kernels()
                   if not fragments or any(f in n.lower() for f in fragments)) / 1e6

    def groups(self, top: int = 10) -> List[List]:
        out: Dict[str, float] = {}
        for n, a, b in self.device:
            low = n.lower()
            g = next((name for name, frags in GROUPS if any(f in low for f in frags)), OTHER)
            out[g] = out.get(g, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The ``top`` longest gaps between device operations, each named by
        the host call that ended it: the last host operation to start before
        the gap's end (on the card the trace holds the CUDA runtime's calls,
        so a gap ended by ``cudaLaunchKernel`` waited for the host to launch,
        one ended by ``cudaMemcpyAsync`` for a copy)."""
        spans = _union(self.device)
        gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(spans, spans[1:]) if a1 > b0),
                      key=lambda g: g[0] - g[1])[:top]
        out = []
        for a, b in gaps:
            before = [h for h in self.host if h[1] <= b]
            name = max(before, key=lambda h: h[1])[0] if before else "(no host operation)"
            out.append([name, (b - a) / 1e6])
        return out


def _union(spans: Sequence[Tuple[str, float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]
