"""A training cell's step by phase, on the device trace's clock: the
program's spans (``utils/spans.py``) with the kernels they launched, and
the counters of its prefetcher and collector.

    python3 -m port_bench.phases --workload hrnet_w48_train --seed <n> --seconds <s> \\
        [--out <file>]

This is a tool beside the benchmark: no cell's run calls it, and it checks
nothing against the reference.  It builds the cell's trainer as
``train_loop.run_train`` does (data, weights and configuration from the
seed), runs four steps and the traffic's warm-up, then

- a window of ``--seconds`` with nothing profiled, reading the
  prefetcher's ``waited_ns``, ``gets``, ``empty_gets`` and the trainer's
  collector counters before and after;
- the traffic's ``trace_steps`` steps profiled as ``train_loop._profile``
  profiles them (device activity alone, spans off): :class:`Trace`;
- as many steps with the spans recording, under a profiler that records
  the device's activity and, of the CPU's, the user ranges alone
  (``RecordScope.USER_SCOPE``: no aten operator): :class:`SpanTrace`;

the two profiled parts in turn :data:`TURNS` times, so that the cost of
recording the spans shows beside the steps' own spread.  It prints one JSON line
(also written to ``--out``): the window's counters, each profiled part's
:func:`summary`, the last traced part's phase table
(:meth:`SpanTrace.phases`), its ``branch_conv.*`` spans' kernels
(:meth:`SpanTrace.by_span`) and the kernels that
``branch_conv_roofline.train`` times but that ran outside them, the host's
runtime calls (:meth:`SpanTrace.host_calls`), its idle
gaps named by span (:meth:`SpanTrace.idle_gaps`) beside ``Trace``'s, and
:func:`readings`.
The card's name is in the line; without a card it exits 2.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from port_bench.trace import Trace, _union

STEP = "fixmatch.step"
PHASE = "fixmatch."
BRANCH_CONV = ("branch_conv.d", "branch_conv.d_post", "branch_conv.e")
OUTSIDE = "(outside the step)"
GC = "python gc"
NO_CALL = "(no host operation)"
TURNS = 3


def innermost(spans: Sequence[Tuple[str, float, float]], times: Sequence[float]
              ) -> List[Optional[str]]:
    """For each time, the name of the innermost span open at it (a span
    covers [start, end)): the latest to start, the shorter of two that
    start together; ``None`` where none is open.  One sweep over the
    spans' ends and the times, so that a step's thousands of launches and
    spans cost no more than a sort."""
    marks = ([(a, 1, i) for i, (_, a, _) in enumerate(spans)]
             + [(b, 0, i) for i, (_, _, b) in enumerate(spans)]
             + [(t, 2, j) for j, t in enumerate(times)])
    marks.sort()
    open_, out = {}, [None] * len(times)
    for _, kind, i in marks:
        if kind == 1:
            open_[i] = (spans[i][1], -spans[i][2])
        elif kind == 0:
            open_.pop(i, None)
        elif open_:
            out[i] = spans[max(open_, key=open_.__getitem__)][0]
    return out


@dataclass
class SpanTrace(Trace):
    """A :class:`Trace` (``device`` and ``host`` as ``Trace.from_profiler``
    keeps them: device operations without user ranges, and the CUDA
    API's calls, ``cuda*`` and ``cu*``) with the program's ranges (``spans``),
    for each device operation the start of the host call that launched it
    (``launched``, matched by correlation id; ``None`` where no call
    matched) and the collector's full collections (``gc``), all in
    microseconds on the profiler's clock."""

    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    launched: List[Optional[float]] = field(default_factory=list)
    gc: List[Tuple[float, float]] = field(default_factory=list)

    @classmethod
    def from_events(cls, events, wall_s: float, units: int, images: int,
                    gc_ns: Sequence[Tuple[int, int]] = ()) -> "SpanTrace":
        """From the profiler's ``KinetoEvent`` list (``_disable_profiler()
        .events()``); ``gc_ns``: the collections as (start, end) in the
        profiler's nanoseconds (Unix time)."""
        from torch.autograd import DeviceType

        rows = [(e.name(), e.start_ns(), e.end_ns(), e.device_type(), e.is_user_annotation(),
                 e.correlation_id()) for e in events]
        base = min((r[1] for r in rows), default=0)

        def us(ns):
            return (ns - base) / 1e3

        dev, host, spans, calls = [], [], [], {}
        for name, a, b, kind, user, corr in rows:
            if user:  # a program range; mirrored on the device's timeline too
                if kind == DeviceType.CPU:
                    spans.append((name, us(a), us(b)))
            elif kind == DeviceType.CUDA:
                dev.append(((name, us(a), us(b)), corr))
            elif kind == DeviceType.CPU:
                host.append((name, us(a), us(b)))
                calls[corr] = us(a)
        dev.sort(key=lambda d: d[0][1])
        spans.sort(key=lambda s: s[1])
        return cls([d for d, _ in dev], host, wall_s, units, images, spans,
                   [calls.get(c) for _, c in dev], [(us(a), us(b)) for a, b in gc_ns])

    def span_s(self, names: Sequence[str]) -> float:
        """Summed seconds of the spans of these names (host time)."""
        return sum(b - a for n, a, b in self.spans if n in names) / 1e6

    def _launches(self) -> List[Tuple[Tuple[str, float, float], Optional[float]]]:
        """Each kernel (as ``Trace.kernels``) with its launching call's start."""
        return [(k, t) for k, t in zip(self.device, self.launched)
                if not k[0].lower().startswith(("memcpy", "memset"))]

    def _phase_spans(self):
        return [s for s in self.spans if s[0].startswith(PHASE)]

    def _phase_at(self, times: Sequence[Optional[float]]) -> List[str]:
        found = innermost(self._phase_spans(), [-1.0 if t is None else t for t in times])
        return [NO_CALL if t is None else OUTSIDE if p is None else p
                for t, p in zip(times, found)]

    def _gaps(self) -> List[Tuple[float, float, Optional[Tuple[str, float, float]]]]:
        """Every gap between device operations, as ``Trace.idle_gaps``
        finds them, with the host call that ended it: the last to start
        before the gap's end."""
        spans = _union(self.device)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        out = []
        for (_, b0), (a1, _) in zip(spans, spans[1:]):
            if a1 > b0:
                k = bisect.bisect_right(starts, a1)
                out.append((b0, a1, host[k - 1] if k else None))
        return out

    def phases(self) -> Dict[str, Dict[str, float]]:
        """Per phase (each ``fixmatch.*`` span name, ``fixmatch.step`` for
        the step's own time outside its phases, :data:`OUTSIDE`), per step:
        ``host_ms`` (the spans' duration), ``device_ms`` and ``launches`` of
        the kernels launched while the phase was the innermost open, and
        ``idle_ms``, the device's gaps whose ending host call started in
        it."""
        out: Dict[str, Dict[str, float]] = {}

        def row(p):
            return out.setdefault(p, {"host_ms": 0.0, "device_ms": 0.0, "idle_ms": 0.0,
                                      "launches": 0})

        for n, a, b in self._phase_spans():
            row(n)["host_ms"] += (b - a) / 1e3
        inner = sum(r["host_ms"] for p, r in out.items() if p != STEP)
        if STEP in out:
            out[STEP]["host_ms"] -= inner
        kern = self._launches()
        for ((_, a, b), _), p in zip(kern, self._phase_at([t for _, t in kern])):
            row(p)["device_ms"] += (b - a) / 1e3
            row(p)["launches"] += 1
        gaps = self._gaps()
        for (a, b, call), p in zip(gaps, self._phase_at([c and c[1] for _, _, c in gaps])):
            row(p)["idle_ms"] += (b - a) / 1e3
        return {p: {k: v / self.units for k, v in r.items()} for p, r in out.items()}

    def by_span(self) -> Dict[str, Dict]:
        """Per innermost span (of any name) open at each kernel's launch,
        per step: ``device_ms``, ``launches`` and the kernels' names (up to
        the argument list)."""
        kern = self._launches()
        found = innermost(self.spans, [-1.0 if t is None else t for _, t in kern])
        out: Dict[str, Dict] = {}
        for ((n, a, b), _), span in zip(kern, found):
            r = out.setdefault(span or OUTSIDE, {"device_ms": 0.0, "launches": 0, "names": set()})
            r["device_ms"] += (b - a) / 1e3 / self.units
            r["launches"] += 1 / self.units
            r["names"].add(n.split("(")[0])
        return {k: {**r, "names": sorted(r["names"])} for k, r in out.items()}

    def host_calls(self, top: int = 8) -> List[List]:
        """The ``top`` CUDA API calls (``cuda*``, ``cu*``) by summed host time:
        [name, ms a step, calls a step]."""
        out: Dict[str, List[float]] = {}
        for n, a, b in self.host:
            r = out.setdefault(n, [0.0, 0])
            r[0] += (b - a) / 1e3 / self.units
            r[1] += 1 / self.units
        return [[n, *r] for n, r in sorted(out.items(), key=lambda kv: -kv[1][0])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """``Trace.idle_gaps``' gaps, in its order and of its lengths, each
        named ``"<innermost span open at the host call's start>: <host
        call>"``, ``"python gc: <host call>"`` where a full collection
        covers the gap's end, or ``"(outside the step): <host call>"``."""
        gaps = sorted(self._gaps(), key=lambda g: g[0] - g[1])[:top]
        found = innermost(self.spans, [c[1] if c else -1.0 for _, _, c in gaps])
        out = []
        for (a, b, call), span in zip(gaps, found):
            label = (GC if any(g0 <= b < g1 for g0, g1 in self.gc)
                     else span if call and span else OUTSIDE)
            out.append([f"{label}: {call[0] if call else NO_CALL}", (b - a) / 1e6])
        return out


def readings(t: SpanTrace, window: Dict[str, int]) -> Dict[str, float]:
    """The seven per-layer numbers: five from the traced steps, two from
    the counters' change over the unprofiled window (``window``: ``steps``,
    ``waited_ns``, ``gc_pause_ns``)."""
    ms, table = 1e3 / t.units, t.phases()

    def device_ms(*phases):
        return sum(table[p]["device_ms"] for p in phases if p in table)

    out = {
        "host_ms_per_step.train": t.span_s((STEP,)) * ms,
        "forward_ms.train": device_ms("fixmatch.teacher", "fixmatch.student"),
        "backward_ms.train": device_ms("fixmatch.backward"),
        "optimizer_ms.train": device_ms("fixmatch.optimizer", "fixmatch.ema"),
        "branch_conv_host_ms.train": t.span_s(BRANCH_CONV) * ms,
    }
    if window["steps"]:
        out["prefetch_wait_ms.train"] = window["waited_ns"] / 1e6 / window["steps"]
        out["gc_ms_per_step.train"] = window["gc_pause_ns"] / 1e6 / window["steps"]
    return out


class _Collections:
    """The harness's own ``gc.callbacks`` hook while a part is profiled:
    each full collection's (start, end) in Unix nanoseconds, the
    profiler's clock."""

    def __init__(self):
        self.spans: List[Tuple[int, int]] = []
        self._t0 = 0

    def __call__(self, phase: str, info: Dict[str, int]) -> None:
        if info["generation"] == 2:
            if phase == "start":
                self._t0 = time.time_ns()
            else:
                self.spans.append((self._t0, time.time_ns()))


def _counters(trainer) -> Dict[str, int]:
    pre, col = trainer._prefetch, trainer.collector
    return {"gets": pre.gets, "empty_gets": pre.empty_gets, "waited_ns": pre.waited_ns,
            "gc_full_collections": col.gc_full_collections, "gc_pause_ns": col.gc_pause_ns}


def _steps(trainer, stream, n: int, clock) -> Dict[str, float]:
    """Run ``n`` steps; their wall time (synchronised), images and host
    seconds inside ``train_step``."""
    clock.sync()
    t0, images, host = time.perf_counter(), 0, 0.0
    for _ in range(n):
        lab, unlab = next(stream)
        h0 = time.perf_counter()
        trainer.train_step(trainer.state, lab, unlab)
        host += time.perf_counter() - h0
        images += lab["image"].shape[0] + unlab["image"].shape[0]
    clock.sync()
    return {"wall_s": time.perf_counter() - t0, "images": images, "host_s": host}


def summary(t: Trace, done: Dict[str, float], n: int) -> Dict[str, float]:
    """A profiled part of ``n`` steps: launches, kernel and busy ms a step,
    its img/s and the host's ms a step inside ``train_step``."""
    return {"launches_per_step": len(t.kernels()) / n,
            "device_ms_per_step": 1e3 * t.device_s() / n,
            "busy_ms_per_step": 1e3 * t.busy_s() / n,
            "img_per_s": done["images"] / done["wall_s"],
            "host_ms_in_train_step": 1e3 * done["host_s"] / n}


def _profile_plain(trainer, stream, n: int, clock):
    from port_bench.train_loop import profiler_activity

    prof = torch.profiler.profile(activities=[profiler_activity(clock)])
    clock.sync()
    prof.start()
    done = _steps(trainer, stream, n, clock)
    prof.stop()
    return Trace.from_profiler(prof, done["wall_s"], n, done["images"]), done


def _profile_spans(trainer, stream, n: int, clock):
    from torch._C._profiler import (
        ProfilerConfig,
        ProfilerState,
        RecordScope,
        _ExperimentalConfig,
    )
    from torch.autograd import ProfilerActivity

    from semi_supervised_semantic_segmentation_tpu_torch.utils import spans

    acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if clock.cuda else set())
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                         _ExperimentalConfig())
    collections = _Collections()
    clock.sync()
    torch.autograd._prepare_profiler(cfg, acts)
    gc.callbacks.append(collections)
    with spans.recording():
        torch.autograd._enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
        try:
            done = _steps(trainer, stream, n, clock)
        finally:
            result = torch.autograd._disable_profiler()
            gc.callbacks.remove(collections)
    return SpanTrace.from_events(result.events(), done["wall_s"], n, done["images"],
                                 collections.spans), done


def measure(bench, name: str, seed: int, seconds: float, device: str) -> Dict:
    """The tool's line (module docstring)."""
    from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import Trainer

    from port_bench.record import Clock
    from port_bench.traffic import make_dataset
    from port_bench.train_loop import _stream, datasets_of, program_config
    from port_bench.weights import cell_state

    cell = bench.cell(name)
    traffic, classes = cell.traffic, cell.config["config"]["data"]["num_classes"]
    sets = {r: make_dataset(traffic, r, classes, seed, device) for r in ("labeled", "unlabeled")}
    sets["val"] = sets["labeled"]
    state = cell_state(cell, seed, sets["labeled"].assemble([0, 1])["image"], device)
    clock = Clock(device)
    work = tempfile.mkdtemp(prefix="port_bench_phases_")
    trainer = None
    try:
        with datasets_of(sets):
            trainer = Trainer(program_config(cell, seed, **{"train.work_dir": work}), device)
        trainer.model.load_state_dict(state)
        trainer.state.ema_model.load_state_dict(state)
        stream = _stream(trainer)
        _steps(trainer, stream, 4 + traffic["warm_steps"], clock)

        before, t0, steps = _counters(trainer), time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            steps += 1
            _steps(trainer, stream, 1, clock)
        after = _counters(trainer)
        window = {k: after[k] - before[k] for k in after}
        window["steps"] = steps
        window["wall_s"] = time.perf_counter() - t0

        n = traffic["trace_steps"]
        parts = {"spans_off": [], "spans_on": []}
        for _ in range(TURNS):
            plain, done = _profile_plain(trainer, stream, n, clock)
            parts["spans_off"].append(summary(plain, done, n))
            traced, done = _profile_spans(trainer, stream, n, clock)
            parts["spans_on"].append(summary(traced, done, n))
    finally:
        if trainer is not None:
            trainer.close()
        shutil.rmtree(work, ignore_errors=True)

    by_span = traced.by_span()
    # every kernel that branch_conv_roofline.train times, launched inside a branch_conv span
    roofline = [m for m in cell.per_layer if m.name == "branch_conv_roofline.train"]
    fragments = roofline[0].reader.KERNELS if roofline else ()
    stray = sorted({k for s, r in by_span.items() if s not in BRANCH_CONV for k in r["names"]
                    if any(f in k.lower() for f in fragments)})
    return {"workload": name, "seed": seed,
            "device": torch.cuda.get_device_name() if clock.cuda else "cpu",
            "window": window, **parts, "phases": traced.phases(),
            "branch_conv": {s: r for s, r in by_span.items() if s in BRANCH_CONV},
            "roofline_kernels_outside_branch_conv": stray, "host_calls": traced.host_calls(),
            "idle_gaps": traced.idle_gaps(), "idle_gaps_unnamed": Trace.idle_gaps(traced),
            "readings": readings(traced, window)}


def main(argv=None) -> int:
    from port_bench.bench import ROOT, Benchmark
    from port_bench.run import set_environment

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    set_environment(ROOT)
    if not torch.cuda.is_available():
        print("port_bench.phases: no CUDA card", file=sys.stderr)
        return 2
    line = measure(Benchmark(ROOT), args.workload, args.seed, args.seconds, "cuda")
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
