"""``port_bench.phases`` against hand computations: the innermost span at a
time, kernels matched to their launching host call by correlation id and
so to a phase, the idle gaps named by span (a span, ``python gc``,
outside the step) with ``Trace.idle_gaps``' lengths and order, the
kernels of each innermost span, the host's calls by time, the seven
readings, and the accepted
readers reading a :class:`SpanTrace` as they read the plain :class:`Trace`
of the same operations.  Then the tool once on the CPU at a tiny size."""

from __future__ import annotations

import types

import pytest
import torch
from torch.autograd import DeviceType

from port_bench import phases
from port_bench.bench import ROOT, Benchmark
from port_bench.phases import SpanTrace, innermost, readings
from port_bench.tests import tiny
from port_bench.trace import Trace

H100 = "NVIDIA H100 80GB HBM3"


class _Event:
    """What the profiler's ``KinetoEvent`` gives, in ns from 10**18."""

    def __init__(self, name, a_us, b_us, kind, user=False, corr=0):
        self._v = (name, 10 ** 18 + int(a_us * 1e3), 10 ** 18 + int(b_us * 1e3), kind, user,
                   corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
SPANS = [("fixmatch.step", 0, 1000), ("fixmatch.teacher", 10, 200), ("branch_conv.d", 50, 80),
         ("fixmatch.student", 200, 400), ("fixmatch.backward", 400, 800),
         ("branch_conv.e", 450, 500), ("fixmatch.optimizer", 800, 900),
         ("fixmatch.ema", 900, 950)]
# (host call start, device operation): launches inside branch_conv.d (teacher),
# the student, branch_conv.e (backward), the optimizer and after the step
LAUNCHES = [(60, ("conv_d48_kernel", 100, 150)), (250, ("gemm", 300, 350)),
            (460, ("conv_dw48_kernel", 600, 700)), (850, ("multi_tensor_apply", 860, 870)),
            (1100, ("elementwise", 1100, 1110)), (5, ("Memcpy HtoD", 0, 20))]


def _events():
    out = [_Event(n, a, b, CPU, user=True, corr=k + 1) for k, (n, a, b) in enumerate(SPANS)]
    # the device's mirror of a range, which is not a device operation
    out.append(_Event("fixmatch.step", 0, 1000, CUDA, user=True))
    for k, (t, (n, a, b)) in enumerate(LAUNCHES):
        call = "cudaMemcpyAsync" if n.startswith("Memcpy") else "cudaLaunchKernel"
        out.append(_Event(call, t, t + 4, CPU, corr=100 + k))
        out.append(_Event(n, a, b, CUDA, corr=100 + k))
    return out


@pytest.fixture()
def traced():
    # a full collection from 1090 to 1105 us covers the last gap's end
    gc_ns = [(10 ** 18 + 1_090_000, 10 ** 18 + 1_105_000)]
    return SpanTrace.from_events(_events(), 1e-3, 1, 16, gc_ns)


def test_innermost_span_at_a_time():
    spans = [("a", 0, 10), ("b", 2, 5), ("c", 2, 4), ("d", 6, 20)]
    assert innermost(spans, [1, 2, 3, 4, 5, 7, 10, 20, -1]) == \
        ["a", "c", "c", "b", "a", "d", "d", None, None]


def test_from_events_keeps_the_trace_and_matches_launches(traced):
    assert [s[0] for s in traced.spans] == [s[0] for s in sorted(SPANS, key=lambda s: s[1])]
    assert [d[0] for d in traced.device] == ["Memcpy HtoD", "conv_d48_kernel", "gemm",
                                             "conv_dw48_kernel", "multi_tensor_apply",
                                             "elementwise"]
    assert traced.launched == pytest.approx([5, 60, 250, 460, 850, 1100])
    assert {h[0] for h in traced.host} == {"cudaLaunchKernel", "cudaMemcpyAsync"}
    assert traced.gc == [pytest.approx((1090, 1105))]


def test_phases_by_hand(traced):
    got = traced.phases()
    assert got["fixmatch.teacher"]["device_ms"] == pytest.approx(0.05)
    assert got["fixmatch.student"]["device_ms"] == pytest.approx(0.05)
    assert got["fixmatch.backward"]["device_ms"] == pytest.approx(0.1)
    assert got["fixmatch.optimizer"]["device_ms"] == pytest.approx(0.01)
    assert got[phases.OUTSIDE]["device_ms"] == pytest.approx(0.01)
    assert sum(r["launches"] for r in got.values()) == 5  # the copy is no kernel
    assert sum(r["device_ms"] for r in got.values()) == pytest.approx(1e3 * traced.device_s())
    # host: each phase's spans; the step's own time is what its phases leave
    assert got["fixmatch.teacher"]["host_ms"] == pytest.approx(0.19)
    assert got["fixmatch.ema"]["host_ms"] == pytest.approx(0.05)
    assert got["fixmatch.step"]["host_ms"] == pytest.approx(1.0 - 0.94)
    # idle: 20-100 ended by the launch at 60 (teacher), 150-300 by 250
    # (student), 350-600 by 460 (backward), 700-860 by 850 (optimizer),
    # 870-1100 by 1100 (outside)
    assert got["fixmatch.teacher"]["idle_ms"] == pytest.approx(0.08)
    assert got["fixmatch.student"]["idle_ms"] == pytest.approx(0.15)
    assert got["fixmatch.backward"]["idle_ms"] == pytest.approx(0.25)
    assert got["fixmatch.optimizer"]["idle_ms"] == pytest.approx(0.16)
    assert got[phases.OUTSIDE]["idle_ms"] == pytest.approx(0.23)


def test_kernels_by_innermost_span(traced):
    got = traced.by_span()
    assert set(got) == {"branch_conv.d", "fixmatch.student", "branch_conv.e",
                        "fixmatch.optimizer", phases.OUTSIDE}
    assert got["branch_conv.d"] == {"device_ms": pytest.approx(0.05), "launches": 1,
                                    "names": ["conv_d48_kernel"]}
    assert got["branch_conv.e"]["device_ms"] == pytest.approx(0.1)
    assert got[phases.OUTSIDE]["names"] == ["elementwise"]


def test_host_calls_by_time(traced):
    traced.units = 2
    assert traced.host_calls(top=1) == [["cudaLaunchKernel", pytest.approx(0.01), 2.5]]


def test_idle_gaps_named_by_span_keep_their_lengths(traced):
    named = traced.idle_gaps()
    assert named == [["branch_conv.e: cudaLaunchKernel", pytest.approx(250e-6)],
                     ["python gc: cudaLaunchKernel", pytest.approx(230e-6)],
                     ["fixmatch.optimizer: cudaLaunchKernel", pytest.approx(160e-6)],
                     ["fixmatch.student: cudaLaunchKernel", pytest.approx(150e-6)],
                     ["branch_conv.d: cudaLaunchKernel", pytest.approx(80e-6)]]
    plain = Trace.idle_gaps(traced)
    assert [g[1] for g in named] == [g[1] for g in plain]
    assert [g[0].split(": ")[1] for g in named] == [g[0] for g in plain]
    traced.gc = []
    assert traced.idle_gaps()[1][0] == "(outside the step): cudaLaunchKernel"
    assert [g[1] for g in traced.idle_gaps(top=2)] == [g[1] for g in plain[:2]]


def test_seven_readings_by_hand(traced):
    window = {"steps": 4, "waited_ns": 2_000_000, "gc_pause_ns": 500_000_000}
    assert readings(traced, window) == {
        "host_ms_per_step.train": pytest.approx(1.0),
        "forward_ms.train": pytest.approx(0.1),
        "backward_ms.train": pytest.approx(0.1),
        "optimizer_ms.train": pytest.approx(0.01),
        "branch_conv_host_ms.train": pytest.approx(0.08),
        "prefetch_wait_ms.train": pytest.approx(0.5),
        "gc_ms_per_step.train": pytest.approx(125.0),
    }
    assert "gc_ms_per_step.train" not in readings(traced, {**window, "steps": 0})
    traced.units = 2
    assert readings(traced, window)["host_ms_per_step.train"] == pytest.approx(0.5)
    assert readings(traced, window)["backward_ms.train"] == pytest.approx(0.05)


def test_accepted_readers_read_a_span_trace_as_its_trace(traced):
    cell = Benchmark(ROOT).cell("hrnet_w48_train")
    plain = Trace(traced.device, traced.host, traced.wall_s, traced.units, traced.images)
    for m in cell.per_layer:
        a = types.SimpleNamespace(loop="train", trace=traced, cell=cell, device_name=H100,
                                  window_ms=2.0, attempted=2, data_wait_s=[1e-3])
        b = types.SimpleNamespace(**{**vars(a), "trace": plain})
        assert m.read(a) == m.read(b), m.name
    assert traced.groups() == plain.groups()


def test_the_tool_on_the_cpu(tmp_path):
    torch.set_num_threads(4)
    bench = Benchmark(tiny.make_root(str(tmp_path)))
    line = phases.measure(bench, "tiny_hrnet_train", 2 ** 31 + 7, 0.3, "cpu")
    assert line["device"] == "cpu" and line["window"]["steps"] >= 1
    assert len(line["spans_off"]) == len(line["spans_on"]) == phases.TURNS
    assert line["window"]["gets"] == line["window"]["steps"]
    got = line["phases"]
    assert set(got) >= {"fixmatch.draw", "fixmatch.views", "fixmatch.teacher",
                        "fixmatch.cutmix", "fixmatch.student", "fixmatch.loss",
                        "fixmatch.backward", "fixmatch.optimizer", "fixmatch.ema"}
    assert all(r["host_ms"] > 0 for r in got.values())
    r = line["readings"]
    assert r["host_ms_per_step.train"] == pytest.approx(sum(x["host_ms"] for x in got.values()))
    assert set(r) == {"host_ms_per_step.train", "forward_ms.train", "backward_ms.train",
                      "optimizer_ms.train", "branch_conv_host_ms.train",
                      "prefetch_wait_ms.train", "gc_ms_per_step.train"}
