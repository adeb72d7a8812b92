"""The benchmark's arithmetic against hand computations: the bytes and
FLOPs of the stem and the branch convs, the model FLOPs that
``FlopCounterMode`` counts, the step times, percentile and window rate
(with a stall, which has to move both), and the busy time, idle share and
idle gaps of a trace."""

from __future__ import annotations

import json
import math
import os
import types

import pytest
import torch
import torch.nn.functional as F

from port_bench import flops, stats
from port_bench.bench import ROOT, Benchmark
from port_bench.reference import layers, models
from port_bench.trace import Trace

H100 = "NVIDIA H100 80GB HBM3"


def _reader(name: str, unit: str):
    """The reader of ``metrics/<name>.py``, whether or not a cell of
    ``BENCHMARK.json`` reports it."""
    return Benchmark(ROOT)._metric({"name": name, "unit": unit, "better": "higher",
                                    "source": "device_trace"}, True)


def test_stem_work_by_hand():
    # 2 images of 8^2: out 4^2; x 2*8*8*3*2 B, y 2*64*4*4*2 B, w 64*3*49*4 B, stats 512 B
    x, y, w, s = 768, 4096, 37632, 512
    fl = 2.0 * 2 * 64 * 16 * 147
    assert flops.stem_work(2, 8, False) == [(x + w + y + s, fl)]
    assert flops.stem_work(2, 8, True)[1] == (x + 2 * y + s + w, fl)


def test_branch_conv_work_by_hand():
    t = 2 * 4 * 8 * 8 * 2  # [2, 4, 8, 8] bf16
    wv = 4 * 4 * 9 * 4 + 2 * 2 * 4 * 4
    fl = 2.0 * 2 * 4 * 4 * 9 * 64
    assert flops.branch_conv_work(2, 4, 8, 8, "fwd") == (2 * t + wv, fl)
    assert flops.branch_conv_work(2, 4, 8, 8, "dw") == (4 * t + wv, fl)
    assert flops.branch_conv_work(2, 4, 8, 8, "dx_post") == (3 * t + wv, fl)
    # the H100's bf16 peak and bandwidth decide which bound holds
    assert flops.least_seconds(3.35e12, 1.0, H100) == pytest.approx(1.0)
    assert flops.least_seconds(1.0, 989e12, H100) == pytest.approx(1.0)


def test_branch_shapes_of_w48():
    model = {"hrnet_width": 48, "hrnet_modules": [1, 4, 3]}
    shapes = flops.hrnet_branch_shapes(model, 1, 1024, 1024)
    # 8 modules x 4 blocks x 2 convs on each of the 48- and 96-channel branches
    assert shapes.count((48, 256, 256)) == 64 and shapes.count((96, 128, 128)) == 64
    assert len(shapes) == 128


def _hand_conv_flops(model_cfg, classes, n, h, w):
    """2 * N * C_out * H_out * W_out * C_in * k * k summed over every conv
    of one forward, read from the shapes the convs see."""
    seen = []
    orig = F.conv2d

    def counting(x, wt, bias=None, stride=1, padding=0, dilation=1, groups=1):
        y = orig(x, wt, bias, stride, padding, dilation, groups)
        seen.append(2.0 * y.numel() * wt.shape[1] * wt.shape[2] * wt.shape[3])
        return y

    layers.F.conv2d = counting
    try:
        model = models.build(model_cfg, classes).eval()
        with torch.no_grad():
            model(torch.zeros(n, h, w, 3))
    finally:
        layers.F.conv2d = orig
    return sum(seen), seen[0]


@pytest.mark.parametrize("model_cfg", [
    {"backbone": "resnet50", "decoder": "deeplabv3plus", "output_stride": 16,
     "aspp_dilations": [6, 12, 18]},
    {"backbone": "hrnet_w48", "decoder": "hrnet_head", "hrnet_width": 8,
     "hrnet_modules": [1, 1, 1]},
])
def test_model_flops_match_hand_count(model_cfg):
    fwd, first = _hand_conv_flops(model_cfg, 5, 2, 64, 64)
    assert flops.model_flops(model_cfg, 5, [("fwd", 2, 64, 64)]) == pytest.approx(fwd)
    # training: the forward, dW of every conv, dx of every conv but the first
    assert flops.model_flops(model_cfg, 5, [("train", 2, 64, 64)]) == pytest.approx(
        3 * fwd - first)


def test_eval_windows_of_config5():
    cell = Benchmark(ROOT).cell("hrnet_w48_train")
    wins = flops.eval_windows(cell.config["config"], (1024, 2048))
    # scales 0.5 .. 1.75 on 1024 x 2048: 1, 2, 3, 6, 8, 10 windows of up to 1024^2, two views
    assert [n for n, _, _ in wins] == [2, 4, 6, 12, 16, 20]
    assert wins[0][1:] == (512, 1024) and wins[2][1:] == (1024, 1024)


def test_step_times_percentile_and_rate():
    ends = [10.0 * (i + 1) for i in range(20)]
    steps = stats.intervals(0.0, ends)
    assert steps == [10.0] * 20
    assert stats.percentile(steps, 95) == pytest.approx(10.0)
    assert stats.rate(16 * 20, ends[-1]) == pytest.approx(1600.0)
    # one stall of 500 ms: every later step ends later
    stalled = ends[:10] + [t + 490.0 for t in ends[10:]]
    steps = stats.intervals(0.0, stalled)
    assert max(steps) == 500.0
    assert stats.percentile(steps, 95) == pytest.approx(10.0 + 0.05 * 490.0)
    assert stats.rate(16 * 20, stalled[-1]) == pytest.approx(16 * 20 / 0.69)


def test_trace_busy_idle_and_gaps():
    t = Trace(device=[("gemm", 0.0, 100.0), ("bn", 50.0, 150.0), ("stem_fwd_kernel", 400.0, 500.0),
                      ("Memcpy HtoD", 900.0, 1000.0)],
              host=[("cudaLaunchKernel", 140.0, 160.0), ("aten::conv2d", 390.0, 420.0),
                    ("aten::item", 500.0, 950.0)],
              wall_s=1e-3, units=1, images=16)
    assert t.busy_s() == pytest.approx(350e-6)
    assert t.device_s() == pytest.approx(300e-6)  # kernels only
    assert t.device_s(("stem_fwd_kernel",)) == pytest.approx(100e-6)
    assert len(t.kernels()) == 3
    assert t.idle_gaps() == [["aten::item", pytest.approx(400e-6)],
                             ["aten::conv2d", pytest.approx(250e-6)]]
    idle = Benchmark(ROOT).cell("hrnet_w48_train").per_layer
    reader = next(m for m in idle if m.name == "idle_share.train")
    # 350 us busy in the one profiled step; the window's steps took 500 us each
    run = types.SimpleNamespace(loop="train", trace=t, window_ms=1.0, attempted=2)
    assert reader.read(run) == pytest.approx(100.0 * (1 - 0.35 / 0.5))


def test_roofline_readers():
    with open(os.path.join(ROOT, "port_bench", "configs", "fixmatch_dlv3p_r50_voc_512.json")) as f:
        cell = types.SimpleNamespace(config=json.load(f))
    stem = _reader("stem_roofline", "%")
    nl, nu, c = 8, 8, 512
    bound = flops.seconds(flops.stem_work(nu, c, False) + flops.stem_work(nl + nu, c, True),
                          H100)
    t = Trace(device=[("stem_fwd_kernel", 0.0, 2 * 1e6 * bound)], units=1)
    run = types.SimpleNamespace(loop="train", trace=t, cell=cell, device_name=H100)
    assert stem.read(run) == pytest.approx(50.0)
    run.trace = Trace(device=[("gemm", 0.0, 10.0)], units=1)
    assert stem.read(run) is None
    assert math.isclose(bound, 159.4e-6, rel_tol=0.01)
    # the branch convs of hrnet_w48_train's step: every conv of the teacher's forward, the
    # student's forward, dW and dx, at twice their least time, read 50 %
    cell = Benchmark(ROOT).cell("hrnet_w48_train")
    branch = next(m for m in cell.per_layer if m.name == "branch_conv_roofline.train")
    cfg = cell.config["config"]
    n, c = 8 + 8, cfg["data"]["crop_size"]
    work = []
    for i, (ch, h, w) in enumerate(flops.hrnet_branch_shapes(cfg["model"], 1, c, c)):
        work += [flops.branch_conv_work(8, ch, h, w, "fwd"),
                 flops.branch_conv_work(n, ch, h, w, "fwd"),
                 flops.branch_conv_work(n, ch, h, w, "dw"),
                 flops.branch_conv_work(n, ch, h, w, "dx_post" if i % 2 else "dx")]
    bound = flops.seconds(work, H100)
    run = types.SimpleNamespace(loop="train", cell=cell, device_name=H100,
                                trace=Trace(device=[("conv_d48_kernel", 0.0, 1e6 * bound),
                                                    ("conv_dw96_kernel", 5e6, 5e6 + 1e6 * bound)],
                                            units=1))
    assert branch.read(run) == pytest.approx(50.0)
    run.trace = Trace(device=[("gemm", 0.0, 10.0)], units=1)
    assert branch.read(run) is None
