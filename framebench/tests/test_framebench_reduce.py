"""The trace reduction, the frame-time tail and both roofline counts on
synthetic inputs."""

import pytest

from framebench import roofline
from framebench.profile import Stretch, reduce_trace
from framebench.run import _load_reader, _quantile, frame_start
from framebench.cells import ROOT
import os

METRICS = os.path.join(ROOT, "framebench")


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    """A 100 us stretch of two frames: frame 0 launches a trace kernel and a
    PyTorch kernel, frame 1 a shade kernel and a PyTorch kernel; one copy."""
    return [
        _ev("user_annotation", "framebench.stretch", 0, 100),
        _ev("user_annotation", "framebench.frame", 1, 40),
        _ev("user_annotation", "framebench.frame", 45, 40),
        _ev("cpu_op", "aten::add", 2, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 3, 1, 1),
        _ev("cpu_op", "aten::mul", 20, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 21, 1, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 50, 1, 3),
        _ev("cpu_op", "aten::__and__", 60, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 61, 1, 4),
        _ev("cuda_runtime", "cudaMemcpyAsync", 70, 1, 5),
        _ev("kernel", "void (anonymous namespace)::trace_kernel<float4>(...)", 10, 10, 1),
        _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>", 25, 5, 2),
        _ev("kernel", "void (anonymous namespace)::shade_kernel<true>(...)", 52, 8, 3),
        _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>", 58, 6, 4),
        _ev("gpu_memcpy", "Memcpy DtoD", 90, 5, 5),
        _ev("gpu_user_annotation", "pathtrace", 0, 100),
    ]


def test_reduce_trace():
    s = reduce_trace(_trace(), ["shade_kernel", "trace_kernel"])
    assert s.frames == 2 and s.launches == 4
    # device busy: [10,20] [25,30] [52,64] [90,95] = 32 us of 100
    assert s.busy_s == pytest.approx(32e-6) and s.window_s == pytest.approx(100e-6)
    assert [k.frame for k in s.kernels] == [0, 0, 1, 1]
    assert [k.own for k in s.kernels] == ["trace_kernel", None, "shade_kernel", None]
    gaps = dict(s.breakdown["idle_gaps"])
    # 0-10 before the trace kernel (aten::add), 20-25 (aten::mul), 30-52 (no op:
    # the launch at 50), 64-90 (the copy's launch), 95-100 (the closing sync)
    assert gaps["aten::add"] == pytest.approx(10e-6)
    assert gaps["aten::mul"] == pytest.approx(5e-6)
    assert gaps["host"] == pytest.approx(22e-6 + 26e-6)
    assert gaps["sync"] == pytest.approx(5e-6)
    ops = dict(s.breakdown["device_ops"])
    assert ops["void at::native::vectorized_elementwise_kernel<4>"] == pytest.approx(11e-6)


@pytest.mark.parametrize("name,expected", [
    ("engine.launches", 2.0),
    ("device.idle_share", 68.0),
    ("torch_ops.ms", 1e3 * 11e-6 / 2),
    ("trace.ms", 1e3 * 10e-6 / 2),
])
def test_readers(name, expected):
    s = reduce_trace(_trace(), ["shade_kernel", "trace_kernel"])
    assert _load_reader(METRICS, name)(s) == pytest.approx(expected)


class _Yard:
    def primary_bound_s(self):
        return 5e-6

    def shade_bound_s(self):
        return 4e-6


@pytest.mark.parametrize("name,expected", [
    ("trace.primary_roofline", 50.0),   # 5 us over the 10 us first trace launch
    ("shade.bounce0_roofline", 50.0),   # 4 us over the 8 us first shade launch
])
def test_roofline_readers(name, expected):
    s = reduce_trace(_trace(), ["shade_kernel", "trace_kernel"])
    s.yard = _Yard()
    assert _load_reader(METRICS, name)(s) == pytest.approx(expected)


def test_readers_return_nothing_without_their_kernel():
    s = Stretch(frames=2, kernels=[], launches=0, busy_s=0.0, window_s=1.0, breakdown={})
    for name in ("trace.ms", "torch_ops.ms", "trace.primary_roofline",
                 "shade.bounce0_roofline"):
        assert _load_reader(METRICS, name)(s) is None


def test_p95_nearest_rank():
    vals = list(range(1, 201))  # 200 intervals: 10 lie beyond the p95
    assert _quantile(vals, 0.95) == 190
    assert _quantile([3.0], 0.95) == 3.0


def test_roofline_counts():
    class Cell:
        width, height = 1000, 500

    y = roofline.Yardsticks(Cell(), None)
    y._primary = None
    px = 500_000
    assert y.shade_bound_s() == pytest.approx(223.2 * px / 3.35e12)
    # operations bind at 40 box and 3 triangle tests a ray
    roofline_primary = roofline.primary_tests
    try:
        roofline.primary_tests = lambda ref: (40.0, 3.0)
        ops = (26 * 40 + 52 * 3) * px / 33.5e12
        assert y.primary_bound_s() == pytest.approx(max(ops, 44 * px / 3.35e12))
        assert ops > 44 * px / 3.35e12
    finally:
        roofline.primary_tests = roofline_primary


def test_seeds_of_any_size():
    from framebench.check import draw_pixels

    for seed in (-5, 0, 1, 2**31 + 12345, 2**40 + 7, 2**62):
        f = frame_start(seed)
        assert 1 <= f <= 64
        px = draw_pixels(seed, 10_000, 64)
        assert len(set(px.tolist())) == 64 and px.max() < 10_000
