"""The port's named ranges and counters (``utils/profiling.py``,
``ops/cuda/trace.py``) and the benchmark's reading of them
(``framebench/stages.py``), on the CPU:

* under ``torch.profiler`` a path frame and a hybrid frame of a small
  textured city put "rng" and "texture" inside their frame range, the
  hybrid frame "gbuffer", "visibility" and "gi" too, and the seeds' TEA
  rounds lie inside the frame range;
* with no profiler recording, ``pass_label`` opens no range;
* on the kernel-A backend ``trace_kernel.lanes`` grows by exactly the lanes
  handed to the kernel's wrapper, and ``Engine.total_rays`` by the lanes
  that carry a query (a segment that is not empty), both as
  ``stages.counters`` reads them;
* ``reduce_ranges`` on a fixed synthetic trace: the device and idle time of
  each range as computed by hand, the existing ``reduce_trace`` fields
  unchanged by the program's ranges, and every reader None, never 0, where
  its range or counter saw nothing."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from framebench.profile import reduce_trace
from framebench.stages import READERS, Stages, counters, reduce_ranges
from vkrt_tpu_torch import engine as engine_mod
from vkrt_tpu_torch.config import RenderSettings
from vkrt_tpu_torch.engine import Engine
from vkrt_tpu_torch.ops.cuda import trace as cuda_trace
from vkrt_tpu_torch.scene import make_city

torch.set_num_threads(2)

W, H = 32, 24
PATH = RenderSettings(rt_mode=1, depth=3, corr_sampler=True, backend="pallas")
HYBRID = RenderSettings(rt_mode=0, depth=3, corr_sampler=True, backend="pallas")


@pytest.fixture(scope="module")
def city():
    return make_city(grid=2, device="cpu")


def _ranges(prof):
    """(start, end, name) of every record_function range, in start order."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.is_user_annotation)


def _inside(r, outer):
    return outer[0] <= r[0] and r[1] <= outer[1]


@pytest.mark.parametrize("settings,frame_range,stages", [
    (PATH, "pathtrace", ("rng", "texture")),
    (HYBRID, "hybrid", ("rng", "texture", "gbuffer", "visibility", "gi")),
], ids=["path", "hybrid"])
def test_stages_nest_inside_the_frame(city, monkeypatch, settings, frame_range, stages):
    eng = Engine(city, W, H, settings)
    eng.render_frame()
    tea = engine_mod.tea

    def seeds(*args, **kwargs):  # marks the engine's seed call
        with torch.profiler.record_function("test.seeds"):
            return tea(*args, **kwargs)

    monkeypatch.setattr(engine_mod, "tea", seeds)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.render_frame()
    ranges = _ranges(prof)
    frames = [r for r in ranges if r[2] == frame_range]
    assert len(frames) == 1
    frame = frames[0]
    for name in stages:
        mine = [r for r in ranges if r[2] == name]
        assert mine, name
        assert all(_inside(r, frame) for r in mine), name
    (seed_range,) = [r for r in ranges if r[2] == "test.seeds"]
    assert _inside(seed_range, frame)
    assert any(r[2] == "rng" and _inside(r, seed_range) for r in ranges)


def test_pass_label_opens_nothing_unrecorded(city, monkeypatch):
    from vkrt_tpu_torch.utils import profiling

    def refuse(name, *args, **kwargs):
        raise AssertionError(f"range {name!r} opened with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.recording()
    for settings in (PATH, HYBRID):
        eng = Engine(city, W, H, settings)
        eng.render_frame()
        eng.render_frame()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
        with pytest.raises(AssertionError, match="'rng'"):
            with profiling.pass_label("rng"):
                pass


@pytest.mark.parametrize("settings", [PATH, HYBRID], ids=["path", "hybrid"])
def test_lanes_and_live_rays(city, monkeypatch, settings):
    eng = Engine(city, W, H, settings)
    eng.render_frame()
    handed, live = [], []
    plain = cuda_trace.trace_rays_bruteforce

    def spy(v0, e1, e2, o, d, t_lim, t_min):
        handed.append(o.shape[0])
        nonempty = (t_lim.abs() > t_min) & (d != 0).any(dim=-1)
        live.append(int(nonempty.sum()))
        return plain(v0, e1, e2, o, d, t_lim, t_min)

    monkeypatch.setattr(cuda_trace, "trace_rays_bruteforce", spy)
    c0 = counters(eng)
    eng.render_frame()
    c1 = counters(eng)
    lanes, rays = c1["lanes"] - c0["lanes"], c1["rays"] - c0["rays"]
    assert handed and lanes == sum(handed)
    assert rays <= lanes
    assert rays == sum(live)
    assert sum(live) < lanes  # padded and dead lanes are walked too


# --- the benchmark's reading, on a fixed synthetic trace ---------------------


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _base():
    """A 100 us stretch of two frames, four kernels and a copy."""
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
    ]


def _program_ranges():
    """Frame 0 under "pathtrace" with nested "rng" ranges around the first
    launch; frame 1 under "hybrid", its second launch under "gi" and
    "texture", the copy's under "gi"."""
    return [
        _ev("user_annotation", "pathtrace", 1.5, 38),
        _ev("user_annotation", "rng", 2, 10),
        _ev("user_annotation", "rng", 2.5, 2),   # nested: counts once
        _ev("user_annotation", "hybrid", 46, 38),
        _ev("user_annotation", "gi", 55, 20),
        _ev("user_annotation", "texture", 60, 3),
        _ev("gpu_user_annotation", "rng", 10, 10),
    ]


def test_reduce_ranges_by_hand():
    st = reduce_ranges(_base() + _program_ranges())
    assert st.frames == 2
    assert st.seen == {"pathtrace", "rng", "hybrid", "gi", "texture"}
    dev = st.device_by_range
    # kernel 1 (10 us) under pathtrace + rng; kernel 2 (5) under pathtrace;
    # kernel 3 (8) under hybrid; kernel 4 (6) under hybrid + gi + texture
    assert dev["rng"] == pytest.approx(10e-6)
    assert dev["pathtrace"] == pytest.approx(15e-6)
    assert dev["hybrid"] == pytest.approx(14e-6)
    assert dev["gi"] == pytest.approx(6e-6) and dev["texture"] == pytest.approx(6e-6)
    idle = st.idle_by_range
    # gaps: 0-10 ends at kernel 1 (pathtrace, rng), 20-25 kernel 2 (pathtrace),
    # 30-52 kernel 3 (hybrid), 64-90 the copy (hybrid, gi), 95-100 the sync
    assert idle["rng"] == pytest.approx(10e-6)
    assert idle["pathtrace"] == pytest.approx(15e-6)
    assert idle["hybrid"] == pytest.approx(48e-6)
    assert idle["gi"] == pytest.approx(26e-6)
    assert "texture" not in idle
    assert st.host_s == pytest.approx([38e-6, 38e-6])
    st.counters = {"rays": 30.0, "lanes": 40.0}
    got = {name: read(st) for name, (_, read) in READERS.items()}
    assert got == pytest.approx({
        "engine.host_ms": 38e-3, "rng.ms": 5e-3, "rng.wait_ms": 5e-3,
        "texture.ms": 3e-3, "gbuffer.ms": None, "visibility.ms": None, "gi.ms": 3e-3,
        "trace.live_share": 75.0})


def test_reduce_trace_unchanged_by_program_ranges():
    own = ["shade_kernel", "trace_kernel"]
    plain = reduce_trace(_base(), own)
    ranged = reduce_trace(_base() + _program_ranges(), own)
    for f in ("frames", "launches", "busy_s", "window_s", "breakdown"):
        assert getattr(ranged, f) == getattr(plain, f), f
    assert [dataclasses.astuple(k) for k in ranged.kernels] == \
        [dataclasses.astuple(k) for k in plain.kernels]


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_none_without_their_range(name):
    st = reduce_ranges(_base())
    assert st.seen == frozenset() and st.device_by_range == {} and st.idle_by_range == {}
    assert READERS[name][1](st) is None
    empty = Stages(frames=0, seen=frozenset(), device_by_range={}, idle_by_range={},
                   host_s=[], counters={"rays": 0.0, "lanes": 0.0})
    assert READERS[name][1](empty) is None
