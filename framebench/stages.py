"""The program's named ranges and counters in a traced stretch: where the
frame's device time and idle time go, stage by stage.

``reduce_ranges`` reads the same Chrome-trace events as
``profile.reduce_trace`` and adds what the program's own ranges
(``vkrt_tpu_torch/utils/profiling.py``: every ``user_annotation`` whose
name does not start with ``framebench.``) say of them:

* each device kernel gets the set of range names enclosing the runtime
  call that launched it, found as ``reduce_trace`` finds its frame;
* ``device_by_range``: device seconds of kernels, each counted once per
  range name (nested ranges of one name count once);
* ``idle_by_range``: idle seconds of the stretch, each gap credited to the
  ranges that enclose the launch of the work that ends it (the rule that
  names ``reduce_trace``'s ``idle_gaps``);
* ``host_s``: the wall duration of each program frame range ("pathtrace" or
  "hybrid", around all of ``Engine.render_frame``): the frame's enqueue.

``counters(engine)`` reads the program's counters (``Engine.total_rays``:
rays that carry a query; ``trace_kernel.lanes``: lanes handed to kernel A),
once after each of the stretch's two synchronises; ``Stages.counters``
holds their differences. ``READERS`` turns a ``Stages`` into per-frame
numbers; each returns None, never 0, where its range or counter saw
nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List

from framebench.profile import _DEVICE, FRAME, STRETCH, _union
from vkrt_tpu_torch.utils.profiling import FRAME_RANGES

PREFIX = "framebench."


@dataclasses.dataclass
class Stages:
    frames: int                         # framebench.frame ranges in the stretch
    seen: FrozenSet[str]                # the program's range names in the stretch
    device_by_range: Dict[str, float]   # device s of kernels launched under each name
    idle_by_range: Dict[str, float]     # idle s ended by work launched under each name
    host_s: List[float]                 # wall s of each program frame range
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)


def reduce_ranges(events: list) -> Stages:
    """Chrome-trace events of one stretch -> ``Stages``."""
    stretch = [e for e in events if e.get("name") == STRETCH and e.get("cat") == "user_annotation"]
    if not stretch:
        raise ValueError("the trace holds no framebench.stretch range")
    w0 = float(stretch[0]["ts"])
    w1 = w0 + float(stretch[0]["dur"])
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                    for e in events if e.get("cat") == "user_annotation"
                    and not e.get("name", "").startswith(PREFIX))
    frames = [e for e in events if e.get("name") == FRAME and e.get("cat") == "user_annotation"]
    host_s = [(e - s) * 1e-6 for s, e, n in ranges if n in FRAME_RANGES and w0 <= s <= w1]
    runtime = {e["args"].get("correlation"): e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e}

    # the names of the ranges enclosing each launch, swept in time order
    launch_ts = sorted({float(e["ts"]) for e in runtime.values()})
    enclosing, active, i = {}, [], 0
    for t in launch_ts:
        while i < len(ranges) and ranges[i][0] <= t:
            active.append(ranges[i])
            i += 1
        active = [r for r in active if r[1] >= t]
        enclosing[t] = {n for _, _, n in active}

    def under(ev):
        rt = runtime.get(ev.get("args", {}).get("correlation")) if ev else None
        return enclosing.get(float(rt["ts"]), set()) if rt is not None else set()

    device, intervals, starts = {}, [], {}
    for e in events:
        if e.get("cat") not in _DEVICE:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0))
        intervals.append((max(s, w0), min(s + d, w1)))
        starts.setdefault(s, e)
        if e["cat"] == "kernel":
            for name in under(e):
                device[name] = device.get(name, 0.0) + d * 1e-6
    _, merged = _union([iv for iv in intervals if iv[1] > iv[0]])
    idle, prev = {}, w0
    for s, e_ in merged + [[w1, w1]]:
        if s > prev:
            for name in under(starts.get(s)):
                idle[name] = idle.get(name, 0.0) + (s - prev) * 1e-6
        prev = max(prev, e_)
    return Stages(frames=len(frames), seen=frozenset(n for _, _, n in ranges),
                  device_by_range=device, idle_by_range=idle, host_s=host_s)


def counters(engine) -> dict:
    """The program's counters (one device read: call between frames)."""
    from vkrt_tpu_torch.ops.cuda.trace import trace_kernel

    return {"rays": engine.total_rays, "lanes": float(trace_kernel.lanes)}


def _device_ms(name):
    def read(st: Stages):
        if name not in st.device_by_range or not st.frames:
            return None
        return 1e3 * st.device_by_range[name] / st.frames
    return read


def _host_ms(st: Stages):
    return 1e3 * sum(st.host_s) / len(st.host_s) if st.host_s else None


def _rng_wait_ms(st: Stages):
    if "rng" not in st.seen or not st.frames:
        return None
    return 1e3 * st.idle_by_range.get("rng", 0.0) / st.frames


def _live_share(st: Stages):
    rays, lanes = st.counters.get("rays"), st.counters.get("lanes")
    return 100.0 * rays / lanes if rays is not None and lanes else None


# metric name -> (unit, reader); each moves frame_ms
READERS = {
    "engine.host_ms": ("ms/frame", _host_ms),
    "rng.ms": ("ms/frame", _device_ms("rng")),
    "rng.wait_ms": ("ms/frame", _rng_wait_ms),
    "texture.ms": ("ms/frame", _device_ms("texture")),
    "gbuffer.ms": ("ms/frame", _device_ms("gbuffer")),
    "visibility.ms": ("ms/frame", _device_ms("visibility")),
    "gi.ms": ("ms/frame", _device_ms("gi")),
    "trace.live_share": ("%", _live_share),
}
