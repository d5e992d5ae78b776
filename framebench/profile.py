"""The traced stretch: ``torch.profiler`` over a fixed number of whole
frames inside the window, reduced to what the per-layer readers
(``framebench/metrics/<metric>.py``) take.

The idle share is ``chip_smoke.py::profile_calls``'s arithmetic (the union
of device intervals against a window) with the window widened from first
kernel to last to the whole stretch: a synchronise before it, the frames,
and a synchronise after them. Device work is tied to its frame by the
correlation id of the runtime call that launched it, and that call to the
frame by the ``framebench.frame`` range around each ``render_frame``.
The program's own kernels are those declared ``__global__`` in
``vkrt_tpu_torch/csrc``; every other kernel is PyTorch's.
"""

from __future__ import annotations

import bisect
import dataclasses
import glob
import json
import os
import re
import tempfile
from typing import Dict, List, Optional

FRAME = "framebench.frame"
STRETCH = "framebench.stretch"
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel|cuLaunchKernelEx)")


def own_kernel_names(root: str) -> List[str]:
    names = set()
    for path in glob.glob(os.path.join(root, "vkrt_tpu_torch", "csrc", "*.cu")):
        with open(path) as f:
            src = f.read()
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src))
    return sorted(names)


@dataclasses.dataclass
class Kernel:
    frame: int          # index within the stretch, -1 outside every frame
    name: str
    start_s: float
    dur_s: float
    own: Optional[str]  # the program's kernel name, None for PyTorch's


@dataclasses.dataclass
class Stretch:
    frames: int
    kernels: List[Kernel]       # device kernels in start order
    launches: int               # kernel launch calls inside the frames
    busy_s: float               # union of device kernel and copy intervals
    window_s: float             # the stretch's wall clock
    breakdown: Dict[str, list]
    yard: object = None         # the cell's yardsticks (framebench.roofline.Yardsticks)

    def first_per_frame(self, own: str) -> List[Kernel]:
        """Each frame's first launch of the program's kernel ``own``."""
        seen, out = set(), []
        for k in self.kernels:
            if k.own == own and k.frame >= 0 and k.frame not in seen:
                seen.add(k.frame)
                out.append(k)
        return out


def _union(intervals):
    busy, merged = 0.0, []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    for s, e in merged:
        busy += e - s
    return busy, merged


def _innermost(ops_start, ops, t):
    """The latest-starting CPU op that encloses time ``t``."""
    i = bisect.bisect_right(ops_start, t) - 1
    steps = 0
    while i >= 0 and steps < 4096:
        s, e, name = ops[i]
        if e >= t:
            return name
        i -= 1
        steps += 1
    return "host"


def reduce_trace(events: list, own_names: List[str]) -> Stretch:
    """Chrome-trace events of one stretch -> ``Stretch``."""
    stretch = [e for e in events if e.get("name") == STRETCH and e.get("cat") == "user_annotation"]
    if not stretch:
        raise ValueError("the trace holds no framebench.stretch range")
    w0 = float(stretch[0]["ts"])
    w1 = w0 + float(stretch[0]["dur"])
    frames = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("name") == FRAME and e.get("cat") == "user_annotation")
    fstarts = [f[0] for f in frames]

    def frame_of(t):
        i = bisect.bisect_right(fstarts, t) - 1
        return i if i >= 0 and t <= frames[i][1] else -1

    runtime = {}
    launches = 0
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e:
            runtime[e["args"].get("correlation")] = e
            if _LAUNCH.match(e.get("name", "")) and frame_of(float(e["ts"])) >= 0:
                launches += 1
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                 for e in events if e.get("cat") == "cpu_op")
    ops_start = [o[0] for o in ops]
    kernels, intervals, by_name = [], [], {}
    for e in events:
        if e.get("cat") not in _DEVICE:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0))
        intervals.append((max(s, w0), min(s + d, w1)))
        if e["cat"] != "kernel":
            continue
        rt = runtime.get(e.get("args", {}).get("correlation"))
        frame = frame_of(float(rt["ts"])) if rt is not None else -1
        own = next((n for n in own_names if n in e["name"]), None)
        kernels.append(Kernel(frame, e["name"], s * 1e-6, d * 1e-6, own))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + d * 1e-6
    kernels.sort(key=lambda k: k.start_s)
    busy, merged = _union([iv for iv in intervals if iv[1] > iv[0]])
    # idle gaps, each named by the host op that launched the work ending it
    starts = {}
    for e in events:
        if e.get("cat") in _DEVICE:
            starts.setdefault(float(e["ts"]), e)
    gaps, prev = {}, w0
    for s, e_ in merged + [[w1, w1]]:
        if s > prev:
            ev = starts.get(s)
            rt = runtime.get(ev.get("args", {}).get("correlation")) if ev else None
            name = "sync" if ev is None else (
                _innermost(ops_start, ops, float(rt["ts"])) if rt is not None else "host")
            gaps[name] = gaps.get(name, 0.0) + (s - prev) * 1e-6
        prev = max(prev, e_)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return Stretch(frames=len(frames), kernels=kernels, launches=launches,
                   busy_s=busy * 1e-6, window_s=(w1 - w0) * 1e-6,
                   breakdown={"device_ops": [[n[:120], v] for n, v in top],
                              "idle_gaps": [[n[:120], v] for n, v in idle]})


class Recorder:
    """Starts and stops the profiler around whole frames of the window."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.range = None

    def start(self):
        self.torch.cuda.synchronize()
        self.prof.start()
        self.range = self.torch.autograd.profiler.record_function(STRETCH)
        self.range.__enter__()

    def stop(self):
        self.torch.cuda.synchronize()
        self.range.__exit__(None, None, None)
        self.prof.stop()

    def events(self) -> list:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(path)
