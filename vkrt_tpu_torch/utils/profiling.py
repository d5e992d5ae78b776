"""Profiling and observability: frame timing, Mrays/s, profiler hooks
(port of ``vkrt_tpu/utils/profiling.py``).

The reference's observability is an ImGui ms/frame + FPS readout
(main.cpp:459) and debug-utils pass labels visible in Nsight
(hello_vulkan.cpp:587-1472). Here: ``FrameStats`` (ms/frame, FPS, Mrays/s),
``pass_label`` (a named range in torch.profiler traces, the analog of
beginLabel/endLabel, opened only while a profiler records; ``labelled``
puts a function under one), ``timed_frame`` (a host clock that
synchronises the device first), ``device_trace`` (a torch.profiler Chrome
trace of the host and the card) and ``nan_debug`` (a tripwire for
non-finite frames).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

_NAN_DEBUG = contextvars.ContextVar("vkrt_nan_debug", default=False)


@dataclass
class FrameStats:
    """Rolling frame statistics: the ImGui readout, headless."""

    times_s: List[float] = field(default_factory=list)
    rays: List[float] = field(default_factory=list)

    def record(self, seconds: float, rays: float = 0.0):
        self.times_s.append(seconds)
        self.rays.append(rays)

    @property
    def ms_per_frame(self) -> float:
        return 1e3 * sum(self.times_s) / max(len(self.times_s), 1)

    @property
    def fps(self) -> float:
        t = sum(self.times_s) / max(len(self.times_s), 1)
        return 1.0 / t if t > 0 else 0.0

    @property
    def mrays_per_s(self) -> float:
        t = sum(self.times_s)
        return sum(self.rays) / t / 1e6 if t > 0 else 0.0

    def summary(self) -> dict:
        return {
            "frames": len(self.times_s),
            "ms_per_frame": round(self.ms_per_frame, 3),
            "fps": round(self.fps, 2),
            "mrays_per_s": round(self.mrays_per_s, 2),
        }

    def log(self, stream=None):
        """One JSON line of ``summary()``, to stderr unless ``stream``."""
        print(json.dumps(self.summary()), file=stream or sys.stderr)


# The program's named ranges, each read by a stage of a trace: the frame
# ("pathtrace" or "hybrid", around all of ``Engine.render_frame``), the RNG
# prologue ("rng": ``ops/rng.py``'s TEA seeds and correlated-draw tables),
# the hybrid's stages ("gbuffer", "visibility", "gi", "denoise"), every
# texel fetch ("texture") and a re-pose ("repose").
FRAME_RANGES = ("pathtrace", "hybrid")
RANGES = FRAME_RANGES + ("rng", "gbuffer", "visibility", "gi", "texture", "denoise", "repose")
_NO_RANGE = contextlib.nullcontext()


def recording() -> bool:
    """Whether a profiler records: ``torch.profiler.profile`` and
    ``device_trace`` alike."""
    return torch._C._autograd._profiler_enabled()


def pass_label(name: str):
    """Named range in torch.profiler traces: beginLabel/endLabel. With no
    profiler recording it opens nothing, so a range costs one test."""
    return torch.profiler.record_function(name) if recording() else _NO_RANGE


def labelled(name: str):
    """Decorator: every call of the function under ``pass_label(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with pass_label(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def synchronize(device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed_frame(stats: FrameStats, rays: float = 0.0, *, device=None):
    """Time one frame on the host clock into ``stats``. ``device``: the
    engine's device, synchronised before each reading of the clock so the
    time is the frame's and not its enqueue's."""
    if device is not None:
        synchronize(device)
    t0 = time.perf_counter()
    yield
    if device is not None:
        synchronize(device)
    stats.record(time.perf_counter() - t0, rays)


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """torch.profiler over the scope (host and, where there is one, the
    card), written as a Chrome trace into ``logdir``; a no-op for None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


def nan_debug_enabled() -> bool:
    return _NAN_DEBUG.get()


def check_finite(x: torch.Tensor, what: str) -> None:
    """Raise FloatingPointError when ``x`` holds a NaN or an infinity (one
    read of the device)."""
    bad = int((~torch.isfinite(x)).sum())
    if bad:
        raise FloatingPointError(f"{what}: {bad} non-finite values")


@contextlib.contextmanager
def nan_debug(enable: bool = True):
    """Opt-in NaN tripwire (SURVEY.md §5: the analog of Vulkan validation):
    under this scope ``Engine.render_frame`` raises FloatingPointError on a
    non-finite composite. PyTorch has no ``jax_debug_nans``; the check costs
    one device read a frame, and only inside the scope."""
    token = _NAN_DEBUG.set(bool(enable))
    try:
        yield
    finally:
        _NAN_DEBUG.reset(token)
