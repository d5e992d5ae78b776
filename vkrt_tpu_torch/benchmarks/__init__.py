"""Trace-kernel probes: the port's counterparts of ``benchmarks/micro_trace.py``
and ``benchmarks/scratch/{ablate_kernel,variants,vpupeak}.py``, the paths
that run kernels C-F (``ops/cuda/probes.py``, ``ops/cuda/trace_variants.py``).

Each module is an entry point (``python -m vkrt_tpu_torch.benchmarks.<name>``)
with a ``run`` function that returns what it printed. They run on the card
(``--device cuda``, the default; raises without one) or, with
``--device cpu``, through the plain versions at a tiny size; a CPU run's
times are the CPU's, not the card's.

The scenes are Cornell (``load_cornell``) and the city (``make_city(grid=96)``,
143,568 triangles), as the JAX probes build them.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from vkrt_tpu_torch.device import select
from vkrt_tpu_torch.ops.cuda.trace import CudaTracer, build_bvh
from vkrt_tpu_torch.ops.cuda.trace_variants import ProbeTables, probe_tables
from vkrt_tpu_torch.ops.trace import Tracer
from vkrt_tpu_torch.scene import SceneTensors, load_cornell, make_city

SCENES = ("cornell", "city")
CITY_GRID = 96
SPIN_HZ = 2.0e9  # spin-kernel cycles a second: about the H100's SM clock
SPIN_MAX_S = 2.0


@dataclasses.dataclass(frozen=True)
class BuiltScene:
    name: str
    scene: SceneTensors
    tables: ProbeTables  # kernel A's BVH tables and the probes' host tables
    tracer: Tracer       # kernel A on the card, brute force on the CPU
    seconds: dict        # host build times: scene, bvh, tables


def build(name: str, device="cuda") -> BuiltScene:
    """Cornell or the city on ``device``, with its BVH and probe tables;
    each host stage timed on the host clock."""
    if name not in SCENES:
        raise ValueError(f"unknown scene {name!r} (one of {SCENES})")
    device = select(device) if isinstance(device, str) else device
    t0 = time.perf_counter()
    scene = load_cornell(device) if name == "cornell" else make_city(CITY_GRID, device=device)
    t1 = time.perf_counter()
    bvh = build_bvh(scene)
    t2 = time.perf_counter()
    tables = probe_tables(bvh, scene)
    t3 = time.perf_counter()
    tracer = CudaTracer(scene=scene, bvh=bvh) if device.type == "cuda" else Tracer(scene)
    return BuiltScene(name, scene, tables, tracer,
                      {"scene": t1 - t0, "bvh": t2 - t1, "tables": t3 - t2})


def describe(b: BuiltScene) -> str:
    s = b.seconds
    return (f"scene {b.name}: {b.scene.num_tris} tris (padded), "
            f"{b.tables.bvh.threaded.shape[0]} BVH nodes ({b.tables.bvh.nodes.shape[0]} "
            f"child-box records), depth {b.tables.max_depth}, "
            f"cut depth {b.tables.cut_depth} ({b.tables.cut.shape[0]} cut nodes), "
            f"{b.tables.wide.nodes.shape[0]} four-child records (depth "
            f"{b.tables.wide.depth}, stack {b.tables.wide.stack}); "
            f"host build {s['scene']:.3f} s scene + {s['bvh']:.3f} s BVH + "
            f"{s['tables']:.3f} s tables on {b.scene.device}")


def time_calls(fn, iters: int, device: torch.device):
    """(device ms, host ms) per call of ``fn`` after one warm-up call.

    On the card the ``iters`` calls are queued behind a spin kernel
    (``torch.cuda._sleep``) lasting twice their measured wall time (at
    most ``SPIN_MAX_S``), so the CUDA events around them time the device
    running them back to back rather than the host's launch rate. (A call
    of more launches than the device's queue holds blocks the host until
    the queue drains, which keeps the device busy too.) Host ms is the
    enqueue time per call on the host clock. On the CPU the host clock
    gives both."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / iters
        return ms, ms
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    spin_s = min(2 * iters * (time.perf_counter() - t0), SPIN_MAX_S)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(spin_s * SPIN_HZ) + 1)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms / iters


def where(device: torch.device) -> str:
    """The device a result was measured on, for every printed header."""
    if device.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(device)})"
    return "cpu (plain versions; times are the CPU's, not the card's)"
