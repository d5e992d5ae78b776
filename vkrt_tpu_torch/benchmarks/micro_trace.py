"""Trace-kernel microbenchmarks (port of ``benchmarks/micro_trace.py``):
where a trace pass spends its time.

Measures, on the card:
  * the launch floor: kernel C (kernel A's ray I/O, no traversal) at 128,
    256, 512 and 1024 threads a block, per launch on the device and per
    call on the host;
  * kernel A closest and any (first-hit-kills, bound 100) on primary and on
    incoherent rays.

Usage: python -m vkrt_tpu_torch.benchmarks.micro_trace [--scene cornell|city]
           [--width 1280 --height 720] [--iters N] [--floor-only]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vkrt_tpu_torch.benchmarks import SCENES, build, describe, time_calls, where
from vkrt_tpu_torch.device import select
from vkrt_tpu_torch.ops.cuda.probes import FLOOR_THREADS, floor_kernel
from vkrt_tpu_torch.ops.intersect import T_MAX
from vkrt_tpu_torch.utils.camera import Camera, generate_rays, pixel_coords, tile_perm

ANY_BOUND = 100.0  # micro_trace.py's any-hit tMax


def ray_count(width: int, height: int) -> int:
    """The rays of a frame, rounded down to whole 1024-ray blocks."""
    n = width * height
    return n - n % 1024


def make_rays(scene, width: int, height: int, kind: str, device):
    """(o, d) of ``ray_count`` rays: "primary" (scanline, centre jitter),
    "tiled" (the same rays in 32x32-tile order, as ``variants.py`` takes
    them) or "incoherent" (numpy ``default_rng(0)`` origins in the scene's
    bounding box and normalised normal directions)."""
    n = ray_count(width, height)
    if kind == "incoherent":
        rng = np.random.default_rng(0)
        v0 = scene.tri_v0.cpu().numpy()
        lo, hi = v0.min(0), v0.max(0)
        o = rng.uniform(lo, hi, (width * height, 3)).astype(np.float32)
        d = rng.normal(size=(width * height, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return torch.as_tensor(o[:n], device=device), torch.as_tensor(d[:n], device=device)
    cam = Camera().matrices(width, height, device)
    jitter = torch.full((width * height, 2), 0.5, device=device)
    pix = None
    if kind == "tiled":
        perm, _ = tile_perm(width, height)
        pix = pixel_coords(width, height, device)[torch.as_tensor(perm.astype(np.int64),
                                                                  device=device)]
    elif kind != "primary":
        raise ValueError(f"unknown ray kind {kind!r}")
    o, d = generate_rays(cam, width, height, jitter, pix=pix)
    return o[:n].contiguous(), d[:n].contiguous()


def floor_sweep(o, d, t_lim, iters: int):
    """Kernel C at every block size: [{threads, device_us, host_us,
    mrays_ceiling}], and the last launch's output."""
    rows, out = [], None
    for threads in FLOOR_THREADS:
        dev_ms, host_ms = time_calls(lambda: floor_kernel(o, d, t_lim, threads), iters,
                                     o.device)
        out = floor_kernel(o, d, t_lim, threads)
        rows.append({"threads": threads, "device_us": dev_ms * 1e3, "host_us": host_ms * 1e3,
                     "mrays_ceiling": o.shape[0] / (dev_ms * 1e-3) / 1e6})
    return rows, out


def trace_timings(tracer, o, d, iters: int):
    """Kernel A closest (bound T_MAX) and any (first-hit-kills, bound 100):
    {mode: {ms, mrays, hits, t_lim}}."""
    n = o.shape[0]
    res = {}
    for mode, lim, any_hit in (("closest", T_MAX, False), ("any", -ANY_BOUND, True)):
        t_lim = torch.full((n,), lim, device=o.device)
        ms, _ = time_calls(lambda: tracer.trace(o, d, t_lim, any_hit=any_hit), iters,
                           o.device)
        res[mode] = {"ms": ms, "mrays": n / (ms * 1e-3) / 1e6,
                     "hits": tracer.trace(o, d, t_lim, any_hit=any_hit), "t_lim": t_lim}
    return res


def run(scene: str = "cornell", width: int = 1280, height: int = 720, iters: int = 8,
        floor_only: bool = False, device="cuda", built=None) -> dict:
    """The floor sweep, then kernel A on ``scene``'s primary and incoherent
    rays. ``built``: a ``benchmarks.build`` result to reuse."""
    device = select(device) if isinstance(device, str) else device
    n = ray_count(width, height)
    print(f"device={where(device)} rays={n}")
    cam_o, cam_d = make_rays(None, width, height, "primary", device)
    floor, floor_out = floor_sweep(cam_o, cam_d, torch.full((n,), T_MAX, device=device), iters)
    for r in floor:
        print(f"floor threads={r['threads']:4d}: {r['device_us']:9.3f} us/launch device, "
              f"{r['host_us']:9.3f} us/call host ({r['mrays_ceiling']:9.1f} Mrays/s ceiling)")
    res = {"rays": n, "floor": floor, "floor_out": floor_out}
    if floor_only:
        return res
    b = built or build(scene, device)
    print(describe(b))
    res["built"] = b
    for kind in ("primary", "incoherent"):
        o, d = make_rays(b.scene, width, height, kind, device)
        t = trace_timings(b.tracer, o, d, iters)
        for mode in ("closest", "any"):
            print(f"{mode:7s} {kind:10s}: {t[mode]['ms']:9.4f} ms  "
                  f"{t[mode]['mrays']:9.2f} Mrays/s")
        res[kind] = {"o": o, "d": d, **t}
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", default="cornell", choices=SCENES)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--floor-only", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if ray_count(args.width, args.height) == 0:
        p.error("width x height must hold at least 1024 rays")
    run(args.scene, args.width, args.height, args.iters, args.floor_only, args.device)


if __name__ == "__main__":
    main()
