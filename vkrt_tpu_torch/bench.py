"""The benchmark entry point (the port's twin of ``bench.py``): the main
path on one card, one JSON line.

    python -m vkrt_tpu_torch.bench

The workload is ``bench.py``'s: the Cornell box (``load_cornell``) at the
width and height of ``config.json`` (1280x720 when it cannot be read),
path-traced at spp 1 and depth 3 with the correlated sampler on
(``RenderSettings().corr_sampler``), pixels in 32x32-tile order seeded by
``tea(pixel id, frame)``, over ``make_tracer(scene, "auto")``: kernel A
(6 launches a frame) and kernel B (3). Frame 0 is the warm-up; then 3
batches of 8 frames, each timed with CUDA events around the batch (the
host clock beside them on stderr), the ray counters kept on the device
until the batch ends. The best batch is reported, as ``bench.py`` does.

Exits: 4 when the accumulator is non-finite or black; then the accuracy
anchor (``benchmarks/accuracy.py``) runs, and 5 when it is out of budget.
An anchor that raises fails the run. Otherwise the last line of stdout is
one JSON object: ``metric``, ``value`` (Mrays/s), ``unit``,
``ms_per_frame``, ``device`` (the card's name) and ``power_limit``.
``vs_baseline`` is left out: ``bench.py``'s ratio is to a target set for
the TPU renderer.

``--device``, ``--width``, ``--height``, ``--batches`` and ``--frames``
exist for the tests (``--device cpu``: the plain versions, times on the
host clock); their defaults are the real workload on the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

SAMPLES = 1
DEPTH = 3
CLEAR = (1.0, 1.0, 1.0, 1.0)


def workload_size() -> tuple:
    """(width, height) of ``config.json`` in the working directory, else
    1280x720 (``bench.py:68-72``)."""
    from vkrt_tpu_torch.config import load_config

    try:
        cfg = load_config("config.json")
        return cfg.width, cfg.height
    except Exception:  # no readable config: the reference's default size
        return 1280, 720


def make_step(scene, tracer, width: int, height: int, device: torch.device):
    """The frame step ``step(frame, accum) -> (accum', rays)``: tile-ordered
    pixels seeded by their original id, as ``Engine.render_frame`` renders
    them; ``accum`` and ``rays`` stay on the device."""
    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.models.pathtracer import pathtrace_frame
    from vkrt_tpu_torch.ops.rng import tea
    from vkrt_tpu_torch.utils.camera import Camera, pixel_coords, tile_perm

    perm, _ = tile_perm(width, height)
    pid = torch.as_tensor(perm.astype(np.int64), device=device)
    pix = pixel_coords(width, height, device)[pid]
    cam = Camera().matrices(width, height, device)
    corr = RenderSettings().corr_sampler

    def step(frame: int, accum):
        return pathtrace_frame(scene, tracer, cam, frame, accum, CLEAR, width=width,
                               height=height, samples=SAMPLES, depth=DEPTH, corr=corr,
                               pix=pix, seeds=tea(pid, frame))

    return step


def measure(device: torch.device, width: int, height: int, batches: int = 3,
            frames: int = 8) -> dict:
    """Frame 0, then ``batches`` timed batches of ``frames`` frames. Returns
    the best batch's {"ms_per_frame", "mrays_per_s", "rays_per_frame"},
    every batch's {"ms", "host_ms", "rays"} and the final accumulator."""
    from vkrt_tpu_torch.ops.trace import make_tracer
    from vkrt_tpu_torch.scene import load_cornell

    t0 = time.perf_counter()
    scene = load_cornell(device=device)
    tracer = make_tracer(scene, "auto")
    step = make_step(scene, tracer, width, height, device)
    print(f"[bench] scene: {scene.num_tris} tris, {scene.num_lights} lights "
          f"({time.perf_counter() - t0:.2f} s); device: {device}", file=sys.stderr)
    cuda = device.type == "cuda"
    accum = torch.zeros((width * height, 3), dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    accum, _ = step(0, accum)
    float(accum[0, 0])  # wait for frame 0
    print(f"[bench] frame 0: {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    runs, f = [], 1
    for _ in range(batches):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        rays = []
        for _ in range(frames):
            accum, r = step(f, accum)
            rays.append(r)  # on the device: a read here would sync every frame
            f += 1
        if cuda:
            end.record()
            end.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        ms = start.elapsed_time(end) if cuda else host_ms
        total = float(torch.stack(rays).sum())
        runs.append({"ms": ms, "host_ms": host_ms, "rays": total})
        print(f"[bench] batch: {ms / frames:.4f} ms/frame ({'CUDA events' if cuda else 'host'})"
              f", host clock {host_ms / frames:.4f} ms/frame, {total / frames:.0f} rays/frame",
              file=sys.stderr)
    best = min(runs, key=lambda b: b["ms"])
    return {"ms_per_frame": best["ms"] / frames,
            "mrays_per_s": best["rays"] / (best["ms"] * 1e-3) / 1e6,
            "rays_per_frame": best["rays"] / frames, "batches": runs, "accum": accum}


def main(argv=None) -> int:
    from vkrt_tpu_torch.benchmarks import accuracy
    from vkrt_tpu_torch.device import card, select

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--frames", type=int, default=8, help="frames a batch")
    args = ap.parse_args(argv)
    dev = select(args.device)
    width, height = workload_size()
    width, height = args.width or width, args.height or height

    res = measure(dev, width, height, args.batches, args.frames)
    final = res["accum"].cpu().numpy()
    if not np.isfinite(final).all():
        print(f"[bench] FATAL: non-finite accum ({int((~np.isfinite(final)).sum())} elements)"
              " -- refusing to report throughput for a broken image", file=sys.stderr,
              flush=True)
        return 4
    if float(final.max()) <= 0.0:
        print("[bench] FATAL: all-zero/black accum -- refusing to report", file=sys.stderr,
              flush=True)
        return 4
    rec = accuracy.run(device=dev)
    if not rec["ok"]:
        print(f"[bench] FATAL: accuracy out of budget: {rec}", file=sys.stderr, flush=True)
        return 5
    info = card(dev)
    print(f"[bench] best of {args.batches} batches of {args.frames} frames: "
          f"{res['ms_per_frame']:.4f} ms/frame, {res['mrays_per_s']:.4f} Mrays/s "
          f"({res['rays_per_frame']:.0f} rays/frame) on {info['name']}, power limit "
          f"{info['power_limit']}", file=sys.stderr, flush=True)
    print(json.dumps({"metric": f"pathtrace_cornell_{width}x{height}_spp{SAMPLES}_depth{DEPTH}",
                      "value": res["mrays_per_s"], "unit": "Mrays/s",
                      "ms_per_frame": res["ms_per_frame"], "device": info["name"],
                      "power_limit": info["power_limit"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
