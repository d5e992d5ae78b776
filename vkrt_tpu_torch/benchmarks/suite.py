"""The benchmark suite's rows through the port's ``Engine`` (port of
``benchmarks/suite.py``; the row names and JSON keys are the JAX suite's):

1. ``cornell_1spp_1bounce``: Cornell path trace, spp 1, depth 1;
2. ``cornell_multibounce_accum``: Cornell, depth 5, progressive accumulation;
3. ``city_full_pathtrace``: ``make_city(grid=96)`` (143,568 triangles, the
   Sponza-class stand-in), depth 4;
4. ``hybrid_shadows_ao_gi``: the city in hybrid mode, shadows, AO and GI;
5. ``city_flythrough_denoised``: hybrid with the temporal denoiser, the
   camera moving every frame, plus ``rmse_vs_converged`` and
   ``rmse_noisy_1frame``;
6. ``cornell_sharded_mesh``: the glTF Cornell box in path mode, depth 3,
   the correlated sampler on, over a (tile, spp) mesh of ranks
   (``parallel/``) of ``factor_mesh(cards)`` (one card: mesh (1, 1), which
   is bit-equal to the engine); one spp group per rank, spp = n_spp;
7. ``bigcity_full_pathtrace``: ``make_city(grid=160)``, depth 4;
8. ``sponzoid_disk_pathtrace``: the on-disk sponzoid (``utils/sponzoid.py``,
   tess 4, 161,920 triangles, four textured materials with normal maps,
   five KHR point lights) through ``parse_gltf -> build_scene -> Engine``,
   depth 3. Its textures are the PNG form, which decodes at full size
   without PIL (the row refuses a texture under 256 px); the asset and the
   rendered PNG go to ``vkrt_tpu_torch/build/assets/sponzoid/``.

Usage: python -m vkrt_tpu_torch.benchmarks.suite [--width W --height H
--frames N --configs 1,2,3 --device cuda|cpu]. Prints one JSON line per
row; each row is timed over its frames after one warm-up frame, with the
device synchronised before and after the batch, and refuses an image
that is not finite or is all black.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vkrt_tpu_torch.device import select
from vkrt_tpu_torch.utils.profiling import synchronize

ROWS = ("1", "2", "3", "4", "5", "6", "7", "8")
ASSET_DIR = Path(__file__).resolve().parent.parent / "build" / "assets" / "sponzoid"
SPONZOID_TESS = 4
MIN_TEXTURE_PX = 256


def _assert_finite_image(name, arr):
    """A NaN/Inf or all-black render fails the row instead of posting a
    timing: a time for a broken image is not a number."""
    a = np.asarray(arr)
    if not np.isfinite(a).all():
        raise AssertionError(f"[suite:{name}] {(~np.isfinite(a)).sum()} non-finite output "
                             "elements; refusing to report a timing for a broken image")
    if float(np.abs(a).max()) <= 0.0:
        raise AssertionError(f"[suite:{name}] all-zero output image")


def run_engine_bench(name, scene, settings, width, height, frames, camera_fn=None,
                     png_out=None, extra_metrics_fn=None):
    """One row: an ``Engine`` on ``scene``, one warm-up frame, then
    ``frames`` frames timed on the host clock between two device
    synchronisations (``camera_fn(t)``, t in [0, 1), poses a frame).
    Prints and returns the row's JSON object."""
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.utils.camera import Camera

    eng = Engine(scene, width, height, settings,
                 camera=camera_fn(0.0) if camera_fn else Camera())
    eng.render_frame().cpu()  # warm-up
    eng.reset_frame()
    eng.total_rays = 0.0
    synchronize(eng.device)
    t0 = time.perf_counter()
    for f in range(frames):
        if camera_fn is not None:
            eng.camera = camera_fn(f / max(frames, 1))
        out = eng.render_frame()
    synchronize(eng.device)
    dt = time.perf_counter() - t0
    final = out.cpu().numpy()
    _assert_finite_image(name, final)
    if png_out:
        from vkrt_tpu_torch.models.post import to_u8_image
        from vkrt_tpu_torch.utils.png import write_png

        write_png(str(png_out), to_u8_image(out, width, height))
        print(f"[suite] wrote {png_out}", file=sys.stderr)
    rec = {
        "config": name,
        "ms_per_frame": round(dt / frames * 1e3, 2),
        "fps": round(frames / dt, 2),
        "mrays_per_s": round(eng.total_rays / dt / 1e6, 2),
        "frames": frames,
        "resolution": f"{width}x{height}",
        "device": (torch.cuda.get_device_name(eng.device) if eng.device.type == "cuda"
                   else "cpu"),
    }
    if extra_metrics_fn is not None:
        rec.update(extra_metrics_fn(final, eng))
    print(json.dumps(rec), flush=True)
    return rec


def run_sharded_bench(name, width, height, frames, depth, device, batches: int = 1):
    """Row 6: Cornell path tracing over a ``factor_mesh`` of the cards (one
    rank on the CPU), ``samples = n_spp``. One warm-up frame, then
    ``batches`` batches of ``frames`` frames from a fresh accumulator,
    each timed on the host clock between two device synchronisations (the
    row's numbers are the last batch's). Prints the row's JSON object (the
    JAX suite's keys, ``mesh`` as ``tile=..,spp=..``) and returns
    ``sharded_bench_rank``'s result."""
    from vkrt_tpu_torch.parallel.mesh import factor_mesh, launch

    n = torch.cuda.device_count() if device.type == "cuda" else 1
    n_tile, n_spp = factor_mesh(n)
    out = launch(sharded_bench_rank, n_tile, n_spp, device, name, width, height, frames,
                 depth, batches)
    print(json.dumps(out["rec"]), flush=True)
    return out


def sharded_bench_rank(mesh, name, width, height, frames, depth, batches):
    """One rank of row 6. Returns {"rec": the row, "batches": [(ms/frame,
    Mrays/s, rays/frame)] a batch, "launches": every rank's launches by
    entry point (``device.counts``) over the warm-up and the batches,
    "accum": the last batch's accumulator in scanline order (N, 3)}."""
    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.ops.trace import make_tracer
    from vkrt_tpu_torch.parallel import render
    from vkrt_tpu_torch.parallel.mesh import all_gather_rows, gather_objects
    from vkrt_tpu_torch.scene import load_cornell
    from vkrt_tpu_torch.utils.camera import Camera

    scene = load_cornell(device=mesh.device)
    step, inv_perm = render.make_sharded_pathtrace_step(
        scene, make_tracer(scene, "auto"), mesh, width=width, height=height,
        samples=mesh.shape["spp"], depth=depth, corr=RenderSettings().corr_sampler)
    cam = Camera().matrices(width, height, mesh.device)
    clear = (1.0, 1.0, 1.0, 1.0)
    kdev.reset_counts()
    accum, rays = step(cam, 0, render.zeros_accum(mesh, width, height), clear)  # warm-up
    float(rays)
    timed = []
    for _ in range(batches):
        accum = render.zeros_accum(mesh, width, height)
        rays = torch.zeros((), dtype=torch.float32, device=mesh.device)
        synchronize(mesh.device)
        t0 = time.perf_counter()
        for f in range(frames):
            accum, r = step(cam, f, accum, clear)
            rays = rays + r
        synchronize(mesh.device)
        dt = time.perf_counter() - t0
        timed.append((dt / frames * 1e3, float(rays) / dt / 1e6, float(rays) / frames))
    launches = gather_objects({entry: c["launches"] for entry, c in kdev.counts.items()},
                              mesh)
    image = all_gather_rows(accum, mesh)[inv_perm]
    _assert_finite_image(name, image.cpu().numpy())
    ms, mrays, _ = timed[-1]
    rec = {
        "config": name,
        "mesh": f"tile={mesh.shape['tile']},spp={mesh.shape['spp']}",
        "backend": mesh.backend,
        "ms_per_frame": round(ms, 2),
        "fps": round(1e3 / ms, 2),
        "mrays_per_s": round(mrays, 2),
        "frames": frames,
        "resolution": f"{width}x{height}",
        "device": (torch.cuda.get_device_name(mesh.device) if mesh.device.type == "cuda"
                   else "cpu"),
    }
    return {"rec": rec, "batches": timed, "launches": launches, "accum": image}


def load_sponzoid_png(device):
    """The sponzoid's PNG form (tess ``SPONZOID_TESS``) on ``device``,
    written into ``ASSET_DIR`` unless it is there; raises unless every
    texture decoded at full size."""
    from vkrt_tpu_torch.scene import build_scene
    from vkrt_tpu_torch.utils.gltf import parse_gltf
    from vkrt_tpu_torch.utils.sponzoid import sponzoid_path

    doc = parse_gltf(sponzoid_path(str(ASSET_DIR), tess=SPONZOID_TESS, texture_format="png"))
    small = [im.name for im in doc.images if min(im.data.shape[:2]) < MIN_TEXTURE_PX]
    if small:
        raise AssertionError(f"sponzoid textures decoded under {MIN_TEXTURE_PX} px: {small}")
    return build_scene(doc, device=device)


SPONZOID_CAMERA = dict(eye=(0.0, 6.0, 26.0), center=(0.0, 5.0, 0.0), up=(0.0, 1.0, 0.0))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--configs", type=str, default=",".join(ROWS))
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu runs the kernels' plain versions (its times are the CPU's)")
    args = p.parse_args(argv)
    device = select(args.device)

    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.scene import load_cornell, make_city
    from vkrt_tpu_torch.utils.camera import Camera, orbit_camera

    w, h, n = args.width, args.height, args.frames
    wanted = set(args.configs.split(","))
    unknown = wanted - set(ROWS)
    if unknown:
        p.error(f"unknown rows {sorted(unknown)} (the port's rows: {','.join(ROWS)})")
    results = []

    if wanted & {"1", "2"}:
        cornell = load_cornell(device=device)
        if "1" in wanted:
            results.append(run_engine_bench(
                "cornell_1spp_1bounce", cornell,
                RenderSettings(rt_mode=1, samples=1, depth=1), w, h, n))
        if "2" in wanted:
            results.append(run_engine_bench(
                "cornell_multibounce_accum", cornell,
                RenderSettings(rt_mode=1, samples=1, depth=5), w, h, n))
    if wanted & {"3", "4", "5"}:
        city = make_city(grid=96, device=device)
        print(f"[suite] city scene: {city.num_tris} tris", file=sys.stderr)
        cam3 = lambda t: orbit_camera(0.12, radius=300, height=48)  # noqa: E731
        if "3" in wanted:
            results.append(run_engine_bench(
                "city_full_pathtrace", city,
                RenderSettings(rt_mode=1, samples=1, depth=4), w, h, n, camera_fn=cam3))
        if "4" in wanted:
            results.append(run_engine_bench(
                "hybrid_shadows_ao_gi", city,
                RenderSettings(rt_mode=0, use_shadows=True, use_ao=True, use_gi=True),
                w, h, n, camera_fn=cam3))
        if "5" in wanted:
            den = RenderSettings(rt_mode=0, use_shadows=True, use_ao=True, use_gi=True,
                                 use_denoiser=True)
            cam5 = lambda t: orbit_camera(t, radius=300, height=48)  # noqa: E731

            def _rmse_vs_converged(final_out, _eng):
                """The last fly-through frame against 64 static frames at
                its pose with the denoiser off, and one such frame (the
                noisy input the denoiser improves on)."""
                from vkrt_tpu_torch.engine import Engine
                from vkrt_tpu_torch.utils.metrics import rmse

                base = den.replace(use_denoiser=False)
                last = cam5((n - 1) / max(n, 1))
                ref_eng = Engine(city, w, h, base, camera=last)
                for _ in range(64):
                    ref = ref_eng.render_frame()
                ref = ref.cpu().numpy()
                noisy = Engine(city, w, h, base, camera=last).render_frame().cpu().numpy()
                return {"rmse_vs_converged": round(rmse(final_out, ref), 5),
                        "rmse_noisy_1frame": round(rmse(noisy, ref), 5)}

            results.append(run_engine_bench(
                "city_flythrough_denoised", city, den, w, h, n, camera_fn=cam5,
                extra_metrics_fn=_rmse_vs_converged))
    if "6" in wanted:
        results.append(run_sharded_bench("cornell_sharded_mesh", w, h, n, 3, device)["rec"])
    if "8" in wanted:
        t0 = time.time()
        sponz = load_sponzoid_png(device)
        print(f"[suite] sponzoid: {sponz.num_tris} tris, {sponz.tex_rgba.shape[0]} textures "
              f"({time.time() - t0:.1f}s load)", file=sys.stderr)
        cam8 = Camera(**SPONZOID_CAMERA)
        results.append(run_engine_bench(
            "sponzoid_disk_pathtrace", sponz,
            RenderSettings(rt_mode=1, samples=1, depth=3), w, h, n,
            camera_fn=lambda t: cam8,
            png_out=ASSET_DIR / "sponzoid_render.png"))
    if "7" in wanted:
        big = make_city(grid=160, device=device)
        print(f"[suite] big city scene: {big.num_tris} tris", file=sys.stderr)
        results.append(run_engine_bench(
            "bigcity_full_pathtrace", big,
            RenderSettings(rt_mode=1, samples=1, depth=4), w, h, n,
            camera_fn=lambda t: orbit_camera(0.12, radius=500, height=64)))
    return results


if __name__ == "__main__":
    main()
