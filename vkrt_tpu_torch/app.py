"""Headless CLI app (port of ``vkrt_tpu/app.py``): hybrid mode (the
default; with ``--gi --denoiser`` its GI is denoised) or path mode;
``--alpha-test`` turns on alpha-tested transparency in either.

Usage:
    python -m vkrt_tpu_torch.app --procedural cornell --gi \\
        --width 1280 --height 720 --frames 16 --out out.png
    python -m vkrt_tpu_torch.app --procedural city --city-grid 96 --gi --denoiser
    python -m vkrt_tpu_torch.app --config config.json --mode path --spp 2 --depth 5
    python -m vkrt_tpu_torch.app --scene path/to.gltf --mode path --depth 3 --stats
    python -m vkrt_tpu_torch.app --scene path/to.gltf --orbit --frames 8 --out fly.png
    python -m vkrt_tpu_torch.app --procedural cornell --interactive < commands.txt
    python -m vkrt_tpu_torch.app --procedural cornell --mode path --mesh 2,2 --spp 2

Renders on the card (``--device cuda``, the default: it fails when there is
no card) or, with ``--device cpu``, through the kernels' plain versions.
``--mesh TILE,SPP`` renders over a (tile, spp) mesh of ranks
(``vkrt_tpu_torch/parallel``), one process a rank, rank r on card
r % count: NCCL when every rank has a card of its own, gloo when ranks
share one (and on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

from vkrt_tpu_torch.config import (
    DEFAULT_CLEAR_COLOR,
    EngineConfig,
    RenderSettings,
    load_config,
    resolve_scene_path,
)
from vkrt_tpu_torch.ops.trace import BACKENDS
from vkrt_tpu_torch.utils.camera import Camera
from vkrt_tpu_torch.utils.png import write_png


def scene_from_args(args, cfg: EngineConfig, device, log: bool = True):
    """The scene the arguments name, on ``device``."""
    from vkrt_tpu_torch import scene as scene_mod

    t0 = time.time()
    if args.procedural == "cornell":
        scene = scene_mod.make_cornell_box(device=device)
    elif args.procedural == "city":
        scene = (scene_mod.make_city(grid=args.city_grid, device=device)
                 if args.city_grid else scene_mod.make_city(device=device))
    elif args.scene:
        scene = scene_mod.load_scene(args.scene, device=device)
    else:
        path = resolve_scene_path(cfg)
        if os.path.exists(path):
            scene = scene_mod.load_scene(path, device=device)
        else:
            if log:
                print(f"scene {path} not found; using procedural cornell", file=sys.stderr)
            scene = scene_mod.make_cornell_box(device=device)
    if log:
        print(f"scene loaded: {scene.num_tris} tris, {scene.num_lights} lights "
              f"({time.time() - t0:.2f}s) on {device}")
    return scene


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="config.json path")
    p.add_argument("--scene", default=None, help="override scene file (.gltf/.glb)")
    p.add_argument("--scene-index", type=int, default=None,
                   help="index into config scenes[]")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--mode", choices=["hybrid", "path"], default="hybrid",
                   help="render mode (main.cpp:457; default hybrid like the reference)")
    p.add_argument("--spp", type=int, default=1, help="samples/pixel 1-100")
    p.add_argument("--depth", type=int, default=3, help="bounces 1-30")
    p.add_argument("--frames", type=int, default=1,
                   help="progressive frames to accumulate")
    p.add_argument("--max-frames", type=int, default=None,
                   help="enable the max-frames limiter at this count")
    p.add_argument("--no-shadows", action="store_true")
    p.add_argument("--no-ao", action="store_true")
    p.add_argument("--gi", action="store_true", help="enable hybrid GI")
    p.add_argument("--denoiser", action="store_true", help="enable SVGF denoiser (GI)")
    p.add_argument("--alpha-test", action="store_true",
                   help="enable alpha-tested transparency (the reference's "
                        "unwired any-hit shaders, finished; see ops/alpha.py)")
    p.add_argument("--view-accumulated", action="store_true")
    p.add_argument("--corr-sampler", action=argparse.BooleanOptionalAction,
                   default=RenderSettings().corr_sampler,
                   help="correlated per-block sampler: share the lobe/light/"
                        "hemisphere draws across each 1024-ray block per "
                        "frame (unbiased)")
    p.add_argument("--clear-color", type=float, nargs=3, default=None)
    p.add_argument("--backend", choices=list(BACKENDS), default="auto",
                   help="trace backend: auto (kernel A on the card, brute force "
                        "on the CPU), bruteforce, bvh (the LBVH built on the "
                        "device, walked by kernel E's stackless body), pallas "
                        "(kernel A's tracer)")
    p.add_argument("--eye", type=float, nargs=3, default=None)
    p.add_argument("--lookat", type=float, nargs=3, default=None)
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--orbit", action="store_true",
                   help="fly-through: orbit the camera over the frames and "
                        "write a PNG per frame (out name gets an _NNNN suffix)")
    p.add_argument("--orbit-radius", type=float, default=18.0)
    p.add_argument("--orbit-height", type=float, default=6.0)
    p.add_argument("--procedural", choices=["cornell", "city"], default=None,
                   help="use a procedural scene instead of a file")
    p.add_argument("--city-grid", type=int, default=None, metavar="N",
                   help="procedural city size (96 = 143,568 triangles, the "
                        "benchmark suite's city; default 16)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu runs the kernels' plain versions")
    p.add_argument("--mesh", default=None, metavar="TILE,SPP",
                   help="render over a (tile, spp) mesh of ranks, one process a "
                        "rank: pixel bands on the tile axis, sample groups on the "
                        "spp axis (e.g. --mesh 4,2 starts 8 ranks; ranks that "
                        "share a card, or the CPU, use gloo, else NCCL)")
    p.add_argument("--save-state", default=None,
                   help="checkpoint the accumulation state to this .npz on exit")
    p.add_argument("--load-state", default=None,
                   help="resume the accumulation state from this .npz")
    p.add_argument("--stats", action="store_true",
                   help="print per-run frame stats JSON to stderr")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler Chrome trace here")
    p.add_argument("--interactive", action="store_true",
                   help="live parameter loop on stdin, the headless ImGui panel "
                        "(main.cpp:67-105): render/set/clear/camera/save "
                        "commands between frames")
    p.add_argument("--out", default="out.png")
    return p


def main(argv=None) -> int:
    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.frames < 1:
        parser.error(f"--frames must be >= 1 (got {args.frames})")
    from vkrt_tpu_torch.device import select

    device = select(args.device)

    cfg = EngineConfig()
    if args.config:
        cfg = load_config(args.config)
    elif os.path.exists("config.json"):
        cfg = load_config("config.json")
    if args.scene_index is not None:
        cfg = dataclasses.replace(cfg, scene=args.scene_index)
    width = args.width or cfg.width
    height = args.height or cfg.height

    settings = RenderSettings(
        samples=args.spp,
        depth=args.depth,
        use_shadows=not args.no_shadows,
        use_ao=not args.no_ao,
        use_gi=args.gi,
        rt_mode=1 if args.mode == "path" else 0,
        view_accumulated=args.view_accumulated,
        max_frames=args.max_frames or 1,
        stop_at_max_frames=args.max_frames is not None,
        use_denoiser=args.denoiser,
        backend=args.backend,
        alpha_test=args.alpha_test,
        corr_sampler=args.corr_sampler,
    )
    cam = Camera(
        eye=tuple(args.eye) if args.eye else (0.0, 0.0, 15.0),
        center=tuple(args.lookat) if args.lookat else (0.0, 0.0, 0.0),
        fov_deg=args.fov,
    )
    clear = tuple(args.clear_color) + (1.0,) if args.clear_color else DEFAULT_CLEAR_COLOR
    if args.mesh:
        return run_sharded(args, cfg, settings, cam, clear, width, height, device)

    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.models.post import to_u8_image
    from vkrt_tpu_torch.utils import checkpoint
    from vkrt_tpu_torch.utils.camera import orbit_camera
    from vkrt_tpu_torch.utils.profiling import FrameStats, device_trace, timed_frame

    scene = scene_from_args(args, cfg, device)
    engine = Engine(scene, width, height, settings, cam, clear)
    if args.load_state:
        ok = checkpoint.restore(engine, args.load_state)
        print(f"resume from {args.load_state}: "
              f"{'ok, frame ' + str(engine.frame) if ok else 'rejected'}")
    if args.interactive:
        return run_interactive(engine, args, width, height)

    stats = FrameStats()
    t0 = time.time()
    out = None
    with device_trace(args.trace_dir):
        for f in range(args.frames):
            if args.orbit:
                engine.camera = orbit_camera(
                    f / args.frames, center=tuple(args.lookat) if args.lookat else (0, 0, 0),
                    radius=args.orbit_radius, height=args.orbit_height, fov_deg=args.fov)
            with timed_frame(stats, device=device):
                out = engine.render_frame()
            if args.orbit:
                base, ext = os.path.splitext(args.out)
                write_png(f"{base}_{f:04d}{ext}", to_u8_image(out, width, height))
    img = to_u8_image(out, width, height)  # copies to the host: syncs
    dt = time.time() - t0
    total_rays = engine.total_rays
    stats.rays = [total_rays / len(stats.times_s)] * len(stats.times_s)
    mrays = total_rays / dt / 1e6 if dt > 0 else 0.0
    print(f"{args.frames} frames at {width}x{height} on {device} in {dt:.3f}s "
          f"({dt / args.frames * 1000:.1f} ms/frame, {mrays:.1f} Mrays/s "
          f"incl. set-up; frame counter {engine.frame})")
    if args.stats:
        stats.log()
    if args.save_state:
        checkpoint.save(engine, args.save_state)
        print(f"saved state to {args.save_state}")
    if args.trace_dir:
        print(f"wrote a trace into {args.trace_dir}")
    write_png(args.out, img)
    print(f"wrote {args.out}")
    return 0


def run_sharded(args, cfg, settings, cam, clear, width, height, device) -> int:
    """``--mesh TILE,SPP``: render over a (tile, spp) mesh of ranks
    (``parallel/render.py``), pixel bands on the tile axis, sample groups on
    the spp axis (one mean a frame). The arguments are checked here, before
    any rank starts (exit code 2, as the JAX app); rank 0 writes the PNG."""
    from vkrt_tpu_torch.parallel.mesh import launch

    try:
        n_tile, n_spp = (int(x) for x in args.mesh.split(","))
    except ValueError:
        print(f"--mesh wants TILE,SPP, got {args.mesh!r}", file=sys.stderr)
        return 2
    if n_tile < 1 or n_spp < 1:
        print(f"--mesh {args.mesh}: both axes need at least one rank", file=sys.stderr)
        return 2
    if settings.rt_mode == 1 and settings.samples % n_spp != 0:
        print(f"--spp {settings.samples} must be divisible by the spp mesh "
              f"axis ({n_spp})", file=sys.stderr)
        return 2
    if settings.rt_mode == 0 and n_spp != 1:
        print("hybrid mode shards pixels only; use --mesh N,1", file=sys.stderr)
        return 2
    if (width * height) % n_tile:
        print(f"--mesh {args.mesh}: {width}x{height} pixels do not split into "
              f"{n_tile} bands", file=sys.stderr)
        return 2
    use_dn = settings.rt_mode == 0 and settings.use_denoiser and settings.use_gi
    if use_dn and height % n_tile != 0:
        print(f"--denoiser under a mesh needs whole row bands: height "
              f"{height} not divisible by tile axis {n_tile}", file=sys.stderr)
        return 2
    where = ("the CPU" if device.type == "cpu" else
             f"{torch.cuda.device_count()} card(s)")
    rays, dt, backend = launch(mesh_rank, n_tile, n_spp, device, args, cfg, settings, cam,
                               clear, width, height)
    mrays = rays / dt / 1e6 if dt > 0 else 0.0
    print(f"sharded mesh(tile={n_tile}, spp={n_spp}) over {backend}, {n_tile * n_spp} ranks "
          f"on {where}: {args.frames} frames at {width}x{height} in {dt:.3f}s "
          f"({mrays:.1f} Mrays/s; set-up included: the first collective's communicator, "
          f"the gather, the PNG)")
    print(f"wrote {args.out}")
    return 0


def mesh_rank(mesh, args, cfg, settings, cam, clear, width, height):
    """One rank of ``--mesh``: the scene on the rank's device, then the
    frames; rank 0 composites and writes the PNG. Returns (total rays,
    seconds from the first frame to the written image, the backend)."""
    from vkrt_tpu_torch.models import post
    from vkrt_tpu_torch.ops.trace import make_tracer
    from vkrt_tpu_torch.parallel import render

    scene = scene_from_args(args, cfg, mesh.device, log=mesh.tile == mesh.spp == 0)
    tracer = make_tracer(scene, settings.backend, alpha=settings.alpha_test)
    cam_m = cam.matrices(width, height, mesh.device)
    t0 = time.time()
    if settings.rt_mode == 1:
        accum, rays = render.render_sharded(
            scene, tracer, cam_m, mesh, width=width, height=height,
            samples=settings.samples, depth=settings.depth, frames=args.frames,
            clear_color=clear, corr=settings.corr_sampler)
        out = post.composite(accum, None, rt_mode=1,
                             view_accumulated=settings.view_accumulated,
                             use_gi=settings.use_gi)
    else:
        (img,), rays = render.render_sharded_hybrid(
            scene, tracer, [cam_m] * args.frames, mesh, width=width, height=height,
            depth=settings.depth, clear_color=clear, use_shadows=settings.use_shadows,
            use_ao=settings.use_ao, use_gi=settings.use_gi,
            use_denoiser=settings.use_denoiser and settings.use_gi,
            corr=settings.corr_sampler)
        out = post.composite(img["color"][:, :3], img["accum"], rt_mode=0,
                             view_accumulated=settings.view_accumulated,
                             use_gi=settings.use_gi)
    if mesh.tile == mesh.spp == 0:
        write_png(args.out, post.to_u8_image(out, width, height))
    return rays, time.time() - t0, mesh.backend


def run_interactive(engine, args, width, height) -> int:
    """Live parameter loop: the headless equivalent of the reference's
    ImGui panel (main.cpp:67-105), changing render settings between frames
    from stdin. Any change resets accumulation, as in the reference
    (main.cpp:103-104); a change of spp, depth, mode, a toggle, the backend
    or the sampler also reallocates the engine's buffers, and ``set`` says
    whether it did.

    Commands (one per line; '#' comments and blank lines ignored):
      render [N]           render N progressive frames (default 1)
      set KEY VALUE        any RenderSettings field, e.g. set depth 5,
                           set use_gi 1, set clamp_weights 1, set samples 2
      clear R G B          clear color
      eye X Y Z | lookat X Y Z | fov DEG      camera (resets accumulation)
      save [PATH]          write the current composite PNG (default --out)
      stats                frame counter + last render timing
      quit                 exit (writes --out first)
    """
    from vkrt_tpu_torch.models.post import to_u8_image
    from vkrt_tpu_torch.utils.profiling import synchronize

    out = None
    last_ms = None

    def render_n(k: int):
        nonlocal out, last_ms
        t0 = time.time()
        for _ in range(k):
            out = engine.render_frame()
        synchronize(engine.device)
        last_ms = (time.time() - t0) / max(k, 1) * 1e3
        print(f"rendered {k} frame(s), {last_ms:.1f} ms/frame "
              f"(frame counter {engine.frame})")

    fields = {f.name for f in dataclasses.fields(engine.settings)}
    print("interactive: 'render N', 'set KEY VALUE', 'clear R G B', "
          "'eye/lookat X Y Z', 'fov D', 'save [PATH]', 'stats', 'quit'", flush=True)
    for line in sys.stdin:
        toks = line.split("#", 1)[0].split()
        if not toks:
            continue
        cmd, rest = toks[0].lower(), toks[1:]
        try:
            if cmd == "quit":
                break
            elif cmd == "render":
                render_n(int(rest[0]) if rest else 1)
            elif cmd == "set":
                key, val = rest[0], rest[1]
                if key not in fields:
                    print(f"unknown setting {key!r}; one of {sorted(fields)}")
                    continue
                cur = getattr(engine.settings, key)
                new = (val not in ("0", "false", "False") if isinstance(cur, bool)
                       else type(cur)(val))
                realloc = engine.update_settings(engine.settings.replace(**{key: new}))
                print(f"{key} = {new} "
                      f"({'buffers reallocated' if realloc else 'buffers kept'})")
            elif cmd == "clear":
                engine.clear_color = tuple(float(x) for x in rest[:3]) + (1.0,)
                engine.reset_frame()  # radiance changes: restart accumulation
                print("clear color set")
            elif cmd in ("eye", "lookat"):
                kw = {"eye" if cmd == "eye" else "center": tuple(float(x) for x in rest[:3])}
                engine.camera = dataclasses.replace(engine.camera, **kw)
                print(f"{cmd} set (accumulation resets on next frame)")
            elif cmd == "fov":
                engine.camera = dataclasses.replace(engine.camera, fov_deg=float(rest[0]))
                print("fov set")
            elif cmd == "save":
                path = rest[0] if rest else args.out
                if out is None:
                    render_n(1)
                write_png(path, to_u8_image(out, width, height))
                print(f"wrote {path}")
            elif cmd == "stats":
                print(f"frame {engine.frame}, last {last_ms and f'{last_ms:.1f}'} "
                      f"ms/frame, total rays {engine.total_rays:.3g}")
            else:
                print(f"unknown command {cmd!r}")
        except (ValueError, IndexError) as e:
            print(f"bad command {line.strip()!r}: {e}")
        sys.stdout.flush()
    if out is not None:
        write_png(args.out, to_u8_image(out, width, height))
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
