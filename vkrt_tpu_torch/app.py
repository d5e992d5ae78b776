"""Headless CLI app (port of ``vkrt_tpu/app.py``): hybrid mode (the
default; with ``--gi --denoiser`` its GI is denoised) or path mode;
``--alpha-test`` turns on alpha-tested transparency in either.

Usage:
    python -m vkrt_tpu_torch.app --procedural cornell --gi \\
        --width 1280 --height 720 --frames 16 --out out.png
    python -m vkrt_tpu_torch.app --procedural city --city-grid 96 --gi --denoiser
    python -m vkrt_tpu_torch.app --config config.json --mode path --spp 2 --depth 5
    python -m vkrt_tpu_torch.app --procedural city --city-grid 96 --mode path --depth 4

Renders on the card (``--device cuda``, the default: it fails when there is
no card) or, with ``--device cpu``, through the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from vkrt_tpu_torch.config import (
    DEFAULT_CLEAR_COLOR,
    EngineConfig,
    RenderSettings,
    load_config,
    resolve_scene_path,
)
from vkrt_tpu_torch.utils.png import write_png


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="config.json path")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--mode", choices=["hybrid", "path"], default="hybrid",
                   help="render mode (main.cpp:457; default hybrid like the reference)")
    p.add_argument("--spp", type=int, default=1, help="samples/pixel 1-100")
    p.add_argument("--depth", type=int, default=3, help="bounces 1-30")
    p.add_argument("--frames", type=int, default=1,
                   help="progressive frames to accumulate")
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
    p.add_argument("--eye", type=float, nargs=3, default=None)
    p.add_argument("--lookat", type=float, nargs=3, default=None)
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--procedural", choices=["cornell", "city"], default=None,
                   help="use a procedural scene instead of a file")
    p.add_argument("--city-grid", type=int, default=None, metavar="N",
                   help="procedural city size (96 = 143,568 triangles, the "
                        "benchmark suite's city; default 16)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu runs the kernels' plain versions")
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
    width = args.width or cfg.width
    height = args.height or cfg.height

    from vkrt_tpu_torch import scene as scene_mod
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.models.post import to_u8_image
    from vkrt_tpu_torch.utils.camera import Camera

    t0 = time.time()
    if args.procedural == "cornell":
        scene = scene_mod.make_cornell_box(device=device)
    elif args.procedural == "city":
        scene = (scene_mod.make_city(grid=args.city_grid, device=device)
                 if args.city_grid else scene_mod.make_city(device=device))
    else:
        path = resolve_scene_path(cfg)
        if os.path.exists(path):
            scene = scene_mod.load_scene(path, device=device)
        else:
            print(f"scene {path} not found; using procedural cornell", file=sys.stderr)
            scene = scene_mod.make_cornell_box(device=device)
    print(f"scene loaded: {scene.num_tris} tris, {scene.num_lights} lights "
          f"({time.time() - t0:.2f}s) on {device}")

    settings = RenderSettings(
        samples=args.spp,
        depth=args.depth,
        use_shadows=not args.no_shadows,
        use_ao=not args.no_ao,
        use_gi=args.gi,
        rt_mode=1 if args.mode == "path" else 0,
        view_accumulated=args.view_accumulated,
        use_denoiser=args.denoiser,
        alpha_test=args.alpha_test,
        corr_sampler=args.corr_sampler,
    )
    cam = Camera(
        eye=tuple(args.eye) if args.eye else (0.0, 0.0, 15.0),
        center=tuple(args.lookat) if args.lookat else (0.0, 0.0, 0.0),
        fov_deg=args.fov,
    )
    clear = tuple(args.clear_color) + (1.0,) if args.clear_color else DEFAULT_CLEAR_COLOR
    engine = Engine(scene, width, height, settings, cam, clear)

    t0 = time.time()
    out = None
    for _ in range(args.frames):
        out = engine.render_frame()
    img = to_u8_image(out, width, height)  # copies to the host: syncs
    dt = time.time() - t0
    total_rays = engine.total_rays
    mrays = total_rays / dt / 1e6 if dt > 0 else 0.0
    print(f"{args.frames} frames at {width}x{height} on {device} in {dt:.3f}s "
          f"({dt / args.frames * 1000:.1f} ms/frame, {mrays:.1f} Mrays/s "
          f"incl. set-up)")
    write_png(args.out, img)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
