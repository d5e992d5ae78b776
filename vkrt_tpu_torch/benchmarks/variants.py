"""Traversal-structure variants of kernel A (port of
``benchmarks/scratch/variants.py``), on the same tree and the same rays.

Kernel E's variants, the alternatives to kernel A's design: ``ordered``
(the wide front-to-back walk: records of up to four children in one
128-byte line, the hit children sorted by entry distance; the counterpart
of the TPU's 16 boxes a visit), ``binary`` (nearer child first over the
threaded table, two dependent rounds of loads a level), ``threaded`` (the
stackless skip-link walk, kernel A's first design; the TPU's "plain"),
``flat`` (a scan over the cut's boxes out of shared memory, then a
stackless walk inside each hit subtree) and ``mt<K>`` (the first K scene
triangles out of shared memory, no boxes: the triangle pipeline's rate).
All read kernel A's triangle records and decide ties as kernel A does. The
TPU script's ``flatcount``, ``scan_only`` and ``votes_only`` are kernel
D's ``count``, ``top`` and ``boxes`` (``ablate_kernel``); its ``dynK`` and
``bitK`` measured Mosaic's loop cost and have no counterpart on the card.

Rays: the 1280x720 primaries in 32x32-tile order, as ``variants.py`` takes
them; ``--incoherent`` adds micro_trace's incoherent rays.

Usage: python -m vkrt_tpu_torch.benchmarks.variants [cornell|city] [variant ...]
           [--width 1280 --height 720] [--iters N] [--incoherent]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from vkrt_tpu_torch.benchmarks import SCENES, build, describe, time_calls, where
from vkrt_tpu_torch.benchmarks.micro_trace import make_rays, ray_count
from vkrt_tpu_torch.device import select
from vkrt_tpu_torch.ops.cuda.trace_variants import parse_variant, trace_variant
from vkrt_tpu_torch.ops.intersect import T_MAX

DEFAULT_VARIANTS = ("flat", "threaded", "binary", "ordered")


def run_variants(b, o, d, names, iters: int) -> dict:
    """Each variant on one ray set: {name: {ms, mrays, hits, t_lim}}."""
    n = o.shape[0]
    t_lim = torch.full((n,), T_MAX, device=o.device)
    res = {}
    for name in names:
        ms, _ = time_calls(lambda: trace_variant(name, b.tables, b.scene, o, d, t_lim),
                           iters, o.device)
        res[name] = {"ms": ms, "mrays": n / (ms * 1e-3) / 1e6, "t_lim": t_lim,
                     "hits": trace_variant(name, b.tables, b.scene, o, d, t_lim)}
    return res


def run(scene: str = "cornell", names=DEFAULT_VARIANTS, width: int = 1280,
        height: int = 720, iters: int = 8, incoherent: bool = False, device="cuda",
        built=None) -> dict:
    """``names`` on the tile-ordered primaries (and the incoherent rays)."""
    for name in names:
        parse_variant(name)
    device = select(device) if isinstance(device, str) else device
    b = built or build(scene, device)
    print(f"device={where(device)} rays={ray_count(width, height)}")
    print(describe(b))
    res = {"built": b}
    for kind in ("tiled", "incoherent") if incoherent else ("tiled",):
        o, d = make_rays(b.scene, width, height, kind, device)
        r = run_variants(b, o, d, names, iters)
        for name in names:
            print(f"  {name:10s} {kind:10s}: {r[name]['ms']:9.4f} ms  "
                  f"{r[name]['mrays']:9.2f} Mrays/s")
        res[kind] = {"o": o, "d": d, **r}
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("scene", nargs="?", default="cornell", choices=SCENES)
    p.add_argument("variants", nargs="*", default=list(DEFAULT_VARIANTS))
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--incoherent", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if ray_count(args.width, args.height) == 0:
        p.error("width x height must hold at least 1024 rays")
    try:
        for name in args.variants:
            parse_variant(name)
    except ValueError as e:
        p.error(str(e))
    run(args.scene, args.variants, args.width, args.height, args.iters, args.incoherent,
        args.device)


if __name__ == "__main__":
    main()
