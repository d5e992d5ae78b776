"""Ablation of kernel A's walk (port of ``benchmarks/scratch/ablate_kernel.py``):
how the device time splits into box tests and triangle work.

Kernel D's modes of kernel A's front-to-back walk on primary and incoherent
rays: ``top`` (slab tests above the cut only; the TPU's "svote"), ``boxes``
(slab tests only, no triangle work, so the closest hit never shrinks the
search; "votes"), ``count`` (the full walk plus per-ray counters) and
``full`` (kernel A). ``count`` prints slab tests ("node visits": two a
child-box record) and triangle tests ("leaf visits") per ray, slab tests
per 1024-ray block (mean / p50 / p95 / max) and the walk's SIMT efficiency
per 32-ray warp.

Usage: python -m vkrt_tpu_torch.benchmarks.ablate_kernel [cornell|city]
           [--width 1280 --height 720] [--iters N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vkrt_tpu_torch.benchmarks import SCENES, build, describe, time_calls, where
from vkrt_tpu_torch.benchmarks.micro_trace import make_rays, ray_count
from vkrt_tpu_torch.device import select
from vkrt_tpu_torch.ops.cuda.trace_variants import trace_ablate
from vkrt_tpu_torch.ops.intersect import T_MAX

MODES = ("top", "boxes", "count", "full")  # ablate_kernel.py's svote, votes, count, full
BLOCK = 1024
WARP = 32


def _stats(x: np.ndarray) -> dict:
    return {"mean": float(x.mean()), "p50": float(np.percentile(x, 50)),
            "p95": float(np.percentile(x, 95)), "max": float(x.max())}


def simt_efficiency(visits: np.ndarray) -> float:
    """The share of a warp's lanes that do work while it walks: per-ray
    visits summed, over 32 x the sum over 32-ray warps (in launch order) of
    the warp's longest ray. A walk runs until its slowest ray is done."""
    warps = visits[: len(visits) // WARP * WARP].reshape(-1, WARP)
    return float(warps.sum() / max(WARP * warps.max(1).sum(), 1))


def visit_stats(counts) -> dict:
    """Per-ray node and leaf visits, per-1024-ray-block node visits and the
    SIMT efficiency of the walk (node + leaf visits per 32-ray warp)."""
    nodes = counts.nodes.cpu().numpy().astype(np.int64)
    leaves = counts.leaves.cpu().numpy().astype(np.int64)
    return {"nodes": _stats(nodes), "leaves": _stats(leaves),
            "simt_efficiency": simt_efficiency(nodes + leaves),
            "block_nodes": _stats(nodes[: len(nodes) // BLOCK * BLOCK].reshape(-1, BLOCK).sum(1)),
            "total_nodes": int(nodes.sum()), "total_leaves": int(leaves.sum())}


def _fmt(s: dict) -> str:
    return f"mean={s['mean']:9.2f} p50={s['p50']:8.0f} p95={s['p95']:8.0f} max={s['max']:8.0f}"


def run_modes(b, o, d, iters: int, modes=MODES) -> dict:
    """Kernel D's ``modes`` on one ray set: {mode: {ms, hits, counts, stats}}."""
    t_lim = torch.full((o.shape[0],), T_MAX, device=o.device)
    res = {}
    for mode in modes:
        def call():
            return trace_ablate(mode, b.tables, b.scene, o, d, t_lim)

        ms, _ = time_calls(call, iters, o.device)
        hits, counts = call()
        res[mode] = {"ms": ms, "hits": hits, "counts": counts, "t_lim": t_lim}
        if counts is not None:
            res[mode]["stats"] = visit_stats(counts)
    return res


def run(scene: str = "cornell", width: int = 1280, height: int = 720, iters: int = 8,
        device="cuda", built=None) -> dict:
    """Every mode on ``scene``'s primary and incoherent rays."""
    device = select(device) if isinstance(device, str) else device
    b = built or build(scene, device)
    print(f"device={where(device)} rays={ray_count(width, height)}")
    print(describe(b))
    res = {"built": b}
    for kind in ("primary", "incoherent"):
        o, d = make_rays(b.scene, width, height, kind, device)
        r = run_modes(b, o, d, iters)
        st = r["count"]["stats"]
        print(f"  {kind} node visits/ray:     {_fmt(st['nodes'])}")
        print(f"  {kind} leaf visits/ray:     {_fmt(st['leaves'])}")
        print(f"  {kind} node visits/block:   {_fmt(st['block_nodes'])}")
        print(f"  {kind} SIMT efficiency:     {st['simt_efficiency']:.4f}")
        for mode in MODES:
            print(f"  {kind} {mode:6s}: {r[mode]['ms']:9.4f} ms")
        res[kind] = {"o": o, "d": d, **r}
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("scene", nargs="?", default="cornell", choices=SCENES)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if ray_count(args.width, args.height) == 0:
        p.error("width x height must hold at least 1024 rays")
    run(args.scene, args.width, args.height, args.iters, args.device)


if __name__ == "__main__":
    main()
