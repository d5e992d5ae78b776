"""Kernels D and E: kernel A's walk with stages cut out, and other traversal
structures (``csrc/trace_variants.cu``).

* ``trace_ablate(mode, ...)`` replaces
  ``benchmarks/scratch/ablate_kernel.py::make_kernel``. Kernel A's
  front-to-back walk over the child-box records in mode ``full`` (kernel
  A), ``boxes`` (slab tests only, the TPU's "votes"), ``top`` (slab tests
  above the cut only, "svote") or ``count`` (full plus per-ray slab tests,
  two a record, and triangle tests, "count" and "flatcount"). Plain
  versions: brute force for ``full``, the miss record for ``boxes`` and
  ``top``, ``trace_rays_bvh_ordered(count=True)`` for ``count``.
* ``trace_variant(variant, ...)`` replaces
  ``benchmarks/scratch/variants.py::make_kernel``. Variants ``threaded``
  (the TPU's "plain": the stackless skip-link walk), ``ordered`` (nearer
  child first, a stack in local memory), ``flat`` and ``mt<K>``, all over
  the threaded table and the scene's triangle tables: the alternatives to
  kernel A's design. Every one computes the closest hit, so brute force
  (over the first K triangles for ``mt<K>``) is the plain version of all
  of them.

The TPU variants ``dynK`` and ``bitK`` measured the cost of Mosaic's loop
iterations and have no counterpart here.

``ProbeTables`` holds what the host derives from the threaded table: each
node's depth (from the skip links), the tree's depth (``ordered``'s stack
holds one entry per level, ``ORDERED_STACK`` in all) and
the cut (``top`` and ``flat``): the nodes at ``cut_depth`` and the
shallower leaves, where ``cut_depth`` puts about ``CUT_TRIS`` triangles
under a cut node, as the TPU tree put 16 clusters of 64 under a super
node.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from vkrt_tpu_torch import device as dev
from vkrt_tpu_torch.ops.cuda.probes import miss_record
from vkrt_tpu_torch.ops.cuda.trace import check_bvh, check_rays, check_scene, node_depths
from vkrt_tpu_torch.ops.intersect import T_MIN
from vkrt_tpu_torch.ops.trace import (
    Bvh, BvhCounts, RayHits, trace_rays_bruteforce, trace_rays_bvh_ordered,
)
from vkrt_tpu_torch.scene import SceneTensors

ABLATE_MODES = {"full": 0, "boxes": 1, "top": 2, "count": 3}
VARIANTS = {"threaded": 0, "ordered": 1, "flat": 2, "mt": 3}
ORDERED_STACK = 64  # variant ordered's stack entries (csrc/trace_variants.cu)
CUT_TRIS = 1024


@dataclasses.dataclass(frozen=True)
class ProbeTables:
    bvh: Bvh             # kernel A's tables, and the threaded table E walks
    depth: torch.Tensor  # (M,) int32 node depth, root 0
    cut: torch.Tensor    # (C,) int32 cut node ids, preorder
    cut_depth: int
    max_depth: int


def cut_depth_for(n_tris: int) -> int:
    """The depth whose subtrees hold about ``CUT_TRIS`` triangles (>= 1)."""
    return max(1, round(math.log2(max(n_tris, 1) / CUT_TRIS)))


def probe_tables(bvh: Bvh, n_tris: int) -> ProbeTables:
    """The host tables of kernels D and E for the BVH of a scene with
    ``n_tris`` triangles."""
    nodes = bvh.threaded
    bits = nodes.detach().cpu().numpy().view(np.int32)
    skip, tri = bits[:, 3].astype(np.int64), bits[:, 7]
    depth = node_depths(skip, tri)
    cut_depth = cut_depth_for(n_tris)
    cut = np.nonzero((depth == cut_depth) | ((depth < cut_depth) & (tri >= 0)))[0]
    return ProbeTables(
        bvh=bvh,
        depth=torch.as_tensor(depth, device=nodes.device),
        cut=torch.as_tensor(cut.astype(np.int32), device=nodes.device),
        cut_depth=cut_depth,
        max_depth=int(depth.max()),
    )


def _hit_buffers(n, device):
    return (torch.empty(n, dtype=torch.float32, device=device),
            torch.empty(n, dtype=torch.int32, device=device),
            torch.empty(n, dtype=torch.float32, device=device),
            torch.empty(n, dtype=torch.float32, device=device))


def trace_ablate(mode: str, tables: ProbeTables, scene: SceneTensors, o, d,
                 t_lim, t_min: float = T_MIN, any_hit: bool = False):
    """Kernel D: kernel A's walk in ``mode``. Returns (RayHits, BvhCounts
    for ``count``, else None)."""
    if mode not in ABLATE_MODES:
        raise ValueError(f"unknown mode {mode!r} (one of {sorted(ABLATE_MODES)})")
    bvh = tables.bvh
    tabs = check_bvh(bvh)
    if o.device.type == "cpu":
        if mode == "count":
            return trace_rays_bvh_ordered(bvh, o, d, t_lim, t_min, any_hit, count=True)
        if mode == "full":
            return trace_rays_bruteforce(scene.tri_v0, scene.tri_e1, scene.tri_e2,
                                         o, d, t_lim, t_min), None
        return miss_record(t_lim), None
    n = check_rays("trace_ablate", o, d, t_lim, tabs)
    t, tri, u, v = _hit_buffers(n, o.device)
    counts = (torch.empty((2, n), dtype=torch.int32, device=o.device)
              if mode == "count" else None)
    err = dev.kernels().vkrt_trace_ablate(
        ABLATE_MODES[mode],
        bvh.nodes.data_ptr(), bvh.tris.data_ptr(), bvh.depth, tables.cut_depth,
        o.data_ptr(), o.stride(0), o.stride(1),
        d.data_ptr(), d.stride(0), d.stride(1),
        t_lim.data_ptr(), n, float(t_min), int(any_hit),
        t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
        None if counts is None else counts.data_ptr(),
        dev.stream_ptr(o.device),
    )
    dev.check("vkrt_trace_ablate", err)
    trace_ablate.launches += 1
    return RayHits(t, tri, u, v), (None if counts is None else BvhCounts(counts[0], counts[1]))


trace_ablate.launches = 0


def parse_variant(name: str):
    """'threaded' | 'ordered' | 'flat' | 'mt<K>' -> (variant, K)."""
    if name.startswith("mt") and name[2:].isdigit() and int(name[2:]) > 0:
        return "mt", int(name[2:])
    if name in VARIANTS and name != "mt":
        return name, 0
    raise ValueError(f"unknown variant {name!r} (threaded, ordered, flat or mt<K>)")


def trace_variant(name: str, tables: ProbeTables, scene: SceneTensors, o, d,
                  t_lim, t_min: float = T_MIN) -> RayHits:
    """Kernel E: the closest hit (bound |t_lim|) by traversal ``name``.
    ``threaded`` ends a first-hit-kills lane (t_lim < 0) at its first hit;
    such a lane promises only its verdict, which is the plain version's."""
    variant, k = parse_variant(name)
    if variant == "mt" and k > scene.tri_v0.shape[0]:
        raise ValueError(f"{name}: the scene has {scene.tri_v0.shape[0]} triangles")
    if o.device.type == "cpu":
        tris = slice(0, k) if variant == "mt" else slice(None)
        return trace_rays_bruteforce(scene.tri_v0[tris], scene.tri_e1[tris],
                                     scene.tri_e2[tris], o, d, t_lim, t_min)
    if variant == "ordered" and tables.max_depth > ORDERED_STACK:
        raise ValueError(f"ordered: tree depth {tables.max_depth} exceeds the "
                         f"{ORDERED_STACK}-entry stack")
    nodes = tables.bvh.threaded
    tabs = check_scene(nodes, scene) + (tables.cut,)
    n = check_rays("trace_variant", o, d, t_lim, tabs)
    t, tri, u, v = _hit_buffers(n, o.device)
    err = dev.kernels().vkrt_trace_variant(
        VARIANTS[variant], tables.max_depth,
        nodes.data_ptr(), nodes.shape[0],
        tables.cut.data_ptr(), tables.cut.shape[0], k,
        scene.tri_v0.data_ptr(), scene.tri_e1.data_ptr(), scene.tri_e2.data_ptr(),
        o.data_ptr(), o.stride(0), o.stride(1),
        d.data_ptr(), d.stride(0), d.stride(1),
        t_lim.data_ptr(), n, float(t_min),
        t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
        dev.stream_ptr(o.device),
    )
    dev.check("vkrt_trace_variant", err)
    trace_variant.launches += 1
    return RayHits(t, tri, u, v)


trace_variant.launches = 0
