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
  ``benchmarks/scratch/variants.py::make_kernel``, the alternatives to
  kernel A's design: ``ordered`` (the wide front-to-back walk over records
  of up to four children, the counterpart of the TPU's 16 boxes a visit;
  plain version ``trace_rays_bvh_wide``, whose counts ``count=True``
  returns), ``binary`` (nearer child first over the threaded table, a stack
  in local memory), ``threaded`` (the TPU's "plain": the stackless
  skip-link walk), ``flat`` (a scan over the cut's boxes out of shared
  memory, then the stackless walk) and ``mt<K>`` (the first K scene
  triangles out of shared memory, no boxes). Every one reads triangles as
  kernel A's records and decides equal-t ties as kernel A does, so each is
  bit-equal to brute force (over the first K triangles for ``mt<K>``),
  the plain version of all but ``ordered``, whose own is bit-equal to it.

``trace_threaded`` launches ``threaded`` alone over a tree's threaded
table and triangle records (``ops/cuda/trace.py::threaded_tables``), with
no ``ProbeTables``: it is what ``LbvhTracer``, the ``bvh`` backend, runs
over the LBVH built on the device (``bvh/lbvh.py``). Its launches count
under ``vkrt_trace_variant`` in ``device.counts``; its plain version is
``trace_rays_bvh`` over the same tables.

The TPU variants ``dynK`` and ``bitK`` measured the cost of Mosaic's loop
iterations and have no counterpart here.

``ProbeTables`` holds what the host derives from the threaded table: each
node's depth (from the skip links), the tree's depth (``binary``'s stack
holds one entry per level, ``BINARY_STACK`` in all), the cut (``top`` and
``flat``): the nodes at ``cut_depth`` and the shallower leaves, where
``cut_depth`` puts about ``CUT_TRIS`` triangles under a cut node, as the
TPU tree put 16 clusters of 64 under a super node; and the tables only
kernel E reads: the wide records (``pack_bvh4_nodes``), the threaded
table with each leaf's slot in ``Bvh.tris``, the cut nodes' rows of it,
and the triangle records in scene order. ``build_bvh`` makes none of
them, so the main path does not pay for them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from vkrt_tpu_torch import device as dev
from vkrt_tpu_torch.bvh.lbvh import FlatBVH, build_lbvh
from vkrt_tpu_torch.ops.cuda.probes import miss_record
from vkrt_tpu_torch.ops.cuda.trace import (
    CPU_TABLES, bvh_args, node_depths, pack_bvh4_nodes, pack_tris, ray_args, threaded_tables,
)
from vkrt_tpu_torch.ops.intersect import T_MIN
from vkrt_tpu_torch.ops.trace import (
    WIDE_STACK, Bvh, BvhCounts, RayHits, Tracer, WideBvh, WideCounts, trace_rays_bruteforce,
    trace_rays_bvh, trace_rays_bvh_ordered, trace_rays_bvh_wide,
)
from vkrt_tpu_torch.scene import SceneTensors

ABLATE_MODES = {"full": 0, "boxes": 1, "top": 2, "count": 3}
VARIANTS = {"threaded": 0, "ordered": 1, "flat": 2, "mt": 3, "binary": 4}
# every instantiation of the kernel (csrc/trace_variants.cu's enum Variant),
# as ``device.variant_info`` takes them
INSTANTIATIONS = {**VARIANTS, "ordered with counts": 5}
BINARY_STACK = 64  # variant binary's stack entries (csrc/trace_variants.cu)
CUT_TRIS = 1024


@dataclasses.dataclass(frozen=True)
class ProbeTables:
    bvh: Bvh                  # kernel A's tables, and the threaded table
    depth: torch.Tensor       # (M,) int32 node depth, root 0
    cut: torch.Tensor         # (C,) int32 cut node ids, preorder
    cut_depth: int
    max_depth: int
    wide: WideBvh             # ordered's records (pack_bvh4_nodes) over bvh.tris
    threaded: torch.Tensor    # (M, 8) bvh.threaded with leaf slots for triangle ids
    cut_boxes: torch.Tensor   # (C, 8) the cut's rows of threaded; inner: ~first child
    scene_tris: torch.Tensor  # (T, 12) triangle records in scene order (mt<K>)


def cut_depth_for(n_tris: int) -> int:
    """The depth whose subtrees hold about ``CUT_TRIS`` triangles (>= 1)."""
    return max(1, round(math.log2(max(n_tris, 1) / CUT_TRIS)))


def probe_tables(bvh: Bvh, scene: SceneTensors) -> ProbeTables:
    """The host tables of kernels D and E for ``scene`` and its BVH."""
    nodes = bvh.threaded.detach().cpu().numpy()
    bits = nodes.view(np.int32)
    skip, tri = bits[:, 3].astype(np.int64), bits[:, 7]
    depth = node_depths(skip, tri)
    cut_depth = cut_depth_for(scene.num_tris)
    cut = np.nonzero((depth == cut_depth) | ((depth < cut_depth) & (tri >= 0)))[0]
    records, stack, wide_depth = pack_bvh4_nodes(nodes[:, 0:3], nodes[:, 4:7], skip, tri)
    # the leaf's place in bvh.tris (leaf order) where the table has its triangle
    slot = np.where(tri >= 0, np.cumsum(tri >= 0) - 1, -1)
    slots = nodes.copy()
    slots.view(np.int32)[:, 7] = slot
    cut_boxes = slots[cut]
    cut_boxes.view(np.int32)[:, 7] = np.where(tri[cut] >= 0, slot[cut], ~(cut + 1))
    v0, e1, e2 = (np.asarray(t.detach().cpu(), np.float32)
                  for t in (scene.tri_v0, scene.tri_e1, scene.tri_e2))

    def put(a):
        return torch.as_tensor(a, device=bvh.threaded.device)

    return ProbeTables(
        bvh=bvh, depth=put(depth), cut=put(cut.astype(np.int32)), cut_depth=cut_depth,
        max_depth=int(depth.max()),
        wide=WideBvh(put(records), bvh.tris, stack, wide_depth),
        threaded=put(slots), cut_boxes=put(cut_boxes),
        scene_tris=put(pack_tris(v0, e1, e2, np.arange(len(v0)))),
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
    tabs = bvh_args(bvh)
    if o.device.type == "cpu":
        dev.check_tensors("trace_ablate", tabs, strided=CPU_TABLES)
        if mode == "count":
            return trace_rays_bvh_ordered(bvh, o, d, t_lim, t_min, any_hit, count=True)
        if mode == "full":
            return trace_rays_bruteforce(scene.tri_v0, scene.tri_e1, scene.tri_e2,
                                         o, d, t_lim, t_min), None
        return miss_record(t_lim), None
    n = o.shape[0]
    dev.check_args("trace_ablate", ray_args(o, d, t_lim) + tabs, strided=("o", "d"))
    t, tri, u, v = _hit_buffers(n, o.device)
    counts = (torch.empty((2, n), dtype=torch.int32, device=o.device)
              if mode == "count" else None)
    dev.launch(
        "vkrt_trace_ablate", o.device,
        ABLATE_MODES[mode],
        bvh.nodes.data_ptr(), bvh.tris.data_ptr(), bvh.depth, tables.cut_depth,
        o.data_ptr(), o.stride(0), o.stride(1),
        d.data_ptr(), d.stride(0), d.stride(1),
        t_lim.data_ptr(), n, float(t_min), int(any_hit),
        t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
        None if counts is None else counts.data_ptr(), lanes=n,
    )
    return RayHits(t, tri, u, v), (None if counts is None else BvhCounts(counts[0], counts[1]))


def _table_args(**tables) -> list:
    """``device.check_args`` entries of f32 (n >= 1, width) tables, given as
    name -> (tensor, width)."""
    for name, (t, _) in tables.items():
        if t.ndim and t.shape[0] < 1:
            raise ValueError(f"{name}: an empty table")
    return [(name, t, torch.float32, (None, width)) for name, (t, width) in tables.items()]


def parse_variant(name: str):
    """'ordered' | 'binary' | 'threaded' | 'flat' | 'mt<K>' -> (variant, K)."""
    if name.startswith("mt") and name[2:].isdigit() and int(name[2:]) > 0:
        return "mt", int(name[2:])
    if name in VARIANTS and name != "mt":
        return name, 0
    raise ValueError(f"unknown variant {name!r} (ordered, binary, threaded, flat or mt<K>)")


def trace_variant(name: str, tables: ProbeTables, scene: SceneTensors, o, d,
                  t_lim, t_min: float = T_MIN, count: bool = False):
    """Kernel E: the closest hit (bound |t_lim|) by traversal ``name``.
    ``ordered`` and ``threaded`` end a first-hit-kills lane (t_lim < 0) at
    its first hit; such a lane promises only its verdict, which is the
    plain version's. ``count`` (``ordered`` only) also returns the walk's
    slab tests (one a child a record holds), triangle tests and records a
    ray: ``(RayHits, WideCounts)``."""
    variant, k = parse_variant(name)
    if variant == "mt" and k > scene.tri_v0.shape[0]:
        raise ValueError(f"{name}: the scene has {scene.tri_v0.shape[0]} triangles")
    if count and variant != "ordered":
        raise ValueError(f"{name}: only ordered counts its tests")
    wide = tables.wide
    if variant == "ordered" and wide.stack > WIDE_STACK:
        raise ValueError(f"ordered: the wide tree needs {wide.stack} stack entries, "
                         f"the walk holds {WIDE_STACK}")
    if variant == "binary" and tables.max_depth > BINARY_STACK:
        raise ValueError(f"binary: tree depth {tables.max_depth} exceeds the "
                         f"{BINARY_STACK}-entry stack")
    if o.device.type == "cpu":
        if variant == "ordered":
            return trace_rays_bvh_wide(wide, o, d, t_lim, t_min, count=count)
        tris = slice(0, k) if variant == "mt" else slice(None)
        return trace_rays_bruteforce(scene.tri_v0[tris], scene.tri_e1[tris],
                                     scene.tri_e2[tris], o, d, t_lim, t_min)
    tabs = (tables.threaded, wide.nodes, tables.cut_boxes, wide.tris, tables.scene_tris)
    n = o.shape[0]
    dev.check_args("trace_variant", ray_args(o, d, t_lim) + _table_args(
        threaded=(tabs[0], 8), wide=(tabs[1], 32), cut_boxes=(tabs[2], 8), tris=(tabs[3], 12),
        scene_tris=(tabs[4], 12)), strided=("o", "d"))
    t, tri, u, v = _hit_buffers(n, o.device)
    counts = torch.empty((3, n), dtype=torch.int32, device=o.device) if count else None
    dev.launch(
        "vkrt_trace_variant", o.device,
        VARIANTS[variant], tables.max_depth, wide.stack,
        tabs[0].data_ptr(), tabs[0].shape[0], tabs[1].data_ptr(), tabs[1].shape[0],
        tabs[2].data_ptr(), tabs[2].shape[0], tabs[3].data_ptr(), tabs[4].data_ptr(), k,
        o.data_ptr(), o.stride(0), o.stride(1),
        d.data_ptr(), d.stride(0), d.stride(1),
        t_lim.data_ptr(), n, float(t_min),
        t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
        None if counts is None else counts.data_ptr(), lanes=n,
    )
    hits = RayHits(t, tri, u, v)
    return (hits, WideCounts(*counts)) if count else hits


def trace_threaded(nodes, tris, o, d, t_lim, t_min: float = T_MIN,
                   any_hit: bool = False) -> RayHits:
    """Kernel E's ``threaded`` body over ``nodes``, a threaded (M, 8) table
    with leaf slots, and ``tris``, its (L, 12) triangle records: kernel A's
    contract (``ops/trace.py``), ties to the lower triangle id. A
    first-hit-kills lane (t_lim < 0, every lane with ``any_hit``) ends at
    its first hit. The walk is stackless, so any depth is taken. On CPU
    tensors it runs the plain version, ``trace_rays_bvh`` over the same
    tables; on CUDA tensors it launches the kernel or raises."""
    if any_hit:
        t_lim = -t_lim.abs()
    if o.device.type == "cpu":
        return trace_rays_bvh(nodes, None, o, d, t_lim, t_min, tris=tris)
    n = o.shape[0]
    dev.check_args("trace_threaded", ray_args(o, d, t_lim) + _table_args(
        nodes=(nodes, 8), tris=(tris, 12)), strided=("o", "d"))
    t, tri, u, v = _hit_buffers(n, o.device)
    # threaded reads nodes and tris alone: the other tables' pointers are
    # never dereferenced
    dev.launch(
        "vkrt_trace_variant", o.device,
        VARIANTS["threaded"], 0, 0,
        nodes.data_ptr(), nodes.shape[0], nodes.data_ptr(), 0, nodes.data_ptr(), 0,
        tris.data_ptr(), tris.data_ptr(), 0,
        o.data_ptr(), o.stride(0), o.stride(1),
        d.data_ptr(), d.stride(0), d.stride(1),
        t_lim.data_ptr(), n, float(t_min),
        t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(), None, lanes=n,
    )
    return RayHits(t, tri, u, v)


@dataclasses.dataclass(frozen=True)
class LbvhTracer(Tracer):
    """The ``bvh`` backend, the JAX package's: the LBVH of the scene's
    triangles built on their device (``build_lbvh``), walked by kernel E's
    ``threaded`` body (``trace_threaded``; on a CPU scene its plain
    version). A re-posed scene gets a new one (``make_lbvh_tracer``), not a
    refit."""

    flat: Optional[FlatBVH] = None  # the LBVH
    nodes: Optional[torch.Tensor] = None  # (M, 8) threaded table, leaf slots
    tris: Optional[torch.Tensor] = None   # (L, 12) triangle records, leaf order

    def trace(self, o, d, t_lim, t_min: float = T_MIN,
              any_hit: bool = False) -> RayHits:
        return trace_threaded(self.nodes, self.tris, o, d, t_lim, t_min, any_hit)


def make_lbvh_tracer(scene: SceneTensors) -> LbvhTracer:
    """The LBVH tracer of ``scene``, built on the scene's device."""
    s = scene
    flat = build_lbvh(s.tri_v0, s.tri_e1, s.tri_e2)
    nodes, tris = threaded_tables(flat, s.tri_v0, s.tri_e1, s.tri_e2)
    return LbvhTracer(scene=scene, flat=flat, nodes=nodes, tris=tris)
