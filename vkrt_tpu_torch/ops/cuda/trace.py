"""Kernel A: the CUDA trace kernel (``csrc/trace.cu``) and its tracer.

Replaces ``vkrt_tpu/ops/pallas/trace.py::_trace_kernel``. The tree is the
threaded preorder SAH BVH of ``utils.native.build_sah_bvh`` (one triangle
per leaf, skip links), built on the host and repacked here into what the
kernel walks (``Bvh``): one 64-byte record per inner node holding both
children's boxes and references (``pack_bvh2_nodes``), and one 48-byte
record per triangle in leaf order (``pack_tris``). The threaded (M, 8)
table (``pack_bvh_nodes``) is kept beside them for kernel E's ``threaded``
and ``flat`` variants and for ``trace_rays_bvh``. Triangle records carry
scene triangle ids, so there is no ``tri_remap``. The TPU kernel's cluster
tree, vote words, pre-pivoted tables and ``TraceSpec`` knobs exist only
because Mosaic has no per-lane gathers and are not ported.

``trace_kernel`` is the wrapper: on CUDA tensors it launches the kernel
(or raises); on CPU tensors it runs the kernel's plain version, the brute
force of ``ops/trace.py``.

Scenes that move (``scene_instances``) keep the tree and refit its boxes
(``refit_bvh``, the counterpart of the TPU package's cluster refit): the
math runs on the tree's host mirror (``BvhHost``, kept by ``build_bvh``)
and only the dirty rows of the three tables are written on the device.

``threaded_tables`` makes kernel E's threaded table and triangle records
of a tree held as tensors (the LBVH of ``bvh/lbvh.py``, the ``bvh``
backend's) on the tree's device, as ``pack_bvh_nodes`` and ``pack_tris``
make them on the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from vkrt_tpu_torch import device as dev
from vkrt_tpu_torch.ops.intersect import T_MIN
from vkrt_tpu_torch.ops.trace import (
    WALK_STACK, Bvh, RayHits, Tracer, trace_rays_bruteforce,
)
from vkrt_tpu_torch.scene import SceneTensors
from vkrt_tpu_torch.utils import native


def pack_bvh_nodes(node_min, node_max, node_skip, node_tri) -> np.ndarray:
    """The four arrays of native.build_sah_bvh -> the threaded (M, 8) f32
    node table, rows [min.xyz | skip (i32 bits) | max.xyz | tri (i32
    bits)] with tri = -1 at inner nodes."""
    nodes = np.zeros((len(node_min), 8), np.float32)
    nodes[:, 0:3] = node_min
    nodes[:, 3] = np.asarray(node_skip, np.int32).view(np.float32)
    nodes[:, 4:7] = node_max
    nodes[:, 7] = np.asarray(node_tri, np.int32).view(np.float32)
    return nodes


def node_depths(skip: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Depth of every node of a threaded preorder tree: the children of
    inner node i are i + 1 and skip[i + 1]."""
    depth = np.zeros(len(skip), np.int32)
    level, frontier = 0, np.zeros(1, np.int64)
    while frontier.size:
        depth[frontier] = level
        inner = frontier[tri[frontier] < 0]
        frontier = np.concatenate([inner + 1, skip[inner + 1]])
        level += 1
    return depth


def node_refs(tri: np.ndarray) -> np.ndarray:
    """Every node's reference in ``pack_bvh2_nodes``' records: an inner
    node's row among the inner nodes, a leaf's ``~slot`` (its place in
    ``leaf_tri``)."""
    is_leaf = tri >= 0
    return np.where(is_leaf, ~(np.cumsum(is_leaf) - 1), np.cumsum(~is_leaf) - 1).astype(np.int32)


def _records(lo, hi, ref, left, right, rec_depth) -> np.ndarray:
    """Child-box records (``pack_bvh2_nodes``' layout) of the inner nodes
    whose children are ``left`` and ``right``."""
    rec = np.zeros((len(left), 16), np.float32)
    rec[:, 0:3], rec[:, 4:7] = lo[left], hi[left]
    rec[:, 8:11], rec[:, 12:15] = lo[right], hi[right]
    rec[:, 3] = ref[left].view(np.float32)
    rec[:, 7] = ref[right].view(np.float32)
    rec[:, 11] = np.asarray(rec_depth, np.int32).view(np.float32)
    return rec


def pack_bvh2_nodes(node_min, node_max, node_skip, node_tri):
    """The threaded tree -> (records, leaf_tri, depth).

    ``records``: (I, 16) f32, one row per inner node in preorder, four
    float4: [left min.xyz | left ref], [left max.xyz | right ref],
    [right min.xyz | the node's depth], [right max.xyz | 0], integers as
    i32 bits. A reference >= 0 is a row of ``records``; a leaf is ``~slot``
    with ``slot`` its place in ``leaf_tri`` (``node_refs``). There are no
    leaf rows.
    ``leaf_tri``: (L,) int32 scene triangle ids in leaf (preorder) order.
    ``depth``: the most inner nodes on a path from the root, which is the
    most stack entries a front-to-back walk holds.

    A root that is a leaf (a one-triangle scene) becomes one record whose
    two children are both that leaf: the second test of the triangle
    changes nothing (an equal t goes to the lower id, and it is the same
    id)."""
    skip = np.asarray(node_skip, np.int64)
    tri = np.asarray(node_tri, np.int32)
    lo, hi = np.asarray(node_min, np.float32), np.asarray(node_max, np.float32)
    leaf_tri = tri[tri >= 0]
    inner = np.nonzero(tri < 0)[0]
    depth = node_depths(skip, tri)
    if inner.size == 0:  # the root is a leaf
        left = right = np.zeros(1, np.int64)
        rec_depth = np.zeros(1, np.int32)
    else:
        left, right = inner + 1, skip[inner + 1]
        rec_depth = depth[inner]
    rec = _records(lo, hi, node_refs(tri), left, right, rec_depth)
    return rec, leaf_tri, int(rec_depth.max()) + 1


def pack_bvh4_nodes(node_min, node_max, node_skip, node_tri):
    """The threaded tree collapsed into records of up to four children ->
    (records, stack, depth), the table of kernel E's ``ordered``.

    A record starts from a binary inner node's two children; while it has
    fewer than four and one of them is an inner node, the inner child with
    the largest surface area gives way to its own two children. ``records``:
    (W, 32) f32, one 128-byte row per record, eight float4 with the
    children as columns: [min.x x4] [min.y x4] [min.z x4] [max.x x4]
    [max.y x4] [max.z x4] [ref x4] [child count | depth | 0 | 0], integers
    as i32 bits. A reference > 0 is a row of ``records``, < 0 the triangle
    record ``~ref`` in leaf (preorder) order, which is ``pack_bvh2_nodes``'
    ``leaf_tri`` order; 0 is an empty slot (row 0 is the root, nobody's
    child), whose box is min +inf, max -inf. The walk must skip an empty
    slot by its reference: the slab test takes the smaller and the larger
    of each axis' two distances, so that inverted box reads as all of
    space. Rows are in breadth-first order, so the first rows are the top
    of the tree. ``stack``: the most entries a front-to-back walk can hold
    (a record pushes up to its child count - 1 before it descends);
    ``depth``: the records on the longest path from the root.

    A root that is a leaf (a one-triangle scene) is one record with that
    leaf as its only child."""
    skip = np.asarray(node_skip, np.int64)
    tri = np.asarray(node_tri, np.int32)
    lo, hi = np.asarray(node_min, np.float32), np.asarray(node_max, np.float32)
    is_leaf = tri >= 0
    slot = np.cumsum(is_leaf) - 1
    ext = hi.astype(np.float64) - lo
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    levels = []  # (children as threaded nodes (F, 4), -1 where empty; counts (F,))
    if is_leaf[0]:
        levels.append((np.array([[0, -1, -1, -1]]), np.ones(1, np.int64)))
        frontier = np.zeros(0, np.int64)
    else:
        frontier = np.zeros(1, np.int64)
    while frontier.size:
        rows = np.arange(len(frontier))
        kids = np.full((len(frontier), 4), -1, np.int64)
        kids[:, 0], kids[:, 1] = frontier + 1, skip[frontier + 1]
        cnt = np.full(len(frontier), 2, np.int64)
        for _ in range(2):
            a = np.where((kids >= 0) & ~is_leaf[kids], area[kids], -1.0)
            j = a.argmax(1)
            grow = a[rows, j] >= 0.0
            parent = kids[grow, j[grow]]
            kids[grow, j[grow]] = parent + 1
            kids[grow, cnt[grow]] = skip[parent + 1]
            cnt[grow] += 1
        levels.append((kids, cnt))
        frontier = kids[(kids >= 0) & ~is_leaf[kids]]
    n_rec = sum(len(k) for k, _ in levels)
    rec = np.zeros((n_rec, 32), np.float32)
    bits = rec.view(np.int32)
    need = np.zeros(n_rec + 1, np.int64)  # stack entries below a record; [n_rec]: a leaf
    base, spans = 0, []
    for level, (kids, cnt) in enumerate(levels):
        f = len(kids)
        inner = (kids >= 0) & ~is_leaf[kids]
        ref = np.where(kids >= 0, ~slot[kids], 0)
        ref[inner] = base + f + np.arange(int(inner.sum()))
        empty = (kids < 0)[:, None, :]
        rec[base:base + f, 0:12] = np.where(empty, np.inf, lo[kids].transpose(0, 2, 1)
                                            ).reshape(f, 12)
        rec[base:base + f, 12:24] = np.where(empty, -np.inf, hi[kids].transpose(0, 2, 1)
                                             ).reshape(f, 12)
        bits[base:base + f, 24:28] = ref
        bits[base:base + f, 28], bits[base:base + f, 29] = cnt, level
        spans.append((base, np.where(inner, ref, n_rec), cnt))
        base += f
    for start, child, cnt in reversed(spans):
        need[start:start + len(child)] = cnt - 1 + need[child].max(1)
    return rec, int(need[0]), len(levels)


def pack_tris(v0, e1, e2, leaf_tri) -> np.ndarray:
    """(L, 12) f32 triangle records in leaf order, three float4:
    [v0.xyz | scene triangle id (i32 bits)], [e1.xyz | 0], [e2.xyz | 0]."""
    leaf_tri = np.asarray(leaf_tri, np.int32)
    rec = np.zeros((len(leaf_tri), 12), np.float32)
    rec[:, 0:3], rec[:, 4:7], rec[:, 8:11] = v0[leaf_tri], e1[leaf_tri], e2[leaf_tri]
    rec[:, 3] = leaf_tri.view(np.float32)
    return rec


def threaded_tables(flat, v0, e1, e2):
    """What kernel E's ``threaded`` body reads of a threaded tree, made on
    the tree's device without a copy to the host: ``flat`` holds the four
    arrays ``(node_min, node_max, node_skip, node_tri)`` as tensors (a
    ``bvh/lbvh.py::FlatBVH``), ``v0``, ``e1``, ``e2`` the scene's (T,3)
    triangles. Returns ``(nodes, tris)``: ``pack_bvh_nodes``' (M, 8) table
    with each leaf's slot in ``tris`` in place of its triangle id (as
    ``trace_variants.probe_tables`` fills it on the host), and
    ``pack_tris``' (L, 12) records in leaf (preorder) order, both equal to
    the host functions' output bit for bit. Every inner node has two
    children, so the tree has L = (M + 1) / 2 leaves."""
    node_min, node_max, node_skip, node_tri = flat
    m = node_tri.shape[0]
    is_leaf = node_tri >= 0
    nodes = torch.empty((m, 8), dtype=torch.float32, device=node_tri.device)
    bits = nodes.view(torch.int32)
    nodes[:, 0:3], nodes[:, 4:7] = node_min, node_max
    bits[:, 3] = node_skip
    bits[:, 7] = torch.where(is_leaf, torch.cumsum(is_leaf, 0) - 1, -1).to(torch.int32)
    # the leaves in preorder: a stable sort puts them first, in their order
    leaf = torch.sort((~is_leaf).to(torch.uint8), stable=True).indices[:(m + 1) // 2]
    leaf_tri = node_tri[leaf].long()
    tris = torch.zeros((leaf.shape[0], 12), dtype=torch.float32, device=node_tri.device)
    tris[:, 0:3], tris[:, 4:7], tris[:, 8:11] = v0[leaf_tri], e1[leaf_tri], e2[leaf_tri]
    tris.view(torch.int32)[:, 3] = leaf_tri.to(torch.int32)
    return nodes, tris


def _tri_arrays(scene: SceneTensors):
    return [np.asarray(t.detach().cpu(), np.float32)
            for t in (scene.tri_v0, scene.tri_e1, scene.tri_e2)]


def build_bvh_arrays(scene: SceneTensors, tri_arrays=None):
    """(node_min, node_max, node_skip, node_tri) from the native SAH
    builder (compiled at first use; a failed build raises: there is no
    Morton fallback). ``tri_arrays``: the scene's (v0, e1, e2) on the host,
    when the caller has them (else they are read from the device)."""
    res = native.build_sah_bvh(*(tri_arrays or _tri_arrays(scene)))
    if res is None:
        raise ValueError("scene has no non-degenerate triangle to build a BVH over")
    return res


class BvhHost(NamedTuple):
    """The host mirror of a ``Bvh``'s tree, kept when it is built, so that
    ``refit_bvh`` never reads the device tables back. M nodes of the
    threaded preorder tree, T scene triangles."""

    skip: np.ndarray         # (M,) int64 skip links
    tri: np.ndarray          # (M,) int32 a leaf's triangle, -1 at inner nodes
    ref: np.ndarray          # (M,) int32 record row (inner) or ~leaf slot (node_refs)
    depth: np.ndarray        # (M,) int32 (node_depths)
    parent: np.ndarray       # (M,) int64, -1 at the root
    lo: np.ndarray           # (M,3) f32 node boxes
    hi: np.ndarray           # (M,3) f32
    node_of_tri: np.ndarray  # (T,) int64 the leaf of a triangle, -1 if not in the tree


def bvh_host(node_min, node_max, node_skip, node_tri, n_tris: int) -> BvhHost:
    """The host mirror of the threaded tree ``native.build_sah_bvh``
    returned, over a scene of ``n_tris`` triangles."""
    skip = np.asarray(node_skip, np.int64)
    tri = np.asarray(node_tri, np.int32)
    inner = np.nonzero(tri < 0)[0]
    parent = np.full(len(tri), -1, np.int64)
    parent[inner + 1] = inner
    parent[skip[inner + 1]] = inner
    node_of_tri = np.full(n_tris, -1, np.int64)
    leaves = np.nonzero(tri >= 0)[0]
    node_of_tri[tri[leaves]] = leaves
    return BvhHost(skip=skip, tri=tri, ref=node_refs(tri), depth=node_depths(skip, tri),
                   parent=parent, lo=np.array(node_min, np.float32),
                   hi=np.array(node_max, np.float32), node_of_tri=node_of_tri)


def build_bvh(scene: SceneTensors, tri_arrays=None) -> Bvh:
    """The scene's BVH tables on the scene's device: what kernel A walks,
    the threaded table beside it, and the tree's host mirror.
    ``tri_arrays``: as ``build_bvh_arrays``."""
    tri_arrays = tri_arrays or _tri_arrays(scene)
    arrays = build_bvh_arrays(scene, tri_arrays)
    records, leaf_tri, depth = pack_bvh2_nodes(*arrays)

    def put(a):
        return torch.as_tensor(a, device=scene.device)

    return Bvh(nodes=put(records), tris=put(pack_tris(*tri_arrays, leaf_tri)),
               depth=depth, threaded=put(pack_bvh_nodes(*arrays)),
               host=bvh_host(*arrays, n_tris=len(tri_arrays[0])))


def _leaf_boxes(v0, e1, e2):
    """Triangle boxes as the native builder forms them
    (``native/bvh_builder.cpp::make_builder``): the corners v0, v0 + e1 and
    v0 + e2 in f32, folded into the box in that order, a corner replacing
    the bound only where it is strictly beyond it."""
    p1, p2 = v0 + e1, v0 + e2
    lo, hi = v0.copy(), v0.copy()
    for p in (p1, p2):
        lo = np.where(p < lo, p, lo)
        hi = np.where(hi < p, p, hi)
    return lo, hi


def _splice(table: torch.Tensor, rows: np.ndarray, values: np.ndarray) -> torch.Tensor:
    """``table`` with ``rows`` replaced: a copy on the device, then an
    ``index_copy_`` of the new rows (copy on write: tables of the earlier
    pose stay as they were)."""
    idx = torch.as_tensor(rows, dtype=torch.long, device=table.device)
    vals = torch.as_tensor(values, device=table.device)
    return table.clone().index_copy_(0, idx, vals)


def refit_bvh(bvh: Bvh, v0, e1, e2, moved) -> Bvh:
    """Refit ``bvh`` to moved triangles: the port's counterpart of
    ``vkrt_tpu/ops/pallas/trace.py::refit_cluster_scene``. The topology
    stays; the boxes grow or shrink.

    ``v0``, ``e1``, ``e2``: the scene's (T,3) f32 triangles after the move,
    on the host; ``moved``: (T,) bool. The leaf boxes of the moved
    triangles are formed as the native builder forms them
    (``_leaf_boxes``); then the dirty ancestors are refit level by level,
    deepest first, from their two children (the lower bound of the right
    child replaces the left's only where it is strictly smaller, so a
    refit of unmoved geometry gives the build's tables bit for bit). Only
    the dirty rows of the three tables are rewritten: the child-box records
    of the dirty inner nodes, the triangle records of the moved triangles
    and the threaded rows of every dirty node. All of it runs on the tree's
    host mirror (``bvh.host``); the device receives the rows. ``depth``
    does not change.

    The builder leaves degenerate triangles (all edges zero: padding) out
    of the tree, and so does a refit; a moved triangle outside the tree
    that is no longer degenerate cannot be refit and raises.
    ``refit_bvh.rows`` counts the rows written, by table."""
    h = bvh.host
    if h is None:
        raise ValueError("refit_bvh needs the tree's host mirror (build_bvh keeps it)")
    ids = np.nonzero(np.asarray(moved, bool))[0]
    leaf = h.node_of_tri[ids]
    outside = leaf < 0
    if outside.any():
        t = ids[outside]
        if (np.abs(e1[t]) + np.abs(e2[t])).any():
            raise ValueError(f"{int(outside.sum())} moved triangles are not in the tree "
                             "(degenerate when it was built) and no longer degenerate: "
                             "rebuild the BVH")
        ids, leaf = ids[~outside], leaf[~outside]
    if ids.size == 0:
        return bvh
    lo, hi = h.lo.copy(), h.hi.copy()
    lo[leaf], hi[leaf] = _leaf_boxes(v0[ids], e1[ids], e2[ids])
    levels, frontier = [], leaf
    while True:  # the dirty ancestors
        frontier = np.unique(h.parent[frontier])
        frontier = frontier[frontier >= 0]
        if not frontier.size:
            break
        levels.append(frontier)
    inner = np.unique(np.concatenate(levels)) if levels else np.zeros(0, np.int64)
    for d in np.unique(h.depth[inner])[::-1]:
        k = inner[h.depth[inner] == d]
        left, right = k + 1, h.skip[k + 1]
        lo[k] = np.where(lo[right] < lo[left], lo[right], lo[left])
        hi[k] = np.where(hi[left] < hi[right], hi[right], hi[left])
    if inner.size:
        rec_rows = h.ref[inner]
        records = _records(lo, hi, h.ref, inner + 1, h.skip[inner + 1], h.depth[inner])
    else:  # the root is a leaf: its one record holds it twice
        rec_rows = np.zeros(1, np.int64)
        records = _records(lo, hi, h.ref, rec_rows, rec_rows, rec_rows)
    dirty = np.concatenate([leaf, inner])
    threaded = pack_bvh_nodes(lo[dirty], hi[dirty], h.skip[dirty], h.tri[dirty])
    slots = ~h.ref[leaf]
    for name, n in (("records", len(rec_rows)), ("tris", len(slots)),
                    ("threaded", len(dirty))):
        refit_bvh.rows[name] += n
    return bvh._replace(
        nodes=_splice(bvh.nodes, rec_rows, records),
        tris=_splice(bvh.tris, slots, pack_tris(v0, e1, e2, ids)),
        threaded=_splice(bvh.threaded, dirty, threaded),
        host=h._replace(lo=lo, hi=hi))


refit_bvh.rows = {"records": 0, "tris": 0, "threaded": 0}


def ray_args(o, d, t_lim) -> list:
    """``device.check_args`` entries of a launch's rays: (N,3) f32 o and d,
    which may be strided views (``strided=("o", "d")``), and (N,) f32
    t_lim."""
    n = o.shape[0]
    return [("o", o, torch.float32, (n, 3)), ("d", d, torch.float32, (n, 3)),
            ("t_lim", t_lim, torch.float32, (n,))]


def bvh_args(bvh: Bvh) -> list:
    """``device.check_args`` entries of the record tables kernels A and D
    walk. An empty tree, or one deeper than the walk's stack, is refused
    here, and the wrappers' CPU branches check the entries' dtypes and
    widths (``device.check_tensors`` with ``CPU_TABLES``), so that both
    devices take the same scenes."""
    if bvh.nodes.shape[0] < 1 or bvh.tris.shape[0] < 1:
        raise ValueError("empty BVH")
    if bvh.depth > WALK_STACK:
        raise ValueError(f"tree depth {bvh.depth} exceeds the walk's "
                         f"{WALK_STACK}-entry stack")
    return [("bvh.nodes", bvh.nodes, torch.float32, (None, 16)),
            ("bvh.tris", bvh.tris, torch.float32, (None, 12))]


# the plain CPU walks read the record tables in any layout
CPU_TABLES = ("bvh.nodes", "bvh.tris")


def trace_kernel(bvh: Bvh, scene: SceneTensors, o, d, t_lim,
                 t_min: float = T_MIN, any_hit: bool = False) -> RayHits:
    """Trace (N,3) o and d with (N,) limits; the kernel's contract (see
    ``ops/trace.py``). ``o`` and ``d`` may be strided views, e.g. rows of a
    (7, N) ray block transposed; ``t_lim`` must be contiguous. Counts the
    lanes handed to it, on either device, in ``trace_kernel.lanes``."""
    tables = bvh_args(bvh)
    n = o.shape[0]
    if o.device.type == "cpu":
        dev.check_tensors("trace_kernel", tables, strided=CPU_TABLES)
        trace_kernel.lanes += n
        return trace_rays_bruteforce(scene.tri_v0, scene.tri_e1, scene.tri_e2,
                                     o, d, t_lim, t_min)
    dev.check_args("trace_kernel", ray_args(o, d, t_lim) + tables, strided=("o", "d"))
    t_out = torch.empty(n, dtype=torch.float32, device=o.device)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty(n, dtype=torch.float32, device=o.device)
    v = torch.empty(n, dtype=torch.float32, device=o.device)
    dev.launch(
        "vkrt_trace", o.device,
        bvh.nodes.data_ptr(), bvh.tris.data_ptr(), bvh.depth,
        o.data_ptr(), o.stride(0), o.stride(1),
        d.data_ptr(), d.stride(0), d.stride(1),
        t_lim.data_ptr(), n, float(t_min), int(any_hit),
        t_out.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(), lanes=n,
    )
    trace_kernel.lanes += n
    return RayHits(t_out, tri, u, v)


trace_kernel.lanes = 0  # padded and dead lanes included: what a launch walks


@dataclasses.dataclass(frozen=True)
class CudaTracer(Tracer):
    """Tracer running kernel A over the scene's BVH (on a CPU tensor, its
    plain version)."""

    bvh: Bvh = None  # build_bvh's tables

    def trace(self, o, d, t_lim, t_min: float = T_MIN,
              any_hit: bool = False) -> RayHits:
        return trace_kernel(self.bvh, self.scene, o, d, t_lim, t_min, any_hit)

    def refit(self, scene: SceneTensors, tri_arrays, moved) -> "CudaTracer":
        """This tracer on ``scene``, whose triangles ``moved`` (``refit_bvh``
        on the host arrays ``tri_arrays`` = (v0, e1, e2))."""
        return dataclasses.replace(self, scene=scene,
                                   bvh=refit_bvh(self.bvh, *tri_arrays, moved))


def make_cuda_tracer(scene: SceneTensors, tri_arrays=None) -> CudaTracer:
    return CudaTracer(scene=scene, bvh=build_bvh(scene, tri_arrays))

