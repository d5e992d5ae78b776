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
"""

from __future__ import annotations

import dataclasses

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


def pack_bvh2_nodes(node_min, node_max, node_skip, node_tri):
    """The threaded tree -> (records, leaf_tri, depth).

    ``records``: (I, 16) f32, one row per inner node in preorder, four
    float4: [left min.xyz | left ref], [left max.xyz | right ref],
    [right min.xyz | the node's depth], [right max.xyz | 0], integers as
    i32 bits. A reference >= 0 is a row of ``records``; a leaf is ``~slot``
    with ``slot`` its place in ``leaf_tri``. There are no leaf rows.
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
    is_leaf = tri >= 0
    leaf_tri = tri[is_leaf]
    # a node's reference: its row among the inner nodes, or ~its leaf slot
    ref = np.where(is_leaf, ~(np.cumsum(is_leaf) - 1), np.cumsum(~is_leaf) - 1).astype(np.int32)
    inner = np.nonzero(~is_leaf)[0]
    depth = node_depths(skip, tri)
    if inner.size == 0:  # the root is a leaf
        left = right = np.zeros(1, np.int64)
        rec_depth = np.zeros(1, np.int32)
    else:
        left, right = inner + 1, skip[inner + 1]
        rec_depth = depth[inner]
    rec = np.zeros((len(left), 16), np.float32)
    rec[:, 0:3], rec[:, 4:7] = lo[left], hi[left]
    rec[:, 8:11], rec[:, 12:15] = lo[right], hi[right]
    rec[:, 3] = ref[left].view(np.float32)
    rec[:, 7] = ref[right].view(np.float32)
    rec[:, 11] = rec_depth.view(np.float32)
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


def _tri_arrays(scene: SceneTensors):
    return [np.asarray(t.detach().cpu(), np.float32)
            for t in (scene.tri_v0, scene.tri_e1, scene.tri_e2)]


def build_bvh_arrays(scene: SceneTensors):
    """(node_min, node_max, node_skip, node_tri) from the native SAH
    builder (compiled at first use; a failed build raises: there is no
    Morton fallback)."""
    res = native.build_sah_bvh(*_tri_arrays(scene))
    if res is None:
        raise ValueError("scene has no non-degenerate triangle to build a BVH over")
    return res


def build_bvh(scene: SceneTensors) -> Bvh:
    """The scene's BVH tables on the scene's device: what kernel A walks,
    and the threaded table beside it."""
    arrays = build_bvh_arrays(scene)
    records, leaf_tri, depth = pack_bvh2_nodes(*arrays)

    def put(a):
        return torch.as_tensor(a, device=scene.device)

    return Bvh(nodes=put(records), tris=put(pack_tris(*_tri_arrays(scene), leaf_tri)),
               depth=depth, threaded=put(pack_bvh_nodes(*arrays)))


def _check_f32(name, t, shape):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want f32 {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def check_rays(name: str, o, d, t_lim, tables=()) -> int:
    """Validate a CUDA launch's rays ((N,3) o and d, maybe strided; (N,)
    contiguous t_lim) and contiguous tables on their device. Returns N."""
    if o.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {o.device}")
    n = o.shape[0]
    _check_f32("o", o, (n, 3))
    _check_f32("d", d, (n, 3))
    _check_f32("t_lim", t_lim, (n,))
    if not t_lim.is_contiguous():
        raise ValueError("t_lim must be contiguous")
    for t in (d, t_lim) + tuple(tables):
        if t.device != o.device:
            raise ValueError(f"{name}: tensor on {t.device}, rays on {o.device}")
    if not all(t.is_contiguous() for t in tables):
        raise ValueError(f"{name}: scene tables must be contiguous")
    return n


def check_bvh(bvh: Bvh):
    """The record tables kernels A and D walk. A tree deeper than the
    walk's stack is refused (on the CPU too, so that both devices take the
    same scenes)."""
    _check_f32("bvh.nodes", bvh.nodes, (bvh.nodes.shape[0], 16))
    _check_f32("bvh.tris", bvh.tris, (bvh.tris.shape[0], 12))
    if bvh.nodes.shape[0] < 1 or bvh.tris.shape[0] < 1:
        raise ValueError("empty BVH")
    if bvh.depth > WALK_STACK:
        raise ValueError(f"tree depth {bvh.depth} exceeds the walk's "
                         f"{WALK_STACK}-entry stack")
    return (bvh.nodes, bvh.tris)


def trace_kernel(bvh: Bvh, scene: SceneTensors, o, d, t_lim,
                 t_min: float = T_MIN, any_hit: bool = False) -> RayHits:
    """Trace (N,3) o and d with (N,) limits; the kernel's contract (see
    ``ops/trace.py``). ``o`` and ``d`` may be strided views, e.g. rows of a
    (7, N) ray block transposed; ``t_lim`` must be contiguous."""
    if o.device.type == "cpu":
        check_bvh(bvh)
        return trace_rays_bruteforce(scene.tri_v0, scene.tri_e1, scene.tri_e2,
                                     o, d, t_lim, t_min)
    n = check_rays("trace_kernel", o, d, t_lim, check_bvh(bvh))
    t_out = torch.empty(n, dtype=torch.float32, device=o.device)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty(n, dtype=torch.float32, device=o.device)
    v = torch.empty(n, dtype=torch.float32, device=o.device)
    err = dev.kernels().vkrt_trace(
        bvh.nodes.data_ptr(), bvh.tris.data_ptr(), bvh.depth,
        o.data_ptr(), o.stride(0), o.stride(1),
        d.data_ptr(), d.stride(0), d.stride(1),
        t_lim.data_ptr(), n, float(t_min), int(any_hit),
        t_out.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
        dev.stream_ptr(o.device),
    )
    dev.check("vkrt_trace", err)
    trace_kernel.launches += 1
    return RayHits(t_out, tri, u, v)


trace_kernel.launches = 0


@dataclasses.dataclass(frozen=True)
class CudaTracer(Tracer):
    """Tracer running kernel A over the scene's BVH."""

    bvh: Bvh = None  # build_bvh's tables

    def trace(self, o, d, t_lim, t_min: float = T_MIN,
              any_hit: bool = False) -> RayHits:
        return trace_kernel(self.bvh, self.scene, o, d, t_lim, t_min, any_hit)


def make_cuda_tracer(scene: SceneTensors) -> CudaTracer:
    return CudaTracer(scene=scene, bvh=build_bvh(scene))
