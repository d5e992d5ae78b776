"""Trace backends: closest-hit and any-hit queries over ray batches.

Port of ``vkrt_tpu/ops/trace.py``. Three tracers share one API:

* ``Tracer`` — brute force over all triangles, in ray chunks and triangle
  blocks. It is the correctness oracle and the plain version of the CUDA
  trace kernel, and the tracer ``make_tracer`` gives a scene on the CPU.
* ``CudaTracer`` (``ops/cuda/trace.py``) — the CUDA trace kernel over the
  SAH BVH's child-box records (``Bvh``), for a scene on a CUDA device.
* ``LbvhTracer`` (``ops/cuda/trace_variants.py``) — the ``bvh`` backend:
  kernel E's stackless walk over the LBVH built on the device.

``trace_rays_bvh_ordered`` is that kernel's front-to-back walk in plain
torch, the plain version of the trace probes' visit counts
(``ops/cuda/trace_variants.py``); ``trace_rays_bvh`` is the stackless walk
over the threaded table, which kernel E's ``threaded`` variant keeps and
the ``bvh`` backend (``LbvhTracer``) runs over the LBVH.

Both implement ``trace`` with the trace kernel's contract (the Pallas
kernel's, ``vkrt_tpu/ops/pallas/trace.py``): per-lane limit ``t_lim``, a
negative limit is a first-hit-kills lane bounded by ``|t_lim|``, and a miss
returns ``t = |t_lim|``, ``tri = -1``, ``u = v = 0``. Dead and pad lanes
(origin 1e30, d = 0, limit -1 or 0) never hit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from vkrt_tpu_torch.ops.alpha import make_alpha_tracer
from vkrt_tpu_torch.ops.intersect import (
    _DET_EPS, T_MIN, _cross, _dot, mt_block, safe_inv_dir,
)
from vkrt_tpu_torch.scene import SceneTensors

TRI_BLOCK = 256  # triangles per step of the brute-force scan
RAY_CHUNK = 1 << 16  # rays per brute-force chunk (bounds the (N, T) temps)


class HitInfo(NamedTuple):
    hit: torch.Tensor  # (N,) bool
    t: torch.Tensor    # (N,) 0 where ~hit
    tri: torch.Tensor  # (N,) int32, -1 where ~hit
    u: torch.Tensor    # (N,)
    v: torch.Tensor    # (N,)


class RayHits(NamedTuple):
    """The trace kernel's output: on a miss t = |t_lim|, tri = -1, u = v = 0."""

    t: torch.Tensor    # (N,) f32
    tri: torch.Tensor  # (N,) int32 scene triangle id
    u: torch.Tensor    # (N,) f32
    v: torch.Tensor    # (N,) f32


def _closest_chunk(v0, e1, e2, o, d, t_min, t_max):
    """Closest hit of a ray chunk by a scan over triangle blocks; ties go
    to the lowest triangle id. Returns (best t or inf, tri, u, v)."""
    n = o.shape[0]
    bt = torch.full((n,), float("inf"), dtype=o.dtype, device=o.device)
    btri = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    bu = torch.zeros((n,), dtype=o.dtype, device=o.device)
    bv = torch.zeros((n,), dtype=o.dtype, device=o.device)
    for base in range(0, v0.shape[0], TRI_BLOCK):
        blk = slice(base, base + TRI_BLOCK)
        hit, t, u, v = mt_block(o, d, v0[blk], e1[blk], e2[blk], t_min, t_max)
        t = torch.where(hit, t, torch.full_like(t, float("inf")))
        j = torch.argmin(t, dim=1, keepdim=True)
        tj = t.gather(1, j)[:, 0]
        better = tj < bt
        bt = torch.where(better, tj, bt)
        btri = torch.where(better, (j[:, 0] + base).to(torch.int32), btri)
        bu = torch.where(better, u.gather(1, j)[:, 0], bu)
        bv = torch.where(better, v.gather(1, j)[:, 0], bv)
    return bt, btri, bu, bv


def trace_rays_bruteforce(tri_v0, tri_e1, tri_e2, o, d, t_lim,
                          t_min: float = T_MIN) -> RayHits:
    """The plain version of the trace kernel: ``(N,3)`` o and d, ``(N,)``
    t_lim. A first-hit-kills lane reports the closest hit, which is one of
    the hits the kernel may report; its verdict is the same. Lanes that
    cannot hit (d = 0, or a bound of at most ``t_min``: dead, parked and
    skipped lanes) are not scanned; they get the miss record."""
    bound = t_lim.abs()
    live = (bound > t_min) & (d != 0).any(dim=1)
    if not bool(live.all()):
        t = bound.clone()
        tri = torch.full_like(t, -1, dtype=torch.int32)
        u, v = torch.zeros_like(t), torch.zeros_like(t)
        idx = live.nonzero()[:, 0]
        if idx.numel():
            h = trace_rays_bruteforce(tri_v0, tri_e1, tri_e2, o[idx], d[idx], t_lim[idx], t_min)
            t[idx], tri[idx], u[idx], v[idx] = h
        return RayHits(t, tri, u, v)
    ts, tris, us, vs = [], [], [], []
    for s in range(0, o.shape[0], RAY_CHUNK):
        sl = slice(s, s + RAY_CHUNK)
        bt, btri, bu, bv = _closest_chunk(
            tri_v0, tri_e1, tri_e2, o[sl], d[sl], t_min, bound[sl]
        )
        hit = btri >= 0
        ts.append(torch.where(hit, bt, bound[sl]))
        tris.append(btri)
        us.append(bu)
        vs.append(bv)
    return RayHits(torch.cat(ts), torch.cat(tris), torch.cat(us), torch.cat(vs))


def trace_closest_bruteforce(tri_v0, tri_e1, tri_e2, orig, direction,
                             t_min, t_max) -> HitInfo:
    """Closest hit by block-scan over all triangles."""
    t_lim = torch.as_tensor(t_max, dtype=orig.dtype, device=orig.device)
    h = trace_rays_bruteforce(tri_v0, tri_e1, tri_e2, orig, direction,
                              t_lim.expand(orig.shape[:1]), t_min)
    return _hit_info(h)


def trace_any_bruteforce(tri_v0, tri_e1, tri_e2, orig, direction, t_min, t_max):
    """Any-hit (shadow/visibility) query. t_max may be per-ray. (N,) bool."""
    return trace_closest_bruteforce(
        tri_v0, tri_e1, tri_e2, orig, direction, t_min, t_max
    ).hit


# kernel A's slab widening 1 + 2*gamma(3), rounded to f32 as nvcc folds it
SLAB_SCALE = float(np.float32(1.0) + np.float32(2.0) * np.float32(1.7881396e-7))


# the front-to-back walk's stack entries (csrc/walk.cuh): one per level
WALK_STACK = 32


class Bvh(NamedTuple):
    """A scene's BVH tables (``ops/cuda/trace.py::build_bvh``)."""

    nodes: torch.Tensor     # (I, 16) f32 child-box records (pack_bvh2_nodes)
    tris: torch.Tensor      # (L, 12) f32 triangle records in leaf order
    depth: int              # the most stack entries a walk of it holds
    threaded: torch.Tensor  # (M, 8) f32 threaded table (pack_bvh_nodes)
    host: object = None     # the tree's host mirror (ops/cuda/trace.py::BvhHost),
    #                         which refit_bvh reads instead of the device tables


class BvhCounts(NamedTuple):
    """Per-ray work of a BVH walk."""

    nodes: torch.Tensor   # (N,) int32 slab tests
    leaves: torch.Tensor  # (N,) int32 Moller-Trumbore tests


class WideCounts(NamedTuple):
    """Per-ray work of the wide walk: ``BvhCounts`` and its steps."""

    nodes: torch.Tensor    # (N,) int32 slab tests: the children of the records read
    leaves: torch.Tensor   # (N,) int32 Moller-Trumbore tests
    records: torch.Tensor  # (N,) int32 records read


def unpack_nodes(nodes: torch.Tensor):
    """The (M, 8) node table -> (lo (M,3), hi (M,3), skip (M,) i64,
    tri (M,) i64) with tri = -1 at inner nodes."""
    bits = nodes.contiguous().view(torch.int32)
    return nodes[:, 0:3], nodes[:, 4:7], bits[:, 3].long(), bits[:, 7].long()


def trace_rays_bvh(nodes: torch.Tensor, scene: SceneTensors, o, d, t_lim,
                   t_min: float = T_MIN, any_hit: bool = False,
                   count: bool = False, tris: torch.Tensor = None):
    """The stackless walk over the threaded table (kernel E's ``threaded``)
    in plain torch, vectorised over rays: the counterpart of
    ``vkrt_tpu/ops/trace.py::trace_closest_bvh`` / ``trace_any_bvh`` with
    kernel A's contract (per-lane ``t_lim``, first-hit-kills lanes, the
    miss record), its widened slab test and its tie rule: a hit at an equal
    t goes to the lower triangle id, so the closest hits are brute force's
    bit for bit (the JAX walk keeps the triangle met first). A leaf's
    column 7 is its scene triangle id, or with ``tris`` (the (L, 12)
    triangle records of ``ops/cuda/trace.py::pack_tris``) its slot in
    them, which is kernel E's table: then ``scene`` is not read. With
    ``count=True`` it counts the slab and triangle tests that walk makes.
    One current node per ray; each step advances every live ray by one
    node (box hit at an inner node -> node + 1, otherwise the skip link)
    until all are done. Returns ``RayHits``, or ``(RayHits, BvhCounts)``
    with ``count``."""
    lo, hi, skip, tri_of = unpack_nodes(nodes)
    if tris is None:
        v0, e1, e2 = scene.tri_v0, scene.tri_e1, scene.tri_e2
        tri_id = torch.arange(v0.shape[0], dtype=torch.int32, device=o.device)
    else:
        rec = tris.view(-1, 3, 4)
        v0, e1, e2 = rec[:, 0, :3], rec[:, 1, :3], rec[:, 2, :3]
        tri_id = tris.view(torch.int32)[:, 3]
    n_nodes = nodes.shape[0]
    n = o.shape[0]
    dev = o.device
    inv = safe_inv_dir(d)
    t_min_t = torch.tensor(t_min, dtype=torch.float32, device=dev)
    best = t_lim.abs().clone()
    btri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros(n, dtype=torch.float32, device=dev)
    kill = (t_lim < 0) | any_hit
    visits = torch.zeros(n, dtype=torch.int32, device=dev)
    leaves = torch.zeros(n, dtype=torch.int32, device=dev)
    ray = torch.arange(n, device=dev)  # live rays
    cur = torch.zeros(n, dtype=torch.long, device=dev)  # their nodes
    while ray.numel():
        oa, ia = o[ray], inv[ray]
        t0 = (lo[cur] - oa) * ia
        t1 = (hi[cur] - oa) * ia
        mn, mx = torch.fmin(t0, t1), torch.fmax(t0, t1)
        tnear = torch.fmax(torch.fmax(torch.fmax(mn[:, 0], mn[:, 1]), mn[:, 2]), t_min_t)
        tfar = torch.fmin(torch.fmin(torch.fmin(mx[:, 0], mx[:, 1]), mx[:, 2]), best[ray])
        box = tnear <= tfar * SLAB_SCALE
        tri = tri_of[cur]
        leaf = box & (tri >= 0)
        visits[ray] += 1
        stop = torch.zeros_like(box)
        if bool(leaf.any()):
            r, k = ray[leaf], tri[leaf]
            leaves[r] += 1
            hit, th, uh, vh = _mt_pairs(o[r], d[r], v0[k], e1[k], e2[k], t_min_t, None)
            tid = tri_id[k]
            hit &= (th < best[r]) | ((th == best[r]) & (tid < btri[r]))
            r, tid = r[hit], tid[hit]
            best[r] = th[hit]
            btri[r] = tid
            bu[r] = uh[hit]
            bv[r] = vh[hit]
            stop[leaf.nonzero()[:, 0][hit]] = kill[r]
        nxt = torch.where(box & (tri < 0), cur + 1, skip[cur])
        live = (nxt < n_nodes) & ~stop
        ray, cur = ray[live], nxt[live]
    hits = RayHits(best, btri, bu, bv)
    return (hits, BvhCounts(visits, leaves)) if count else hits


def _slab(lo, hi, o, inv, t_min, best):
    """Kernel A's widened slab test of (A,3) boxes against (A,3) rays:
    (hit, entry distance)."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    mn, mx = torch.fmin(t0, t1), torch.fmax(t0, t1)
    tnear = torch.fmax(torch.fmax(torch.fmax(mn[:, 0], mn[:, 1]), mn[:, 2]), t_min)
    tfar = torch.fmin(torch.fmin(torch.fmin(mx[:, 0], mx[:, 1]), mx[:, 2]), best)
    return tnear <= tfar * SLAB_SCALE, tnear


def _sort_children(ref, key, network):
    """Compare-exchange network over the columns of (A, C) child references
    and their entry distances: columns a, b swap where key a > key b, as the
    kernels' network does, so equal keys keep their slots."""
    ref, key = list(ref.unbind(1)), list(key.unbind(1))
    for a, b in network:
        swap = key[a] > key[b]
        key[a], key[b] = torch.where(swap, key[b], key[a]), torch.where(swap, key[a], key[b])
        ref[a], ref[b] = torch.where(swap, ref[b], ref[a]), torch.where(swap, ref[a], ref[b])
    return torch.stack(ref, 1), torch.stack(key, 1)


def _child_slabs(lo, hi, child, o, inv, t_min, best, network):
    """The slab tests of one record's children ((A, 3, C) box columns,
    (A, C) references) against (A, 3) rays: (references, entry distances)
    nearest first, reference 0 (the root, nobody's child) and distance inf
    where a child is missed or its slot is empty."""
    refs, keys = [], []
    for j in range(child.shape[1]):
        hit, tnear = _slab(lo[:, :, j], hi[:, :, j], o, inv, t_min, best)
        hit = hit & (child[:, j] != 0)
        refs.append(torch.where(hit, child[:, j], torch.zeros_like(child[:, j])))
        keys.append(torch.where(hit, tnear, torch.full_like(tnear, float("inf"))))
    return _sort_children(torch.stack(refs, 1), torch.stack(keys, 1), network)


def _front_to_back(children, slabs, tris, stack, o, d, t_lim, t_min, any_hit, count):
    """The front-to-back walk of ``trace_rays_bvh_ordered`` and
    ``trace_rays_bvh_wide``, vectorised over rays. ``children(k, o, inv,
    best)`` tests the children of records ``k`` and returns
    ``_child_slabs``' pair; ``slabs`` is the (records,) count of slab tests
    a record needs (its children), ``tris`` the (L, 12) triangle record
    table and ``stack`` the entries a ray may hold. With ``count`` it
    returns ``(RayHits, slab tests, triangle tests, records)`` a ray."""
    dev = o.device
    n = o.shape[0]
    tri_rec = tris.view(-1, 3, 4)
    tri_id = tris.view(torch.int32)[:, 3]
    inv = safe_inv_dir(d)
    t_min_t = torch.tensor(t_min, dtype=torch.float32, device=dev)
    best = t_lim.abs().clone()
    btri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros(n, dtype=torch.float32, device=dev)
    kill = (t_lim < 0) | any_hit
    visits = torch.zeros(n, dtype=torch.int32, device=dev)
    leaves = torch.zeros(n, dtype=torch.int32, device=dev)
    records = torch.zeros(n, dtype=torch.int32, device=dev)
    stack_ref = torch.zeros((n, stack), dtype=torch.long, device=dev)
    stack_t = torch.zeros((n, stack), dtype=torch.float32, device=dev)
    sp = torch.zeros(n, dtype=torch.long, device=dev)
    ray = torch.arange(n, device=dev)                   # live rays
    ref = torch.zeros(n, dtype=torch.long, device=dev)  # their references
    while ray.numel():
        pop = torch.zeros_like(ray, dtype=torch.bool)   # rays that need a stack entry
        at_inner = ref >= 0
        if bool(at_inner.any()):
            r, k = ray[at_inner], ref[at_inner]
            visits[r] += slabs[k]
            records[r] += 1
            child, key = children(k, o[r], inv[r], t_min_t, best[r])
            for j in range(child.shape[1] - 1, 0, -1):  # the farthest first
                m = child[:, j] != 0
                rm, spm = r[m], sp[r[m]]
                stack_ref[rm, spm] = child[m, j]
                stack_t[rm, spm] = key[m, j]
                sp[rm] += 1
            ref[at_inner] = child[:, 0]
            pop[at_inner] = child[:, 0] == 0
        done = torch.zeros_like(pop)
        at_leaf = ~at_inner
        if bool(at_leaf.any()):
            r, slot = ray[at_leaf], ~ref[at_leaf]
            leaves[r] += 1
            pop[at_leaf] = True
            hit, th, uh, vh = _mt_pairs(o[r], d[r], tri_rec[slot, 0, :3], tri_rec[slot, 1, :3],
                                        tri_rec[slot, 2, :3], t_min_t, None)
            tid = tri_id[slot]
            hit &= (th < best[r]) | ((th == best[r]) & (tid < btri[r]))
            rh = r[hit]
            best[rh], btri[rh], bu[rh], bv[rh] = th[hit], tid[hit], uh[hit], vh[hit]
            ended = torch.zeros_like(hit)
            ended[hit] = kill[rh]
            done[at_leaf] = ended
        # pop: the newest entry whose entry distance is still within best
        want = pop & ~done
        while bool(want.any()):
            empty = want & (sp[ray] == 0)
            done |= empty
            want &= ~empty
            r = ray[want]
            sp[r] -= 1
            ok = stack_t[r, sp[r]] <= best[r] * SLAB_SCALE
            taken = want.clone()
            taken[want] = ok
            ref[taken] = stack_ref[r[ok], sp[r[ok]]]
            want &= ~taken
        ray, ref = ray[~done], ref[~done]
    hits = RayHits(best, btri, bu, bv)
    return (hits, visits, leaves, records) if count else hits


def trace_rays_bvh_ordered(bvh: Bvh, o, d, t_lim, t_min: float = T_MIN,
                           any_hit: bool = False, count: bool = False):
    """Kernel A's walk in plain torch, vectorised over rays, with kernel
    A's contract, arithmetic and tie rule, so its hits are the kernel's bit
    for bit and, with ``count=True``, its visit counts are kernel D's.

    Each ray holds a current reference and a stack of (reference, entry
    distance) pairs. At an inner record both child boxes are tested against
    (t_min, best): the walk goes on into the nearer one that is hit and
    pushes the farther. At a leaf the triangle is tested; a hit at an equal
    t goes to the lower scene triangle id, and ends a first-hit-kills lane.
    Then the newest stack entry still within best (widened as the slab
    test is) is taken, and the walk ends when there is none.

    A record costs two slab tests.
    Returns ``RayHits``, or ``(RayHits, BvhCounts)`` with ``count``."""
    if bvh.depth > WALK_STACK:
        raise ValueError(f"tree depth {bvh.depth} exceeds the walk's "
                         f"{WALK_STACK}-entry stack")
    rec = bvh.nodes.view(-1, 4, 4)
    rec_bits = bvh.nodes.view(torch.int32).view(-1, 4, 4)

    def children(k, oa, ia, t_min_t, ba):
        lo = torch.stack([rec[k, 0, :3], rec[k, 2, :3]], 2)
        hi = torch.stack([rec[k, 1, :3], rec[k, 3, :3]], 2)
        return _child_slabs(lo, hi, rec_bits[k, 0:2, 3].long(), oa, ia, t_min_t, ba,
                            ((0, 1),))

    slabs = torch.full((rec.shape[0],), 2, dtype=torch.int32, device=o.device)
    out = _front_to_back(children, slabs, bvh.tris, bvh.depth, o, d, t_lim, t_min,
                         any_hit, count)
    return (out[0], BvhCounts(out[1], out[2])) if count else out


# the wide walk's stack entries (csrc/trace_variants.cu): up to three a level
WIDE_STACK = 64
# the order a record's four children are sorted in, nearest first
WIDE_NETWORK = ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))


class WideBvh(NamedTuple):
    """The four-children-a-record tables of kernel E's ``ordered``
    (``ops/cuda/trace.py::pack_bvh4_nodes``)."""

    nodes: torch.Tensor  # (W, 32) f32 records, breadth first
    tris: torch.Tensor   # (L, 12) f32 triangle records: ``Bvh.tris`` itself
    stack: int           # the most stack entries a walk of it holds
    depth: int           # records on the longest path from the root


def trace_rays_bvh_wide(wide: WideBvh, o, d, t_lim, t_min: float = T_MIN,
                        count: bool = False):
    """Kernel E's ``ordered`` in plain torch: ``trace_rays_bvh_ordered``'s
    walk over records of up to four children. At a record the four child
    boxes are tested against (t_min, best); the children that are hit are
    sorted by entry distance (``WIDE_NETWORK``), the walk goes on into the
    nearest and pushes the others, the farthest first. Leaves, ties, pops
    and first-hit-kills lanes (t_lim < 0) are kernel A's, so the hits are
    brute force's bit for bit and, with ``count=True``, the counts are the
    kernel's: a record costs one slab test a child it holds (an empty slot
    is skipped by its reference and is no work the closest hit needs).
    Returns ``RayHits``, or ``(RayHits, WideCounts)`` with ``count``."""
    if wide.stack > WIDE_STACK:
        raise ValueError(f"the wide tree needs {wide.stack} stack entries, the "
                         f"walk holds {WIDE_STACK}")
    rec = wide.nodes.view(-1, 8, 4)
    rec_bits = wide.nodes.view(torch.int32).view(-1, 8, 4)

    def children(k, oa, ia, t_min_t, ba):
        return _child_slabs(rec[k, 0:3], rec[k, 3:6], rec_bits[k, 6].long(), oa, ia,
                            t_min_t, ba, WIDE_NETWORK)

    out = _front_to_back(children, rec_bits[:, 7, 0], wide.tris, wide.stack, o, d, t_lim,
                         t_min, False, count)
    return (out[0], WideCounts(*out[1:])) if count else out


def _mt_pairs(o, d, v0, e1, e2, t_min, t_max):
    """``mt_block`` for (A,3) rays against (A,3) triangles, pair by pair,
    in its operation order. ``t_max`` None leaves the far bound to the
    caller."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    ok = det.abs() > _DET_EPS
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    if t_max is not None:
        hit = hit & (t < t_max)
    return hit, t, u, v


def _hit_info(h: RayHits) -> HitInfo:
    hit = h.tri >= 0
    return HitInfo(hit=hit, t=torch.where(hit, h.t, torch.zeros_like(h.t)),
                   tri=h.tri, u=h.u, v=h.v)


def interp_corners(corner, tri, u, v):
    """(T,3,k) corner table at the hits -> (N,k): a0 + u*(a1-a0) + v*(a2-a0)."""
    c = corner[tri.long()]
    return (c[:, 0] + u[:, None] * (c[:, 1] - c[:, 0])
            + v[:, None] * (c[:, 2] - c[:, 0]))


@dataclasses.dataclass(frozen=True)
class Tracer:
    """Brute-force tracer bound to one scene (the CPU oracle)."""

    scene: SceneTensors
    # a negative limit makes a lane first-hit-kills (the verdict is what a
    # shadow query reads), which the general loop gives its shadow lanes
    anyhit_kill_capable = True

    def trace(self, o, d, t_lim, t_min: float = T_MIN,
              any_hit: bool = False) -> RayHits:
        """The trace kernel's contract. ``any_hit`` makes every lane a
        first-hit-kills lane (the brute force reports closest hits, so it
        changes nothing here)."""
        s = self.scene
        return trace_rays_bruteforce(s.tri_v0, s.tri_e1, s.tri_e2, o, d,
                                     t_lim, t_min)

    def trace_block(self, rays, t_min: float = T_MIN) -> RayHits:
        """Rays as one (7, N) block of rows [o.xyz | d.xyz | t_lim]."""
        return self.trace(rays[0:3].T, rays[3:6].T, rays[6], t_min)

    def _lim(self, orig, t_max, t_lim):
        """(N,) contiguous limits (kernel A reads them as an array)."""
        if t_lim is not None:
            return t_lim
        lim = torch.as_tensor(t_max, dtype=orig.dtype, device=orig.device)
        return lim.expand(orig.shape[:1]).contiguous()

    def closest(self, orig, direction, t_min, t_max, t_lim=None) -> HitInfo:
        """Closest hit. ``t_lim``: optional per-ray tMax override."""
        return _hit_info(self.trace(orig, direction,
                                    self._lim(orig, t_max, t_lim), t_min))

    def any(self, orig, direction, t_min, t_max) -> torch.Tensor:
        """Any-hit (shadow/visibility); ``t_max`` may be per-ray. Limits
        are negated into first-hit-kills lanes (a zero limit stays a
        zero bound, so such lanes never hit)."""
        lim = -self._lim(orig, t_max, None).abs()
        return self.trace(orig, direction, lim, t_min, any_hit=True).tri >= 0


BACKENDS = ("auto", "bruteforce", "bvh", "pallas")


def make_tracer(scene: SceneTensors, backend: str = "auto", alpha: bool = False,
                tri_arrays=None):
    """The tracer of ``backend`` (the JAX package's names) for a scene:

    * ``auto``: kernel A's tracer on a CUDA device, brute force on the CPU
      (the JAX package takes its LBVH on a CPU scene of more than 4096
      triangles, for the CPU's speed alone: both give exact closest hits);
    * ``bruteforce``: ``Tracer`` (``trace_rays_bruteforce``) on either device;
    * ``bvh``: the JAX package's LBVH, built on the scene's device
      (``bvh/lbvh.py``; no SAH build, nothing read back to the host) and
      walked by kernel E's stackless ``threaded`` body
      (``ops/cuda/trace_variants.py::LbvhTracer``); on a CPU scene its plain
      version, ``trace_rays_bvh``;
    * ``pallas``: kernel A's tracer (``CudaTracer``); on a CPU scene its
      wrapper runs the plain version, as every wrapper does.

    Every backend gives brute force's closest hits bit for bit.
    ``alpha``: wrap it in the alpha tracer (``ops/alpha.py``) when the
    scene has a MASK or BLEND material (opt-in, as in the JAX package: the
    reference ships its any-hit shaders unwired). ``tri_arrays``: the
    scene's (v0, e1, e2) on the host for kernel A's SAH build, when the
    caller has them (an ``InstancedScene``'s mirrors)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown trace backend {backend!r} (one of {BACKENDS})")
    if scene.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no tracer for device {scene.device}")
    if backend == "bruteforce" or (backend == "auto" and scene.device.type == "cpu"):
        inner = Tracer(scene)
    elif backend == "bvh":
        from vkrt_tpu_torch.ops.cuda.trace_variants import make_lbvh_tracer

        inner = make_lbvh_tracer(scene)
    else:
        from vkrt_tpu_torch.ops.cuda.trace import make_cuda_tracer

        inner = make_cuda_tracer(scene, tri_arrays)
    return make_alpha_tracer(scene, inner) if alpha else inner
