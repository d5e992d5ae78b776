"""The benchmark's own binary SAH tree and its plain walk.

The tree is built here, in numpy, with frozen parameters (``BINS`` centroid
bins a node and axis, leaves of at most ``LEAF`` triangles, the surface area
heuristic with equal costs for a box and a triangle test), level by level
over all nodes of a level at once. It serves two readers: the reference
tracer (closest hits, ties to the lower triangle id, as the port's brute
force ``vkrt_tpu_torch/ops/trace.py::trace_rays_bruteforce`` and kernel A
report them at commit 400863e) and the roofline of kernel A, which counts
the box and triangle tests of a walk over it (``Walk.counts``). Neither
depends on the port's own tree.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BINS = 16
LEAF = 4
STACK = 64
T_MIN = 1e-3
T_MAX = 1e4
_DET_EPS = 1e-9
_PAD = 1e-6  # box padding relative to the scene's extent: the walk never misses a tie


class Tree(NamedTuple):
    lo: np.ndarray      # (M, 3) f32 node boxes
    hi: np.ndarray
    left: np.ndarray    # (M,) int32 child ids, -1 at a leaf
    right: np.ndarray
    start: np.ndarray   # (M,) int32 leaf range into ``order``
    count: np.ndarray
    order: np.ndarray   # (T,) int32 triangle ids, leaf by leaf


def _area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def build_sah(v0, v1, v2) -> Tree:
    """Binned SAH tree over (T, 3) f32 corners."""
    tlo = np.minimum(np.minimum(v0, v1), v2).astype(np.float64)
    thi = np.maximum(np.maximum(v0, v1), v2).astype(np.float64)
    cen = 0.5 * (tlo + thi)
    n = len(v0)
    order = np.arange(n, dtype=np.int64)
    lo, hi, left, right, start, count = [], [], [], [], [], []

    def new_node():
        for lst, val in ((lo, None), (hi, None), (left, -1), (right, -1), (start, 0),
                         (count, 0)):
            lst.append(val)
        return len(left) - 1

    seg_start = np.array([0], np.int64)
    seg_count = np.array([n], np.int64)
    seg_node = np.array([new_node()], np.int64)
    while len(seg_node):
        s = len(seg_node)
        offs = np.concatenate([[0], np.cumsum(seg_count)[:-1]])
        seg_of = np.repeat(np.arange(s), seg_count)
        pos = np.repeat(seg_start - offs, seg_count) + np.arange(seg_count.sum())
        el = order[pos]
        nlo = np.minimum.reduceat(tlo[el], offs)
        nhi = np.maximum.reduceat(thi[el], offs)
        cmin = np.minimum.reduceat(cen[el], offs)
        cmax = np.maximum.reduceat(cen[el], offs)
        best_cost = np.full(s, np.inf)
        best_axis = np.zeros(s, np.int64)
        best_split = np.zeros(s, np.int64)
        bins_of = np.zeros((3, len(el)), np.int64)
        for a in range(3):
            ext = (cmax[:, a] - cmin[:, a])[seg_of]
            b = np.where(ext > 0, (cen[el, a] - cmin[seg_of, a]) / np.where(ext > 0, ext, 1.0)
                         * BINS, 0.0)
            b = np.clip(b.astype(np.int64), 0, BINS - 1)
            bins_of[a] = b
            key = seg_of * BINS + b
            cnt = np.bincount(key, minlength=s * BINS).reshape(s, BINS)
            perm = np.argsort(key, kind="stable")
            ks = key[perm]
            first = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
            blo = np.full((s * BINS, 3), np.inf)
            bhi = np.full((s * BINS, 3), -np.inf)
            blo[ks[first]] = np.minimum.reduceat(tlo[el][perm], first)
            bhi[ks[first]] = np.maximum.reduceat(thi[el][perm], first)
            blo, bhi = blo.reshape(s, BINS, 3), bhi.reshape(s, BINS, 3)
            llo = np.minimum.accumulate(blo, axis=1)[:, :-1]
            lhi = np.maximum.accumulate(bhi, axis=1)[:, :-1]
            rlo = np.minimum.accumulate(blo[:, ::-1], axis=1)[:, ::-1][:, 1:]
            rhi = np.maximum.accumulate(bhi[:, ::-1], axis=1)[:, ::-1][:, 1:]
            nl = np.cumsum(cnt, axis=1)[:, :-1]
            nr = seg_count[:, None] - nl
            with np.errstate(invalid="ignore"):
                cost = np.where(nl > 0, _area(llo, lhi) * nl, 0.0) + np.where(
                    nr > 0, _area(rlo, rhi) * nr, 0.0)
            cost = np.where((nl > 0) & (nr > 0), cost, np.inf)
            j = np.argmin(cost, axis=1)
            c = cost[np.arange(s), j]
            better = c < best_cost
            best_cost = np.where(better, c, best_cost)
            best_axis = np.where(better, a, best_axis)
            best_split = np.where(better, j, best_split)
        split = seg_count > LEAF
        # which side each element goes: the best bin split, or the halves of
        # the segment where every centroid fell in one bin
        no_split = ~np.isfinite(best_cost)
        side = (bins_of[best_axis[seg_of], np.arange(len(el))] > best_split[seg_of])
        rank = np.arange(len(el)) - offs[seg_of]
        side = np.where(no_split[seg_of], rank >= seg_count[seg_of] // 2, side)
        for i in range(s):
            nd = seg_node[i]
            lo[nd], hi[nd] = nlo[i], nhi[i]
            if not split[i]:
                start[nd], count[nd] = seg_start[i], seg_count[i]
        # stable partition of each split segment: left side first
        mask = split[seg_of]
        part = np.argsort(seg_of * 2 + side, kind="stable")
        new_el = el[part]
        order[pos] = np.where(mask, new_el, el)
        nl_seg = np.bincount(seg_of[~side], minlength=s)
        nxt_start, nxt_count, nxt_node = [], [], []
        for i in np.flatnonzero(split):
            nd = seg_node[i]
            a, b = new_node(), new_node()
            left[nd], right[nd] = a, b
            nxt_start += [seg_start[i], seg_start[i] + nl_seg[i]]
            nxt_count += [nl_seg[i], seg_count[i] - nl_seg[i]]
            nxt_node += [a, b]
        seg_start = np.asarray(nxt_start, np.int64)
        seg_count = np.asarray(nxt_count, np.int64)
        seg_node = np.asarray(nxt_node, np.int64)
    lo, hi = np.asarray(lo), np.asarray(hi)
    pad = _PAD * max(float(np.abs(lo).max()), float(np.abs(hi).max()), 1.0)
    return Tree(lo=(lo - pad).astype(np.float32), hi=(hi + pad).astype(np.float32),
                left=np.asarray(left, np.int32), right=np.asarray(right, np.int32),
                start=np.asarray(start, np.int32), count=np.asarray(count, np.int32),
                order=order.astype(np.int32))


class Hits(NamedTuple):
    hit: torch.Tensor   # (N,) bool
    t: torch.Tensor
    tri: torch.Tensor   # (N,) int64, -1 on a miss
    u: torch.Tensor     # 0 on a miss
    v: torch.Tensor


class Walk:
    """The tree on a device in ``dtype`` with the triangles' v0/e1/e2, and
    the counts of the last ``closest`` (box tests, triangle tests, rays)."""

    def __init__(self, tree: Tree, v0, e1, e2, device, dtype=torch.float32):
        def t(x, dt):
            return torch.as_tensor(np.asarray(x), device=device).to(dt)

        self.lo, self.hi = t(tree.lo, dtype), t(tree.hi, dtype)
        self.left, self.right = t(tree.left, torch.int64), t(tree.right, torch.int64)
        self.start, self.count = t(tree.start, torch.int64), t(tree.count, torch.int64)
        self.order = t(tree.order, torch.int64)
        self.v0, self.e1, self.e2 = v0.to(dtype), e1.to(dtype), e2.to(dtype)
        self.counts = (0, 0, 0)

    def _mt(self, o, d, tri, t_min, t_max):
        """Möller-Trumbore with every product and sum rounded on its own
        (``ops/intersect.py::mt_block``, one triangle a lane)."""
        v0, e1, e2 = self.v0[tri], self.e1[tri], self.e2[tri]

        def cr(a, b):
            return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                                a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                                a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)

        def dt(a, b):
            return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]

        pvec = cr(d, e2)
        det = dt(e1, pvec)
        ok = det.abs() > _DET_EPS
        inv = torch.where(ok, 1.0 / det, torch.zeros_like(det))
        tvec = o - v0
        u = dt(tvec, pvec) * inv
        qvec = cr(tvec, e1)
        v = dt(d, qvec) * inv
        t = dt(e2, qvec) * inv
        hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
        return hit, t, u, v

    def closest(self, o, d, t_lim, t_min: float = T_MIN) -> Hits:
        """Closest hit within (t_min, |t_lim|), ties to the lower id. Lanes
        with d = 0 or a bound of at most t_min are not walked."""
        n, dev, dtp = o.shape[0], o.device, self.lo.dtype
        o, d = o.to(dtp), d.to(dtp)
        bound = t_lim.abs().to(dtp)
        best_t = bound.clone()
        best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
        best_u = torch.zeros(n, dtype=dtp, device=dev)
        best_v = torch.zeros(n, dtype=dtp, device=dev)
        eps = 1e-20
        inv = 1.0 / torch.where(d.abs() < eps, torch.where(d < 0, -eps, eps).to(dtp), d)
        stack = torch.zeros((n, STACK), dtype=torch.int64, device=dev)
        sp = ((bound > t_min) & (d != 0).any(dim=1)).to(torch.int64)
        boxes = tris = 0
        lane = torch.arange(n, device=dev)
        while True:
            a = lane[sp > 0]
            if a.numel() == 0:
                break
            top = sp[a] - 1
            node = stack[a, top]
            sp[a] = top
            leaf = self.left[node] < 0
            la, ln = a[leaf], node[leaf]
            if la.numel():
                cnt, st = self.count[ln], self.start[ln]
                tris += int(cnt.sum())
                for j in range(int(cnt.max())):
                    m = cnt > j
                    lj, tri = la[m], self.order[st[m] + j]
                    hit, t, u, v = self._mt(o[lj], d[lj], tri, t_min, bound[lj])
                    bt, btri = best_t[lj], best_tri[lj]
                    take = hit & ((t < bt) | ((t == bt) & (tri < btri)))
                    best_t[lj] = torch.where(take, t, bt)
                    best_tri[lj] = torch.where(take, tri, btri)
                    best_u[lj] = torch.where(take, u, best_u[lj])
                    best_v[lj] = torch.where(take, v, best_v[lj])
            ia, inode = a[~leaf], node[~leaf]
            if ia.numel():
                boxes += 2 * ia.numel()
                oa, inva, bt = o[ia], inv[ia], best_t[ia]
                near, ok = [], []
                for child in (self.left[inode], self.right[inode]):
                    t0 = (self.lo[child] - oa) * inva
                    t1 = (self.hi[child] - oa) * inva
                    tn = torch.clamp_min(torch.minimum(t0, t1).amax(dim=1), t_min)
                    tf = torch.minimum(torch.maximum(t0, t1).amin(dim=1), bt)
                    near.append(tn)
                    ok.append(tn <= tf)
                cl, cr_ = self.left[inode], self.right[inode]
                swap = near[1] < near[0]  # nearer child popped first: pushed last
                first = torch.where(swap, cl, cr_)
                second = torch.where(swap, cr_, cl)
                ok_first = torch.where(swap, ok[0], ok[1])
                ok_second = torch.where(swap, ok[1], ok[0])
                s0 = sp[ia]
                stack[ia[ok_first], s0[ok_first]] = first[ok_first]
                s1 = s0 + ok_first.to(torch.int64)
                stack[ia[ok_second], s1[ok_second]] = second[ok_second]
                sp[ia] = s1 + ok_second.to(torch.int64)
                if int(sp.max()) >= STACK:
                    raise RuntimeError("walk stack overflow")
        hit = best_tri >= 0
        self.counts = (boxes, tris, int((bound > t_min).sum()))
        return Hits(hit, torch.where(hit, best_t, 0.0), best_tri,
                    torch.where(hit, best_u, 0.0), torch.where(hit, best_v, 0.0))
