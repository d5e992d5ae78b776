"""LBVH: the linear BVH built on the device (Morton sort + Karras linking).

Port of ``vkrt_tpu/bvh/lbvh.py``, bit for bit:

1. triangle boxes and centroids, 30-bit Morton codes (10 bits an axis) over
   the centroids' bounds;
2. a stable sort of the codes, so equal codes keep their triangle order
   (the JAX package sorts ``(code, index)`` pairs by the code alone);
3. Karras 2012's internal nodes, every one on its own from longest-common-
   prefix queries (equal codes fall through to the index bits);
4. each node's box as a range min / max over the sorted leaf boxes, read
   from a sparse table;
5. the threaded preorder layout in closed form: ``dfs = 2 * first_leaf +
   (left-child edges above the node)``, ``skip = dfs + 2 * leaves - 1``, so
   a walk needs one cursor a ray (box hit at an inner node -> node + 1,
   otherwise the skip link).

Everything is plain PyTorch on the device of the inputs: no value goes to
the host, so a build on the card queues its kernels and returns. The JAX
package's ``while_loop`` over the left-child edges becomes pointer doubling
(a fixed number of rounds, the same counts). The CPU has no uint32 ``>>``,
so the unsigned arithmetic runs in int64 holding values in [0, 2^32), as
``ops/rng.py`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vkrt_tpu_torch.ops.rng import MASK32


class FlatBVH(NamedTuple):
    """Threaded preorder BVH. M = 2n - 1 nodes."""

    node_min: torch.Tensor   # (M,3) f32
    node_max: torch.Tensor   # (M,3)
    node_skip: torch.Tensor  # (M,) int32 preorder index after this subtree
    node_tri: torch.Tensor   # (M,) int32 triangle id, -1 for inner nodes


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every third bit (Morton helper): int64 in [0, 2^32)
    (the JAX package's uint32). Each product's bits above 31 fall to the
    mask, as the uint32 product wraps."""
    v = v.to(torch.int64) & MASK32
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(p01: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) from points normalized to [0,1]^3.
    (N,3) -> (N,)."""
    q = (p01 * 1024.0).clamp(0.0, 1023.0).to(torch.int64)
    return (_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1) | _expand_bits(q[:, 2])


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the uint32 bits of an integer tensor (int64
    result), by five shift rounds as the JAX package counts them."""
    x = x.to(torch.int64) & MASK32
    shift = torch.zeros_like(x)
    cur = x
    for s in (16, 8, 4, 2, 1):
        hi = (cur >> s) != 0
        cur = torch.where(hi, cur >> s, cur)
        shift = shift + hi.to(torch.int64) * s
    return torch.where(x == 0, 32, 31 - shift)


def build_lbvh(tri_v0: torch.Tensor, tri_e1: torch.Tensor, tri_e2: torch.Tensor) -> FlatBVH:
    """The LBVH of (n,3) f32 triangles (vertex, two edges) on their device.
    Every triangle is a leaf, degenerate ones (padding) too."""
    dev = tri_v0.device
    n = tri_v0.shape[0]
    v1 = tri_v0 + tri_e1
    v2 = tri_v0 + tri_e2
    bmin = torch.minimum(torch.minimum(tri_v0, v1), v2)
    bmax = torch.maximum(torch.maximum(tri_v0, v1), v2)
    if n == 1:
        one = torch.ones(1, dtype=torch.int32, device=dev)
        return FlatBVH(bmin, bmax, one, one - 1)

    centroid = 0.5 * (bmin + bmax)
    lo = centroid.amin(0)
    hi = centroid.amax(0)
    codes = morton3d((centroid - lo) / torch.clamp(hi - lo, min=1e-12))

    # sort leaves by (code, original index)
    codes_s, order = torch.sort(codes, stable=True)
    tri_id = order.to(torch.int32)
    lmin, lmax = bmin[order], bmax[order]

    def delta(i, j):
        """Common-prefix length of sorted keys i and j (duplicate codes:
        32 + that of the indices); -1 where j is out of range."""
        j_ok = (j >= 0) & (j < n)
        jc = j.clamp(0, n - 1)
        x = codes_s[i] ^ codes_s[jc]
        d = torch.where(x == 0, 32 + _clz32(i ^ jc), _clz32(x))
        return torch.where(j_ok, d, -1)

    i = torch.arange(n - 1, dtype=torch.int64, device=dev)
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # upper bound by doubling (idempotent once the condition fails)
    lmax_len = torch.full((n - 1,), 2, dtype=torch.int64, device=dev)
    for _ in range(31):
        grow = delta(i, i + lmax_len * d) > delta_min
        lmax_len = torch.where(grow, torch.clamp(lmax_len * 2, max=1 << 30), lmax_len)

    # binary search the exact other end j = i + l*d
    ln = torch.zeros(n - 1, dtype=torch.int64, device=dev)
    for k in range(1, 32):
        t = lmax_len >> k
        cand = ln + t
        ok = (t > 0) & (delta(i, i + cand * d) > delta_min)
        ln = torch.where(ok, cand, ln)
    j = i + ln * d

    # split position gamma by binary search on the node's own prefix
    delta_node = delta(i, j)
    s = torch.zeros(n - 1, dtype=torch.int64, device=dev)
    t = ln
    done = torch.zeros(n - 1, dtype=torch.bool, device=dev)
    for _ in range(32):
        t = (t + 1) >> 1
        cand = s + t
        ok = ~done & (delta(i, i + cand * d) > delta_node)
        s = torch.where(ok, cand, s)
        done = done | (t <= 1)
    gamma = i + s * d + torch.clamp(d, max=0)

    first = torch.minimum(i, j)
    last = torch.maximum(i, j)
    # global node ids: internal k -> k (k in [0, n-2]); leaf k -> n-1+k
    left_id = torch.where(first == gamma, (n - 1) + gamma, gamma)
    right_id = torch.where(last == gamma + 1, (n - 1) + gamma + 1, gamma + 1)

    m = 2 * n - 1
    parent = torch.full((m,), -1, dtype=torch.int64, device=dev)
    parent[left_id] = i
    parent[right_id] = i
    # index_fill_ takes its value as a scalar: an assignment of True would
    # copy a host tensor to the device
    is_left = torch.zeros(m, dtype=torch.bool, device=dev).index_fill_(0, left_id, True)

    # per-node leaf ranges
    leaves = torch.arange(n, dtype=torch.int64, device=dev)
    node_first = torch.cat([first, leaves])
    node_last = torch.cat([last, leaves])

    # left-child edges on the path to the root, by pointer doubling: after
    # round r, a_left[v] sums the edges of the 2^r nodes from v up and anc[v]
    # is the node 2^r above v (-1 past the root); the tree is at most m deep
    a_left = ((parent >= 0) & is_left).to(torch.int64)
    anc = parent
    for _ in range(m.bit_length()):
        has = anc >= 0
        up = anc.clamp(min=0)
        a_left = a_left + torch.where(has, a_left[up], 0)
        anc = torch.where(has, anc[up], -1)

    n_leaves = node_last - node_first + 1
    dfs = 2 * node_first + a_left
    skip = dfs + 2 * n_leaves - 1

    # internal boxes: range min/max over sorted leaf boxes via a sparse table
    levels = max(1, (n - 1).bit_length())
    sp_min, sp_max = [lmin], [lmax]
    for k in range(1, levels):
        half = 1 << (k - 1)
        prev_min, prev_max = sp_min[-1], sp_max[-1]
        shifted_min = torch.cat([prev_min[half:], prev_min[-1:].expand(half, 3)])
        shifted_max = torch.cat([prev_max[half:], prev_max[-1:].expand(half, 3)])
        sp_min.append(torch.minimum(prev_min, shifted_min))
        sp_max.append(torch.maximum(prev_max, shifted_max))
    sp_min = torch.stack(sp_min)  # (levels, n, 3)
    sp_max = torch.stack(sp_max)

    # k = floor(log2(length)) via comparisons (exact for ints)
    k_level = torch.zeros(m, dtype=torch.int64, device=dev)
    for jbit in range(1, levels):
        k_level = k_level + (n_leaves >= (1 << jbit)).to(torch.int64)
    a_idx = node_first
    b_idx = torch.clamp(node_last - (torch.ones_like(k_level) << k_level) + 1, min=0)
    nmin = torch.minimum(sp_min[k_level, a_idx], sp_min[k_level, b_idx])
    nmax = torch.maximum(sp_max[k_level, a_idx], sp_max[k_level, b_idx])

    # scatter into the preorder layout (dfs is a permutation of the nodes)
    out_min = torch.zeros((m, 3), dtype=tri_v0.dtype, device=dev).index_copy_(0, dfs, nmin)
    out_max = torch.zeros((m, 3), dtype=tri_v0.dtype, device=dev).index_copy_(0, dfs, nmax)
    out_skip = torch.zeros(m, dtype=torch.int32, device=dev).index_copy_(
        0, dfs, skip.to(torch.int32))
    out_tri = torch.full((m,), -1, dtype=torch.int32, device=dev).index_copy_(
        0, dfs[n - 1:], tri_id)
    return FlatBVH(out_min, out_max, out_skip, out_tri)
