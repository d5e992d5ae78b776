"""Ray reordering for coherence (port of ``vkrt_tpu/ops/sort_rays.py``).

Diffuse bounce rays from one block of lanes share tight origins but scatter
their directions over the hemisphere, so the lanes of one warp walk
different parts of the tree. Sorting rays by (direction octant, origin
Morton cell) before tracing regroups the pool so neighbouring lanes cover a
small origin region and one direction cone -- the wavefront path tracer's
trick (SURVEY.md section 2d): one sort and two gathers a trace, one gather
a result to put the hits back in ray order.

As in the JAX package, no loop uses it: ``SortingTracer`` wraps a tracer
for whoever wants sorted traces. Keys are int64 tensors holding the JAX
package's uint32 keys (the CPU has no uint32 ``>>``; see ``ops/rng.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vkrt_tpu_torch.bvh.lbvh import _expand_bits
from vkrt_tpu_torch.ops.trace import HitInfo

DEAD_KEY = 0xFFFFFFFF


def ray_sort_keys(origin, direction, lo, hi, dead=None) -> torch.Tensor:
    """(N,) int64 key in [0, 2^32): direction octant << 21 | 21-bit origin
    Morton code (7 bits an axis over the box ``lo``..``hi``).

    Octant-major: a bounce pool's origins are already tile-coherent and its
    directions hemisphere-random, so the spread of directions dominates
    what a group of rays touches; 8 direction runs, each sorted by origin,
    give groups of one cone over a tight origin region.

    ``dead``: optional (N,) bool; dead lanes get ``DEAD_KEY`` and sort to
    the tail."""
    p = (origin - lo) / torch.clamp(hi - lo, min=1e-12)
    q = (p * 128.0).clamp(0.0, 127.0).to(torch.int64)
    # 7-bit expand via the 10-bit helper (top bits zero)
    morton = (_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1) | _expand_bits(q[:, 2])
    octant = ((direction[:, 0] >= 0).to(torch.int64) * 4
              + (direction[:, 1] >= 0).to(torch.int64) * 2
              + (direction[:, 2] >= 0).to(torch.int64))
    key = (octant << 21) | morton
    if dead is not None:
        key = torch.where(dead, DEAD_KEY, key)
    return key


def _unsort(perm: torch.Tensor) -> torch.Tensor:
    """The inverse of the permutation ``perm``."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


class SortingTracer(NamedTuple):
    """Wraps a tracer; sorts rays for coherence, unsorts results."""

    inner: object
    lo: torch.Tensor  # (3,) scene bounds
    hi: torch.Tensor

    def perm(self, origin, direction, dead=None) -> torch.Tensor:
        """The lanes in key order (a stable sort: equal keys keep their
        order)."""
        keys = ray_sort_keys(origin, direction, self.lo, self.hi, dead=dead)
        return torch.sort(keys, stable=True).indices

    def closest(self, origin, direction, t_min, t_max, t_lim=None) -> HitInfo:
        dead = None if t_lim is None else t_lim < 0
        perm = self.perm(origin, direction, dead)
        tl_s = None if t_lim is None else t_lim[perm]
        h = self.inner.closest(origin[perm], direction[perm], t_min, t_max, t_lim=tl_s)
        inv = _unsort(perm)
        return HitInfo(*(x[inv] for x in h))

    def any(self, origin, direction, t_min, t_max) -> torch.Tensor:
        t_max_arr = torch.as_tensor(t_max, dtype=origin.dtype, device=origin.device)
        t_max_arr = t_max_arr.expand(origin.shape[:1])
        perm = self.perm(origin, direction, dead=t_max_arr <= 0)
        hit = self.inner.any(origin[perm], direction[perm], t_min, t_max_arr[perm])
        return hit[_unsort(perm)]


def make_sorting_tracer(inner, scene) -> SortingTracer:
    """``inner`` behind a sort over ``scene``'s bounds (its padded
    triangles', as the JAX package takes them), found on the scene's
    device."""
    v0 = scene.tri_v0
    v1, v2 = v0 + scene.tri_e1, v0 + scene.tri_e2
    lo = torch.minimum(torch.minimum(v0, v1), v2).amin(0)
    hi = torch.maximum(torch.maximum(v0, v1), v2).amax(0)
    return SortingTracer(inner=inner, lo=lo, hi=hi)
