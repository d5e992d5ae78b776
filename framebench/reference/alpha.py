"""Plain alpha-tested punch-through: the reference's closest hit where the
engine runs with ``alpha_test`` on a scene with a MASK or BLEND material.

Written from the contract that ``vkrt_tpu_torch/ops/alpha.py`` states (the
glTF alpha modes and the reference engine's any-hit shader,
raytrace_rahit_todo.glsl:32-38), not from its code, and importing nothing
of the program. A trace finds its closest hit with the benchmark's own walk
(``reference/bvh.py``); then, for up to ``ROUNDS`` rounds, each lane whose
newest hit is still undecided draws whether it sees through it:

* the hit's opacity is the material factor's alpha times the baseColor
  texture's alpha at the hit (level 0, bilinear, REPEAT:
  ``shade.sample_texture``), read through the material's mode: OPAQUE 1,
  MASK 1 where alpha >= cutoff and else 0, BLEND alpha;
* the draw is ``tea(seed ^ PUNCH_KEY, round + 1, 8 rounds)``, its low 24
  bits over 2^24; a lane punches where the draw >= the opacity;
* a punched lane traces again from ``t (1 + 1e-4) + 1e-3`` along its ray,
  its limit that much shorter (clamped at 0, where it has none left), and
  its new hit, measured from the original origin, replaces the old; a lane
  that does not punch, or whose new trace misses, is decided.

After the last round the newest hit stands. Every trace gets its lanes'
seeds: where a pool of k N rays is traced with N seeds, repeat r of the
seeds is ``s ^ (r 0x9E3779B9 mod 2^32)``; where the engine hands a trace no
seeds, a lane's seed is its index in the engine's pool. Visibility rays
are closest traces under positive limits: a transparent first hit does
not end them.
"""

from __future__ import annotations

import torch

from framebench.reference import shade as sh
from framebench.reference.bvh import T_MIN, Hits

ROUNDS = 4
PUNCH_KEY = 0x61706861  # "apha"
POOL_SALT = 0x9E3779B9
OPAQUE, MASK, BLEND = 0, 1, 2


def enabled(settings: dict, inp) -> bool:
    """The engine's rule: ``alpha_test`` set and a material that is not
    opaque."""
    return bool(settings.get("alpha_test", False)) and any(
        m.alpha_mode != OPAQUE for m in inp.materials)


def opacity(scn, tri, u, v):
    """(N,) opacity of hits on triangles ``tri`` at barycentrics (u, v)."""
    tri = tri.long()
    w = 1.0 - u - v
    uv = sh._bary(scn.corner_uv[tri], w, u, v)
    m = scn.tri_mat[tri].long()
    alpha = scn.mat_base_color[m][:, 3] * sh.sample_texture(
        scn.tex_rgba, scn.tex_size, scn.mat_base_tex[m], uv)[:, 3]
    mode = scn.mat_alpha_mode[m]
    cut = (alpha >= scn.mat_alpha_cutoff[m]).to(alpha.dtype)
    return torch.where(mode == OPAQUE, torch.ones_like(alpha),
                       torch.where(mode == MASK, cut, alpha))


def punch_draw(seed, rnd: int):
    """(N,) f32 uniform of round ``rnd`` (0-based) from the lanes' seeds."""
    bits = sh.tea(sh.as_u32(seed) ^ PUNCH_KEY, rnd + 1, rounds=8)
    return (bits & 0x00FFFFFF).to(torch.float32) * (1.0 / float(1 << 24))


def pool_seeds(seed, n: int):
    """The seeds of ``n`` rays traced with fewer seeds, tiled."""
    s = sh.as_u32(seed)
    reps = -(-n // s.shape[0])
    return torch.cat([s ^ ((r * POOL_SALT) & sh.MASK32) for r in range(reps)])[:n]


class Tracer:
    """The walk with punch-through on the reference's scene."""

    def __init__(self, scn, walk, rounds: int = ROUNDS):
        self.scn, self.walk, self.rounds = scn, walk, rounds

    def closest(self, o, d, t_lim, seed, t_min: float = T_MIN) -> Hits:
        """The hits of rays (o, d) within (t_min, t_lim), ``t_lim`` >= 0 a
        ray, alpha-tested with the lanes' ``seed``."""
        n = o.shape[0]
        seed = pool_seeds(seed, n)
        first = self.walk.closest(o, d, t_lim, t_min)
        hit, t, tri, u, v = (x.clone() for x in first)
        undecided = hit.clone()
        for rnd in range(self.rounds):
            lanes = torch.nonzero(undecided).flatten()
            if lanes.numel() == 0:
                break
            see = punch_draw(seed[lanes], rnd) >= opacity(self.scn, tri[lanes], u[lanes],
                                                           v[lanes]).float()
            lanes = lanes[see]
            undecided = torch.zeros_like(undecided)
            if lanes.numel() == 0:
                break
            adv = t[lanes] * (1.0 + 1e-4) + 1e-3
            again = self.walk.closest(o[lanes] + d[lanes] * adv[:, None], d[lanes],
                                      torch.clamp_min(t_lim[lanes] - adv, 0.0), t_min)
            hit[lanes] = again.hit
            t[lanes] = torch.where(again.hit, again.t + adv, 0.0)
            tri[lanes], u[lanes], v[lanes] = again.tri, again.u, again.v
            undecided[lanes] = again.hit
        return Hits(hit, t, tri, u, v)
