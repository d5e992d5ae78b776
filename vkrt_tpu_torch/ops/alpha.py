"""Alpha-tested any-hit: stochastic transparency as masked re-tracing
(port of ``vkrt_tpu/ops/alpha.py``).

The reference ships (unwired) any-hit shaders that stochastically ignore
intersections on transparent materials (raytrace_rahit_todo.glsl:32-38).
Here that is a bounded re-trace loop around the tracer: trace closest,
evaluate the hit's opacity (material factor x baseColor texture alpha at
the hit UV), draw a uniform, and re-trace the punched lanes from just past
their hit; the other lanes are parked (origin 1e30, d = 0, limit -1) and
never hit.

Opacity semantics (glTF 2.0 alphaMode x the reference's rahit):
* OPAQUE (0): opacity 1, never punches;
* MASK (1): 1 where alpha >= cutoff, else 0 (deterministic cutout);
* BLEND (2): opacity = alpha (stochastic transparency).

The punch draw is a TEA hash of the lane seed and the round, so the
estimator's own stream is untouched: ``tea(seed ^ 0x61706861, r + 1, 8)``,
``u01 = (bits & 0xFFFFFF) / 2^24``, punch where ``u01 >= opacity``, bit for
bit as in the JAX package.

Two choices of this port:
* Every trace runs all ``rounds`` re-trace rounds (1 + ``rounds`` launches
  of the inner tracer). The JAX package skips a round when no lane is
  unsettled (``lax.cond``); in PyTorch that test would read the device back
  every round. A round in which no lane punches changes nothing (the draw
  is a pure hash and the merge only touches punched lanes), so the results
  are the same.
* A punched lane whose hit lies within its advance of its limit has no
  segment left: its re-trace limit is clamped to 0, which never hits. The
  JAX package's brute-force and LBVH tracers miss on such a negative limit
  too; to kernel A a negative limit would be a first-hit-kills lane.
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch.ops.rng import MASK32, as_u32, tea
from vkrt_tpu_torch.ops.texture import sample_texture
from vkrt_tpu_torch.scene import scene_is_textured

# Max transparent surfaces a single ray segment can punch through per trace.
# Beyond this the last hit is accepted (bounded bias).
DEFAULT_ROUNDS = 4
_PUNCH_KEY = 0x61706861  # "apha"
_INV_2_24 = 1.0 / 16777216.0


def scene_has_alpha(scene) -> bool:
    """True iff any material can punch through. Reads the (M,) alpha modes
    to the host: call it once, when the tracer is built."""
    return bool((scene.mat_alpha_mode.cpu() != 0).any())


def opacity_at_hit(scene, tri, u, v):
    """Effective opacity of a hit: baseColor.a (factor x texture) through the
    material's alphaMode. ``tri`` pre-clamped >= 0."""
    mat_id = scene.tri_mat[tri.long()].long()
    mode = scene.mat_alpha_mode[mat_id]
    alpha = scene.mat_base_color[mat_id, 3]
    cutoff = scene.mat_alpha_cutoff[mat_id]
    if scene_is_textured(scene):
        w = 1.0 - u - v
        cuv = scene.corner_uv[tri.long()]  # (N,3,2)
        uv = cuv[:, 0] * w[:, None] + cuv[:, 1] * u[:, None] + cuv[:, 2] * v[:, None]
        base_tex = scene.mat_base_tex[mat_id]
        alpha = alpha * sample_texture(scene.tex_rgba, scene.tex_size, base_tex, uv)[:, 3]
    masked = (alpha >= cutoff).to(alpha.dtype)
    return torch.where(mode == 0, 1.0, torch.where(mode == 1, masked, alpha))


def alpha_closest(scene, tracer, orig, direction, t_min, t_max, t_lim, seed,
                  rounds: int = DEFAULT_ROUNDS):
    """``tracer.closest`` with stochastic alpha punch-through.

    ``t_lim`` is per lane (the trace contract); the returned HitInfo's ``t``
    is measured from the ORIGINAL origin. ``seed`` (N,) integer lane seeds
    (int32 bits or uint32 values) is read only."""
    hi = tracer.closest(orig, direction, t_min, t_max, t_lim=t_lim)
    # a lane is unsettled only while its newest hit awaits its punch
    # decision: re-drawing settled lanes would compound the punch probability
    unsettled = torch.ones(orig.shape[:1], dtype=torch.bool, device=orig.device)
    key = as_u32(seed) ^ _PUNCH_KEY
    for r in range(rounds):
        a = opacity_at_hit(scene, torch.clamp_min(hi.tri, 0), hi.u, hi.v)
        bits = tea(key, r + 1, rounds=8)
        u01 = (bits & 0x00FFFFFF).to(torch.float32) * _INV_2_24
        punch = unsettled & hi.hit & (u01 >= a)  # rahit: rnd > dissolve -> ignore

        # advance punched lanes just past their hit (hi.t is measured from
        # the original origin, so the advance is too); park everyone else
        adv = hi.t * (1.0 + 1e-4) + 1e-3
        new_o = orig + direction * adv[:, None]
        to = torch.where(punch[:, None], new_o, 1e30)
        td = torch.where(punch[:, None], direction, 0.0)
        tl = torch.where(punch, torch.clamp_min(t_lim - adv, 0.0), -1.0)
        hi2 = tracer.closest(to, td, t_min, t_max, t_lim=tl)

        # punched lanes adopt the re-trace (t shifted back to the original
        # origin's frame); settled lanes keep theirs
        hi = type(hi)(
            hit=torch.where(punch, hi2.hit, hi.hit),
            t=torch.where(punch, hi2.t + adv, hi.t),
            tri=torch.where(punch, hi2.tri, hi.tri),
            u=torch.where(punch, hi2.u, hi.u),
            v=torch.where(punch, hi2.v, hi.v),
        )
        unsettled = punch  # only re-traced lanes have an undecided hit
    return hi


def make_alpha_tracer(scene, inner, rounds: int = DEFAULT_ROUNDS):
    """Wrap ``inner`` with punch-through when the scene needs it, else
    return ``inner`` unchanged (no cost for opaque scenes)."""
    if not scene_has_alpha(scene):
        return inner
    return AlphaTracer(scene, inner, rounds)


class AlphaTracer:
    """Tracer adapter: the ``closest``/``any`` surface, alpha-aware.

    ``with_seed`` returns an adapter carrying the callers' lane seeds, so
    estimator code hands them down without changing the trace call. Like
    the JAX adapter it does not declare ``anyhit_kill_capable``: callers
    give it positive limits, and ``any`` traces closest hits (a transparent
    first hit must not end the search)."""

    def __init__(self, scene, inner, rounds: int = DEFAULT_ROUNDS, seed=None):
        self.scene = scene
        self.inner = inner
        self.rounds = rounds
        self.seed = seed

    def with_seed(self, seed):
        return AlphaTracer(self.scene, self.inner, self.rounds, seed)

    def _seed_for(self, n: int, device):
        if self.seed is not None:
            return self.seed
        return torch.arange(n, dtype=torch.int64, device=device)  # deterministic fallback

    def closest(self, orig, direction, t_min, t_max, t_lim=None):
        n = orig.shape[0]
        if t_lim is None:
            t_lim = torch.full((n,), float(t_max), dtype=orig.dtype, device=orig.device)
        seed = self._seed_for(n, orig.device)
        if seed.shape[0] != n:
            # a fused pool traces kN rays with N seeds: tile, decorrelating
            # each repeat by the uint32 product r * 0x9E3779B9 (wrapped)
            reps = -(-n // seed.shape[0])
            s = as_u32(seed)
            seed = torch.cat([s ^ ((r * 0x9E3779B9) & MASK32) for r in range(reps)])[:n]
        return alpha_closest(self.scene, self.inner, orig, direction, t_min, t_max, t_lim,
                             seed, self.rounds)

    def any(self, orig, direction, t_min, t_max):
        """Visibility: a closest trace under the (positive) limits
        ``t_max``, scalar or per ray; True where something opaque enough
        is hit."""
        if torch.is_tensor(t_max) and t_max.ndim:
            return self.closest(orig, direction, t_min, None, t_lim=t_max).hit
        return self.closest(orig, direction, t_min, t_max).hit
