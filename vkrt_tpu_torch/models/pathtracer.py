"""Progressive Monte-Carlo path tracer (port of
``vkrt_tpu/models/pathtracer.py``).

A frame: for every pixel, ``samples`` paths of up to ``depth`` bounces with
NEE shadow rays, keeping the reference's estimator quirks (firefly clamp,
blocked-shadow skip, clear*0.8 / 0.01 miss radiance, frame-0 centre
jitter with both draws still advanced, progressive ``mix`` accumulation).
Two bounce loops. Scenes that kernel B shades (untextured, or baseColor
the only texture) take the packed loop of ``ops/cuda/shade.py``: on a CUDA
device both of its stages are the hand-written kernels, on the CPU their
plain versions. Other textured scenes take the general loop here: kernel A
traces (brute force on the CPU), and ``models/shading.py`` shades in
PyTorch, as the JAX package shades them in XLA.

The general loop follows the dtype of the scene, the camera and the carry
(``trace_pixels`` takes the scene's), so a float64 scene
(``scene.scene_to_dtype``) and camera (``Camera.matrices(dtype=)``) give
the float64 oracle of ``benchmarks/accuracy.py``, which asks for the
general loop with ``general_loop=True`` as the JAX oracle takes it with a
brute-force tracer. RNG draws stay the f32 values of the uint32 LCG and
widen where they meet the carry, and the ray counters stay f32, as in the
JAX package. The packed loop is f32 only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vkrt_tpu_torch.models.shading import clamp_bounds, sample_bsdf, surface_at_hit
from vkrt_tpu_torch.ops.cuda.shade import bounce_chain_packed, kernel_shading_available
from vkrt_tpu_torch.ops.intersect import T_MAX, T_MIN
from vkrt_tpu_torch.ops.rng import MASK32, corr_draws, rnd, seed_pixels
from vkrt_tpu_torch.utils.camera import generate_rays


class BounceCarry(NamedTuple):
    origin: torch.Tensor       # (N,3) prd.rayOrigin
    direction: torch.Tensor    # (N,3) prd.rayDirection
    seed: torch.Tensor         # (N,) int32 bits of the uint32 LCG state
    cur_weight: torch.Tensor   # (N,3) curWeight
    hit_value: torch.Tensor    # (N,3) accumulated hitValue
    active: torch.Tensor       # (N,) path still in the bounce loop
    is_specular: torch.Tensor  # (N,) prd.isSpecular (persists across miss)
    light_dist: torch.Tensor   # (N,) prd.lightDist (persists across miss)
    hit_dists: torch.Tensor    # (N,) denoiser hit-distance bookkeeping
    rays_main: torch.Tensor    # () f32 count of main rays traced
    rays_shadow: torch.Tensor  # () f32 count of shadow rays traced


def bounce_chain(scene, tracer, carry: BounceCarry, *, depth: int,
                 start_depth: int, clear_color, hitdist_weight: float,
                 hitdist_accumulate: bool, clamp_weights=False,
                 corr_seed=None, general_loop: bool = False) -> BounceCarry:
    """Run the bounce loop (rgen:62-116). ``corr_seed``: uint32 enabling
    the correlated per-block sampler, None for independent per-lane
    draws. The packed loop (``ops.cuda.shade.bounce_chain_packed``) where
    kernel B shades the scene and the tracer is not seeded per call (an
    alpha tracer's ``with_seed``: kernel A's tables cannot see through a
    transparent surface), else ``general_bounce_chain``; both serve any
    depth. ``general_loop``: take the general loop on any scene (the
    float64 oracle)."""
    if depth <= start_depth:
        return carry
    packed = (not general_loop and kernel_shading_available(scene)
              and not hasattr(tracer, "with_seed"))
    if packed and carry.origin.dtype != torch.float32:
        raise ValueError(f"the packed loop is float32 only, got a {carry.origin.dtype} "
                         "carry (general_loop=True takes the general loop)")
    loop = bounce_chain_packed if packed else general_bounce_chain
    return loop(
        scene, tracer, carry,
        depth=depth, start_depth=start_depth, clear_color=clear_color,
        hitdist_weight=hitdist_weight, hitdist_accumulate=hitdist_accumulate,
        clamp_weights=clamp_weights, t_min=T_MIN, t_max=T_MAX,
        corr_seed=corr_seed,
    )


def general_bounce_chain(scene, tracer, carry: BounceCarry, *, depth: int,
                         start_depth: int, clear_color, hitdist_weight: float,
                         hitdist_accumulate: bool, clamp_weights=False,
                         t_min: float = T_MIN, t_max: float = T_MAX,
                         corr_seed=None) -> BounceCarry:
    """The bounce loop of ``vkrt_tpu/models/pathtracer.py::bounce_chain``
    (its XLA body, rgen:62-116) for any scene: per bounce ``surface_at_hit``
    and ``sample_bsdf``, then one fused trace of 2N rays, the next bounce's
    main rays and this bounce's shadow rays, whose lanes carry negative
    limits (kernel A's first-hit-kills lanes: only the verdict is read)
    when the tracer declares ``anyhit_kill_capable``, else positive ones;
    the last bounce traces its shadow rays alone (``any``). Dead lanes get
    a degenerate ray (origin 1e30, d = 0, limit -1). A tracer with
    ``with_seed`` (the alpha tracer) gets the seeds of the carry each trace
    starts from, as the JAX loop's ``seeded`` hands them over.

    The ray counters count as the JAX loop does. Its deep-bounce form
    (depth - start_depth > 8) traces the fused pool on the last bounce too
    and then takes that bounce's dangling main rays off the count again;
    this loop does not trace them, which gives the same count for any
    depth."""
    n = carry.origin.shape[0]
    dt = carry.origin.dtype
    lo, hi = clamp_bounds(clamp_weights)
    clear3 = torch.tensor([float(c) for c in clear_color[:3]], dtype=dt,
                          device=carry.origin.device)
    sh_sign = -1.0 if getattr(tracer, "anyhit_kill_capable", False) else 1.0

    def seeded(c):
        # an alpha tracer draws its punch-through decisions from the lane seeds
        return tracer.with_seed(c.seed) if hasattr(tracer, "with_seed") else tracer

    def closest(c, o, d, lim):
        return seeded(c).closest(o, d, t_min, t_max, t_lim=lim)

    def live(c, x, dead):
        return torch.where(c.active[:, None], x, dead)

    def main_lim(active):
        return torch.where(active, t_max, -1.0).to(dt)

    hi_cur = closest(carry, live(carry, carry.origin, 1e30),
                     live(carry, carry.direction, 0.0), main_lim(carry.active))
    c = carry._replace(rays_main=carry.rays_main + carry.active.float().sum())
    for d in range(start_depth, depth):
        trace_next = d < depth - 1
        miss = (~hi_cur.hit & c.active) | ~c.active
        surf = surface_at_hit(scene, torch.clamp_min(hi_cur.tri, 0), hi_cur.u, hi_cur.v,
                              c.direction)
        emit_gate = torch.ones_like(c.is_specular) if d == 0 else c.is_specular  # rchit:83
        corr = None if corr_seed is None else corr_draws(n, corr_seed, d,
                                                         device=c.origin.device).to(dt)
        bs = sample_bsdf(scene, surf, c.direction, c.seed, emit_gate, corr=corr)

        # rmiss (raytrace.rmiss:11-19)
        miss_value = clear3 * 0.8 if d == 0 else torch.full_like(clear3, 0.01)
        hit_value_this = torch.where(miss[:, None], miss_value, bs.emit_plus_nee)
        is_spec_this = torch.where(miss, c.is_specular, bs.is_specular)
        light_dist_this = torch.where(miss, c.light_dist, bs.light_dist)

        # shadow ray (rgen:77-97): diffuse hits only; the others get d = 0
        # and limit 0, so they never hit
        do_shadow = c.active & ~miss & ~is_spec_this
        sh_dir = torch.where(do_shadow[:, None], bs.shadow_dir, 0.0)
        sh_lim = torch.where(do_shadow, sh_sign * torch.clamp_min(light_dist_this - 0.1, t_min),
                             0.0)
        active_next = c.active & ~miss

        if trace_next:
            nx_o = torch.where(active_next[:, None], surf.world_pos, 1e30)
            nx_d = torch.where(active_next[:, None], bs.next_dir, 0.0)
            nx_lim = main_lim(active_next)
            res = closest(c, torch.cat([nx_o, surf.world_pos]), torch.cat([nx_d, sh_dir]),
                          torch.cat([nx_lim, sh_lim]))
            hi_next = type(res)(*(x[:n] for x in res))
            shadow_hit = res.hit[n:]
        else:
            shadow_hit = seeded(c).any(surf.world_pos, sh_dir, t_min, sh_lim)
            hi_next = hi_cur
        shadow_hit = shadow_hit & do_shadow

        contrib = torch.clamp_max(hit_value_this * c.cur_weight, 10.0)  # rgen:101
        add = (c.active & ~shadow_hit)[:, None]
        hit_value = c.hit_value + torch.where(add, contrib, 0.0)

        # hit-distance bookkeeping at depth 1 for diffuse hits (rgen:103-114);
        # miss lanes never run it (rmiss sets prd.depth = 100)
        at_d1 = (d == 1) & ~is_spec_this & c.active & ~miss
        hd_new = torch.where(shadow_hit, 0.5 * light_dist_this, light_dist_this)
        hd_new = hd_new * hitdist_weight
        if hitdist_accumulate:
            hit_dists = torch.where(at_d1, c.hit_dists + hd_new, c.hit_dists)
        else:
            hit_dists = torch.where(at_d1, hd_new, c.hit_dists)

        step_weight = torch.clamp_max(torch.clamp_min(bs.weight, lo), hi)
        # a miss lane keeps its weight (it leaves the loop; 0*inf would NaN)
        cur_weight = c.cur_weight * torch.where(miss[:, None], 1.0, step_weight)

        c = BounceCarry(
            origin=torch.where(miss[:, None], c.origin, surf.world_pos),
            direction=torch.where(miss[:, None], c.direction, bs.next_dir),
            seed=torch.where(miss, c.seed, bs.seed),
            cur_weight=cur_weight,
            hit_value=hit_value,
            active=active_next,
            is_specular=is_spec_this,
            light_dist=light_dist_this,
            hit_dists=hit_dists,
            rays_main=c.rays_main + (active_next.float().sum() if trace_next else 0.0),
            rays_shadow=c.rays_shadow + do_shadow.float().sum(),
        )
        hi_cur = hi_next
    return c


class PathTraceResult(NamedTuple):
    radiance: torch.Tensor   # (N,3) prd.hitValue (mean over spp)
    hit_dists: torch.Tensor  # (N,) REBLUR hit-distance input
    rays: torch.Tensor       # () f32 total rays traced (main + shadow)


def corr_seed_for(frame: int, sample: int, salt: int = 0) -> int:
    """The shared-draw table's seed for one (frame, sample), uint32."""
    return (frame * 0x9E3779B9 + sample * 0x6A09E667 + salt) & MASK32


def trace_pixels(scene, tracer, cam, width: int, height: int, frame: int,
                 clear_color, *, samples: int, depth: int,
                 clamp_weights=False, corr: bool = False, corr_salt=None,
                 pix=None, seeds=None, general_loop: bool = False) -> PathTraceResult:
    """Full rgen main() over all pixels (rgen:24-121), in the dtype of the
    scene (the camera's matrices in the same one).

    ``pix``/``seeds``: optional pixel coordinates and RNG states (int32
    bits), e.g. tile-ordered with seeds of the original pixel ids (the
    engine). Defaults cover the whole frame in scanline order.
    ``corr``: correlated per-block sampler; ``corr_salt`` decorrelates the
    shared-draw tables across shards / spp groups. ``general_loop``: see
    ``bounce_chain``."""
    device = cam.view_inverse.device
    dt = scene.tri_v0.dtype
    n = width * height if pix is None else pix.shape[0]
    seed = seed_pixels(width, height, frame, device) if seeds is None else seeds
    hit_values = torch.zeros((n, 3), dtype=dt, device=device)
    hit_dists = torch.zeros((n,), dtype=dt, device=device)
    rays = torch.zeros((), dtype=torch.float32, device=device)
    for s in range(samples):
        corr_seed = corr_seed_for(frame, s, corr_salt or 0) if corr else None
        seed, r1 = rnd(seed)
        seed, r2 = rnd(seed)
        if frame == 0:  # rgen:44 centre jitter; both draws still advance
            jitter = torch.full((n, 2), 0.5, dtype=dt, device=device)
        else:
            jitter = torch.stack([r1, r2], dim=-1).to(dt)
        origin, direction = generate_rays(cam, width, height, jitter, pix=pix)
        carry = BounceCarry(
            origin=origin,
            direction=direction,
            seed=seed,
            cur_weight=torch.ones((n, 3), dtype=dt, device=device),
            hit_value=torch.zeros((n, 3), dtype=dt, device=device),
            active=torch.ones((n,), dtype=torch.bool, device=device),
            is_specular=torch.zeros((n,), dtype=torch.bool, device=device),
            light_dist=torch.zeros((n,), dtype=dt, device=device),
            hit_dists=hit_dists,
            rays_main=rays,
            rays_shadow=torch.zeros((), dtype=torch.float32, device=device),
        )
        out = bounce_chain(
            scene, tracer, carry, depth=depth, start_depth=0,
            clear_color=clear_color, hitdist_weight=1.0 / samples,
            hitdist_accumulate=True, clamp_weights=clamp_weights,
            corr_seed=corr_seed, general_loop=general_loop,
        )
        seed = out.seed
        hit_values = hit_values + out.hit_value
        hit_dists = out.hit_dists
        rays = out.rays_main + out.rays_shadow
    return PathTraceResult(radiance=hit_values / samples, hit_dists=hit_dists,
                           rays=rays)


def accumulate(accum, new, frame: int):
    """Progressive accumulation mix(old, new, 1/(frame+1)) (rgen:136-145),
    in the dtype of ``new``."""
    if frame <= 0:
        return new
    a = 1.0 / (torch.tensor(float(frame), dtype=new.dtype) + 1.0)
    a = a.to(new.device)
    return accum * (1.0 - a) + new * a


def pathtrace_frame(scene, tracer, cam, frame: int, accum, clear_color, *,
                    width: int, height: int, samples: int, depth: int,
                    clamp_weights=False, corr: bool = False, pix=None,
                    seeds=None, general_loop: bool = False):
    """One path-traced frame + accumulation (hello_vulkan.cpp:1423-1448).
    ``accum``: (H*W, 3) running image in the pixel order of ``pix``.
    ``general_loop``: see ``bounce_chain``. Returns (new_accum, rays)."""
    res = trace_pixels(
        scene, tracer, cam, width, height, frame, clear_color,
        samples=samples, depth=depth, clamp_weights=clamp_weights,
        corr=corr, pix=pix, seeds=seeds, general_loop=general_loop,
    )
    return accumulate(accum, res.radiance, frame), res.rays
