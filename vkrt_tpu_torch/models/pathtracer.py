"""Progressive Monte-Carlo path tracer (port of
``vkrt_tpu/models/pathtracer.py``).

A frame: for every pixel, ``samples`` paths of up to ``depth`` bounces with
NEE shadow rays, keeping the reference's estimator quirks (firefly clamp,
blocked-shadow skip, clear*0.8 / 0.01 miss radiance, frame-0 centre
jitter with both draws still advanced, progressive ``mix`` accumulation).
The bounce loop is always the packed loop of ``ops/cuda/shade.py``: on a
CUDA device both of its stages are the hand-written kernels, on the CPU
their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vkrt_tpu_torch.ops.cuda.shade import bounce_chain_packed
from vkrt_tpu_torch.ops.intersect import T_MAX, T_MIN
from vkrt_tpu_torch.ops.rng import MASK32, rnd, seed_pixels
from vkrt_tpu_torch.scene import require_untextured
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
                 corr_seed=None) -> BounceCarry:
    """Run the bounce loop (rgen:62-116). ``corr_seed``: uint32 enabling
    the correlated per-block sampler, None for independent per-lane
    draws. Always the packed loop (``ops.cuda.shade.bounce_chain_packed``)."""
    if depth <= start_depth:
        return carry
    return bounce_chain_packed(
        scene, tracer, carry,
        depth=depth, start_depth=start_depth, clear_color=clear_color,
        hitdist_weight=hitdist_weight, hitdist_accumulate=hitdist_accumulate,
        clamp_weights=clamp_weights, t_min=T_MIN, t_max=T_MAX,
        corr_seed=corr_seed,
    )


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
                 pix=None, seeds=None) -> PathTraceResult:
    """Full rgen main() over all pixels (rgen:24-121).

    ``pix``/``seeds``: optional pixel coordinates and RNG states (int32
    bits), e.g. tile-ordered with seeds of the original pixel ids (the
    engine). Defaults cover the whole frame in scanline order.
    ``corr``: correlated per-block sampler; ``corr_salt`` decorrelates the
    shared-draw tables across shards / spp groups."""
    device = cam.view_inverse.device
    n = width * height if pix is None else pix.shape[0]
    seed = seed_pixels(width, height, frame, device) if seeds is None else seeds
    hit_values = torch.zeros((n, 3), dtype=torch.float32, device=device)
    hit_dists = torch.zeros((n,), dtype=torch.float32, device=device)
    rays = torch.zeros((), dtype=torch.float32, device=device)
    for s in range(samples):
        corr_seed = corr_seed_for(frame, s, corr_salt or 0) if corr else None
        seed, r1 = rnd(seed)
        seed, r2 = rnd(seed)
        if frame == 0:  # rgen:44 centre jitter; both draws still advance
            jitter = torch.full((n, 2), 0.5, dtype=torch.float32, device=device)
        else:
            jitter = torch.stack([r1, r2], dim=-1)
        origin, direction = generate_rays(cam, width, height, jitter, pix=pix)
        carry = BounceCarry(
            origin=origin,
            direction=direction,
            seed=seed,
            cur_weight=torch.ones((n, 3), dtype=torch.float32, device=device),
            hit_value=torch.zeros((n, 3), dtype=torch.float32, device=device),
            active=torch.ones((n,), dtype=torch.bool, device=device),
            is_specular=torch.zeros((n,), dtype=torch.bool, device=device),
            light_dist=torch.zeros((n,), dtype=torch.float32, device=device),
            hit_dists=hit_dists,
            rays_main=rays,
            rays_shadow=torch.zeros((), dtype=torch.float32, device=device),
        )
        out = bounce_chain(
            scene, tracer, carry, depth=depth, start_depth=0,
            clear_color=clear_color, hitdist_weight=1.0 / samples,
            hitdist_accumulate=True, clamp_weights=clamp_weights,
            corr_seed=corr_seed,
        )
        seed = out.seed
        hit_values = hit_values + out.hit_value
        hit_dists = out.hit_dists
        rays = out.rays_main + out.rays_shadow
    return PathTraceResult(radiance=hit_values / samples, hit_dists=hit_dists,
                           rays=rays)


def accumulate(accum, new, frame: int):
    """Progressive accumulation mix(old, new, 1/(frame+1)) (rgen:136-145),
    in f32."""
    if frame <= 0:
        return new
    a = 1.0 / (torch.tensor(float(frame), dtype=new.dtype) + 1.0)
    a = a.to(new.device)
    return accum * (1.0 - a) + new * a


def pathtrace_frame(scene, tracer, cam, frame: int, accum, clear_color, *,
                    width: int, height: int, samples: int, depth: int,
                    clamp_weights=False, corr: bool = False, pix=None,
                    seeds=None):
    """One path-traced frame + accumulation (hello_vulkan.cpp:1423-1448).
    ``accum``: (H*W, 3) running image in the pixel order of ``pix``.
    Returns (new_accum, rays). Raises on a textured scene (textures are not
    sampled yet; the answer is decided once per scene, no sync a frame)."""
    require_untextured(scene)
    res = trace_pixels(
        scene, tracer, cam, width, height, frame, clear_color,
        samples=samples, depth=depth, clamp_weights=clamp_weights,
        corr=corr, pix=pix, seeds=seeds,
    )
    return accumulate(accum, res.radiance, frame), res.rays
