"""The plain path tracer at chosen pixels: camera rays, the bounce loop,
progressive accumulation.

A frozen copy of the port's plain path (commit 400863e):
``vkrt_tpu_torch/utils/camera.py`` (``look_at``, ``perspective_vk``,
``generate_rays``, the 32x32 tile order of ``tile_perm``),
``models/pathtracer.py`` (``trace_pixels`` at one sample a pixel,
``general_bounce_chain``, ``accumulate``) and ``ops/rng.py``'s seeds. The
lanes are (frame, pixel) pairs, so one call renders a pixel's samples of
many frames; each lane finds its correlated draws from its frame and its
pixel's 1024-lane block in tile order. The tracer is the benchmark's own
SAH tree (``reference/bvh.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from framebench.reference import shade as sh
from framebench.reference.bvh import T_MAX, T_MIN

TILE = 32


def look_at(eye, center, up) -> np.ndarray:
    eye, center, up = (np.asarray(x, np.float64) for x in (eye, center, up))
    z = eye - center
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = x, y, z
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def perspective_vk(fov_deg, aspect, near=0.1, far=1000.0) -> np.ndarray:
    f = 1.0 / math.tan(math.radians(fov_deg) * 0.5)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = -f
    m[2, 2] = far / (near - far)
    m[2, 3] = (near * far) / (near - far)
    m[3, 2] = -1.0
    return m


def camera(eye, center, fov_deg, width, height, device, dtype=torch.float32):
    """(view_inverse, proj_inverse), rounded to f32, carried in ``dtype``."""
    view = look_at(eye, center, (0.0, 1.0, 0.0))
    proj = perspective_vk(fov_deg, width / float(height))

    def t(m):
        return torch.tensor(np.asarray(m, np.float32), device=device).to(dtype)

    return t(np.linalg.inv(view)), t(np.linalg.inv(proj))


def tile_position(pid, width: int, height: int):
    """Position of scanline pixel ``pid`` in the engine's 32x32 tile order."""
    x, y = pid % width, pid // width
    ty, tx = y // TILE, x // TILE
    th = torch.clamp_max(height - ty * TILE, TILE)
    tw = torch.clamp_max(width - tx * TILE, TILE)
    return ty * TILE * width + tx * TILE * th + (y % TILE) * tw + (x % TILE)


def generate_rays(cam, width, height, jitter, pix):
    vi, pi = cam
    in_uv = (pix + jitter) / torch.tensor([width, height], dtype=torch.float32,
                                          device=pix.device)
    d = in_uv * 2.0 - 1.0
    tdir = torch.stack([pi[r, 0] * d[:, 0] + pi[r, 1] * d[:, 1] + pi[r, 2] + pi[r, 3]
                        for r in range(3)], dim=-1)
    tdir = tdir / torch.sqrt((tdir * tdir).sum(dim=-1, keepdim=True))
    wdir = torch.stack([vi[r, 0] * tdir[:, 0] + vi[r, 1] * tdir[:, 1] + vi[r, 2] * tdir[:, 2]
                        for r in range(3)], dim=-1)
    return vi[:3, 3].expand(wdir.shape), wdir


def bounce_loop(scn, walk, origin, direction, seed, cur_w, active, is_spec, *, depth: int,
                start_depth: int, block, cseed, corr: bool, clear_color, clamp_weights=False,
                hit_dist: bool = False):
    """``general_bounce_chain`` from ``start_depth`` on (N,) lanes; returns
    the lanes' accumulated radiance (N, 3), and with ``hit_dist`` also the
    denoiser's hit distance (N,): at depth 1, on a diffuse hit, the light's
    distance, halved where its shadow ray is blocked (rgen:103-114, the
    hybrid's overwrite), else 0."""
    dt = scn.tri_v0.dtype
    n = origin.shape[0]
    lo, hi = sh.clamp_bounds(clamp_weights)
    clear3 = torch.tensor([float(c) for c in clear_color[:3]], dtype=dt, device=origin.device)
    light_dist = torch.zeros(n, dtype=dt, device=origin.device)
    hit_value = torch.zeros((n, 3), dtype=dt, device=origin.device)
    hit_dists = torch.zeros(n, dtype=dt, device=origin.device)

    def main_lim(act):
        return torch.where(act, T_MAX, -1.0).to(dt)

    hits = walk.closest(torch.where(active[:, None], origin, 1e30),
                        torch.where(active[:, None], direction, 0.0), main_lim(active))
    for d in range(start_depth, depth):
        trace_next = d < depth - 1
        miss = (~hits.hit & active) | ~active
        surf = sh.surface_at_hit(scn, torch.clamp_min(hits.tri, 0), hits.u.to(dt),
                                 hits.v.to(dt))
        emit_gate = torch.ones_like(is_spec) if d == 0 else is_spec
        cd = sh.corr_lane_draws(block, cseed, d).to(dt) if corr else None
        bs = sh.sample_bsdf(scn, surf, direction, seed, emit_gate, corr=cd)
        miss_value = clear3 * 0.8 if d == 0 else torch.full_like(clear3, 0.01)
        hv_this = torch.where(miss[:, None], miss_value, bs.emit_plus_nee)
        spec_this = torch.where(miss, is_spec, bs.is_specular)
        ld_this = torch.where(miss, light_dist, bs.light_dist)
        do_shadow = active & ~miss & ~spec_this
        sh_dir = torch.where(do_shadow[:, None], bs.shadow_dir, 0.0)
        sh_lim = torch.where(do_shadow, -torch.clamp_min(ld_this - 0.1, T_MIN), 0.0)
        active_next = active & ~miss
        if trace_next:
            res = walk.closest(
                torch.cat([torch.where(active_next[:, None], surf.world_pos, 1e30),
                           surf.world_pos]),
                torch.cat([torch.where(active_next[:, None], bs.next_dir, 0.0), sh_dir]),
                torch.cat([main_lim(active_next), sh_lim]))
            hits_next = type(res)(*(x[:n] for x in res))
            shadow_hit = res.hit[n:]
        else:
            shadow_hit = walk.closest(surf.world_pos, sh_dir, sh_lim).hit
            hits_next = hits
        shadow_hit = shadow_hit & do_shadow
        contrib = torch.clamp_max(hv_this * cur_w, 10.0)
        hit_value = hit_value + torch.where((active & ~shadow_hit)[:, None], contrib, 0.0)
        if d == 1:
            hit_dists = torch.where(do_shadow, torch.where(shadow_hit, 0.5 * ld_this, ld_this),
                                    hit_dists)
        step_w = torch.clamp_max(torch.clamp_min(bs.weight, lo), hi)
        cur_w = cur_w * torch.where(miss[:, None], 1.0, step_w)
        direction = torch.where(miss[:, None], direction, bs.next_dir)
        seed = torch.where(miss, seed, bs.seed)
        active, is_spec, light_dist, hits = active_next, spec_this, ld_this, hits_next
    return (hit_value, hit_dists) if hit_dist else hit_value


def path_samples(scn, walk, cam, width, height, pid, frame, *, depth: int, corr: bool,
                 clear_color, clamp_weights: bool = False):
    """(N, 3) radiance of one sample at scanline pixel ``pid`` in frame
    ``frame`` (both (N,) int64), in the scene's dtype."""
    dt = scn.tri_v0.dtype
    dev = pid.device
    n = pid.shape[0]
    seed = sh.tea(pid, frame)
    seed, r1 = sh.rnd(seed)
    seed, r2 = sh.rnd(seed)
    jitter = torch.where((frame == 0)[:, None], 0.5, torch.stack([r1, r2], dim=-1)).to(dt)
    pix = torch.stack([pid % width, pid // width], dim=-1).to(torch.float32)
    origin, direction = generate_rays(cam, width, height, jitter, pix)
    return bounce_loop(
        scn, walk, origin, direction, seed, torch.ones((n, 3), dtype=dt, device=dev),
        torch.ones(n, dtype=torch.bool, device=dev), torch.zeros(n, dtype=torch.bool, device=dev),
        depth=depth, start_depth=0, block=tile_position(pid, width, height) // sh.CORR_BLOCK,
        cseed=sh.corr_seed_for(frame), corr=corr, clear_color=clear_color,
        clamp_weights=clamp_weights)


def accumulate(frames, samples, dtype=torch.float32):
    """The engine's progressive mix over ``frames`` in order, starting from
    a zero buffer: ``samples`` (F, K, 3), one row a frame (rgen:136-145)."""
    acc = torch.zeros_like(samples[0], dtype=dtype)
    for i, f in enumerate(frames):
        new = samples[i].to(dtype)
        if f <= 0:
            acc = new
            continue
        a = (1.0 / (torch.tensor(float(f), dtype=dtype) + 1.0)).to(new.device)
        acc = acc * (1.0 - a) + new * a
    return acc
