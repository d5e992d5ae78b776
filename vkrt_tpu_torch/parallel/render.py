"""Sharded frame rendering over a (tile, spp) mesh of ranks (port of
``vkrt_tpu/parallel/render.py``).

Every rank runs the same bounce chain (``models/pathtracer``) on its band
of pixels and its sample group: kernels A and B on the card, as in the
single-process engine. A path frame's collectives are one mean of the
radiance over the spp axis and one sum of the ray count over the mesh.
The accumulator stays in bands across frames; ``render_sharded`` gathers
it once, at the end.

Seeding: ``tea(pixel id, frame * n_spp + group)``. With one spp group this
is the engine's seeding, so a pixel's samples do not depend on the band it
falls in: a (1, 1) mesh reproduces ``Engine`` bit for bit, and so does an
(n, 1) mesh with the correlated sampler off. The correlated sampler's
tables are salted with both coordinates (``corr_salt``), which is 0 on a
(1, 1) mesh; on more ranks its 1024-ray blocks follow the band's own pool,
a different (equally unbiased) correlated estimator, as in the JAX package.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vkrt_tpu_torch import device as kdev
from vkrt_tpu_torch.models.pathtracer import accumulate, trace_pixels
from vkrt_tpu_torch.ops.rng import MASK32, tea
from vkrt_tpu_torch.parallel.mesh import (
    RenderMesh, all_gather_rows, gather_objects, pmean, psum,
)
from vkrt_tpu_torch.utils.camera import pixel_coords, tile_perm
from vkrt_tpu_torch.utils.profiling import synchronize

TILE_SALT, GROUP_SALT = 0xC2B2AE35, 0x27D4EB2F
ATROUS_REACH = 2 ** 3  # the denoiser's widest à-trous tap, in rows


def corr_salt_for(mesh: RenderMesh) -> int:
    """The correlated sampler's table salt of this rank, uint32: both
    coordinates mixed (0 on a (1, 1) mesh)."""
    return (mesh.tile * TILE_SALT + mesh.spp * GROUP_SALT) & MASK32


def band_pixels(mesh: RenderMesh, width: int, height: int, tiled: bool):
    """This rank's pixels: (pix (n, 2) f32, pixel ids (n,) int64) on its
    device, and ``inv_perm`` (N,) mapping the gathered bands to scanline
    order. ``tiled`` with whole row bands (``height % n_tile == 0``): each
    band's pixels in 32x32-tile order, the permutation built on the host
    (the trace kernel wants compact tiles, not 1280-wide stripes);
    otherwise contiguous chunks in scanline order."""
    n_tile = mesh.shape["tile"]
    n = width * height
    if n % n_tile:
        raise ValueError(f"pixels {n} not divisible by the tile axis {n_tile}")
    band_n = n // n_tile
    if tiled and height % n_tile == 0:
        band_perm, _ = tile_perm(width, height // n_tile)
        order = np.concatenate([band_perm.astype(np.int64) + b * band_n
                                for b in range(n_tile)])
        inv = np.argsort(order)
    else:
        order = inv = np.arange(n, dtype=np.int64)
    pid = torch.as_tensor(order[mesh.tile * band_n:(mesh.tile + 1) * band_n],
                          device=mesh.device)
    pix = pixel_coords(width, height, mesh.device)[pid]
    return pix, pid, torch.as_tensor(inv, device=mesh.device)


def make_sharded_pathtrace_step(scene, tracer, mesh: RenderMesh, *, width: int,
                                height: int, samples: int, depth: int, corr: bool = False):
    """The rank's path-mode frame. Returns ``(step, inv_perm)``:
    ``step(cam, frame, accum, clear_color) -> (accum', rays)`` with
    ``accum`` the band's rows (``zeros_accum``), in the band's tile order
    across frames (un-permuting inside the frame loop would cost a gather a
    frame; ``inv_perm`` does it once, on the gathered image), and ``rays``
    the mesh's total for the frame, on the device."""
    n_spp = mesh.shape["spp"]
    if samples % n_spp:
        raise ValueError(f"spp {samples} not divisible by the spp axis {n_spp}")
    local_samples = samples // n_spp
    pix, pid, inv_perm = band_pixels(mesh, width, height, tiled=True)
    salt = corr_salt_for(mesh) if corr else None

    def step(cam, frame: int, accum, clear_color):
        seeds = tea(pid, (frame * n_spp + mesh.spp) & MASK32)
        res = trace_pixels(scene, tracer, cam, width, height, frame, clear_color,
                           samples=local_samples, depth=depth, corr=corr, corr_salt=salt,
                           pix=pix, seeds=seeds)
        radiance = pmean(res.radiance, mesh, "spp")
        return accumulate(accum, radiance, frame), psum(res.rays, mesh)

    return step, inv_perm


def make_sharded_hybrid_step(scene, tracer, mesh: RenderMesh, *, width: int, height: int,
                             depth: int, use_shadows: bool = True, use_ao: bool = True,
                             use_gi: bool = False, use_denoiser: bool = False,
                             corr: bool = False):
    """The rank's hybrid frame over its band of scanline rows (the hybrid
    pass has one sample stream, so the spp axis must be 1). Returns
    ``step(cam, frame, accum_rt, clear_color, denoise_state=None) ->
    (gbuf, accum_rt', rays, denoise_state')``, all of the band.

    With ``use_denoiser`` (requires ``use_gi``) the temporal denoiser runs
    in its band form (``models/denoiser.denoise_temporal_tile``: ring
    halos for the clamp and à-trous stencils, the gathered history for
    reprojection), per pixel equal to the full-frame filter; the step then
    takes and returns the band's ``DenoiserState`` (``init_state(width,
    height // n_tile)``). It requires whole row bands of at least the
    filter's 2^3-row tap reach."""
    from vkrt_tpu_torch.models.hybrid import hybrid_frame

    n_tile = mesh.shape["tile"]
    if mesh.shape["spp"] != 1:
        raise ValueError("hybrid mode shards pixels only: the spp axis must be 1")
    if use_denoiser:
        if not use_gi:
            raise ValueError("the denoiser filters the GI channel: use_gi is required")
        if height % n_tile or height // n_tile < ATROUS_REACH:
            raise ValueError(f"the denoised mesh needs whole row bands of at least "
                             f"{ATROUS_REACH} rows: height {height}, tile axis {n_tile}")
    pix, pid, _ = band_pixels(mesh, width, height, tiled=False)
    salt = corr_salt_for(mesh) if corr else None

    def step(cam, frame: int, accum_rt, clear_color, denoise_state=None):
        gbuf, new_accum, rays, new_state = hybrid_frame(
            scene, tracer, cam, frame, accum_rt, clear_color, width=width, height=height,
            depth=depth, use_shadows=use_shadows, use_ao=use_ao, use_gi=use_gi,
            use_denoiser=use_denoiser, corr=corr, corr_salt=salt, pix=pix,
            seeds=tea(pid, frame), denoise_state=denoise_state,
            tile_axis=mesh if use_denoiser else None)
        return gbuf, new_accum, psum(rays, mesh), new_state

    return step


def zeros_accum(mesh: RenderMesh, width: int, height: int, channels: int = 3):
    """A fresh accumulator of the rank's band: (N / n_tile, channels) f32
    (3 for path mode, 4 for hybrid)."""
    rows = width * height // mesh.shape["tile"]
    return torch.zeros((rows, channels), dtype=torch.float32, device=mesh.device)


def render_sharded(scene, tracer, cam, mesh: RenderMesh, *, width: int, height: int,
                   samples: int, depth: int, frames: int, clear_color, corr: bool = False):
    """``frames`` progressive path-mode frames under the mesh. Returns the
    whole accumulator in scanline order (N, 3) (every rank of a tile row
    gets it) and the total rays. The ray counter stays on the device until
    the last frame: a read each frame would sync the frame."""
    step, inv_perm = make_sharded_pathtrace_step(
        scene, tracer, mesh, width=width, height=height, samples=samples, depth=depth,
        corr=corr)
    accum = zeros_accum(mesh, width, height)
    rays = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for f in range(frames):
        accum, r = step(cam, f, accum, clear_color)
        rays = rays + r
    return all_gather_rows(accum, mesh)[inv_perm], float(rays)


def render_sharded_hybrid(scene, tracer, cams, mesh: RenderMesh, *, width: int, height: int,
                          depth: int, clear_color, use_shadows: bool = True,
                          use_ao: bool = True, use_gi: bool = False,
                          use_denoiser: bool = False, corr: bool = False,
                          gather_each_frame: bool = False):
    """Hybrid frames under the mesh, one a camera of ``cams``. The frame
    counter restarts at 0 when the camera changes, as the engine's does
    (hello_vulkan.cpp:1506-1521): a fly-through accumulates nothing, and
    the denoiser's history carries it. Returns (images, total rays):
    ``images`` a list of {"accum": (N, 4), "color": the G-buffer's (N, 4)}
    in scanline order, for every frame with ``gather_each_frame``, else for
    the last one."""
    from vkrt_tpu_torch.models.denoiser import init_state

    step = make_sharded_hybrid_step(
        scene, tracer, mesh, width=width, height=height, depth=depth,
        use_shadows=use_shadows, use_ao=use_ao, use_gi=use_gi, use_denoiser=use_denoiser,
        corr=corr)
    accum = zeros_accum(mesh, width, height, 4)
    state = (init_state(width, height // mesh.shape["tile"], mesh.device)
             if use_denoiser else None)
    rays = torch.zeros((), dtype=torch.float32, device=mesh.device)
    images = []
    frame, prev = -1, None
    for k, cam in enumerate(cams):
        moved = prev is None or not all(torch.equal(a, b) for a, b in zip(cam, prev))
        frame, prev = 0 if moved else frame + 1, cam
        gbuf, accum, r, state = step(cam, frame, accum, clear_color, state)
        rays = rays + r
        if gather_each_frame or k == len(cams) - 1:
            images.append({"accum": all_gather_rows(accum, mesh),
                           "color": all_gather_rows(gbuf.color, mesh)})
    return images, float(rays)


# --- rank functions (``mesh.launch`` spawns them by name) --------------------


def scene_for(spec, device):
    """A scene named by a picklable spec: ``("cornell_box",)`` (the
    procedural box) or ``("city", grid)``."""
    from vkrt_tpu_torch import scene as sc

    kind, *rest = spec
    if kind == "cornell_box":
        return sc.make_cornell_box(device=device)
    if kind == "city":
        return sc.make_city(grid=rest[0], device=device)
    raise ValueError(f"unknown scene spec {spec!r}")


def denoise_sharded(mesh: RenderMesh, state, diff_rad_hitd, norm_rough_packed, view_z,
                    world_pos, view_proj, width: int, height: int):
    """``denoise_temporal_tile`` on this rank's band of whole-frame inputs
    (a ``DenoiserState`` and the denoiser's per-pixel inputs, scanline
    order, on any device). Returns the gathered (filtered (N, 3), new
    ``DenoiserState``), whole frame."""
    from vkrt_tpu_torch.models.denoiser import DenoiserState, denoise_temporal_tile

    band_n = width * height // mesh.shape["tile"]
    rows = slice(mesh.tile * band_n, (mesh.tile + 1) * band_n)

    def band(x):
        return x[rows].to(mesh.device)

    band_state = DenoiserState(*(band(x) if f != "prev_view_proj" else x.to(mesh.device)
                                 for f, x in zip(DenoiserState._fields, state)))
    filtered, new_state = denoise_temporal_tile(
        band_state, band(diff_rad_hitd), band(norm_rough_packed), band(view_z),
        band(world_pos), view_proj.to(mesh.device), width, height, mesh)
    return all_gather_rows(filtered, mesh), DenoiserState(
        *(all_gather_rows(x, mesh) if f != "prev_view_proj" else x
          for f, x in zip(DenoiserState._fields, new_state)))


def run_jobs(mesh: RenderMesh, jobs):
    """Run jobs on this rank, each a dict with a ``kind``:

    * "path" (``render_sharded``) and "hybrid" (``render_sharded_hybrid``):
      ``scene`` (a ``scene_for`` spec), ``backend``, ``cameras``
      (``Camera``s: one, or one a frame), the render function's keyword
      arguments, and for path mode ``frames``. ``device.counts`` is set to
      0 before the job and read after it. Result: the gathered images, the
      rays, the seconds the render took on this rank's host clock (the
      device synchronised around it), every rank's launches by entry point
      and the backend;
    * "denoise" (``denoise_sharded``): ``args``, its arguments after the
      mesh. Result: its (filtered, state).

    Returns the results in the order of the jobs."""
    from vkrt_tpu_torch.ops.trace import make_tracer

    out = []
    scenes = {}
    for job in jobs:
        job = dict(job)
        kind = job.pop("kind")
        if kind == "denoise":
            out.append(denoise_sharded(mesh, *job["args"]))
            continue
        if kind not in ("path", "hybrid"):
            raise ValueError(f"unknown job kind {kind!r}")
        spec = tuple(job.pop("scene"))
        if spec not in scenes:
            scenes[spec] = scene_for(spec, mesh.device)
        scene = scenes[spec]
        tracer = make_tracer(scene, job.pop("backend", "auto"))
        w, h = job["width"], job["height"]
        cams = [c.matrices(w, h, mesh.device) for c in job.pop("cameras")]
        kdev.reset_counts()
        synchronize(mesh.device)
        t0 = time.perf_counter()
        if kind == "path":
            accum, rays = render_sharded(scene, tracer, cams[0], mesh, **job)
            res = {"accum": accum, "rays": rays}
        else:
            images, rays = render_sharded_hybrid(scene, tracer, cams, mesh, **job)
            res = {"images": images, "rays": rays}
        synchronize(mesh.device)
        res["seconds"] = time.perf_counter() - t0
        res["launches"] = gather_objects(
            {entry: c["launches"] for entry, c in kdev.counts.items()}, mesh)
        res["backend"] = mesh.backend
        out.append(res)
    return out
