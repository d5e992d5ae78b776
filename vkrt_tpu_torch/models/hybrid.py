"""Hybrid mode: G-buffer + ray-traced shadows / AO / one-path GI (port of
``vkrt_tpu/models/hybrid.py``, ``shaders/raytraceHybrid.rgen:50-303``) over
the G-buffer of ``models/gbuffer.py``. Per pixel:

* shadows: one randomly chosen light, binary visibility with a 0.01 floor,
  modulates alpha (hybrid rgen:81-131);
* AO: 4 cosine-hemisphere rays, radius 2.0, modulates alpha
  (rgen:133-169);
* GI: lobe pick by ``ratio = metalness*(1-roughness)`` vs 0.8
  (rgen:184-202), then the path tracer's bounce chain from depth 1
  (rgen:211-266), weighted by albedo for the diffuse lobe;
* NRD REBLUR packing of radiance + normalized hit distance
  (rgen:273-281);
* accumulation into the RGBA accum image (rgen:36-48);
* with ``use_denoiser`` and GI, the GI radiance filtered by
  ``models/denoiser.py`` (temporal with a ``denoise_state``, else
  spatial-only) replaces the accumulated RGB.

On the card a frame runs kernel A three ways: the G-buffer's closest
trace, one first-hit-kills launch for the shadow and AO rays of every
pixel together, and the GI chain's traces; kernel B shades the GI chain
where it shades the scene. The denoiser launches its own kernels
(``csrc/denoise.cu``): the temporal pass and one launch an à-trous
iteration, 1 + 3 a temporal frame, 3 a spatial-only one.

The stages run under named ranges of ``utils.profiling``: "gbuffer",
"visibility" (the shadow and AO pool and its verdicts), "gi" (the chain
from depth 1) and "denoise".
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch.models import denoiser as dn
from vkrt_tpu_torch.models.gbuffer import GBuffer, gbuffer_pass
from vkrt_tpu_torch.models.pathtracer import BounceCarry, accumulate, bounce_chain
from vkrt_tpu_torch.ops import nrd
from vkrt_tpu_torch.ops.rng import MASK32, corr_draws, rnd, seed_pixels
from vkrt_tpu_torch.ops.sampling import create_coordinate_system, sampling_hemisphere
from vkrt_tpu_torch.utils.camera import retile, untile
from vkrt_tpu_torch.utils.profiling import pass_label
from vkrt_tpu_torch.utils.smath import dot, length, normalize, reflect

AO_SAMPLES = 4        # raytraceHybrid.rgen:31
RTAO_RADIUS = 2.0     # rgen:32
SHADOW_T_MIN = 0.1    # rgen:104
# the shared-draw table keys of the pre-chain draws: the shadow light pick
# (column 1), the AO hemispheres (columns 2-3) and the GI lobe direction
# (columns 2-3); the chain itself keys its bounces 1..depth-1
CORR_KEY_SHADOW, CORR_KEY_AO, CORR_KEY_GI = 64, 65, 72


def hybrid_corr_seed(frame: int) -> int:
    """The shared-draw tables' seed of a hybrid frame, uint32: the frame
    alone (the path tracer's ``corr_seed_for`` mixes in the sample)."""
    return (frame * 0x9E3779B9) & MASK32


def hybrid_effects(scene, tracer, gbuf: GBuffer, cam, seed, frame: int, accum_rt, *,
                   depth: int, use_shadows: bool, use_ao: bool, use_gi: bool,
                   clamp_weights=False, corr: bool = False, corr_salt=None):
    """The raytraceHybrid.rgen main() body. Returns (new_accum,
    diff_rad_hitd, seed, rays).

    ``corr``: correlated per-block sampler: the shadow light pick, the AO
    hemisphere draws, the GI lobe direction and the GI bounce chain each
    share one draw per 1024-ray block a frame. ``corr_salt``: uint32 added
    to the tables' seed, decorrelating them across a mesh's bands (None or
    0: the unsharded stream)."""
    n = gbuf.color.shape[0]
    device = gbuf.color.device
    n_lights = scene.num_lights
    corr_seed = (hybrid_corr_seed(frame) + (corr_salt or 0)) & MASK32 if corr else None

    def corr_tab(key):
        return corr_draws(n, corr_seed, key, device=device)

    world_pos = gbuf.position[:, :3]
    world_nrm = gbuf.normal[:, :3]
    albedo = torch.stack([gbuf.color[:, 3], gbuf.position[:, 3], gbuf.normal[:, 3]], dim=-1)
    roughness = gbuf.rough_metal[:, 0]
    metalness = gbuf.rough_metal[:, 1]
    # background test (rgen:67): both position and normal exactly zero
    shaded = ~((world_pos == 0.0).all(dim=-1) & (world_nrm == 0.0).all(dim=-1))

    color_rgb = torch.zeros((n, 3), dtype=torch.float32, device=device)
    color_a = torch.ones((n,), dtype=torch.float32, device=device)
    rays = torch.zeros((), dtype=torch.float32, device=device)

    # The shadow ray and the 4 AO rays are independent visibility queries
    # from the same G-buffer point: one first-hit-kills trace for all of
    # them (per-lane limits; a lane that skips its query gets d = 0 and
    # limit 0, which never hits). The RNG draw order is unchanged.
    with pass_label("visibility"):
        vis_dirs, vis_lims = [], []
        if use_shadows:  # rgen:81-131
            seed, r = rnd(seed)  # drawn even when the shared draw replaces it
            if corr:
                r = corr_tab(CORR_KEY_SHADOW)[:, 1]
            light_idx = torch.clamp((r * float(n_lights)).to(torch.int32), 0, n_lights - 1).long()
            ldir = scene.light_pos[light_idx] - world_pos
            ldist = length(ldir)
            l = ldir / torch.clamp_min(ldist[:, None], 1e-20)
            facing = dot(l, world_nrm) >= 0.0
            do_trace = shaded & facing
            vis_dirs.append(torch.where(do_trace[:, None], l, 0.0))
            vis_lims.append(torch.where(do_trace,
                                        torch.clamp_min(ldist - SHADOW_T_MIN, SHADOW_T_MIN), 0.0))
            rays = rays + do_trace.float().sum()

        if use_ao:  # rgen:133-169
            tangent, binormal = create_coordinate_system(world_nrm)
            for i_ao in range(AO_SAMPLES):
                u = None
                if corr:
                    t = corr_tab(CORR_KEY_AO + i_ao)
                    u = (t[:, 2], t[:, 3])
                seed, d = sampling_hemisphere(seed, tangent, binormal, world_nrm, uniforms=u)
                vis_dirs.append(torch.where(shaded[:, None], normalize(d), 0.0))
                vis_lims.append(torch.where(shaded, RTAO_RADIUS, 0.0))
            rays = rays + AO_SAMPLES * shaded.float().sum()

        if vis_dirs:
            k = len(vis_dirs)
            vis_tracer = tracer.with_seed(seed) if hasattr(tracer, "with_seed") else tracer
            hits = vis_tracer.any(world_pos.repeat(k, 1), torch.cat(vis_dirs), SHADOW_T_MIN,
                                  torch.cat(vis_lims)).reshape(k, n)
            seg = 0
            if use_shadows:
                blocked = hits[0]
                seg = 1
                visibility = torch.where(facing & ~(blocked & do_trace), 1.0, 0.0)
                visibility = torch.clamp_min(visibility, 0.01)  # rgen:129
                color_a = torch.where(shaded, color_a * visibility, color_a)
            if use_ao:
                ao = torch.where(hits[seg:seg + AO_SAMPLES] & shaded[None, :],
                                 1.0 / AO_SAMPLES, 0.0).sum(dim=0)
                color_a = torch.where(shaded, color_a * (1.0 - ao), color_a)

    diff_rad_hitd = torch.zeros((n, 4), dtype=torch.float32, device=device)
    with pass_label("gi"):
        if use_gi:  # rgen:171-282
            ratio = metalness * (1.0 - roughness)  # rgen:184 (not the path formula)
            is_diffuse = ratio < 0.8
            tangent, binormal = create_coordinate_system(world_nrm)
            u = None
            if corr:
                t = corr_tab(CORR_KEY_GI)
                u = (t[:, 2], t[:, 3])
            seed_d, hemi = sampling_hemisphere(seed, tangent, binormal, world_nrm, uniforms=u)
            dir_d = normalize(hemi)
            eye = cam.view_inverse[:3, 3]
            v = normalize(eye - world_pos)
            dir_s = normalize(reflect(-v, world_nrm))
            carry = BounceCarry(
                origin=world_pos,
                direction=torch.where(is_diffuse[:, None], dir_d, dir_s),
                seed=torch.where(is_diffuse, seed_d, seed),
                cur_weight=torch.where(is_diffuse[:, None], albedo, 1.0),
                hit_value=torch.zeros((n, 3), dtype=torch.float32, device=device),
                active=shaded,
                is_specular=~is_diffuse,
                light_dist=torch.zeros((n,), dtype=torch.float32, device=device),
                hit_dists=torch.zeros((n,), dtype=torch.float32, device=device),
                rays_main=rays,
                rays_shadow=torch.zeros((), dtype=torch.float32, device=device),
            )
            out = bounce_chain(
                scene, tracer, carry, depth=depth, start_depth=1,
                clear_color=(0.0, 0.0, 0.0, 0.0),  # unused: d > 0 misses get 0.01
                hitdist_weight=1.0,
                hitdist_accumulate=False,  # hybrid overwrites (rgen:257-263)
                clamp_weights=clamp_weights, corr_seed=corr_seed,
            )
            seed = out.seed
            rays = out.rays_main + out.rays_shadow
            gi = torch.where(shaded[:, None], out.hit_value, 0.0)
            color_rgb = gi  # rgen:271: color.rgb = indirectColor.rgb
            nh = nrd.norm_hit_dist(out.hit_dists, gbuf.view_z, roughness)
            diff_rad_hitd = nrd.pack_radiance_and_norm_hit_dist(gi, nh)

    color = torch.cat([color_rgb, color_a[:, None]], dim=-1)
    # background pixels accumulate (0,0,0,1) (rgen:67-71)
    background = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32, device=device)
    color = torch.where(shaded[:, None], color, background)
    return accumulate(accum_rt, color, frame), diff_rad_hitd, seed, rays


def hybrid_frame(scene, tracer, cam, frame: int, accum_rt, clear_color, *, width: int,
                 height: int, depth: int, use_shadows: bool, use_ao: bool, use_gi: bool,
                 use_denoiser: bool = False, clamp_weights=False, corr: bool = False,
                 corr_salt=None, pix=None, seeds=None, perm=None, inv_perm=None,
                 denoise_state=None, tile_axis=None):
    """A hybrid frame: G-buffer pass + RT effects + accumulation
    (main.cpp:506-561). Returns (gbuffer, new_accum, rays, denoise_state').

    ``pix``/``seeds``: optional pixel coordinates and RNG states (int32
    bits), e.g. tile-ordered with seeds of the original pixel ids (the
    engine). ``perm``/``inv_perm``: ``tile_perm``'s pair, set when ``pix``
    is the whole frame in tile order: the denoiser then un-tiles its
    image-space inputs and re-tiles the filtered radiance (reshape copies
    when ``width % 32 == 0``, row gathers otherwise). Otherwise the
    full-frame denoiser cannot take ``pix``.
    ``denoise_state``: a ``DenoiserState`` selects the temporal
    (reprojecting) denoiser; None the spatial-only filter. Without GI,
    ``use_denoiser`` is ignored, as in the JAX package.
    ``tile_axis``: the ``parallel.mesh.RenderMesh`` when ``pix`` is this
    rank's band of whole scanline rows on the mesh's tile axis (the JAX
    package's shard_map axis name): the denoiser then runs in its band
    form (``denoise_temporal_tile``), which is temporal only.
    ``corr_salt``: see ``hybrid_effects``."""
    device = cam.view_inverse.device
    with pass_label("gbuffer"):
        gbuf = gbuffer_pass(scene, tracer, cam, width, height, clear_color, pix=pix)
    seed = seed_pixels(width, height, frame, device) if seeds is None else seeds
    new_accum, diff_rad_hitd, _, rays = hybrid_effects(
        scene, tracer, gbuf, cam, seed, frame, accum_rt, depth=depth,
        use_shadows=use_shadows, use_ao=use_ao, use_gi=use_gi,
        clamp_weights=clamp_weights, corr=corr, corr_salt=corr_salt,
    )
    rays = rays + float(gbuf.color.shape[0])  # + primary G-buffer rays
    new_state = denoise_state
    if use_denoiser and use_gi and tile_axis is not None:
        if denoise_state is None:
            raise ValueError("the band denoiser is temporal only: pass a denoise_state")
        with pass_label("denoise"):
            filtered, new_state = dn.denoise_temporal_tile(
                denoise_state, diff_rad_hitd, gbuf.norm_rough, gbuf.view_z,
                gbuf.position[:, :3], cam.view_proj, width, height, tile_axis)
        new_accum = torch.cat([filtered, new_accum[:, 3:4]], dim=-1)
    elif use_denoiser and use_gi:
        if pix is not None and inv_perm is None:
            raise ValueError("the denoiser needs the whole frame: pass inv_perm with pix")
        structured = width % 32 == 0

        def unperm(a):
            if inv_perm is None:
                return a
            return untile(a, width, height) if structured else a[inv_perm]

        with pass_label("denoise"):
            if denoise_state is not None:
                filtered, new_state = dn.denoise_temporal(
                    denoise_state, unperm(diff_rad_hitd), unperm(gbuf.norm_rough),
                    unperm(gbuf.view_z), unperm(gbuf.position[:, :3]), cam.view_proj,
                    width, height)
            else:
                filtered = dn.denoise_gi(unperm(diff_rad_hitd), unperm(gbuf.norm_rough),
                                         unperm(gbuf.view_z), width, height)
        if perm is not None:
            filtered = retile(filtered, width, height) if structured else filtered[perm]
        new_accum = torch.cat([filtered, new_accum[:, 3:4]], dim=-1)
    return gbuf, new_accum, rays, new_state
