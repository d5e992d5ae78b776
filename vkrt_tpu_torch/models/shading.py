"""Hit shading and BSDF sampling (port of ``vkrt_tpu/models/shading.py``,
the closest-hit stage ``shaders/raytrace.rchit``): attribute interpolation,
the TBN frame and normal mapping, material and texture evaluation, NEE
direct light, and the lobe pick (diffuse with probability
``0.5*(1-metalness)``, else GGX specular).

Both lobes are evaluated on every lane and one is selected, with each
lobe's own RNG stream advanced and the survivor's state kept, so a lane's
draws are those of the reference's divergent execution. This is the
general shading path: the path tracer runs it (in PyTorch, on either
device) on scenes that kernel B does not shade, those with metallic-
roughness, emissive or normal-map textures.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vkrt_tpu_torch.ops import brdf as brdf_ops
from vkrt_tpu_torch.ops.rng import rnd
from vkrt_tpu_torch.ops.sampling import (
    M_INV_PI, create_coordinate_system, local_to_world, sampling_hemisphere,
    sampling_ndf_ggxtr,
)
from vkrt_tpu_torch.ops.texture import (
    aniso_minor_lod, sample_texture, sample_texture_aniso, sample_texture_lod,
)
from vkrt_tpu_torch.scene import tex_slots_used
from vkrt_tpu_torch.utils.smath import cross, dot, length, normalize, reflect


def clamp_bounds(clamp_weights: bool):
    """RenderSettings.clamp_weights -> (lo, hi) path-throughput clamp:
    [0, 50] on, [-inf, +inf] (the identity) off."""
    return (0.0, 50.0) if clamp_weights else (-math.inf, math.inf)


class SurfaceSample(NamedTuple):
    """What the rchit stage writes back through the payload, and what the
    G-buffer pass needs (raycommon.glsl:8-19, frag_shader.frag:122-149)."""

    world_pos: torch.Tensor       # (N,3)
    shading_normal: torch.Tensor  # (N,3) texNormal
    geo_normal: torch.Tensor      # (N,3) interpolated worldNrm
    base_color: torch.Tensor      # (N,3)
    metallic: torch.Tensor        # (N,) raw (unclamped)
    roughness: torch.Tensor       # (N,) raw (unclamped)
    emissive: torch.Tensor        # (N,3) emissiveFactor * texture
    tangent: torch.Tensor         # (N,3) final frame tangent
    binormal: torch.Tensor        # (N,3)
    uv: torch.Tensor              # (N,2)
    mat_id: torch.Tensor          # (N,) int32


def _bary(corner, w, u, v):
    """(N,3,k) corner values -> (N,k): c0*w + c1*u + c2*v, the three-term
    sum in order."""
    return corner[:, 0] * w[:, None] + corner[:, 1] * u[:, None] + corner[:, 2] * v[:, None]


def surface_at_hit(scene, tri, u, v, ray_dir, lod=None, uv_grads=None) -> SurfaceSample:
    """Interpolate the attributes and evaluate the material at the hit
    (rchit:31-113). ``tri`` must be clamped to >= 0 (callers mask miss
    lanes). ``lod``: optional (N,) continuous mip level (the G-buffer
    pass); ``uv_grads``: optional (ddx_uv, ddy_uv) for anisotropic
    sampling; neither (the path tracer): level 0."""
    tri = tri.long()
    w = 1.0 - u - v
    cn = scene.corner_normal[tri]    # (N,3,3)
    ctg = scene.corner_tangent[tri]  # (N,3,4)
    cuv = scene.corner_uv[tri]       # (N,3,2)
    world_pos = scene.tri_v0[tri] + u[:, None] * scene.tri_e1[tri] + v[:, None] * scene.tri_e2[tri]
    world_nrm = normalize(_bary(cn, w, u, v))
    world_tag = normalize(_bary(ctg[..., :3], w, u, v))
    # Gram-Schmidt, and the handedness of corner 0's tangent.w (rchit:77-78)
    world_tag = normalize(world_tag - dot(world_tag, world_nrm, keepdims=True) * world_nrm)
    world_bin = ctg[:, 0, 3:4] * cross(world_nrm, world_tag)
    uv = _bary(cuv, w, u, v)
    mat_id = scene.tri_mat[tri]
    del ray_dir  # ffnormal is computed but unused in the reference (rchit:98)
    return _material_surface(scene, mat_id, uv, world_pos, world_nrm, world_tag,
                             world_bin, lod, uv_grads)


def _material_surface(scene, mat_id, uv, world_pos, world_nrm, world_tag,
                      world_bin, lod, uv_grads=None) -> SurfaceSample:
    """The material and texture half of the rchit stage (rchit:80-113).
    Each texture slot is fetched only when some material uses it (a fetch
    over all-(-1) indices is white, so skipping it changes nothing)."""
    m = mat_id.long()
    base_factor = scene.mat_base_color[m][:, :3]
    metal_f = scene.mat_metallic[m]
    rough_f = scene.mat_roughness[m]
    emis_f = scene.mat_emissive[m]
    used = tex_slots_used(scene)

    if uv_grads is not None:
        # 4x anisotropic trilinear for the colour textures; the metallic-
        # roughness and normal maps trilinear at the minor-axis level
        ddx_uv, ddy_uv = uv_grads

        def fetch(idx):
            return sample_texture_aniso(scene.tex_mip_atlas, scene.tex_level_size,
                                        scene.tex_level_off, scene.tex_n_levels, idx, uv,
                                        ddx_uv, ddy_uv)

        def fetch_data(idx):
            lod_m = aniso_minor_lod(scene.tex_level_size, idx, ddx_uv, ddy_uv)
            return sample_texture_lod(scene.tex_mip_atlas, scene.tex_level_size,
                                      scene.tex_level_off, scene.tex_n_levels, idx, uv, lod_m)
    elif lod is None:
        def fetch(idx):
            return sample_texture(scene.tex_rgba, scene.tex_size, idx, uv)
        fetch_data = fetch
    else:
        def fetch(idx):
            return sample_texture_lod(scene.tex_mip_atlas, scene.tex_level_size,
                                      scene.tex_level_off, scene.tex_n_levels, idx, uv, lod)
        fetch_data = fetch

    base_color = base_factor
    if used["mat_base_tex"]:
        base_color = base_factor * fetch(scene.mat_base_tex[m])[:, :3]
    # roughness in G, metalness in B (gltf.glsl:40-44)
    roughness, metallic = rough_f, metal_f
    if used["mat_mr_tex"]:
        mr = fetch_data(scene.mat_mr_tex[m])
        roughness = rough_f * mr[:, 1]
        metallic = metal_f * mr[:, 2]
    emissive = emis_f
    if used["mat_emissive_tex"]:
        emissive = emis_f * fetch(scene.mat_emissive_tex[m])[:, :3]
    shading_normal, tangent, binormal = world_nrm, world_tag, world_bin
    if used["mat_normal_tex"]:
        # normal mapping (rchit:93-106): the frame is rebuilt around texNormal
        normal_tex = scene.mat_normal_tex[m]
        tex_n_rgb = fetch_data(normal_tex)[:, :3]
        mapped = normalize(tex_n_rgb * 2.0 - 1.0)
        mapped_world = normalize(local_to_world(mapped, world_tag, world_bin, world_nrm))
        has_nmap = (normal_tex >= 0)[:, None]
        shading_normal = torch.where(has_nmap, mapped_world, world_nrm)
        nt, nb = create_coordinate_system(shading_normal)
        tangent = torch.where(has_nmap, nt, world_tag)
        binormal = torch.where(has_nmap, nb, world_bin)

    return SurfaceSample(world_pos=world_pos, shading_normal=shading_normal,
                         geo_normal=world_nrm, base_color=base_color, metallic=metallic,
                         roughness=roughness, emissive=emissive, tangent=tangent,
                         binormal=binormal, uv=uv, mat_id=mat_id)


class BsdfSample(NamedTuple):
    """The rchit stage's payload writes (rchit:215-218) and NEE's
    bookkeeping."""

    next_dir: torch.Tensor       # (N,3)
    weight: torch.Tensor         # (N,3) BRDF*cos/pdf
    emit_plus_nee: torch.Tensor  # (N,3) prd.hitValue
    is_specular: torch.Tensor    # (N,) bool
    shadow_dir: torch.Tensor     # (N,3) L toward the sampled light
    light_dist: torch.Tensor     # (N,)
    seed: torch.Tensor           # (N,) int32 bits of the uint32 LCG state


def sample_bsdf(scene, surf: SurfaceSample, ray_dir, seed, emit_gate, corr=None) -> BsdfSample:
    """Lobe selection and sampling (rchit:118-218). ``emit_gate`` (N,) bool
    is the ``prd.depth == 0 || prd.isSpecular`` emissive gate
    (rchit:83-88). ``corr``: optional (N, 6) per-block shared uniforms
    (``ops.rng.corr_draws``) replacing the six draws (lobe, light,
    hemisphere r1/r2, GGX r1/r2); the lane seeds advance as without it."""
    n_lights = scene.num_lights
    v = normalize(-ray_dir)
    nrm = surf.shading_normal
    emittance = torch.where(emit_gate[:, None], surf.emissive, 0.0)

    # the ratio takes the unclamped metalness (rchit:127), the clamps follow
    ratio = 0.5 * (1.0 - surf.metallic)
    rough_c = torch.clamp(surf.roughness, 0.01, 0.99)
    metal_c = torch.clamp(surf.metallic, 0.01, 0.99)

    seed, r1 = rnd(seed)
    if corr is not None:
        r1 = corr[:, 0]
    is_diffuse = r1 < ratio

    # ---- diffuse branch: light pick, then two hemisphere draws ----
    seed_d, r_light = rnd(seed)
    if corr is not None:
        r_light = corr[:, 1]
    light_idx = torch.clamp((r_light * float(n_lights)).to(torch.int32), 0, n_lights - 1).long()
    lpos = scene.light_pos[light_idx]
    lcol = scene.light_color[light_idx]
    lint = scene.light_intensity[light_idx]
    ltype = scene.light_type[light_idx]
    ldir = lpos - surf.world_pos
    light_dist = length(ldir)
    l_nee = ldir / torch.clamp_min(light_dist[:, None], 1e-20)

    # directLight re-fetches the unclamped material (gltf.glsl:111-115): NEE
    # sees the raw metallic/roughness, the sampled lobes the clamped ones
    brdf_nee, li, cos_nee = brdf_ops.direct_light(
        lpos, lcol, lint, ltype, surf.world_pos, nrm, v, surf.base_color,
        surf.metallic, surf.roughness)
    # "if dot(L, texNormal) <= 0: += 0" (rchit:166-174); lightsCount scaling
    nee = torch.where((dot(l_nee, nrm) > 0.0)[:, None],
                      float(n_lights) * brdf_nee * li * cos_nee[:, None], 0.0)
    seed_d, hemi = sampling_hemisphere(
        seed_d, surf.tangent, surf.binormal, nrm,
        uniforms=None if corr is None else (corr[:, 2], corr[:, 3]))
    dir_d = normalize(hemi)
    # BRDF*cos/pdf with BRDF = (1-metal)*baseColor/pi, pdf = ratio*cos/pi
    pdf_d = ratio * dot(dir_d, nrm) * M_INV_PI
    brdf_d = (1.0 - metal_c)[:, None] * surf.base_color * M_INV_PI
    weight_d = brdf_d * (dot(dir_d, nrm) / torch.clamp_min(pdf_d, 1e-12))[:, None]

    # ---- specular branch: two GGX draws ----
    alpha = rough_c * rough_c
    seed_s, h_local = sampling_ndf_ggxtr(
        seed, alpha * alpha, uniforms=None if corr is None else (corr[:, 4], corr[:, 5]))
    h = normalize(local_to_world(h_local, surf.tangent, surf.binormal, nrm))
    dir_s = normalize(reflect(-v, h))
    f0 = 0.04 * (1.0 - metal_c[:, None]) + surf.base_color * metal_c[:, None]
    brdf_over_pdf = brdf_ops.specular_brdf_over_pdf_cook_torrance(nrm, h, v, dir_s, f0,
                                                                  rough_c, ratio)
    weight_s = brdf_over_pdf * dot(dir_s, nrm)[:, None]  # cosTheta (rchit:207)

    sel = is_diffuse[:, None]
    return BsdfSample(
        next_dir=torch.where(sel, dir_d, dir_s),
        weight=torch.where(sel, weight_d, weight_s),
        emit_plus_nee=emittance + torch.where(sel, nee, 0.0),
        is_specular=~is_diffuse,
        shadow_dir=l_nee,
        light_dist=light_dist,
        seed=torch.where(is_diffuse, seed_d, seed_s),
    )
