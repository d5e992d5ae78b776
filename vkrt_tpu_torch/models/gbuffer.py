"""G-buffer pass: the raster pipeline replaced by primary-visibility rays
(port of ``vkrt_tpu/models/gbuffer.py``).

The reference rasterizes the scene into a G-buffer with direct PBR lighting
from all lights (vert_shader.vert + frag_shader.frag:122-214). Here a
closest trace of one ray through each pixel centre (kernel A on the card)
fills the same buffer contract:

* color.rgb = emissive + sum over lights of BRDF * Li * cosTheta
  (frag:188-214);
* albedo = (1-metal)*baseColor carried in the alpha channels of
  color/position/normal (frag:140-149);
* position/normal: world space; the rough+metal pair (frag:141-144);
* NRD inputs: motion vector (0), oct-packed normal+roughness, viewZ
  (frag:135-138);
* background: color = clear color, position = normal = 0 exactly: the
  hybrid pass's background test (raytraceHybrid.rgen:67).

Textures are filtered as the raster pipeline's sampler would: 4x
anisotropic trilinear from ray-differential UV gradients by default, or
the isotropic per-triangle-density trilinear LOD with ``VKRT_ANISO=0``.
Camera and Jacobian math is explicit multiply-adds, never a matmul (f32
matmuls may run as TF32 on the card).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from vkrt_tpu_torch.models.shading import surface_at_hit
from vkrt_tpu_torch.ops import brdf as brdf_ops
from vkrt_tpu_torch.ops.intersect import T_MAX, T_MIN
from vkrt_tpu_torch.ops.nrd import pack_normal_and_roughness
from vkrt_tpu_torch.scene import scene_is_textured
from vkrt_tpu_torch.utils.camera import generate_rays, pixel_coords
from vkrt_tpu_torch.utils.smath import cross, dot, length, normalize, transform_point


class GBuffer(NamedTuple):
    color: torch.Tensor        # (N,4) direct light rgb + albedo.r
    position: torch.Tensor     # (N,4) world pos + albedo.g
    normal: torch.Tensor       # (N,4) shading normal + albedo.b
    rough_metal: torch.Tensor  # (N,2)
    view_z: torch.Tensor       # (N,)
    norm_rough: torch.Tensor   # (N,4) NRD packed
    motion: torch.Tensor       # (N,4) zeros (static camera MV, frag:135)


def direct_lighting(scene, p, n, v, base_color, metallic, roughness):
    """All-lights direct PBR sum (frag_shader.frag:193-213).

    Directional lights use the reference's quirk: L = normalize(position)
    and no distance attenuation."""
    acc = torch.zeros_like(p)
    for i in range(scene.num_lights):
        lpos = scene.light_pos[i]
        lcol = scene.light_color[i]
        lint = scene.light_intensity[i]
        is_point = scene.light_type[i] == 0
        ldir = lpos - p
        dist = length(ldir, keepdims=True)
        li_point = lcol * lint / torch.clamp_min(dist * dist, 1e-20)
        l_point = ldir / torch.clamp_min(dist, 1e-20)
        l_dir = normalize(lpos).expand(p.shape)
        l = torch.where(is_point, l_point, l_dir)
        li = torch.where(is_point, li_point, lcol * lint)
        h = normalize(l + v)
        cos_t = torch.clamp_min(dot(l, n), 0.0)
        contrib = (brdf_ops.compute_pbr_brdf(n, v, l, h, base_color, metallic, roughness)
                   * li * cos_t[:, None])
        acc = acc + torch.where((cos_t > 0.0)[:, None], contrib, 0.0)
    return acc


def _iso_lod(scene, cam, height: int, hi):
    """The isotropic per-triangle-density trilinear LOD (``VKRT_ANISO=0``):
    log2 of the footprint in texels of the widest level 0."""
    pixel_angle = 2.0 * cam.proj_inverse[1, 1].abs() / float(height)
    tex_w = scene.tex_level_size[:, 0, 0].max().float()
    density = scene.tri_uv_density[torch.clamp_min(hi.tri, 0).long()]
    footprint_texels = hi.t * pixel_angle * density * tex_w
    return torch.log2(torch.clamp_min(footprint_texels, 1e-9))


def _uv_grads(scene, cam, width: int, height: int, pix, direction, hi):
    """Screen-space UV derivatives by ray differentials: the per-pixel
    camera direction derivative is transferred onto the hit plane
    (Igehy-style) and pushed through the triangle's UV Jacobian, the
    analytic analog of the raster pipeline's dFdx/dFdy. Returns (ddx_uv,
    ddy_uv), (N,2) each."""
    pi = cam.proj_inverse
    rot = cam.view_inverse[:3, :3]  # camera -> world rotation

    def rot_mul(v):
        return rot[:, 0] * v[0] + rot[:, 1] * v[1] + rot[:, 2] * v[2]

    # d(target)/d(pixel): a projInverse column scaled by the NDC step,
    # rotated to world (generate_rays' target, rgen:47-50)
    ax = rot_mul(pi[:3, 0] * (2.0 / float(width)))
    ay = rot_mul(pi[:3, 1] * (2.0 / float(height)))
    # |target| per pixel (direction was normalized in camera space)
    dndc = ((pix + 0.5) / torch.tensor([width, height], dtype=torch.float32, device=pix.device)
            * 2.0 - 1.0)
    t3 = torch.stack(
        [
            pi[0, 0] * dndc[:, 0] + pi[0, 1] * dndc[:, 1] + pi[0, 2] + pi[0, 3],
            pi[1, 0] * dndc[:, 0] + pi[1, 1] * dndc[:, 1] + pi[1, 2] + pi[1, 3],
            pi[2, 0] * dndc[:, 0] + pi[2, 1] * dndc[:, 1] + pi[2, 2] + pi[2, 3],
        ],
        dim=-1,
    )
    inv_tlen = 1.0 / torch.clamp_min(length(t3), 1e-20)

    tri = torch.clamp_min(hi.tri, 0).long()
    e1 = scene.tri_e1[tri]
    e2 = scene.tri_e2[tri]
    cuv = scene.corner_uv[tri]  # (N,3,2)
    ng = cross(e1, e2)
    denom = dot(ng, direction)
    safe_denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    # barycentric solve: world step -> (du_bary, dv_bary) via the edge Gram
    # matrix, then -> UV through the corner-UV deltas
    a = dot(e1, e1)
    b = dot(e1, e2)
    c = dot(e2, e2)
    inv_det = 1.0 / torch.clamp_min(a * c - b * b, 1e-20)
    duv1 = cuv[:, 1] - cuv[:, 0]
    duv2 = cuv[:, 2] - cuv[:, 0]

    def uv_deriv(axis_vec):
        # normalized-direction derivative, then plane transfer at t
        dd = (axis_vec[None, :] - direction * dot(direction, axis_vec[None, :], keepdims=True)
              ) * inv_tlen[:, None]
        dp = hi.t[:, None] * (dd - direction * (dot(ng, dd) / safe_denom)[:, None])
        p = dot(e1, dp)
        q = dot(e2, dp)
        du_b = (c * p - b * q) * inv_det
        dv_b = (a * q - b * p) * inv_det
        return duv1 * du_b[:, None] + duv2 * dv_b[:, None]

    return uv_deriv(ax), uv_deriv(ay)


def gbuffer_pass(scene, tracer, cam, width: int, height: int, clear_color,
                 pix=None) -> GBuffer:
    """Primary rays at pixel centres -> G-buffer (replaces rasterizeGltf).
    ``pix``: optional (N,2) pixel coordinates, e.g. tile-ordered (the
    engine); defaults to the whole frame in scanline order."""
    device = cam.view_inverse.device
    if pix is None:
        pix = pixel_coords(width, height, device)
    n = pix.shape[0]
    origin, direction = generate_rays(
        cam, width, height, torch.full((n, 2), 0.5, dtype=torch.float32, device=device), pix=pix
    )
    hi = tracer.closest(origin, direction, T_MIN, T_MAX)
    miss = ~hi.hit

    uv_grads = lod = None
    if scene_is_textured(scene):
        if os.environ.get("VKRT_ANISO", "1") == "1":
            uv_grads = _uv_grads(scene, cam, width, height, pix, direction, hi)
        else:
            lod = _iso_lod(scene, cam, height, hi)
    surf = surface_at_hit(scene, torch.clamp_min(hi.tri, 0), hi.u, hi.v, direction,
                          lod=lod, uv_grads=uv_grads)

    v = normalize(-direction)
    # the frag shader uses the raw factors: the path's clamps do not apply
    direct = direct_lighting(scene, surf.world_pos, surf.shading_normal, v,
                             surf.base_color, surf.metallic, surf.roughness)
    color_rgb = surf.emissive + direct
    albedo = (1.0 - surf.metallic)[:, None] * surf.base_color  # frag:140

    clear3 = torch.tensor([float(c) for c in clear_color[:3]], dtype=torch.float32,
                          device=device)
    m = miss[:, None]
    color_rgb = torch.where(m, clear3, color_rgb)
    world_pos = torch.where(m, 0.0, surf.world_pos)
    nrm = torch.where(m, 0.0, surf.shading_normal)
    albedo = torch.where(m, 0.0, albedo)

    view_z = torch.where(miss, 0.0, transform_point(cam.view, surf.world_pos)[:, 2])
    packed = pack_normal_and_roughness(surf.shading_normal, surf.roughness,
                                       surf.mat_id.float())
    return GBuffer(
        color=torch.cat([color_rgb, albedo[:, 0:1]], dim=1),
        position=torch.cat([world_pos, albedo[:, 1:2]], dim=1),
        normal=torch.cat([nrm, albedo[:, 2:3]], dim=1),
        rough_metal=torch.where(m, 0.0, torch.stack([surf.roughness, surf.metallic], dim=-1)),
        view_z=view_z,
        norm_rough=torch.where(m, 0.0, packed),
        motion=torch.zeros((n, 4), dtype=torch.float32, device=device),
    )
