"""NRD/REBLUR packing math (port of ``vkrt_tpu/ops/nrd.py``, the math of
``shaders/gltf.glsl:156-273``): oct-encoded normal + roughness, YCoCg
radiance + normalized hit distance, the hit-distance normalization. The
hybrid frame writes the denoiser's inputs in this contract.
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch.utils.smath import length

NRD_FP16_MIN = 1e-7
NRD_FP16_MAX = 65504.0

# REBLUR hit-distance parameters hardcoded in the reference
# (raytraceHybrid.rgen:276, raytrace.rgen:129).
HIT_DIST_PARAMS = (3.0, 1.0, 20.0, -25.0)


def _sign_not_zero(v):
    return torch.where(v >= 0.0, 1.0, -1.0)


def encode_unit_vector(v, signed: bool = False):
    """Octahedral encode (gltf.glsl:157-165). v: (...,3) -> (...,2)."""
    a = v.abs()
    denom = (a[..., 0] + a[..., 1] + a[..., 2])[..., None]
    v = v / torch.clamp_min(denom, 1e-20)
    xy = v[..., :2]
    # GLSL's v.yx: swapped components
    oct_wrap = (1.0 - torch.stack([v[..., 1], v[..., 0]], dim=-1).abs()) * _sign_not_zero(xy)
    e = torch.where(v[..., 2:3] >= 0.0, xy, oct_wrap)
    return e if signed else e * 0.5 + 0.5


def decode_unit_vector(p, signed: bool = False, normalize: bool = True):
    """Octahedral decode (gltf.glsl:178-188)."""
    p = p if signed else p * 2.0 - 1.0
    z = 1.0 - p[..., 0].abs() - p[..., 1].abs()
    t = torch.clamp(-z, 0.0, 1.0)
    xy = p - t[..., None] * _sign_not_zero(p)
    n = torch.cat([xy, z[..., None]], dim=-1)
    if normalize:
        n = n / torch.clamp_min(length(n, keepdims=True), 1e-20)
    return n


def pack_normal_and_roughness(n, roughness, material_id):
    """NRD_FrontEnd_PackNormalAndRoughness (gltf.glsl:167-176)."""
    e = encode_unit_vector(n, signed=False)
    return torch.cat(
        [e, roughness[..., None], torch.clamp(material_id / 3.0, 0.0, 1.0)[..., None]],
        dim=-1,
    )


def unpack_normal_and_roughness(p):
    """Returns (normal, roughness, material_id) (gltf.glsl:190-201)."""
    n = decode_unit_vector(p[..., :2], signed=False, normalize=True)
    return n, p[..., 2], p[..., 3]


def linear_to_ycocg(c):
    """(gltf.glsl:203-210)."""
    y = 0.25 * c[..., 0] + 0.5 * c[..., 1] + 0.25 * c[..., 2]
    co = 0.5 * c[..., 0] - 0.5 * c[..., 2]
    cg = -0.25 * c[..., 0] + 0.5 * c[..., 1] - 0.25 * c[..., 2]
    return torch.stack([y, co, cg], dim=-1)


def ycocg_to_linear(c):
    """(gltf.glsl:212-222)."""
    t = c[..., 0] - c[..., 2]
    r = t + c[..., 1]
    g = c[..., 0] + c[..., 2]
    b = t - c[..., 1]
    return torch.clamp_min(torch.stack([r, g, b], dim=-1), 0.0)


def pack_radiance_and_norm_hit_dist(radiance, norm_hit_dist, sanitize: bool = True):
    """REBLUR_FrontEnd_PackRadianceAndNormHitDist (gltf.glsl:227-244).
    ``sanitize``: a pixel with any non-finite channel packs as zero
    radiance, the rest clamps to [0, NRD_FP16_MAX]; a non-finite hit
    distance packs as 0, the rest clamps to [0, 1]."""
    if sanitize:
        bad = (~torch.isfinite(radiance)).any(dim=-1, keepdim=True)
        radiance = torch.where(bad, 0.0, torch.clamp(radiance, 0.0, NRD_FP16_MAX))
        norm_hit_dist = torch.where(~torch.isfinite(norm_hit_dist), 0.0,
                                    torch.clamp(norm_hit_dist, 0.0, 1.0))
    norm_hit_dist = torch.where(norm_hit_dist != 0.0,
                                torch.clamp_min(norm_hit_dist, NRD_FP16_MIN), norm_hit_dist)
    return torch.cat([linear_to_ycocg(radiance), norm_hit_dist[..., None]], dim=-1)


def unpack_radiance_and_norm_hit_dist(data):
    """REBLUR_BackEnd_UnpackRadianceAndNormHitDist (gltf.glsl:246-251)."""
    return torch.cat([ycocg_to_linear(data[..., :3]), data[..., 3:4]], dim=-1)


def hit_distance_normalization(view_z, roughness, params=HIT_DIST_PARAMS):
    """_REBLUR_GetHitDistanceNormalization (gltf.glsl:254-258)."""
    px, py, pz, pw = params
    s = torch.clamp(torch.exp2(pw * roughness * roughness), 0.0, 1.0)
    return (px + view_z.abs() * py) * (1.0 + (pz - 1.0) * s)


def norm_hit_dist(hit_dist, view_z, roughness, params=HIT_DIST_PARAMS):
    """REBLUR_FrontEnd_GetNormHitDist (gltf.glsl:260-265)."""
    f = hit_distance_normalization(view_z, roughness, params)
    return torch.clamp(hit_dist / torch.clamp_min(f, 1e-20), 0.0, 1.0)
