"""glTF PBR BRDF library (port of ``vkrt_tpu/ops/brdf.py``, itself the
batched form of ``shaders/gltf.glsl``).

The reference estimator's quirks are kept: the ``1e-4`` stabilisers, the
|.| placements, the Schlick-GGX ``k`` remap, and ``direct_light``'s
point-light-only evaluation (a light of another type has zero BRDF).
Functions take material values already sampled from the textures.
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch.ops.sampling import M_INV_PI
from vkrt_tpu_torch.utils.smath import dot, length, normalize


def ndf_ggxtr(n, h, alpha):
    """GGX/Trowbridge-Reitz NDF (gltf.glsl:55-66); 0 where N.H <= 0."""
    a2 = alpha * alpha
    nh = dot(n, h)
    nh2 = nh * nh
    d = nh2 * (a2 - 1.0) + 1.0
    val = a2 * M_INV_PI / (d * d + 1e-4)
    return torch.where(nh <= 0.0, 0.0, val)


def g_schlick_ggx(nv, k):
    """Schlick-GGX visibility term (gltf.glsl:68-71)."""
    return nv / (nv * (1.0 - k) + k)


def g_smith(n, v, l, k):
    """Smith geometry term with |N.V|, |N.L| (gltf.glsl:73-78)."""
    nv = torch.abs(dot(n, v))
    nl = torch.abs(dot(n, l))
    return g_schlick_ggx(nv, k) * g_schlick_ggx(nl, k)


def f_schlick(h, v, f0):
    """Fresnel-Schlick with |H.V| (gltf.glsl:80-83). f0: (..., 3)."""
    hv = torch.abs(dot(h, v))
    return f0 + (1.0 - f0) * torch.pow(torch.clamp_min(1.0 - hv, 0.0), 5.0)[..., None]


def _k_direct(roughness):
    """k remap for direct lighting: (r+1)^2/8 (gltf.glsl:88)."""
    return (roughness + 1.0) * (roughness + 1.0) / 8.0


def specular_brdf_cook_torrance(n, h, v, l, f0, roughness):
    """Cook-Torrance D*F*G / (4|VN||LN| + 1e-4) (gltf.glsl:85-96)."""
    alpha = roughness * roughness
    k = _k_direct(roughness)
    d = ndf_ggxtr(n, h, alpha)
    g = g_smith(n, v, l, k)
    f = f_schlick(h, v, f0)
    down = 4.0 * torch.abs(dot(v, n)) * torch.abs(dot(l, n)) + 1e-4
    return (d * g / down)[..., None] * f


def specular_brdf_over_pdf_cook_torrance(n, h, v, l, f0, roughness, ratio):
    """BRDF/pdf of the GGX-importance-sampled lobe (gltf.glsl:98-109):
    pdf = (1-ratio) * N.H / (4 L.H + 1e-4), D cancelling the NDF sample."""
    k = _k_direct(roughness)
    pdf = (1.0 - ratio) * dot(n, h) / (4.0 * dot(l, h) + 1e-4)
    g = g_smith(n, v, l, k)
    f = f_schlick(h, v, f0)
    down = 4.0 * torch.abs(dot(v, n)) * torch.abs(dot(l, n)) + 1e-4
    return (g / (down * pdf))[..., None] * f


def compute_pbr_brdf(n, v, l, h, base_color, metallic, roughness):
    """Diffuse + specular PBR BRDF (gltf.glsl:111-134): kD = (1-F)(1-metal),
    F0 = mix(0.04, baseColor, metal)."""
    f0 = base_color * metallic[..., None] + 0.04 * (1.0 - metallic[..., None])
    f = f_schlick(h, v, f0)
    spec = specular_brdf_cook_torrance(n, h, v, l, f0, roughness)
    kd = (1.0 - f) * (1.0 - metallic[..., None])
    diffuse = kd * base_color * M_INV_PI
    return diffuse + spec


def direct_light(light_pos, light_color, light_intensity, light_type,
                 p, n, v, base_color, metallic, roughness):
    """Point-light NEE evaluation (gltf.glsl:136-154). Returns (brdf, li,
    cos_theta): only ``type == 0`` contributes, Li = color*intensity/d^2,
    and the BRDF is zero where cos_theta <= 0."""
    ldir = light_pos - p
    d = length(ldir, keepdims=True)
    l = ldir / torch.clamp_min(d, 1e-20)
    h = normalize(l + v)
    li = light_color * (light_intensity / torch.clamp_min(d[..., 0] * d[..., 0], 1e-20))[..., None]
    cos_theta = torch.clamp_min(dot(l, n), 0.0)
    brdf = compute_pbr_brdf(n, v, l, h, base_color, metallic, roughness)
    gate = ((light_type == 0) & (cos_theta > 0.0))[..., None]
    brdf = torch.where(gate, brdf, 0.0)
    return brdf, li, cos_theta
