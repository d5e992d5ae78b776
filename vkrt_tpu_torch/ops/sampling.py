"""Direction sampling: cosine hemisphere, ONB construction, GGX NDF (port of
``vkrt_tpu/ops/sampling.py``, the math of ``shaders/random.glsl:35-70``).

Draws are taken in the GLSL's order (r1 then r2) on the port's LCG
(``ops/rng.py``, int32 bits of the uint32 state); every sampler takes and
returns the state.
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch.ops.rng import rnd
from vkrt_tpu_torch.utils.smath import cross

M_PI = 3.14159265358979323846
M_TWO_PI = 2.0 * M_PI
M_INV_PI = 1.0 / M_PI


def hemisphere_from_uniforms(r1, r2, x, y, z):
    """Cosine-weighted hemisphere direction around the frame (x, y, z) from
    two uniforms in [0, 1) (random.glsl:35-45, after the draws)."""
    sq = torch.sqrt(r1)
    phi = M_TWO_PI * r2
    cx = (torch.cos(phi) * sq)[..., None]
    cy = (torch.sin(phi) * sq)[..., None]
    cz = torch.sqrt(torch.clamp_min(1.0 - r1, 0.0))[..., None]
    return cx * x + cy * y + cz * z


def sampling_hemisphere(state, x, y, z, uniforms=None):
    """Cosine-weighted hemisphere sample around (x, y, z = normal). Returns
    (state, direction). ``uniforms``: optional (r1, r2) replacing the lane
    draws (correlated per-block sampling); the state still advances."""
    state, r1 = rnd(state)
    state, r2 = rnd(state)
    if uniforms is not None:
        r1, r2 = uniforms
    return state, hemisphere_from_uniforms(r1, r2, x, y, z)


def create_coordinate_system(n):
    """Branchless ONB of random.glsl:47-54: both tangent choices are
    computed and the one for |N.x| > |N.y| selected. Returns (nt, nb)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    inv_a = 1.0 / torch.sqrt(torch.clamp_min(nx * nx + nz * nz, 1e-30))
    t_a = torch.stack([nz * inv_a, torch.zeros_like(nx), -nx * inv_a], dim=-1)
    inv_b = 1.0 / torch.sqrt(torch.clamp_min(ny * ny + nz * nz, 1e-30))
    t_b = torch.stack([torch.zeros_like(nx), -nz * inv_b, ny * inv_b], dim=-1)
    nt = torch.where((torch.abs(nx) > torch.abs(ny))[..., None], t_a, t_b)
    nb = cross(n, nt)
    return nt, nb


def ggxtr_half_from_uniforms(r1, r2, alpha2):
    """GGX NDF half-vector in local space from two uniforms
    (random.glsl:56-70, after the draws)."""
    cos_theta = torch.sqrt(torch.clamp_min((1.0 - r2) / ((alpha2 - 1.0) * r2 + 1.0), 0.0))
    sin_theta = torch.clamp(torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0)),
                            0.0, 1.0)
    phi = r1 * M_TWO_PI
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta],
                       dim=-1)


def sampling_ndf_ggxtr(state, alpha2, uniforms=None):
    """GGX NDF half-vector sample in the (tangent, binormal, normal) frame.
    The caller passes ``alpha*alpha`` with ``alpha = roughness^2``
    (raytrace.rchit:191-192), as the reference does. Returns (state,
    h_local); ``uniforms`` as ``sampling_hemisphere``."""
    state, r1 = rnd(state)
    state, r2 = rnd(state)
    if uniforms is not None:
        r1, r2 = uniforms
    return state, ggxtr_half_from_uniforms(r1, r2, alpha2)


def local_to_world(local, tangent, binormal, normal):
    """TBN transform: world = x*T + y*B + z*N (raytrace.rchit:99,192)."""
    return local[..., 0:1] * tangent + local[..., 1:2] * binormal + local[..., 2:3] * normal
