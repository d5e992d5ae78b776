"""Small batched vector-math helpers (port of ``vkrt_tpu/utils/smath.py``).

Every function works on tensors whose last axis is the vector axis (size 3
or 4) and broadcasts over the leading axes. f32 throughout. Sums over the
vector axis are written out as ``x + y + z`` so the order of the adds is
the one XLA's three-term reduce takes.
"""

from __future__ import annotations

import torch


def dot(a, b, keepdims: bool = False):
    p = a * b
    out = p[..., 0] + p[..., 1] + p[..., 2]
    if p.shape[-1] == 4:
        out = out + p[..., 3]
    return out[..., None] if keepdims else out


def length(v, keepdims: bool = False):
    return torch.sqrt(torch.clamp_min(dot(v, v, keepdims=keepdims), 0.0))


def normalize(v, eps: float = 1e-20):
    return v * (1.0 / torch.clamp_min(length(v, keepdims=True), eps))


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def reflect(incident, normal):
    """GLSL ``reflect(I, N) = I - 2*dot(N, I)*N``."""
    return incident - 2.0 * dot(normal, incident, keepdims=True) * normal


def mix(a, b, t):
    """GLSL ``mix``: a*(1-t) + b*t."""
    return a * (1.0 - t) + b * t


def _mat3_apply(m3, v):
    """(3,3) @ (...,3) as explicit multiply-adds (no matmul, as in the JAX
    package, so both round alike)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            m3[0, 0] * x + m3[0, 1] * y + m3[0, 2] * z,
            m3[1, 0] * x + m3[1, 1] * y + m3[1, 2] * z,
            m3[2, 0] * x + m3[2, 1] * y + m3[2, 2] * z,
        ],
        dim=-1,
    )


def transform_point(mat4, p):
    """Apply a 4x4 matrix to points with implicit w=1. p: (..., 3)."""
    return _mat3_apply(mat4[:3, :3], p) + mat4[:3, 3]


def transform_dir(mat4, d):
    """Apply a 4x4 matrix to directions with implicit w=0. d: (..., 3)."""
    return _mat3_apply(mat4[:3, :3], d)


def transform_normal(inv_mat4, n):
    """(M^-1)^T @ n, with ``inv_mat4`` the world-to-object matrix
    (``vec3(nrm * gl_WorldToObjectEXT)``, raytrace.rchit:74-76)."""
    return _mat3_apply(inv_mat4[:3, :3].transpose(0, 1), n)


def luminance(rgb):
    w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=rgb.dtype, device=rgb.device)
    return dot(rgb, w)
