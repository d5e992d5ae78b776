"""Plain shading of the path tracer's general loop: the RNG, vector math,
glTF BRDF, direction sampling, level-0 texture fetches, the hit's surface
and the BSDF sample.

A frozen copy of the port's plain path (commit 400863e) with the modules
it mirrors: ``vkrt_tpu_torch/ops/rng.py`` (TEA, LCG, the correlated
per-block draws, here per lane from its block id), ``utils/smath.py``,
``ops/brdf.py``, ``ops/sampling.py``, ``ops/texture.py::sample_texture``
and ``models/shading.py::surface_at_hit`` / ``sample_bsdf`` (level 0, no
mip paths). Every function follows the dtype of its inputs; RNG draws are
f32 and widen or narrow where they meet them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

MASK32 = 0xFFFFFFFF
M_PI = 3.14159265358979323846
M_TWO_PI = 2.0 * M_PI
M_INV_PI = 1.0 / M_PI
CORR_BLOCK = 1024


# --- RNG (ops/rng.py) --------------------------------------------------------

def as_u32(x, device=None):
    if not torch.is_tensor(x):
        x = torch.tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & MASK32


def tea(val0, val1, rounds: int = 16):
    v0 = as_u32(val0)
    v1 = as_u32(val1, device=v0.device)
    v0, v1 = torch.broadcast_tensors(v0, v1)
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & MASK32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & MASK32) ^ ((v1 + s0) & MASK32)
                    ^ ((v1 >> 5) + 0xC8013EA4))) & MASK32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & MASK32) ^ ((v0 + s0) & MASK32)
                    ^ ((v0 >> 5) + 0x7E95761E))) & MASK32
    return v0.to(torch.int32)


def rnd(state):
    s = (as_u32(state) * 1664525 + 1013904223) & MASK32
    return s.to(torch.int32), (s & 0x00FFFFFF).to(torch.int32).to(torch.float32) * (
        1.0 / float(0x01000000))


def corr_seed_for(frame, sample: int = 0, salt: int = 0):
    """(N,) int64 frames -> the shared-draw tables' uint32 seeds."""
    return (frame * 0x9E3779B9 + sample * 0x6A09E667 + salt) & MASK32


def corr_lane_draws(block, corr_seed, depth: int):
    """(N, 6) f32: row ``block`` of the per-block table of ``corr_seed`` at
    bounce ``depth`` (``ops/rng.py::block_uniform_table``), per lane."""
    dkey = (int(depth) * 0x85EBCA6B) & MASK32
    st = tea(block, as_u32(corr_seed) ^ dkey, rounds=8)
    us = []
    for _ in range(6):
        st, u = rnd(st)
        us.append(u)
    return torch.stack(us, dim=1)


# --- vector math (utils/smath.py) --------------------------------------------

def dot(a, b, keepdims: bool = False):
    p = a * b
    out = p[..., 0] + p[..., 1] + p[..., 2]
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
    return incident - 2.0 * dot(normal, incident, keepdims=True) * normal


# --- glTF BRDF (ops/brdf.py) -------------------------------------------------

def _ndf_ggxtr(n, h, alpha):
    a2 = alpha * alpha
    nh = dot(n, h)
    d = nh * nh * (a2 - 1.0) + 1.0
    return torch.where(nh <= 0.0, 0.0, a2 * M_INV_PI / (d * d + 1e-4))


def _g_schlick_ggx(nv, k):
    return nv / (nv * (1.0 - k) + k)


def _g_smith(n, v, l, k):
    return (_g_schlick_ggx(torch.abs(dot(n, v)), k)
            * _g_schlick_ggx(torch.abs(dot(n, l)), k))


def _f_schlick(h, v, f0):
    hv = torch.abs(dot(h, v))
    return f0 + (1.0 - f0) * torch.pow(torch.clamp_min(1.0 - hv, 0.0), 5.0)[..., None]


def _k_direct(roughness):
    return (roughness + 1.0) * (roughness + 1.0) / 8.0


def _specular_cook_torrance(n, h, v, l, f0, roughness):
    alpha = roughness * roughness
    d = _ndf_ggxtr(n, h, alpha)
    g = _g_smith(n, v, l, _k_direct(roughness))
    f = _f_schlick(h, v, f0)
    down = 4.0 * torch.abs(dot(v, n)) * torch.abs(dot(l, n)) + 1e-4
    return (d * g / down)[..., None] * f


def _specular_over_pdf(n, h, v, l, f0, roughness, ratio):
    pdf = (1.0 - ratio) * dot(n, h) / (4.0 * dot(l, h) + 1e-4)
    g = _g_smith(n, v, l, _k_direct(roughness))
    f = _f_schlick(h, v, f0)
    down = 4.0 * torch.abs(dot(v, n)) * torch.abs(dot(l, n)) + 1e-4
    return (g / (down * pdf))[..., None] * f


def _pbr_brdf(n, v, l, h, base_color, metallic, roughness):
    f0 = base_color * metallic[..., None] + 0.04 * (1.0 - metallic[..., None])
    f = _f_schlick(h, v, f0)
    spec = _specular_cook_torrance(n, h, v, l, f0, roughness)
    kd = (1.0 - f) * (1.0 - metallic[..., None])
    return kd * base_color * M_INV_PI + spec


def _direct_light(light_pos, light_color, light_intensity, light_type, p, n, v,
                  base_color, metallic, roughness):
    ldir = light_pos - p
    d = length(ldir, keepdims=True)
    l = ldir / torch.clamp_min(d, 1e-20)
    h = normalize(l + v)
    li = light_color * (light_intensity / torch.clamp_min(d[..., 0] * d[..., 0], 1e-20))[..., None]
    cos_theta = torch.clamp_min(dot(l, n), 0.0)
    brdf = _pbr_brdf(n, v, l, h, base_color, metallic, roughness)
    gate = ((light_type == 0) & (cos_theta > 0.0))[..., None]
    return torch.where(gate, brdf, 0.0), li, cos_theta


# --- direction sampling (ops/sampling.py) ------------------------------------

def _hemisphere(r1, r2, x, y, z):
    sq = torch.sqrt(r1)
    phi = M_TWO_PI * r2
    cx = (torch.cos(phi) * sq)[..., None]
    cy = (torch.sin(phi) * sq)[..., None]
    cz = torch.sqrt(torch.clamp_min(1.0 - r1, 0.0))[..., None]
    return cx * x + cy * y + cz * z


def _coordinate_system(n):
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    inv_a = 1.0 / torch.sqrt(torch.clamp_min(nx * nx + nz * nz, 1e-30))
    t_a = torch.stack([nz * inv_a, torch.zeros_like(nx), -nx * inv_a], dim=-1)
    inv_b = 1.0 / torch.sqrt(torch.clamp_min(ny * ny + nz * nz, 1e-30))
    t_b = torch.stack([torch.zeros_like(nx), -nz * inv_b, ny * inv_b], dim=-1)
    nt = torch.where((torch.abs(nx) > torch.abs(ny))[..., None], t_a, t_b)
    return nt, cross(n, nt)


def _ggx_half(r1, r2, alpha2):
    cos_t = torch.sqrt(torch.clamp_min((1.0 - r2) / ((alpha2 - 1.0) * r2 + 1.0), 0.0))
    sin_t = torch.clamp(torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0)), 0.0, 1.0)
    phi = r1 * M_TWO_PI
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)


def _to_world(local, t, b, n):
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


# --- level-0 texture fetch (ops/texture.py::sample_texture) ------------------

def sample_texture(tex_rgba, tex_size, tex_idx, uv):
    k_all, th, tw, _ = tex_rgba.shape
    flat = tex_rgba.reshape(k_all * th * tw, 4)
    k = torch.clamp_min(tex_idx, 0).long()
    size = tex_size[k]
    wi, hi = size[:, 0], size[:, 1]
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    fx = u * wi.to(uv.dtype) - 0.5
    fy = v * hi.to(uv.dtype) - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    ax = (fx - x0)[:, None]
    ay = (fy - y0)[:, None]
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    x0i, x1i = torch.remainder(x0, wi), torch.remainder(x0 + 1, wi)
    y0i, y1i = torch.remainder(y0, hi), torch.remainder(y0 + 1, hi)

    def texel(y, x):
        return flat[(k * th + y.long()) * tw + x.long()].to(uv.dtype)

    c = (texel(y0i, x0i) * (1 - ax) * (1 - ay) + texel(y0i, x1i) * ax * (1 - ay)
         + texel(y1i, x0i) * (1 - ax) * ay + texel(y1i, x1i) * ax * ay)
    return torch.where((tex_idx >= 0)[:, None], c, 1.0)


# --- the hit's surface and the BSDF sample (models/shading.py) ---------------

class Surface(NamedTuple):
    world_pos: torch.Tensor
    shading_normal: torch.Tensor
    base_color: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    emissive: torch.Tensor
    tangent: torch.Tensor
    binormal: torch.Tensor


def _bary(corner, w, u, v):
    return corner[:, 0] * w[:, None] + corner[:, 1] * u[:, None] + corner[:, 2] * v[:, None]


def surface_at_hit(scn, tri, u, v) -> Surface:
    """Attributes and material at the hit, level-0 textures (rchit:31-113).
    ``scn``: ``reference.scene.RefScene``."""
    tri = tri.long()
    w = 1.0 - u - v
    cn, ctg, cuv = scn.corner_normal[tri], scn.corner_tangent[tri], scn.corner_uv[tri]
    world_pos = scn.tri_v0[tri] + u[:, None] * scn.tri_e1[tri] + v[:, None] * scn.tri_e2[tri]
    nrm = normalize(_bary(cn, w, u, v))
    tag = normalize(_bary(ctg[..., :3], w, u, v))
    tag = normalize(tag - dot(tag, nrm, keepdims=True) * nrm)
    binormal = ctg[:, 0, 3:4] * cross(nrm, tag)
    uv = _bary(cuv, w, u, v)
    m = scn.tri_mat[tri].long()
    base_color = scn.mat_base_color[m][:, :3]
    rough, metal, emissive = scn.mat_roughness[m], scn.mat_metallic[m], scn.mat_emissive[m]
    used = scn.slots_used

    def fetch(idx):
        return sample_texture(scn.tex_rgba, scn.tex_size, idx, uv)

    if used["base"]:
        base_color = base_color * fetch(scn.mat_base_tex[m])[:, :3]
    if used["mr"]:
        mr = fetch(scn.mat_mr_tex[m])
        rough = rough * mr[:, 1]
        metal = metal * mr[:, 2]
    if used["emissive"]:
        emissive = emissive * fetch(scn.mat_emissive_tex[m])[:, :3]
    shading_normal, tangent = nrm, tag
    if used["normal"]:
        normal_tex = scn.mat_normal_tex[m]
        mapped = normalize(fetch(normal_tex)[:, :3] * 2.0 - 1.0)
        mapped_world = normalize(_to_world(mapped, tag, binormal, nrm))
        has = (normal_tex >= 0)[:, None]
        shading_normal = torch.where(has, mapped_world, nrm)
        nt, nb = _coordinate_system(shading_normal)
        tangent = torch.where(has, nt, tag)
        binormal = torch.where(has, nb, binormal)
    return Surface(world_pos, shading_normal, base_color, metal, rough, emissive,
                   tangent, binormal)


class Bsdf(NamedTuple):
    next_dir: torch.Tensor
    weight: torch.Tensor
    emit_plus_nee: torch.Tensor
    is_specular: torch.Tensor
    shadow_dir: torch.Tensor
    light_dist: torch.Tensor
    seed: torch.Tensor


def sample_bsdf(scn, surf: Surface, ray_dir, seed, emit_gate, corr=None) -> Bsdf:
    """Lobe pick, NEE and the sampled direction (rchit:118-218); ``corr``:
    (N, 6) shared draws replacing the lane's six, whose seeds still advance."""
    n_lights = scn.light_pos.shape[0]
    v = normalize(-ray_dir)
    nrm = surf.shading_normal
    emittance = torch.where(emit_gate[:, None], surf.emissive, 0.0)
    ratio = 0.5 * (1.0 - surf.metallic)
    rough_c = torch.clamp(surf.roughness, 0.01, 0.99)
    metal_c = torch.clamp(surf.metallic, 0.01, 0.99)

    seed, r1 = rnd(seed)
    if corr is not None:
        r1 = corr[:, 0]
    is_diffuse = r1 < ratio
    seed_d, r_light = rnd(seed)
    if corr is not None:
        r_light = corr[:, 1]
    light_idx = torch.clamp((r_light * float(n_lights)).to(torch.int32), 0, n_lights - 1).long()
    lpos = scn.light_pos[light_idx]
    ldir = lpos - surf.world_pos
    light_dist = length(ldir)
    l_nee = ldir / torch.clamp_min(light_dist[:, None], 1e-20)
    brdf_nee, li, cos_nee = _direct_light(
        lpos, scn.light_color[light_idx], scn.light_intensity[light_idx],
        scn.light_type[light_idx], surf.world_pos, nrm, v, surf.base_color,
        surf.metallic, surf.roughness)
    nee = torch.where((dot(l_nee, nrm) > 0.0)[:, None],
                      float(n_lights) * brdf_nee * li * cos_nee[:, None], 0.0)
    seed_d, h1 = rnd(seed_d)
    seed_d, h2 = rnd(seed_d)
    if corr is not None:
        h1, h2 = corr[:, 2], corr[:, 3]
    dir_d = normalize(_hemisphere(h1, h2, surf.tangent, surf.binormal, nrm))
    pdf_d = ratio * dot(dir_d, nrm) * M_INV_PI
    brdf_d = (1.0 - metal_c)[:, None] * surf.base_color * M_INV_PI
    weight_d = brdf_d * (dot(dir_d, nrm) / torch.clamp_min(pdf_d, 1e-12))[:, None]

    alpha = rough_c * rough_c
    seed_s, g1 = rnd(seed)
    seed_s, g2 = rnd(seed_s)
    if corr is not None:
        g1, g2 = corr[:, 4], corr[:, 5]
    h = normalize(_to_world(_ggx_half(g1, g2, alpha * alpha), surf.tangent, surf.binormal, nrm))
    dir_s = normalize(reflect(-v, h))
    f0 = 0.04 * (1.0 - metal_c[:, None]) + surf.base_color * metal_c[:, None]
    weight_s = (_specular_over_pdf(nrm, h, v, dir_s, f0, rough_c, ratio)
                * dot(dir_s, nrm)[:, None])
    sel = is_diffuse[:, None]
    return Bsdf(next_dir=torch.where(sel, dir_d, dir_s),
                weight=torch.where(sel, weight_d, weight_s),
                emit_plus_nee=emittance + torch.where(sel, nee, 0.0),
                is_specular=~is_diffuse, shadow_dir=l_nee, light_dist=light_dist,
                seed=torch.where(is_diffuse, seed_d, seed_s))


def clamp_bounds(clamp_weights: bool):
    return (0.0, 50.0) if clamp_weights else (-math.inf, math.inf)
