"""The plain hybrid frame at chosen pixels: the G-buffer pass, shadows, AO
and one-path GI, the accumulation of the RT buffer and the composite.

A frozen copy of the port's plain path (commit 400863e):
``vkrt_tpu_torch/models/gbuffer.py`` (pixel-centre primaries, ray-
differential UV gradients, 4x anisotropic trilinear fetches, the all-lights
direct PBR sum), ``ops/texture.py`` (``build_mip_pyramid``,
``pack_mip_atlas`` stored in bfloat16 and read back as f32,
``sample_texture_lod``, ``sample_texture_aniso``, ``aniso_minor_lod``),
``models/hybrid.py::hybrid_effects`` (the shared-draw keys 64, 65-68 and
72, visibility from t 0.1, the GI lobe and the chain from depth 1) and
``models/post.py::composite``; where the cell's engine alpha-tests, every
trace goes through ``reference/alpha.py``. The G-buffer does not depend on
the frame, so it is computed once a pixel; the effects run on (frame,
pixel) lanes.
For the denoiser (``reference/denoise.py``), ``effects_gi`` also returns
the GI radiance and its hit distance, and ``denoiser_inputs`` packs them
with the G-buffer's normal, depth and position as ``models/hybrid.py``
hands them to ``models/denoiser.py`` (commit 3c30f64).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from framebench.reference import denoise as ref_dn
from framebench.reference import render
from framebench.reference import shade as sh
from framebench.reference.bvh import T_MAX, T_MIN
from framebench.reference.scene import _srgb_to_linear

AO_SAMPLES = 4
RTAO_RADIUS = 2.0
SHADOW_T_MIN = 0.1
KEY_SHADOW, KEY_AO, KEY_GI = 64, 65, 72
MAX_ANISO = 4.0
ANISO_OFFSETS = (-0.375, -0.125, 0.125, 0.375)


class Atlas(NamedTuple):
    texels: torch.Tensor      # (K*TH*2TW, 4) in its storage dtype
    th: int
    tw2: int
    level_size: torch.Tensor  # (K, L, 2) int32 (w, h)
    level_off: torch.Tensor   # (K, L) int32
    n_levels: torch.Tensor    # (K,) int32


def _pyramid(image):
    levels = [np.asarray(image, np.float32)]
    cur = levels[0]
    while max(cur.shape[0], cur.shape[1]) > 1:
        nxt = cur
        if nxt.shape[0] > 1:
            h = nxt.shape[0] // 2
            nxt = 0.5 * (nxt[0:2 * h:2] + nxt[1:2 * h:2])
        if nxt.shape[1] > 1:
            w = nxt.shape[1] // 2
            nxt = 0.5 * (nxt[:, 0:2 * w:2] + nxt[:, 1:2 * w:2])
        levels.append(nxt.astype(np.float32))
        cur = nxt
    return levels


def build_atlas(inp, device, store=torch.bfloat16) -> Atlas:
    """Each image's mip chain side by side (level l at x offset
    W*(2 - 2^(1-l))), levels past an image's last repeating its last."""
    k = len(inp.images)
    th = max(im.shape[0] for im in inp.images)
    tw = max(im.shape[1] for im in inp.images)
    lmax = max(1, int(np.ceil(np.log2(max(th, tw)))) + 1)
    atlas = np.zeros((k, th, 2 * tw, 4), np.float32)
    size = np.zeros((k, lmax, 2), np.int32)
    off = np.zeros((k, lmax), np.int32)
    n_levels = np.zeros(k, np.int32)
    for i, im in enumerate(inp.images):
        f = im.astype(np.float32) / 255.0
        if inp.srgb[i]:
            f = np.concatenate([_srgb_to_linear(f[..., :3]), f[..., 3:]], axis=-1)
        levels = _pyramid(f)
        n_levels[i] = len(levels)
        x = 0
        for lv, lev in enumerate(levels[:lmax]):
            h, w = lev.shape[:2]
            atlas[i, :h, x:x + w] = lev
            size[i, lv] = (w, h)
            off[i, lv] = x
            x += w
        for lv in range(len(levels), lmax):
            size[i, lv] = size[i, len(levels) - 1]
            off[i, lv] = off[i, len(levels) - 1]
    t = torch.tensor(atlas, device=device).to(store)
    return Atlas(t.reshape(-1, 4), th, 2 * tw, torch.tensor(size, device=device),
                 torch.tensor(off, device=device), torch.tensor(n_levels, device=device))


def _bilinear(at: Atlas, k, uv, wi, hi, xoff, dt):
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    fx = u * wi.to(dt) - 0.5
    fy = v * hi.to(dt) - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    ax, ay = (fx - x0)[:, None], (fy - y0)[:, None]
    x0, y0 = x0.to(torch.int32), y0.to(torch.int32)
    x0i, x1i = torch.remainder(x0, wi) + xoff, torch.remainder(x0 + 1, wi) + xoff
    y0i, y1i = torch.remainder(y0, hi), torch.remainder(y0 + 1, hi)

    def texel(y, x):
        return at.texels[(k * at.th + y.long()) * at.tw2 + x.long()].to(dt)

    return (texel(y0i, x0i) * (1 - ax) * (1 - ay) + texel(y0i, x1i) * ax * (1 - ay)
            + texel(y1i, x0i) * (1 - ax) * ay + texel(y1i, x1i) * ax * ay)


def _lod_fetch(at: Atlas, tex_idx, uv, lod):
    dt = uv.dtype
    k = torch.clamp_min(tex_idx, 0).long()
    max_l = (at.n_levels[k] - 1).to(dt)
    lod_c = torch.minimum(torch.maximum(lod, torch.zeros_like(lod)), max_l)
    l0 = torch.floor(lod_c).to(torch.int32)
    l1 = torch.minimum(l0 + 1, max_l.to(torch.int32))
    frac = (lod_c - l0.to(dt))[:, None]

    def level(li):
        sz, off = at.level_size[k, li.long()], at.level_off[k, li.long()]
        return _bilinear(at, k, uv, sz[:, 0], sz[:, 1], off, dt)

    c = level(l0) * (1 - frac) + level(l1) * frac
    return torch.where((tex_idx >= 0)[:, None], c, 1.0)


def _footprint(at: Atlas, tex_idx, ddx, ddy):
    sz0 = at.level_size[torch.clamp_min(tex_idx, 0).long(), 0].to(ddx.dtype)
    a, b = ddx * sz0, ddy * sz0
    return (torch.sqrt(a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1]),
            torch.sqrt(b[:, 0] * b[:, 0] + b[:, 1] * b[:, 1]))


def _minor_lod(px, py):
    pmax, pmin = torch.maximum(px, py), torch.minimum(px, py)
    return torch.log2(torch.clamp_min(torch.maximum(pmin, pmax / MAX_ANISO), 1e-9))


def _aniso_fetch(at: Atlas, tex_idx, uv, ddx, ddy):
    px, py = _footprint(at, tex_idx, ddx, ddy)
    lod = _minor_lod(px, py)
    major = torch.where((px >= py)[:, None], ddx, ddy)
    acc = 0.0
    for s in ANISO_OFFSETS:
        acc = acc + _lod_fetch(at, tex_idx, uv + major * s, lod)
    return acc / len(ANISO_OFFSETS)


def _uv_grads(scn, cam, width, height, pix, direction, hits):
    vi, pi = cam
    rot = vi[:3, :3]

    def rot_mul(v):
        return rot[:, 0] * v[0] + rot[:, 1] * v[1] + rot[:, 2] * v[2]

    ax = rot_mul(pi[:3, 0] * (2.0 / float(width)))
    ay = rot_mul(pi[:3, 1] * (2.0 / float(height)))
    dndc = ((pix + 0.5) / torch.tensor([width, height], dtype=torch.float32, device=pix.device)
            * 2.0 - 1.0)
    t3 = torch.stack([pi[r, 0] * dndc[:, 0] + pi[r, 1] * dndc[:, 1] + pi[r, 2] + pi[r, 3]
                      for r in range(3)], dim=-1)
    inv_tlen = 1.0 / torch.clamp_min(sh.length(t3), 1e-20)
    tri = torch.clamp_min(hits.tri, 0).long()
    e1, e2, cuv = scn.tri_e1[tri], scn.tri_e2[tri], scn.corner_uv[tri]
    ng = sh.cross(e1, e2)
    denom = sh.dot(ng, direction)
    safe = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    a, b, c = sh.dot(e1, e1), sh.dot(e1, e2), sh.dot(e2, e2)
    inv_det = 1.0 / torch.clamp_min(a * c - b * b, 1e-20)
    duv1, duv2 = cuv[:, 1] - cuv[:, 0], cuv[:, 2] - cuv[:, 0]

    def deriv(axis):
        dd = (axis[None, :] - direction * sh.dot(direction, axis[None, :], keepdims=True)
              ) * inv_tlen[:, None]
        dp = hits.t[:, None] * (dd - direction * (sh.dot(ng, dd) / safe)[:, None])
        p, q = sh.dot(e1, dp), sh.dot(e2, dp)
        return (duv1 * ((c * p - b * q) * inv_det)[:, None]
                + duv2 * ((a * q - b * p) * inv_det)[:, None])

    return deriv(ax), deriv(ay)


class GBuffer(NamedTuple):
    color: torch.Tensor      # (K, 3) direct light, or the clear colour on a miss
    position: torch.Tensor   # (K, 3), 0 on a miss
    normal: torch.Tensor     # (K, 3), 0 on a miss
    albedo: torch.Tensor     # (K, 3)
    roughness: torch.Tensor
    metalness: torch.Tensor


def gbuffer(scn, walk, atlas: Atlas, cam, width, height, pid, clear_color,
            alpha=None) -> GBuffer:
    """The G-buffer rows of scanline pixels ``pid``. ``alpha``: a
    ``reference.alpha.Tracer`` in the walk's place; the engine hands this
    trace no seeds, so a lane's seed is its index in the engine's pool, the
    whole frame in tile order: the pixel's tile position."""
    dt = scn.tri_v0.dtype
    n = pid.shape[0]
    pix = torch.stack([pid % width, pid // width], dim=-1).to(torch.float32)
    origin, direction = render.generate_rays(
        cam, width, height, torch.full((n, 2), 0.5, dtype=dt, device=pid.device), pix)
    lim = torch.full((n,), T_MAX, dtype=dt, device=pid.device)
    if alpha is None:
        hits = walk.closest(origin, direction, lim)
    else:
        hits = alpha.closest(origin, direction, lim, render.tile_position(pid, width, height))
    u, v = hits.u.to(dt), hits.v.to(dt)
    tri = torch.clamp_min(hits.tri, 0)
    used = scn.slots_used
    ddx, ddy = _uv_grads(scn, cam, width, height, pix, direction, hits)

    # surface_at_hit with uv_grads: colour slots anisotropic, data slots at
    # the minor axis's level
    t = tri.long()
    w = 1.0 - u - v
    cn, ctg, cuv = scn.corner_normal[t], scn.corner_tangent[t], scn.corner_uv[t]
    pos = scn.tri_v0[t] + u[:, None] * scn.tri_e1[t] + v[:, None] * scn.tri_e2[t]
    nrm = sh.normalize(sh._bary(cn, w, u, v))
    tag = sh.normalize(sh._bary(ctg[..., :3], w, u, v))
    tag = sh.normalize(tag - sh.dot(tag, nrm, keepdims=True) * nrm)
    binormal = ctg[:, 0, 3:4] * sh.cross(nrm, tag)
    uv = sh._bary(cuv, w, u, v)
    m = scn.tri_mat[t].long()
    base = scn.mat_base_color[m][:, :3]
    rough, metal, emis = scn.mat_roughness[m], scn.mat_metallic[m], scn.mat_emissive[m]

    def data(idx):
        return _lod_fetch(atlas, idx, uv, _minor_lod(*_footprint(atlas, idx, ddx, ddy)))

    if used["base"]:
        base = base * _aniso_fetch(atlas, scn.mat_base_tex[m], uv, ddx, ddy)[:, :3]
    if used["mr"]:
        mr = data(scn.mat_mr_tex[m])
        rough, metal = rough * mr[:, 1], metal * mr[:, 2]
    if used["emissive"]:
        emis = emis * _aniso_fetch(atlas, scn.mat_emissive_tex[m], uv, ddx, ddy)[:, :3]
    shading = nrm
    if used["normal"]:
        nt = scn.mat_normal_tex[m]
        mapped = sh.normalize(data(nt)[:, :3] * 2.0 - 1.0)
        shading = torch.where((nt >= 0)[:, None],
                              sh.normalize(sh._to_world(mapped, tag, binormal, nrm)), nrm)

    view = sh.normalize(-direction)
    direct = torch.zeros_like(pos)
    for i in range(scn.light_pos.shape[0]):  # frag_shader.frag:193-213, point lights
        ldir = scn.light_pos[i] - pos
        dist = sh.length(ldir, keepdims=True)
        li = scn.light_color[i] * scn.light_intensity[i] / torch.clamp_min(dist * dist, 1e-20)
        l = ldir / torch.clamp_min(dist, 1e-20)
        if int(scn.light_type[i]) != 0:
            l = sh.normalize(scn.light_pos[i]).expand(pos.shape)
            li = (scn.light_color[i] * scn.light_intensity[i]).expand(pos.shape)
        h = sh.normalize(l + view)
        cos_t = torch.clamp_min(sh.dot(l, shading), 0.0)
        contrib = sh._pbr_brdf(shading, view, l, h, base, metal, rough) * li * cos_t[:, None]
        direct = direct + torch.where((cos_t > 0.0)[:, None], contrib, 0.0)
    miss = ~hits.hit[:, None]
    clear3 = torch.tensor([float(c) for c in clear_color[:3]], dtype=dt, device=pid.device)
    return GBuffer(color=torch.where(miss, clear3, emis + direct),
                   position=torch.where(miss, 0.0, pos),
                   normal=torch.where(miss, 0.0, shading),
                   albedo=torch.where(miss, 0.0, (1.0 - metal)[:, None] * base),
                   roughness=torch.where(miss[:, 0], 0.0, rough),
                   metalness=torch.where(miss[:, 0], 0.0, metal))


def effects(scn, walk, g: GBuffer, cam, width, height, pid, frame, *, depth: int, corr: bool,
            use_shadows=True, use_ao=True, use_gi=True, clamp_weights=False, alpha=None):
    """(N, 4) RT colour of (pixel, frame) lanes; ``g`` holds the lanes'
    G-buffer rows."""
    return effects_gi(scn, walk, g, cam, width, height, pid, frame, depth=depth, corr=corr,
                      use_shadows=use_shadows, use_ao=use_ao, use_gi=use_gi,
                      clamp_weights=clamp_weights, alpha=alpha)[0]


def effects_gi(scn, walk, g: GBuffer, cam, width, height, pid, frame, *, depth: int,
               corr: bool, use_shadows=True, use_ao=True, use_gi=True, clamp_weights=False,
               alpha=None):
    """``effects`` and what the denoiser takes of them: (RT colour (N, 4),
    GI radiance (N, 3), 0 off the G-buffer, GI hit distance (N,)).
    ``alpha``: a ``reference.alpha.Tracer`` in the walk's place: the
    visibility pool traces with the seeds after the shadow and AO draws
    under positive limits, the GI chain with its own (``render.bounce_loop``)."""
    dt = scn.tri_v0.dtype
    n = pid.shape[0]
    n_lights = scn.light_pos.shape[0]
    seed = sh.tea(pid, frame)
    block = render.tile_position(pid, width, height) // sh.CORR_BLOCK
    cseed = (frame * 0x9E3779B9) & sh.MASK32

    def table(key):
        return sh.corr_lane_draws(block, cseed, key).to(dt)

    pos, nrm = g.position, g.normal
    shaded = ~((pos == 0.0).all(dim=-1) & (nrm == 0.0).all(dim=-1))
    color_a = torch.ones(n, dtype=dt, device=pid.device)
    dirs, lims = [], []
    if use_shadows:
        seed, r = sh.rnd(seed)
        if corr:
            r = table(KEY_SHADOW)[:, 1]
        li = torch.clamp((r * float(n_lights)).to(torch.int32), 0, n_lights - 1).long()
        ldir = scn.light_pos[li] - pos
        ldist = sh.length(ldir)
        l = ldir / torch.clamp_min(ldist[:, None], 1e-20)
        facing = sh.dot(l, nrm) >= 0.0
        do_trace = shaded & facing
        dirs.append(torch.where(do_trace[:, None], l, 0.0))
        lims.append(torch.where(do_trace, torch.clamp_min(ldist - SHADOW_T_MIN, SHADOW_T_MIN),
                                0.0))
    if use_ao:
        tangent, binormal = sh._coordinate_system(nrm)
        for i in range(AO_SAMPLES):
            seed, r1 = sh.rnd(seed)
            seed, r2 = sh.rnd(seed)
            if corr:
                t = table(KEY_AO + i)
                r1, r2 = t[:, 2], t[:, 3]
            d = sh._hemisphere(r1, r2, tangent, binormal, nrm)
            dirs.append(torch.where(shaded[:, None], sh.normalize(d), 0.0))
            lims.append(torch.where(shaded, RTAO_RADIUS, 0.0))
    if dirs:
        k = len(dirs)
        if alpha is None:
            hits = walk.closest(pos.repeat(k, 1), torch.cat(dirs), -torch.cat(lims).to(dt),
                                t_min=SHADOW_T_MIN).hit.reshape(k, n)
        else:
            hits = alpha.closest(pos.repeat(k, 1), torch.cat(dirs), torch.cat(lims).to(dt), seed,
                                 t_min=SHADOW_T_MIN).hit.reshape(k, n)
        seg = 0
        if use_shadows:
            vis = torch.clamp_min(torch.where(facing & ~(hits[0] & do_trace), 1.0, 0.0), 0.01)
            color_a = torch.where(shaded, color_a * vis.to(dt), color_a)
            seg = 1
        if use_ao:
            ao = torch.where(hits[seg:seg + AO_SAMPLES] & shaded[None, :], 1.0 / AO_SAMPLES,
                             0.0).sum(dim=0).to(dt)
            color_a = torch.where(shaded, color_a * (1.0 - ao), color_a)
    color_rgb = torch.zeros((n, 3), dtype=dt, device=pid.device)
    hit_dist = torch.zeros(n, dtype=dt, device=pid.device)
    if use_gi:
        ratio = g.metalness * (1.0 - g.roughness)
        is_diffuse = ratio < 0.8
        tangent, binormal = sh._coordinate_system(nrm)
        seed_d, r1 = sh.rnd(seed)
        seed_d, r2 = sh.rnd(seed_d)
        if corr:
            t = table(KEY_GI)
            r1, r2 = t[:, 2], t[:, 3]
        dir_d = sh.normalize(sh._hemisphere(r1, r2, tangent, binormal, nrm))
        eye = cam[0][:3, 3]
        dir_s = sh.normalize(sh.reflect(-sh.normalize(eye - pos), nrm))
        gi, hit_dist = render.bounce_loop(
            scn, walk, pos, torch.where(is_diffuse[:, None], dir_d, dir_s),
            torch.where(is_diffuse, seed_d, seed),
            torch.where(is_diffuse[:, None], g.albedo, 1.0), shaded, ~is_diffuse,
            depth=depth, start_depth=1, block=block, cseed=cseed, corr=corr,
            clear_color=(0.0, 0.0, 0.0, 0.0), clamp_weights=clamp_weights, hit_dist=True,
            alpha=alpha)
        color_rgb = torch.where(shaded[:, None], gi, 0.0)
    color = torch.cat([color_rgb, color_a[:, None]], dim=-1)
    background = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dt, device=pid.device)
    return torch.where(shaded[:, None], color, background), color_rgb, hit_dist


def view_matrices(eye, center, fov_deg, width, height, device, dtype=torch.float32):
    """(view, view_proj) of a pose, rounded to f32 and carried in ``dtype``:
    the G-buffer's depth and the reprojection's projection."""
    view = render.look_at(eye, center, (0.0, 1.0, 0.0))
    proj = render.perspective_vk(fov_deg, width / float(height))

    def t(m):
        return torch.tensor(np.asarray(m, np.float32), device=device).to(dtype)

    return t(view), t(proj @ view)


class DenoiserInputs(NamedTuple):
    """What the hybrid frame hands its denoiser, one row a pixel."""
    diff_rad_hitd: torch.Tensor  # (K, 4) packed GI radiance (YCoCg) and hit distance
    norm_rough: torch.Tensor     # (K, 4) packed normal, roughness, material slot
    view_z: torch.Tensor         # (K,) depth in the view, 0 off the G-buffer
    world_pos: torch.Tensor      # (K, 3) the G-buffer's position, 0 off it


def denoiser_inputs(g: GBuffer, gi, hit_dist, view) -> DenoiserInputs:
    """The denoiser's inputs from the G-buffer rows ``g`` and the GI of
    ``effects_gi`` (models/hybrid.py, models/gbuffer.py: the NRD packing of
    the GI radiance with its normalised hit distance and of the shading
    normal with the roughness). The material slot packs 0: the denoiser
    reads only the normal of that packing."""
    pos = g.position
    miss = (pos == 0.0).all(dim=-1) & (g.normal == 0.0).all(dim=-1)
    vz = view[2, 0] * pos[:, 0] + view[2, 1] * pos[:, 1] + view[2, 2] * pos[:, 2] + view[2, 3]
    view_z = torch.where(miss, 0.0, vz)
    packed = ref_dn.pack_normal_roughness(g.normal, g.roughness, torch.zeros_like(g.roughness))
    nh = ref_dn.norm_hit_dist(hit_dist, view_z, g.roughness)
    return DenoiserInputs(ref_dn.pack_radiance(gi, nh),
                          torch.where(miss[:, None], 0.0, packed), view_z, pos)


def composite(raster_rgb, accum_rt):
    """``models/post.py::composite`` in hybrid mode, view_accumulated off."""
    return raster_rgb * accum_rt[:, 3:4] + accum_rt[:, :3]
