"""Kernel B: the CUDA shade kernel (``csrc/shade.cu``) and the bounce loop.

Replaces ``vkrt_tpu/ops/pallas/shade.py::_shade_kernel`` (launched by
``shade_call``) and ports ``bounce_chain_packed`` around it. One bounce per
call: apply the previous bounce's deferred NEE given its shadow verdict
(plus the hit-distance bookkeeping at d = 1), rebuild the TBN frame from the
winner's corner attributes, look up the material, pick a light uniformly,
Cook-Torrance NEE x lightsCount, pick the lobe, sample a cosine hemisphere
or a GGX half-vector on separate LCG streams, apply the miss radiance, the
firefly clamp and the throughput clamp, and emit the carry, the next rays
and the shadow rays.

Layout: structure of arrays, one row per column, so neighbouring lanes sit
at neighbouring addresses. The carry is (14, N) f32 (``C_*`` below) plus
the LCG state as its own (N,) int32 tensor; rays are (7, N) rows
[o.xyz | d.xyz | t_lim]; the hit is the trace kernel's (t, tri, u, v). The
TPU kernel read a resolve block interpolated inside the trace kernel; here
the shade kernel gathers the winner's corner attributes by triangle id, and
looks materials and lights up by index, with no table-size caps.

With ``ShadeParams.albedo`` (scenes whose only texture is baseColor) a hit
lane also fetches its base-colour texel itself, bilinear at level 0 of
``tex_rgba`` at the delta-form uv of the winner's corners, and multiplies
it into the material's base colour: the TPU kernel's albedo mode, whose
block ``xla_albedo_block`` fetched outside the kernel. Scenes with other
textures are not shaded here (``kernel_shading_available``).

``shade_plain`` is the kernel's plain version: the same math over (N,)
tensors in the kernel's operation order. ``shade`` is the wrapper: on CUDA
tensors it launches the kernel (or raises); on CPU tensors it runs
``shade_plain``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vkrt_tpu_torch import device as dev
from vkrt_tpu_torch.models.shading import clamp_bounds
from vkrt_tpu_torch.ops.rng import CORR_BLOCK, block_uniform_table, rnd
from vkrt_tpu_torch.ops.texture import sample_texture_plain
from vkrt_tpu_torch.ops.trace import interp_corners
from vkrt_tpu_torch.scene import SceneTensors, scene_base_only_textured, scene_is_textured
from vkrt_tpu_torch.utils.profiling import pass_label

M_PI = 3.14159265358979323846
M_TWO_PI = 2.0 * M_PI
M_INV_PI = 1.0 / M_PI

# carry rows (the JAX carry block's columns 1-14; the seed is its own tensor)
C_CW = 0        # 0-2 cur_weight rgb
C_HV = 3        # 3-5 hit_value rgb
C_ACTIVE = 6    # 0/1
C_SPEC = 7      # 0/1 prd.isSpecular
C_LDIST = 8     # prd.lightDist
C_HD = 9        # hit-distance bookkeeping
C_PEND = 10     # 10-12 pending NEE contribution (awaiting shadow verdict)
C_PSH = 13      # 0/1 pending do_shadow mask
CARRY_COLS = 14
RAY_COLS = 7    # [o.xyz | d.xyz | t_lim]

# pool padding granularity: whole correlated-sampler blocks (pad lanes
# come last, so padding never changes which lanes share a corr row)
POOL_BLOCK = CORR_BLOCK


class ShadeParams(NamedTuple):
    """The per-call scalars of one shade step."""

    d: int
    first: bool
    resolve_hd: bool
    hitdist_weight: float
    hitdist_accumulate: bool
    t_min: float
    t_max: float
    clear: tuple        # clear color rgb
    clamp_lo: float
    clamp_hi: float
    albedo: bool = False  # fetch the baseColor texture (baseColor-only scenes)


class ShadeOut(NamedTuple):
    carry: torch.Tensor        # (14, N) f32
    seed: torch.Tensor         # (N,) int32
    next_rays: torch.Tensor    # (7, N) f32
    shadow_rays: torch.Tensor  # (7, N) f32


def kernel_shading_available(scene: SceneTensors) -> bool:
    """Can kernel B shade this scene? Untextured scenes, and scenes whose
    only texture is baseColor (the albedo instantiation). The JAX gate's
    table caps and tracer test exist for the Pallas kernels and are not
    ported."""
    return not scene_is_textured(scene) or scene_base_only_textured(scene)


def scene_tables(scene: SceneTensors):
    """(M, 8) material rows [base rgb | metallic | roughness | emissive rgb]
    and (L, 8) light rows [pos xyz | color rgb | intensity | type]."""
    mat = torch.cat(
        [scene.mat_base_color[:, :3], scene.mat_metallic[:, None],
         scene.mat_roughness[:, None], scene.mat_emissive],
        dim=1,
    ).float().contiguous()
    light = torch.cat(
        [scene.light_pos, scene.light_color, scene.light_intensity[:, None],
         scene.light_type[:, None].float()],
        dim=1,
    ).float().contiguous()
    return mat, light


# --- the plain version --------------------------------------------------------


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _cross3(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _normalize3(x, y, z, eps=1e-20):
    inv = 1.0 / torch.clamp_min(torch.sqrt(torch.clamp_min(x * x + y * y + z * z, 0.0)), eps)
    return x * inv, y * inv, z * inv


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def _k_direct(rough):
    return (rough + 1.0) * (rough + 1.0) * 0.125


def _g_schlick(nv, k):
    return nv / (nv * (1.0 - k) + k)


def _g_smith(nl_abs, nv_abs, k):
    return _g_schlick(nv_abs, k) * _g_schlick(nl_abs, k)


def shade_plain(carry, seed, rays, hit, sh_tri, scene: SceneTensors,
                mat_tab, light_tab, corr_tab, p: ShadeParams) -> ShadeOut:
    """One shade step over (N,) columns, in the kernel's operation order.

    ``hit``: (t, tri, u, v) of ``rays`` from the trace kernel. ``sh_tri``:
    the previous bounce's shadow-trace triangle ids (None when
    ``p.first``). ``corr_tab``: (G, 8) per-block shared uniforms
    (``ops.rng.block_uniform_table``) or None."""
    n = seed.shape[0]
    n_lights = light_tab.shape[0]

    cwr, cwg, cwb = carry[C_CW], carry[C_CW + 1], carry[C_CW + 2]
    hvr, hvg, hvb = carry[C_HV], carry[C_HV + 1], carry[C_HV + 2]
    active = carry[C_ACTIVE] > 0.0
    is_spec = carry[C_SPEC] > 0.0
    light_dist = carry[C_LDIST]
    hd = carry[C_HD]
    pr, pg, pb = carry[C_PEND], carry[C_PEND + 1], carry[C_PEND + 2]
    pend_sh = carry[C_PSH] > 0.0

    # --- resolve the PREVIOUS bounce's pending NEE (deferred shadow) --------
    if not p.first:
        blocked = (sh_tri >= 0) & pend_sh
        keep = ~blocked
        hvr = hvr + torch.where(keep, pr, 0.0)
        hvg = hvg + torch.where(keep, pg, 0.0)
        hvb = hvb + torch.where(keep, pb, 0.0)
        if p.resolve_hd:
            # prev bounce was depth 1: hit-distance bookkeeping (rgen:103-114)
            hd_new = torch.where(blocked, 0.5 * light_dist, light_dist)
            hd_new = hd_new * p.hitdist_weight
            if p.hitdist_accumulate:
                hd = torch.where(pend_sh, hd + hd_new, hd)
            else:
                hd = torch.where(pend_sh, hd_new, hd)

    # --- this bounce's ray + hit --------------------------------------------
    dx, dy, dz = rays[3], rays[4], rays[5]
    t_hit, tri, hu, hv = hit
    is_hit = tri >= 0
    miss = (~is_hit & active) | ~active
    px = rays[0] + t_hit * dx
    py = rays[1] + t_hit * dy
    pz = rays[2] + t_hit * dz

    # --- the winner's corner attributes (zero on miss lanes) ----------------
    safe = torch.where(is_hit, tri, torch.zeros_like(tri)).long()
    nrm = interp_corners(scene.corner_normal, safe, hu, hv)
    tan = interp_corners(scene.corner_tangent[:, :, :3], safe, hu, hv)
    nrm = torch.where(is_hit[:, None], nrm, 0.0)
    tan = torch.where(is_hit[:, None], tan, 0.0)
    tw = torch.where(is_hit, scene.corner_tangent[safe, 0, 3], 0.0)
    mat = torch.where(is_hit, scene.tri_mat[safe], 0).long()
    if p.albedo:  # hit lanes fetch the baseColor texel; miss lanes stay white
        # by PyTorch gathers on every device: the kernel's fetch shares
        # csrc/texture.cuh with the texture kernel, so that kernel is no check
        uv = interp_corners(scene.corner_uv, safe, hu, hv)
        with pass_label("texture"):
            rgba = sample_texture_plain(scene.tex_rgba, scene.tex_size,
                                        scene.mat_base_tex[mat], uv)
        albedo = torch.where(is_hit[:, None], rgba[:, :3], 1.0)

    # --- surface frame -------------------------------------------------------
    nx, ny, nz = _normalize3(nrm[:, 0], nrm[:, 1], nrm[:, 2])
    tx, ty, tz = _normalize3(tan[:, 0], tan[:, 1], tan[:, 2])
    tn = _dot3(tx, ty, tz, nx, ny, nz)
    tx, ty, tz = _normalize3(tx - tn * nx, ty - tn * ny, tz - tn * nz)
    bx, by, bz = _cross3(nx, ny, nz, tx, ty, tz)
    bx, by, bz = tw * bx, tw * by, tw * bz

    # --- material by index -------------------------------------------------
    m = mat_tab[mat]
    baser, baseg, baseb, metal, rough, emr, emg, emb = m.unbind(1)
    if p.albedo:  # base_color = base_factor * fetch(base_tex)
        baser, baseg, baseb = baser * albedo[:, 0], baseg * albedo[:, 1], baseb * albedo[:, 2]

    # --- sample_bsdf ---------------------------------------------------------
    vx, vy, vz = _normalize3(-dx, -dy, -dz)
    gate = torch.ones_like(is_spec) if p.d == 0 else is_spec
    e_r = torch.where(gate, emr, 0.0)
    e_g = torch.where(gate, emg, 0.0)
    e_b = torch.where(gate, emb, 0.0)

    ratio = 0.5 * (1.0 - metal)
    rough_c = torch.clamp(rough, 0.01, 0.99)
    metal_c = torch.clamp(metal, 0.01, 0.99)

    cu = None
    if corr_tab is not None:
        rows = torch.arange(n, device=seed.device) // CORR_BLOCK
        cu = corr_tab[rows]

    seed0 = seed
    seed1, r1 = rnd(seed0)
    if cu is not None:
        r1 = cu[:, 0]
    is_diffuse = r1 < ratio

    # ---- diffuse branch (light pick + NEE + cosine hemisphere) ----
    seed_d, r_light = rnd(seed1)
    if cu is not None:
        r_light = cu[:, 1]
    lidx = torch.clamp((r_light * float(n_lights)).to(torch.int32), 0, n_lights - 1)
    lpx, lpy, lpz, lcr, lcg_, lcb, lint, ltype = light_tab[lidx.long()].unbind(1)

    ldx, ldy, ldz = lpx - px, lpy - py, lpz - pz
    ldist = torch.sqrt(torch.clamp_min(_dot3(ldx, ldy, ldz, ldx, ldy, ldz), 0.0))
    linv = 1.0 / torch.clamp_min(ldist, 1e-20)
    lx, ly, lz = ldx * linv, ldy * linv, ldz * linv

    hx, hy, hz = _normalize3(lx + vx, ly + vy, lz + vz)
    li_scale = lint * (1.0 / torch.clamp_min(ldist * ldist, 1e-20))
    lir, lig, lib = lcr * li_scale, lcg_ * li_scale, lcb * li_scale
    cos_nee = torch.clamp_min(_dot3(lx, ly, lz, nx, ny, nz), 0.0)

    f0r = baser * metal + 0.04 * (1.0 - metal)
    f0g = baseg * metal + 0.04 * (1.0 - metal)
    f0b = baseb * metal + 0.04 * (1.0 - metal)
    hv_abs = torch.abs(_dot3(hx, hy, hz, vx, vy, vz))
    fres = _pow5(torch.clamp_min(1.0 - hv_abs, 0.0))
    fr = f0r + (1.0 - f0r) * fres
    fg = f0g + (1.0 - f0g) * fres
    fb = f0b + (1.0 - f0b) * fres
    alpha_raw = rough * rough
    a2 = alpha_raw * alpha_raw
    nh = _dot3(nx, ny, nz, hx, hy, hz)
    dterm = nh * nh * (a2 - 1.0) + 1.0
    ndf = a2 * M_INV_PI * (1.0 / (dterm * dterm + 1e-4))
    ndf = torch.where(nh <= 0.0, 0.0, ndf)
    k_raw = _k_direct(rough)
    nv_abs = torch.abs(_dot3(nx, ny, nz, vx, vy, vz))
    nl_abs = torch.abs(_dot3(nx, ny, nz, lx, ly, lz))
    g = _g_smith(nl_abs, nv_abs, k_raw)
    down = 4.0 * nv_abs * nl_abs + 1e-4
    spec_s = ndf * g * (1.0 / down)
    kdr = (1.0 - fr) * (1.0 - metal)
    kdg = (1.0 - fg) * (1.0 - metal)
    kdb = (1.0 - fb) * (1.0 - metal)
    brdfr = kdr * baser * M_INV_PI + spec_s * fr
    brdfg = kdg * baseg * M_INV_PI + spec_s * fg
    brdfb = kdb * baseb * M_INV_PI + spec_s * fb
    nee_gate = (ltype == 0.0) & (cos_nee > 0.0)
    brdfr = torch.where(nee_gate, brdfr, 0.0)
    brdfg = torch.where(nee_gate, brdfg, 0.0)
    brdfb = torch.where(nee_gate, brdfb, 0.0)
    pos_gate = _dot3(lx, ly, lz, nx, ny, nz) > 0.0
    nl_f = float(n_lights)
    neer = torch.where(pos_gate, nl_f * brdfr * lir * cos_nee, 0.0)
    neeg = torch.where(pos_gate, nl_f * brdfg * lig * cos_nee, 0.0)
    neeb = torch.where(pos_gate, nl_f * brdfb * lib * cos_nee, 0.0)

    # cosine hemisphere bounce (random.glsl:35-45) in the (T,B,N) frame
    seed_d, hr1 = rnd(seed_d)
    seed_d, hr2 = rnd(seed_d)
    if cu is not None:
        hr1 = cu[:, 2]
        hr2 = cu[:, 3]
    sq = torch.sqrt(hr1)
    phi = M_TWO_PI * hr2
    cxl = torch.cos(phi) * sq
    cyl = torch.sin(phi) * sq
    czl = torch.sqrt(torch.clamp_min(1.0 - hr1, 0.0))
    ddx = cxl * tx + cyl * bx + czl * nx
    ddy = cxl * ty + cyl * by + czl * ny
    ddz = cxl * tz + cyl * bz + czl * nz
    ddx, ddy, ddz = _normalize3(ddx, ddy, ddz)
    dn = _dot3(ddx, ddy, ddz, nx, ny, nz)
    pdf_d = ratio * dn * M_INV_PI
    wscale = dn * (1.0 / torch.clamp_min(pdf_d, 1e-12))
    wdr = (1.0 - metal_c) * baser * M_INV_PI * wscale
    wdg = (1.0 - metal_c) * baseg * M_INV_PI * wscale
    wdb = (1.0 - metal_c) * baseb * M_INV_PI * wscale

    # ---- specular branch: GGX importance sample (random.glsl:56-70) ----
    alpha_c = rough_c * rough_c
    a2c = alpha_c * alpha_c
    seed_s, g1 = rnd(seed1)
    seed_s, g2 = rnd(seed_s)
    if cu is not None:
        g1 = cu[:, 4]
        g2 = cu[:, 5]
    cos_t = torch.sqrt(torch.clamp_min((1.0 - g2) / ((a2c - 1.0) * g2 + 1.0), 0.0))
    sin_t = torch.clamp(torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0)), 0.0, 1.0)
    gphi = g1 * M_TWO_PI
    hlx = sin_t * torch.cos(gphi)
    hly = sin_t * torch.sin(gphi)
    shx = hlx * tx + hly * bx + cos_t * nx
    shy = hlx * ty + hly * by + cos_t * ny
    shz = hlx * tz + hly * bz + cos_t * nz
    shx, shy, shz = _normalize3(shx, shy, shz)
    hv_dot = _dot3(vx, vy, vz, shx, shy, shz)
    dsx = -vx + 2.0 * hv_dot * shx
    dsy = -vy + 2.0 * hv_dot * shy
    dsz = -vz + 2.0 * hv_dot * shz
    dsx, dsy, dsz = _normalize3(dsx, dsy, dsz)
    f0cr = 0.04 * (1.0 - metal_c) + baser * metal_c
    f0cg = 0.04 * (1.0 - metal_c) + baseg * metal_c
    f0cb = 0.04 * (1.0 - metal_c) + baseb * metal_c
    k_c = _k_direct(rough_c)
    nh_s = _dot3(nx, ny, nz, shx, shy, shz)
    lh_s = _dot3(dsx, dsy, dsz, shx, shy, shz)
    pdf_s = (1.0 - ratio) * nh_s * (1.0 / (4.0 * lh_s + 1e-4))
    nl_s = torch.abs(_dot3(nx, ny, nz, dsx, dsy, dsz))
    g_s = _g_smith(nl_s, nv_abs, k_c)
    hv_s = torch.abs(_dot3(shx, shy, shz, vx, vy, vz))
    fres_s = _pow5(torch.clamp_min(1.0 - hv_s, 0.0))
    fsr = f0cr + (1.0 - f0cr) * fres_s
    fsg = f0cg + (1.0 - f0cg) * fres_s
    fsb = f0cb + (1.0 - f0cb) * fres_s
    down_s = 4.0 * nv_abs * nl_s + 1e-4
    cos_s = _dot3(dsx, dsy, dsz, nx, ny, nz)
    sscale = g_s * (1.0 / (down_s * pdf_s)) * cos_s
    wsr, wsg, wsb = fsr * sscale, fsg * sscale, fsb * sscale

    # ---- lobe select (per-branch RNG streams) ----
    sel = is_diffuse
    ndx = torch.where(sel, ddx, dsx)
    ndy = torch.where(sel, ddy, dsy)
    ndz = torch.where(sel, ddz, dsz)
    bwr = torch.where(sel, wdr, wsr)
    bwg = torch.where(sel, wdg, wsg)
    bwb = torch.where(sel, wdb, wsb)
    epr = e_r + torch.where(sel, neer, 0.0)
    epg = e_g + torch.where(sel, neeg, 0.0)
    epb = e_b + torch.where(sel, neeb, 0.0)
    bs_seed = torch.where(sel, seed_d, seed_s)

    # --- rmiss + bounce-carry update ----------------------------------------
    if p.d == 0:  # clearColor*0.8 on primary (rmiss:15), in f32
        mvr, mvg, mvb = (float(np.float32(c) * np.float32(0.8)) for c in p.clear)
    else:
        mvr = mvg = mvb = 0.01
    hv_this_r = torch.where(miss, mvr, epr)
    hv_this_g = torch.where(miss, mvg, epg)
    hv_this_b = torch.where(miss, mvb, epb)
    spec_this = (miss & is_spec) | (~miss & ~is_diffuse)
    ldist_this = torch.where(miss, light_dist, ldist)
    do_shadow = active & ~miss & ~spec_this
    active_next = active & ~miss

    # pending NEE contribution for THIS bounce (firefly clamp, rgen:101)
    np_r = torch.where(active, torch.clamp_max(hv_this_r * cwr, 10.0), 0.0)
    np_g = torch.where(active, torch.clamp_max(hv_this_g * cwg, 10.0), 0.0)
    np_b = torch.where(active, torch.clamp_max(hv_this_b * cwb, 10.0), 0.0)

    lo, hi = p.clamp_lo, p.clamp_hi
    bwr = torch.clamp_max(torch.clamp_min(bwr, lo), hi)
    bwg = torch.clamp_max(torch.clamp_min(bwg, lo), hi)
    bwb = torch.clamp_max(torch.clamp_min(bwb, lo), hi)
    cwr = cwr * torch.where(miss, 1.0, bwr)
    cwg = cwg * torch.where(miss, 1.0, bwg)
    cwb = cwb * torch.where(miss, 1.0, bwb)
    seed_out = torch.where(miss, seed0, bs_seed)

    # --- next + shadow rays ---------------------------------------------------
    next_rays = torch.stack([
        torch.where(active_next, px, 1e30), torch.where(active_next, py, 1e30),
        torch.where(active_next, pz, 1e30),
        torch.where(active_next, ndx, 0.0), torch.where(active_next, ndy, 0.0),
        torch.where(active_next, ndz, 0.0),
        torch.where(active_next, p.t_max, -1.0),
    ])
    # NEGATIVE limit = the trace kernel's first-hit-kills mode
    sh_lim = torch.where(do_shadow, -torch.clamp_min(ldist_this - 0.1, p.t_min), 0.0)
    shadow_rays = torch.stack([
        px, py, pz,
        torch.where(do_shadow, lx, 0.0), torch.where(do_shadow, ly, 0.0),
        torch.where(do_shadow, lz, 0.0), sh_lim,
    ])
    one = torch.ones_like(px)
    zero = torch.zeros_like(px)
    carry_out = torch.stack([
        cwr, cwg, cwb, hvr, hvg, hvb,
        torch.where(active_next, one, zero), torch.where(spec_this, one, zero),
        ldist_this, hd, np_r, np_g, np_b, torch.where(do_shadow, one, zero),
    ])
    return ShadeOut(carry_out, seed_out, next_rays, shadow_rays)


# --- the kernel wrapper --------------------------------------------------------


def shade(carry, seed, rays, hit, sh_tri, scene: SceneTensors, mat_tab,
          light_tab, corr_tab, p: ShadeParams) -> ShadeOut:
    """One shade step: kernel B on CUDA tensors, ``shade_plain`` on CPU
    tensors. Arguments as ``shade_plain``."""
    if seed.device.type == "cpu":
        return shade_plain(carry, seed, rays, hit, sh_tri, scene, mat_tab,
                           light_tab, corr_tab, p)
    n = seed.shape[0]
    n_tris = scene.tri_mat.shape[0]
    t_hit, tri, hu, hv = hit
    want = [
        ("seed", seed, torch.int32, (n,)),
        ("carry", carry, torch.float32, (CARRY_COLS, n)),
        ("rays", rays, torch.float32, (RAY_COLS, n)),
        ("hit.t", t_hit, torch.float32, (n,)),
        ("hit.tri", tri, torch.int32, (n,)),
        ("hit.u", hu, torch.float32, (n,)),
        ("hit.v", hv, torch.float32, (n,)),
        ("corner_normal", scene.corner_normal, torch.float32, (n_tris, 3, 3)),
        ("corner_tangent", scene.corner_tangent, torch.float32, (n_tris, 3, 4)),
        ("tri_mat", scene.tri_mat, torch.int32, (n_tris,)),
        ("mat_tab", mat_tab, torch.float32, (None, 8)),
        ("light_tab", light_tab, torch.float32, (None, 8)),
    ]
    if not p.first:
        if sh_tri is None:
            raise ValueError("shade: a non-first bounce needs the previous shadow verdicts")
        want.append(("sh_tri", sh_tri, torch.int32, (n,)))
    if corr_tab is not None:
        want.append(("corr_tab", corr_tab, torch.float32,
                     (-(-n // CORR_BLOCK), 8)))
    k_tex, tex_h, tex_w = scene.tex_rgba.shape[:3]
    if p.albedo:
        want += [
            ("corner_uv", scene.corner_uv, torch.float32, (n_tris, 3, 2)),
            ("mat_base_tex", scene.mat_base_tex, torch.int32, (mat_tab.shape[0],)),
            ("tex_rgba", scene.tex_rgba, torch.float32, (k_tex, tex_h, tex_w, 4)),
            ("tex_size", scene.tex_size, torch.int32, (k_tex, 2)),
        ]
    dev.check_args("shade", want)
    if light_tab.shape[0] < 1 or mat_tab.shape[0] < 1:
        raise ValueError("shade: the scene needs at least one material and one light")
    out = ShadeOut(
        torch.empty((CARRY_COLS, n), dtype=torch.float32, device=seed.device),
        torch.empty((n,), dtype=torch.int32, device=seed.device),
        torch.empty((RAY_COLS, n), dtype=torch.float32, device=seed.device),
        torch.empty((RAY_COLS, n), dtype=torch.float32, device=seed.device),
    )
    dev.launch(
        "vkrt_shade", seed.device,
        carry.data_ptr(), seed.data_ptr(), rays.data_ptr(),
        t_hit.data_ptr(), tri.data_ptr(), hu.data_ptr(), hv.data_ptr(),
        None if p.first else sh_tri.data_ptr(),
        scene.corner_normal.data_ptr(), scene.corner_tangent.data_ptr(),
        scene.tri_mat.data_ptr(),
        mat_tab.data_ptr(), light_tab.data_ptr(), light_tab.shape[0],
        None if corr_tab is None else corr_tab.data_ptr(),
        *((scene.corner_uv.data_ptr(), scene.mat_base_tex.data_ptr(),
           scene.tex_rgba.data_ptr(), scene.tex_size.data_ptr()) if p.albedo
          else (None,) * 4),
        tex_h, tex_w,
        n, p.d, int(p.first), int(p.resolve_hd),
        p.hitdist_weight, int(p.hitdist_accumulate), p.t_min, p.t_max,
        *(float(c) for c in p.clear), p.clamp_lo, p.clamp_hi,
        out.carry.data_ptr(), out.seed.data_ptr(),
        out.next_rays.data_ptr(), out.shadow_rays.data_ptr(), lanes=n,
        also=dev.SHADE_ALBEDO if p.albedo else None,
    )
    return out


# --- the bounce loop -------------------------------------------------------------


def _pad(x, total: int):
    """Zero-pad the last dim of x to ``total`` lanes."""
    n = x.shape[-1]
    if n == total:
        return x.contiguous()
    return torch.nn.functional.pad(x, (0, total - n))


def bounce_chain_packed(
    scene: SceneTensors, tracer, carry, *,
    depth: int, start_depth: int, clear_color,
    hitdist_weight: float, hitdist_accumulate: bool, clamp_weights,
    t_min: float, t_max: float, corr_seed=None,
):
    """The bounce loop over SoA blocks (``vkrt_tpu/ops/pallas/shade.py::
    bounce_chain_packed``): pack once at entry, then per bounce a closest
    trace (kernel A), a shade step (kernel B) and, while d < depth - 1, a
    first-hit-kills shadow trace; a final shadow trace, the epilogue and
    the ray counters come last. Returns the BounceCarry contract of
    ``models.pathtracer.bounce_chain``: seed / hit_value / hit_dists /
    active / is_specular / light_dist / cur_weight / ray counters (origin
    and direction keep their entry values)."""
    n = carry.origin.shape[0]
    device = carry.origin.device
    mat_tab, light_tab = scene_tables(scene)
    lo, hi = clamp_bounds(clamp_weights)
    clear = tuple(float(c) for c in clear_color[:3])
    albedo = scene_base_only_textured(scene)

    active0 = carry.active
    rays_main = carry.rays_main + active0.float().sum()
    rays_shadow = carry.rays_shadow
    total = -(-n // POOL_BLOCK) * POOL_BLOCK

    a = active0
    ray_cur = _pad(torch.stack([
        torch.where(a, carry.origin[:, 0], 1e30), torch.where(a, carry.origin[:, 1], 1e30),
        torch.where(a, carry.origin[:, 2], 1e30),
        torch.where(a, carry.direction[:, 0], 0.0), torch.where(a, carry.direction[:, 1], 0.0),
        torch.where(a, carry.direction[:, 2], 0.0),
        torch.where(a, torch.full((n,), t_max, device=device), -1.0),
    ]), total)
    zeros = torch.zeros((n,), dtype=torch.float32, device=device)
    carry_blk = _pad(torch.stack([
        carry.cur_weight[:, 0], carry.cur_weight[:, 1], carry.cur_weight[:, 2],
        carry.hit_value[:, 0], carry.hit_value[:, 1], carry.hit_value[:, 2],
        a.float(), carry.is_specular.float(), carry.light_dist,
        carry.hit_dists, zeros, zeros, zeros, zeros,
    ]), total)
    seed = _pad(carry.seed, total)

    corr = corr_seed is not None
    first = True
    sh_tri = None
    for d in range(start_depth, depth):
        corr_tab = (block_uniform_table(total // CORR_BLOCK, corr_seed, d, device=device)
                    if corr else None)
        hit = tracer.trace_block(ray_cur, t_min)
        p = ShadeParams(
            d=d, first=first, resolve_hd=(not first and d - 1 == 1),
            hitdist_weight=float(hitdist_weight),
            hitdist_accumulate=bool(hitdist_accumulate),
            t_min=float(t_min), t_max=float(t_max), clear=clear,
            clamp_lo=lo, clamp_hi=hi, albedo=albedo,
        )
        carry_blk, seed, next_rays, shadow_rays = shade(
            carry_blk, seed, ray_cur, hit, sh_tri, scene, mat_tab, light_tab,
            corr_tab, p,
        )
        rays_shadow = rays_shadow + carry_blk[C_PSH].sum()
        if d < depth - 1:
            rays_main = rays_main + carry_blk[C_ACTIVE].sum()
            ray_cur = next_rays
            sh_tri = tracer.trace_block(shadow_rays, t_min).tri
        else:
            ray_cur = shadow_rays  # final shadow-only trace
        first = False

    # final shadow verdicts + epilogue
    sh_hit = tracer.trace_block(ray_cur, t_min).tri >= 0
    pend_sh = carry_blk[C_PSH] > 0.0
    blocked = sh_hit & pend_sh
    keep = (~blocked).float()
    hv = carry_blk[C_HV:C_HV + 3] + keep * carry_blk[C_PEND:C_PEND + 3]
    hd = carry_blk[C_HD]
    if depth - 1 == 1:
        ld = carry_blk[C_LDIST]
        hd_new = torch.where(blocked, 0.5 * ld, ld) * hitdist_weight
        if hitdist_accumulate:
            hd = torch.where(pend_sh, hd + hd_new, hd)
        else:
            hd = torch.where(pend_sh, hd_new, hd)

    return carry._replace(
        seed=seed[:n],
        hit_value=hv[:, :n].T,
        hit_dists=hd[:n],
        active=carry_blk[C_ACTIVE, :n] > 0.0,
        is_specular=carry_blk[C_SPEC, :n] > 0.0,
        light_dist=carry_blk[C_LDIST, :n],
        cur_weight=carry_blk[C_CW:C_CW + 3, :n].T,
        rays_main=rays_main,
        rays_shadow=rays_shadow,
    )
