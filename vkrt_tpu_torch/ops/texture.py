"""Texture sampling as batched gathers (port of ``vkrt_tpu/ops/texture.py``).

Bilinear filtering with REPEAT addressing on the scene's stacked, padded
level-0 textures (``tex_rgba``, (K, TH, TW, 4) f32, each image in its own
(w, h) corner, ``tex_size``), and trilinear / 4x anisotropic filtering on
the (K, TH, 2*TW, 4) mip atlas (bf16, cast to f32 after the gather). The
path tracer samples level 0; the mip paths serve the hybrid G-buffer.

Numerics follow the JAX package: the wrap is ``uv - floor(uv)``, the texel
indices wrap with a floor modulo (``torch.remainder``: ``x0 = -1`` wraps to
``w - 1``; ``%`` on negative ints is not used), and the bilinear sum keeps
its term order. Every fetch runs under the "texture" range of
``utils.profiling``.

On the card each ``sample_*`` call is one launch of ``csrc/texture.cu``
(``ops/cuda/texture.py``), held bit for bit to the PyTorch body. That body
is the plain version (``sample_texture_plain``, ``sample_texture_lod_plain``,
``sample_texture_aniso_plain``): every CPU call takes it, and the card's
tests and ``chip_smoke.py`` call it by name.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vkrt_tpu_torch.ops.cuda import texture as tex_cuda
from vkrt_tpu_torch.utils.profiling import labelled

# Anisotropic tap count, read and validated once at import. 4 matches the
# reference sampler's maxAnisotropy (hello_vulkan.cpp:452-454); 2 halves
# the tap fan.
ANISO_TAPS = int(os.environ.get("VKRT_ANISO_TAPS", "4"))
if ANISO_TAPS not in (2, 4):
    raise ValueError(f"VKRT_ANISO_TAPS must be 2 or 4, got {ANISO_TAPS!r}")

MAX_ANISO = 4.0  # the reference sampler's maxAnisotropy


def _gather_texel(tex_flat, k, y, x, th, tw):
    lin = (k.long() * th + y.long()) * tw + x.long()
    # a bf16 atlas is read in bf16 and cast after the gather
    return tex_flat[lin].float()


def _bilinear_at_level(tex_flat, k, th, tw, uv, wi, hi, xoff=None):
    """The bilinear REPEAT fetch at one level of (K*th*tw, 4) texels:
    ``wi``/``hi`` (N,) int level sizes, ``xoff`` the level's x offset in
    the atlas (None: 0, level 0 of ``tex_rgba``)."""
    u = uv[:, 0] - torch.floor(uv[:, 0])  # REPEAT wrap
    v = uv[:, 1] - torch.floor(uv[:, 1])
    fx = u * wi.float() - 0.5
    fy = v * hi.float() - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    ax = (fx - x0)[:, None]
    ay = (fy - y0)[:, None]
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    x0i = torch.remainder(x0, wi)
    x1i = torch.remainder(x0 + 1, wi)
    if xoff is not None:
        x0i = x0i + xoff
        x1i = x1i + xoff
    y0i = torch.remainder(y0, hi)
    y1i = torch.remainder(y0 + 1, hi)
    c00 = _gather_texel(tex_flat, k, y0i, x0i, th, tw)
    c10 = _gather_texel(tex_flat, k, y0i, x1i, th, tw)
    c01 = _gather_texel(tex_flat, k, y1i, x0i, th, tw)
    c11 = _gather_texel(tex_flat, k, y1i, x1i, th, tw)
    return (c00 * (1 - ax) * (1 - ay)
            + c10 * ax * (1 - ay)
            + c01 * (1 - ax) * ay
            + c11 * ax * ay)


@labelled("texture")
def sample_texture(tex_rgba, tex_size, tex_idx, uv):
    """Bilinear REPEAT sample of level 0. ``tex_idx`` (N,) int (-1 =>
    white), ``uv`` (N, 2). Returns (N, 4) RGBA f32. Texel centres at
    half-integer coordinates (GL_LINEAR)."""
    if uv.device.type == "cuda":
        return tex_cuda.level0(tex_rgba, tex_size, tex_idx, uv)
    return sample_texture_plain(tex_rgba, tex_size, tex_idx, uv)


def sample_texture_plain(tex_rgba, tex_size, tex_idx, uv):
    """``sample_texture`` in PyTorch gathers on any device: the plain
    version."""
    k_all, th, tw, _ = tex_rgba.shape
    tex_flat = tex_rgba.reshape(k_all * th * tw, 4)
    k = torch.clamp_min(tex_idx, 0).long()
    size = tex_size[k]  # (N, 2) w, h
    c = _bilinear_at_level(tex_flat, k, th, tw, uv, size[:, 0], size[:, 1])
    return torch.where((tex_idx >= 0)[:, None], c, 1.0)


@labelled("texture")
def sample_texture_lod(atlas, level_size, level_off, n_levels, tex_idx, uv, lod):
    """Trilinear mip sample (GL_LINEAR_MIPMAP_LINEAR). ``tex_idx`` (N,)
    (-1 => white), ``uv`` (N, 2), ``lod`` (N,) continuous level of detail.
    Returns (N, 4)."""
    if uv.device.type == "cuda":
        return tex_cuda.trilinear(atlas, level_size, level_off, n_levels, tex_idx, uv, lod)
    return sample_texture_lod_plain(atlas, level_size, level_off, n_levels, tex_idx, uv, lod)


def sample_texture_lod_plain(atlas, level_size, level_off, n_levels, tex_idx, uv, lod):
    """``sample_texture_lod`` in PyTorch gathers on any device: the plain
    version."""
    k_all, th, tw2, _ = atlas.shape
    tex_flat = atlas.reshape(k_all * th * tw2, 4)
    k = torch.clamp_min(tex_idx, 0).long()
    max_l = (n_levels[k] - 1).float()
    lod_c = torch.minimum(torch.maximum(lod, torch.zeros_like(lod)), max_l)
    l0 = torch.floor(lod_c).to(torch.int32)
    l1 = torch.minimum(l0 + 1, max_l.to(torch.int32))
    frac = (lod_c - l0.float())[:, None]

    def level(li):
        li = li.long()
        sz = level_size[k, li]
        off = level_off[k, li]
        return _bilinear_at_level(tex_flat, k, th, tw2, uv, sz[:, 0], sz[:, 1], off)

    c = level(l0) * (1 - frac) + level(l1) * frac
    return torch.where((tex_idx >= 0)[:, None], c, 1.0)


def _footprint(level_size, tex_idx, ddx_uv, ddy_uv):
    """Level-0 texel footprints of the two screen axes: (px, py)."""
    k = torch.clamp_min(tex_idx, 0).long()
    sz0 = level_size[k, 0].float()  # (N, 2) level-0 (w, h)
    a = ddx_uv * sz0
    b = ddy_uv * sz0
    px = torch.sqrt(a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1])
    py = torch.sqrt(b[:, 0] * b[:, 0] + b[:, 1] * b[:, 1])
    return px, py


def _minor_lod(px, py):
    pmax = torch.maximum(px, py)
    pmin = torch.minimum(px, py)
    pmin_eff = torch.clamp_min(torch.maximum(pmin, pmax / MAX_ANISO), 1e-9)
    return torch.log2(pmin_eff)


def aniso_minor_lod(level_size, tex_idx, ddx_uv, ddy_uv):
    """The minor-footprint-axis mip level (clamped so major/minor never
    exceeds MAX_ANISO): the level the anisotropic taps sample at."""
    return _minor_lod(*_footprint(level_size, tex_idx, ddx_uv, ddy_uv))


@labelled("texture")
def sample_texture_aniso(atlas, level_size, level_off, n_levels, tex_idx, uv,
                         ddx_uv, ddy_uv, taps=None):
    """4x anisotropic trilinear sample from screen-space UV derivatives
    (``ddx_uv``/``ddy_uv``: (N, 2) UV change per pixel step): the level
    from the minor axis, ``taps`` trilinear taps along the major axis."""
    if taps is None:
        taps = ANISO_TAPS
    if uv.device.type == "cuda":
        return tex_cuda.aniso(atlas, level_size, level_off, n_levels, tex_idx, uv, ddx_uv,
                              ddy_uv, taps)
    return sample_texture_aniso_plain(atlas, level_size, level_off, n_levels, tex_idx, uv,
                                      ddx_uv, ddy_uv, taps)


def sample_texture_aniso_plain(atlas, level_size, level_off, n_levels, tex_idx, uv,
                               ddx_uv, ddy_uv, taps=None):
    """``sample_texture_aniso`` in PyTorch gathers on any device: the plain
    version."""
    px, py = _footprint(level_size, tex_idx, ddx_uv, ddy_uv)
    lod = _minor_lod(px, py)
    major = torch.where((px >= py)[:, None], ddx_uv, ddy_uv)
    if taps is None:
        taps = ANISO_TAPS
    offsets = {2: (-0.25, 0.25), 4: (-0.375, -0.125, 0.125, 0.375)}[taps]
    acc = 0.0
    for s in offsets:
        acc = acc + sample_texture_lod_plain(atlas, level_size, level_off, n_levels,
                                             tex_idx, uv + major * s, lod)
    return acc / len(offsets)


def build_mip_pyramid(image: np.ndarray):
    """Full mip chain by 2x2 box filter (hello_vulkan.cpp:499), host-side
    numpy: level 0 .. 1x1."""
    levels = [np.asarray(image, np.float32)]
    cur = levels[0]
    while max(cur.shape[0], cur.shape[1]) > 1:
        nxt = cur
        if nxt.shape[0] > 1:
            h = nxt.shape[0] // 2
            nxt = 0.5 * (nxt[0 : 2 * h : 2] + nxt[1 : 2 * h : 2])
        if nxt.shape[1] > 1:
            w = nxt.shape[1] // 2
            nxt = 0.5 * (nxt[:, 0 : 2 * w : 2] + nxt[:, 1 : 2 * w : 2])
        levels.append(nxt.astype(np.float32))
        cur = nxt
    return levels


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """Piecewise sRGB EOTF (what R8G8B8A8_SRGB sampling does in hardware)."""
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(
        np.float32
    )


def pack_mip_atlas(images, srgb_flags=None):
    """Per-image mip pyramids side by side in one (K, TH, 2*TW, 4) atlas:
    level l of a WxH image at x-offset W*(2 - 2^(1-l)). Returns (atlas f32
    linear, level_size (K, L, 2) i32 (w, h), level_off (K, L) i32, n_levels
    (K,) i32); levels past an image's last repeat its last."""
    k = len(images)
    th = max(im.shape[0] for im in images)
    tw = max(im.shape[1] for im in images)
    lmax = max(1, int(np.ceil(np.log2(max(th, tw)))) + 1)
    atlas = np.zeros((k, th, 2 * tw, 4), np.float32)
    level_size = np.zeros((k, lmax, 2), np.int32)
    level_off = np.zeros((k, lmax), np.int32)
    n_levels = np.zeros(k, np.int32)
    for i, im in enumerate(images):
        f = im.astype(np.float32) / 255.0
        if srgb_flags is not None and srgb_flags[i]:
            f = np.concatenate([srgb_to_linear(f[..., :3]), f[..., 3:]], axis=-1)
        levels = build_mip_pyramid(f)
        n_levels[i] = len(levels)
        x = 0
        for lv, lev in enumerate(levels[:lmax]):
            h, w = lev.shape[:2]
            atlas[i, :h, x : x + w] = lev
            level_size[i, lv] = (w, h)
            level_off[i, lv] = x
            x += w
        for lv in range(len(levels), lmax):
            level_size[i, lv] = level_size[i, len(levels) - 1]
            level_off[i, lv] = level_off[i, len(levels) - 1]
    return atlas, level_size, level_off, n_levels
