"""The texel fetch's CUDA kernel (``csrc/texture.cu``): one launch a
``sample_*`` call of ``ops/texture.py``, one thread a lane.

``ops/texture.py`` dispatches here for every call on the card; its
PyTorch body is the plain version these are held to bit for bit
(``tests/test_torch_texture_gpu.py``). The per-lane inputs must be
contiguous (every caller's are) and the host integers (N, the padded
height and row width, the level count, the taps) are launch scalars, so a
call uploads nothing and does not synchronise. ``device.check_args``
checks every dtype before the device, so a wrong dtype is refused on the
CPU too.
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch import device as dev

_INDEX = (torch.int32, torch.int64)
_ATLAS = (torch.bfloat16, torch.float32)


def _check(sampler, tables, tex_idx, uv, **more):
    """Check a sampler's tables (``device.check_args`` entries, the
    (K, TH, W, 4) texel table first) and each lane's inputs (N index,
    (N, 2) f32 uv, ``more``: name -> (f32 tensor, trailing shape)), all
    contiguous on one CUDA device. Returns (N, device)."""
    what = f"texture {sampler}"
    n = tex_idx.shape[0] if tex_idx.ndim == 1 else -1
    device = dev.check_args(what, [
        ("tex_idx", tex_idx, _INDEX, (n,)), ("uv", uv, torch.float32, (n, 2)),
        *((name, t, torch.float32, (n, *tail)) for name, (t, tail) in more.items()), *tables])
    tex = tables[0][1]
    if tex.data_ptr() % (4 * tex.element_size()):
        raise ValueError(f"{what}: the texel table is not aligned to its texels")
    if n >= 2**31:
        raise ValueError(f"{what}: {n} lanes, at most 2^31 - 1")
    return n, device


def _mip(atlas, level_size, level_off, n_levels):
    """``_check``'s entries of a mip atlas and its level tables, and the
    tables' level count."""
    k, levels = level_off.shape if level_off.ndim == 2 else (-1, -1)
    return [("atlas", atlas, _ATLAS, (k, None, None, 4)),
            ("level_size", level_size, torch.int32, (k, levels, 2)),
            ("level_off", level_off, torch.int32, (k, levels)),
            ("n_levels", n_levels, torch.int32, (k,))], levels


def _index(t):
    return t.data_ptr(), int(t.dtype == torch.int64)


def level0(tex_rgba, tex_size, tex_idx, uv) -> torch.Tensor:
    """``sample_texture`` on the card: bilinear REPEAT of the (K, TH, TW, 4)
    f32 level 0 at (N, 2) ``uv``, index -1 white. Returns (N, 4) f32."""
    k = tex_size.shape[0] if tex_size.ndim == 2 else -1
    n, device = _check("level0", [("texels", tex_rgba, torch.float32, (k, None, None, 4)),
                                  ("tex_size", tex_size, torch.int32, (k, 2))], tex_idx, uv)
    out = torch.empty((n, 4), dtype=torch.float32, device=device)
    _, th, tw, _ = tex_rgba.shape
    if n:
        dev.launch("vkrt_tex_level0", device, tex_rgba.data_ptr(), tex_size.data_ptr(), th, tw,
                   *_index(tex_idx), uv.data_ptr(), n, out.data_ptr(), lanes=n)
    return out


def trilinear(atlas, level_size, level_off, n_levels, tex_idx, uv, lod) -> torch.Tensor:
    """``sample_texture_lod`` on the card: trilinear from the (K, TH, 2TW, 4)
    bf16 or f32 mip atlas at (N,) ``lod``. Returns (N, 4) f32."""
    tables, levels = _mip(atlas, level_size, level_off, n_levels)
    n, device = _check("trilinear", tables, tex_idx, uv, lod=(lod, ()))
    out = torch.empty((n, 4), dtype=torch.float32, device=device)
    _, th, pitch, _ = atlas.shape
    if n:
        dev.launch("vkrt_tex_lod", device, atlas.data_ptr(), int(atlas.dtype == torch.bfloat16),
                   level_size.data_ptr(), level_off.data_ptr(), n_levels.data_ptr(), levels,
                   th, pitch, *_index(tex_idx), uv.data_ptr(), lod.data_ptr(), n,
                   out.data_ptr(), lanes=n)
    return out


def aniso(atlas, level_size, level_off, n_levels, tex_idx, uv, ddx_uv, ddy_uv,
          taps: int) -> torch.Tensor:
    """``sample_texture_aniso`` on the card: ``taps`` (2 or 4) trilinear
    taps along the major axis of the (N, 2) UV derivatives' footprint, at
    the minor axis' level. Returns (N, 4) f32."""
    if taps not in (2, 4):
        raise ValueError(f"texture aniso: taps is {taps!r}, want 2 or 4")
    tables, levels = _mip(atlas, level_size, level_off, n_levels)
    n, device = _check("aniso", tables, tex_idx, uv, ddx_uv=(ddx_uv, (2,)),
                       ddy_uv=(ddy_uv, (2,)))
    out = torch.empty((n, 4), dtype=torch.float32, device=device)
    _, th, pitch, _ = atlas.shape
    if n:
        dev.launch("vkrt_tex_aniso", device, atlas.data_ptr(), int(atlas.dtype == torch.bfloat16),
                   level_size.data_ptr(), level_off.data_ptr(), n_levels.data_ptr(), levels,
                   th, pitch, *_index(tex_idx), uv.data_ptr(), ddx_uv.data_ptr(),
                   ddy_uv.data_ptr(), int(taps), n, out.data_ptr(), lanes=n)
    return out
