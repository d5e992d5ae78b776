"""The texel fetch's CUDA kernel (``csrc/texture.cu``): one launch a
``sample_*`` call of ``ops/texture.py``, one thread a lane.

``ops/texture.py`` dispatches here for every call on the card; its
PyTorch body is the plain version these are held to bit for bit
(``tests/test_torch_texture_gpu.py``). The per-lane inputs must be
contiguous (every caller's are) and the host integers (N, the padded
height and row width, the level count, the taps) are launch scalars, so a
call uploads nothing and does not synchronise. ``launches`` and ``lanes``
count, by sampler, the launches made and the lanes handed the kernel;
they are module state, so a test that patches a wrapper still reads the
real wrapper's counts.
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch import device as dev

_INDEX = (torch.int32, torch.int64)
_ATLAS = (torch.bfloat16, torch.float32)

launches = {"level0": 0, "trilinear": 0, "aniso": 0}
lanes = {"level0": 0, "trilinear": 0, "aniso": 0}


def reset() -> None:
    """Set every sampler's counts to 0."""
    for counts in (launches, lanes):
        for sampler in counts:
            counts[sampler] = 0


def _dtype(name, t, want):
    if t.dtype not in want:
        names = " or ".join(str(d).removeprefix("torch.") for d in want)
        raise TypeError(f"texture: {name} is {t.dtype}, want {names}")


def _lanes(sampler, tex_idx, uv, **more):
    """Check each lane's inputs (N index, (N, 2) f32 uv, ``more``: name ->
    (tensor, trailing shape)), all contiguous; returns N."""
    _dtype("tex_idx", tex_idx, _INDEX)
    _dtype("uv", uv, (torch.float32,))
    for name, (t, _) in more.items():
        _dtype(name, t, (torch.float32,))
    n = tex_idx.shape[0] if tex_idx.ndim == 1 else -1
    shapes = {"tex_idx": (tex_idx, ()), "uv": (uv, (2,)), **more}
    for name, (t, tail) in shapes.items():
        if tuple(t.shape) != (n, *tail):
            raise ValueError(f"texture {sampler}: {name} is {tuple(t.shape)}, want "
                             f"{(max(n, 0), *tail)}")
        if not t.is_contiguous():
            raise ValueError(f"texture {sampler}: {name} must be contiguous")
    if n >= 2**31:
        raise ValueError(f"texture {sampler}: {n} lanes, at most 2^31 - 1")
    return n


def _tables(sampler, device, *tables):
    """The texel table and its int32 tables on ``device``, contiguous."""
    for t in tables:
        if t.device != device:
            raise ValueError(f"texture {sampler}: a table on {t.device}, lanes on {device}")
        if not t.is_contiguous():
            raise ValueError(f"texture {sampler}: its tables must be contiguous")


def _on_card(sampler, *lane_inputs):
    device = lane_inputs[0].device
    if device.type != "cuda":
        raise ValueError(f"texture {sampler}: {device} is not a CUDA device")
    for t in lane_inputs[1:]:
        if t.device != device:
            raise ValueError(f"texture {sampler}: lanes on {t.device} and {device}")
    return device


def _texels(sampler, tex, dtypes):
    _dtype("texels", tex, dtypes)
    if tex.ndim != 4 or tex.shape[3] != 4:
        raise ValueError(f"texture {sampler}: texels are {tuple(tex.shape)}, want (K, TH, W, 4)")
    if tex.data_ptr() % (4 * tex.element_size()):
        raise ValueError(f"texture {sampler}: the texel table is not aligned to its texels")


def _mip(sampler, atlas, level_size, level_off, n_levels):
    _texels(sampler, atlas, _ATLAS)
    for name, t in (("level_size", level_size), ("level_off", level_off),
                    ("n_levels", n_levels)):
        _dtype(name, t, (torch.int32,))
    k, levels = level_off.shape if level_off.ndim == 2 else (-1, -1)
    if (tuple(level_size.shape) != (k, levels, 2) or tuple(n_levels.shape) != (k,)
            or atlas.shape[0] != k):
        raise ValueError(f"texture {sampler}: level tables {tuple(level_size.shape)}, "
                         f"{tuple(level_off.shape)}, {tuple(n_levels.shape)} for an atlas of "
                         f"{atlas.shape[0]} images")
    return levels


def _launch(sampler, entry, device, n, *args):
    """``entry`` over ``n`` lanes (none when n is 0), counted."""
    if n:
        dev.launch(entry, device, *args)
        launches[sampler] += 1
        lanes[sampler] += n


def _index(t):
    return t.data_ptr(), int(t.dtype == torch.int64)


def level0(tex_rgba, tex_size, tex_idx, uv) -> torch.Tensor:
    """``sample_texture`` on the card: bilinear REPEAT of the (K, TH, TW, 4)
    f32 level 0 at (N, 2) ``uv``, index -1 white. Returns (N, 4) f32."""
    _texels("level0", tex_rgba, (torch.float32,))
    _dtype("tex_size", tex_size, (torch.int32,))
    if tuple(tex_size.shape) != (tex_rgba.shape[0], 2):
        raise ValueError(f"texture level0: tex_size is {tuple(tex_size.shape)}")
    n = _lanes("level0", tex_idx, uv)
    device = _on_card("level0", tex_idx, uv)
    _tables("level0", device, tex_rgba, tex_size)
    out = torch.empty((n, 4), dtype=torch.float32, device=device)
    _, th, tw, _ = tex_rgba.shape
    _launch("level0", "vkrt_tex_level0", device, n, tex_rgba.data_ptr(), tex_size.data_ptr(),
            th, tw, *_index(tex_idx), uv.data_ptr(), n, out.data_ptr())
    return out


def trilinear(atlas, level_size, level_off, n_levels, tex_idx, uv, lod) -> torch.Tensor:
    """``sample_texture_lod`` on the card: trilinear from the (K, TH, 2TW, 4)
    bf16 or f32 mip atlas at (N,) ``lod``. Returns (N, 4) f32."""
    levels = _mip("trilinear", atlas, level_size, level_off, n_levels)
    n = _lanes("trilinear", tex_idx, uv, lod=(lod, ()))
    device = _on_card("trilinear", tex_idx, uv, lod)
    _tables("trilinear", device, atlas, level_size, level_off, n_levels)
    out = torch.empty((n, 4), dtype=torch.float32, device=device)
    _, th, pitch, _ = atlas.shape
    _launch("trilinear", "vkrt_tex_lod", device, n, atlas.data_ptr(),
            int(atlas.dtype == torch.bfloat16), level_size.data_ptr(), level_off.data_ptr(),
            n_levels.data_ptr(), levels, th, pitch, *_index(tex_idx), uv.data_ptr(),
            lod.data_ptr(), n, out.data_ptr())
    return out


def aniso(atlas, level_size, level_off, n_levels, tex_idx, uv, ddx_uv, ddy_uv,
          taps: int) -> torch.Tensor:
    """``sample_texture_aniso`` on the card: ``taps`` (2 or 4) trilinear
    taps along the major axis of the (N, 2) UV derivatives' footprint, at
    the minor axis' level. Returns (N, 4) f32."""
    if taps not in (2, 4):
        raise ValueError(f"texture aniso: taps is {taps!r}, want 2 or 4")
    levels = _mip("aniso", atlas, level_size, level_off, n_levels)
    n = _lanes("aniso", tex_idx, uv, ddx_uv=(ddx_uv, (2,)), ddy_uv=(ddy_uv, (2,)))
    device = _on_card("aniso", tex_idx, uv, ddx_uv, ddy_uv)
    _tables("aniso", device, atlas, level_size, level_off, n_levels)
    out = torch.empty((n, 4), dtype=torch.float32, device=device)
    _, th, pitch, _ = atlas.shape
    _launch("aniso", "vkrt_tex_aniso", device, n, atlas.data_ptr(),
            int(atlas.dtype == torch.bfloat16), level_size.data_ptr(), level_off.data_ptr(),
            n_levels.data_ptr(), levels, th, pitch, *_index(tex_idx), uv.data_ptr(),
            ddx_uv.data_ptr(), ddy_uv.data_ptr(), int(taps), n, out.data_ptr())
    return out
