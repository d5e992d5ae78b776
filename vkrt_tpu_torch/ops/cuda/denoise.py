"""The temporal denoiser's CUDA kernels (``csrc/denoise.cu``): one temporal
pass a frame (``temporal``) and one launch an à-trous iteration
(``atrous``), one thread a pixel.

``models/denoiser.py`` dispatches here for every call on the card; its
PyTorch bodies (``temporal_pass_plain``, ``atrous_filter_plain``) are the
plain version these are held to (``tests/test_torch_denoiser_gpu.py``).
Every per-pixel input must be contiguous but the world positions (on a
mesh's band, a view of the G-buffer's (N, 4) rows). A field's rows beyond
the frame or band come from a halo callable, so one kernel serves the full
frame (views of its own rows: roll's periodic wrap, the clamp's edge) and a
band (the rows the ring brought). Sizes and constants go as launch scalars
and the tap table from host memory: a call uploads nothing and does not
synchronise. ``device.check_args`` checks every dtype before the device, so
a wrong dtype is refused on the CPU too.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vkrt_tpu_torch import device as dev

F32 = torch.float32
TAP_FLOATS = 78  # csrc/denoise.cu TapTable


@functools.cache
def tap_table(step: int, kernel: tuple, sigma_z: float, sigma_n: float,
              sigma_l: float) -> ctypes.Array:
    """The constants of an à-trous iteration at ``step`` as PyTorch on the
    card hands them to its kernels, in ``csrc/denoise.cu``'s ``TapTable``
    order: each tap's ``kernel[dy] * kernel[dx]`` (a Python float, cast to
    f32), the reciprocals of the divisors ``SIGMA_Z |sy| + SIGMA_Z |sx| +
    1e-3`` and ``r = sqrt(dy^2 + dx^2) / 2``, then ``sigma_n``, ``sigma_l``
    and the pre-blur's 1 / 9. A tensor divided by a Python scalar runs as a
    multiply by the scalar's reciprocal, taken in double and rounded to f32
    (measured on the card: ``f32(1) / f32(d)`` differs at d = 1.001, 8.001,
    ...)."""
    f32 = np.float32
    taps = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)]
    kw = [f32(kernel[dy + 2] * kernel[dx + 2]) for dy, dx in taps]
    inv_z = [f32(1.0 / (sigma_z * abs(dy * step) + sigma_z * abs(dx * step) + 1e-3))
             for dy, dx in taps]
    inv_r = [f32(1.0 / ((dy * dy + dx * dx) ** 0.5 / 2.0)) if dy or dx else f32(0.0)
             for dy, dx in taps]
    vals = [*kw, *inv_z, *inv_r, f32(sigma_n), f32(sigma_l), f32(1.0 / 9.0)]
    return (ctypes.c_float * TAP_FLOATS)(*map(float, vals))


def _halo_entries(name, halo, k: int, width: int, tail):
    """``check_args`` entries of a field's halo rows (top, bottom): k rows
    of the field each."""
    return [(f"{name} {side}", x, F32, (k, width, *tail))
            for side, x in zip(("top", "bottom"), halo)]


def _check_pixels(what: str, n: int) -> None:
    if n >= 2**31:
        raise ValueError(f"{what}: {n} pixels, at most 2^31 - 1")


def atrous(radiance, normal, view_z, width: int, height: int, iterations: int, variance,
           hit_dist_norm, halo, consts) -> torch.Tensor:
    """``atrous_filter`` on the card: ``iterations`` launches over the
    (height * width, 3) ``radiance`` with (N, 3) ``normal``, (N,)
    ``view_z`` and the optional (N,) ``variance`` and raw
    ``hit_dist_norm``. ``halo(x, k)`` gives the k rows above and below a
    (height, width, ...) field; ``consts``: (kernel, sigma_z, sigma_n,
    sigma_l) for ``tap_table``. Returns the filtered (N, 3) f32."""
    what = "denoise atrous"
    n = width * height
    want = [("radiance", radiance, F32, (n, 3)), ("normal", normal, F32, (n, 3)),
            ("view_z", view_z, F32, (n,))]
    want += [(name, t, F32, (n,)) for name, t in
             (("variance", variance), ("hit_dist_norm", hit_dist_norm)) if t is not None]
    device = dev.check_args(what, want)
    _check_pixels(what, n)
    # name -> (the (height, width, ...) field, its trailing shape); the
    # image and the variance are replaced by each iteration's outputs
    fields = {"radiance": (radiance.view(height, width, 3), (3,)),
              "normal": (normal.view(height, width, 3), (3,)),
              "view_z": (view_z.view(height, width), ())}
    if variance is not None:
        fields["variance"] = (variance.view(height, width), ())
    hd = None if hit_dist_norm is None else hit_dist_norm.data_ptr()
    for it in range(iterations):
        step, k = 1 << it, 2 << it
        halos = {name: halo(x, k) for name, (x, _) in fields.items()}
        dev.check_args(what, [e for name, (_, tail) in fields.items()
                              for e in _halo_entries(name, halos[name], k, width, tail)],
                       device=device)
        ptrs = []
        for name in ("radiance", "normal", "view_z", "variance"):
            if name in fields:
                top, bottom = halos[name]
                ptrs += [fields[name][0].data_ptr(), top.data_ptr(), bottom.data_ptr()]
            else:
                ptrs += [None, None, None]
        img = torch.empty_like(fields["radiance"][0])
        var = torch.empty_like(fields["variance"][0]) if variance is not None else None
        table = tap_table(step, *consts)
        dev.launch("vkrt_denoise_atrous", device, *ptrs, hd, ctypes.addressof(table), width,
                   height, step, img.data_ptr(), None if var is None else var.data_ptr(),
                   lanes=n)
        fields["radiance"] = (img, (3,))
        if var is not None:
            fields["variance"] = (var, ())
    return fields["radiance"][0].view(n, 3)


def temporal(history, diff_rad_hitd, norm_rough_packed, view_z, world_pos, width: int,
             height: int, clamp_rows, consts) -> tuple:
    """The temporal pass on the card over the inputs' rows (the frame, or a
    band of whole rows), reprojecting against ``history``, the whole
    (height * width) frame's ``DenoiserState``. ``clamp_rows(x)`` gives the
    rows above and below a (rows, width, 4) field for the clamp's box;
    ``consts``: (MAX_HISTORY, DEPTH_REJECT, NORMAL_REJECT). Returns
    (rad_acc (N, 3), variance, hit_dist, hist_m1, hist_m2, hist_len,
    prev_view_z (N,) each, prev_normal (N, 3)), f32."""
    what = "denoise temporal"
    nq = diff_rad_hitd.shape[0] if diff_rad_hitd.ndim == 2 else -1
    nf = width * height
    h = history
    device = dev.check_args(what, [
        ("diff_rad_hitd", diff_rad_hitd, F32, (nq, 4)),
        ("norm_rough_packed", norm_rough_packed, F32, (nq, 4)),
        ("view_z", view_z, F32, (nq,)), ("world_pos", world_pos, F32, (nq, 3)),
        ("prev_view_proj", h.prev_view_proj, F32, (4, 4)),
        ("hist_rad", h.hist_rad, F32, (nf, 3)), ("hist_m1", h.hist_m1, F32, (nf,)),
        ("hist_m2", h.hist_m2, F32, (nf,)), ("hist_len", h.hist_len, F32, (nf,)),
        ("prev_view_z", h.prev_view_z, F32, (nf,)),
        ("prev_normal", h.prev_normal, F32, (nf, 3))], strided=("world_pos",))
    if nq % width or nq > nf:
        raise ValueError(f"{what}: {nq} pixels are not whole rows of a {width} x {height} "
                         f"frame")
    _check_pixels(what, nf)
    rows = nq // width
    top, bottom = clamp_rows(diff_rad_hitd.view(rows, width, 4))
    dev.check_args(what, _halo_entries("diff_rad_hitd", (top, bottom), 1, width, (4,)),
                   device=device)
    out = [torch.empty((nq, 3) if c == 3 else (nq,), dtype=F32, device=device)
           for c in (3, 1, 1, 1, 1, 1, 1, 3)]
    max_history, depth_reject, normal_reject = consts
    if nq:
        dev.launch("vkrt_denoise_temporal", device, diff_rad_hitd.data_ptr(), top.data_ptr(),
                   bottom.data_ptr(), norm_rough_packed.data_ptr(), view_z.data_ptr(),
                   world_pos.data_ptr(), world_pos.stride(0), world_pos.stride(1),
                   h.prev_view_proj.data_ptr(), h.hist_rad.data_ptr(), h.hist_m1.data_ptr(),
                   h.hist_m2.data_ptr(), h.hist_len.data_ptr(), h.prev_view_z.data_ptr(),
                   h.prev_normal.data_ptr(), width, height, rows, max_history, depth_reject,
                   normal_reject, *(t.data_ptr() for t in out), lanes=nq)
    return tuple(out)
