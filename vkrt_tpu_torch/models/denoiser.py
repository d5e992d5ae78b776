"""Denoiser: temporal reprojection + variance-guided à-trous filtering
(port of ``vkrt_tpu/models/denoiser.py``).

The reference wires NRD REBLUR_DIFFUSE end to end but leaves the
``NRD.Denoise`` dispatch commented out (main.cpp:566-602); this module
finishes it on the same 5-buffer contract (hello_vulkan.h:199-207): packed
diffuse radiance + normalized hit distance (YCoCg), oct-packed normal +
roughness, viewZ, and the camera's motion.

* **camera reprojection**: the scene is static, so screen motion comes from
  the camera alone; the previous frame's viewProj re-projects each G-buffer
  world position to its previous pixel;
* **disocclusion-tested history**: bilinear history taps validated by the
  previous frame's viewZ (relative depth test) and normal agreement;
* **history clamp**: reprojected colour clamped to the current frame's 3x3
  neighbourhood box (edge-replicated at the borders);
* **variance-guided à-trous**: SVGF-style luminance moments accumulate
  temporally, their variance steers the luminance edge-stopper, and the
  packed hit distance scales the blur radius.

On the card a denoised frame is 1 + 3 launches of ``csrc/denoise.cu``
(``ops/cuda/denoise.py``): ``temporal_pass`` (unpack, reprojection, clamp,
moments) and one ``atrous_filter`` launch an iteration, one thread a pixel,
each reading its neighbourhood in place. Every CPU call takes the PyTorch
bodies, the plain version (``temporal_pass_plain``, ``atrous_filter_plain``,
``denoise_temporal_plain``), which the card's kernels are held to. There
everything is image-space tensor math except the one history gather (4
bilinear taps a pixel). The taps of the à-trous filter are periodic row
shifts written as "pad k halo rows, then slice" (``_pad_rows`` with a
``halo_fn``) followed by a periodic column roll, as in the JAX package, so
the row-band form (``denoise_temporal_tile``, a frame's bands on the tile
axis of a ``parallel.mesh.RenderMesh``) only supplies another halo: the
neighbour bands' rows over the ring (``_ring_halo``). The kernels take the
same halos as row pointers, so both forms run on them too. The projective
products are explicit multiply-adds, never a matmul (which the card may run
as TF32). The JAX package has no Pallas kernel for any of this.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vkrt_tpu_torch.device import select
from vkrt_tpu_torch.ops import nrd
from vkrt_tpu_torch.ops.cuda import denoise as dn_cuda

# 1D B3-spline kernel for the à-trous wavelet
_KERNEL = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)
SIGMA_Z = 1.0
SIGMA_N = 64.0
SIGMA_L = 4.0          # SVGF luminance sigma
MAX_HISTORY = 32.0     # REBLUR maxAccumulatedFrameNum ballpark
DEPTH_REJECT = 0.05    # relative viewZ disocclusion threshold
NORMAL_REJECT = 0.8    # min dot(n, n_prev) to accept history


def _luminance(rgb):
    return 0.25 * rgb[..., 0] + 0.5 * rgb[..., 1] + 0.25 * rgb[..., 2]


class Temporal(NamedTuple):
    """What the temporal pass hands the à-trous filter and the new state,
    per pixel of the frame or band, image order."""

    rad_acc: torch.Tensor      # (N,3) accumulated radiance, history clamped
    variance: torch.Tensor     # (N,) luminance variance, short-history boost
    hit_dist: torch.Tensor     # (N,) normalized hit distance as packed
    hist_m1: torch.Tensor      # (N,) luminance moments
    hist_m2: torch.Tensor
    hist_len: torch.Tensor     # (N,) history length
    prev_view_z: torch.Tensor  # (N,) |view_z|
    prev_normal: torch.Tensor  # (N,3) unpacked normal


class DenoiserState(NamedTuple):
    """Per-pixel temporal history, image (row-major) order."""

    hist_rad: torch.Tensor        # (N,3) accumulated radiance
    hist_m1: torch.Tensor         # (N,) luminance 1st moment
    hist_m2: torch.Tensor         # (N,) luminance 2nd moment
    hist_len: torch.Tensor        # (N,) accumulated frame count (0 = none)
    prev_view_proj: torch.Tensor  # (4,4)
    prev_view_z: torch.Tensor     # (N,)
    prev_normal: torch.Tensor     # (N,3)


def init_state(width: int, height: int, device=None) -> DenoiserState:
    """An empty history. ``device`` None means the card."""
    device = select() if device is None else torch.device(device)
    n = width * height

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return DenoiserState(hist_rad=zeros(n, 3), hist_m1=zeros(n), hist_m2=zeros(n),
                         hist_len=zeros(n), prev_view_proj=zeros(4, 4),
                         prev_view_z=zeros(n), prev_normal=zeros(n, 3))


def _project(world_pos, m, rows):
    """Rows ``rows`` of ``[p, 1] @ m.T`` as explicit multiply-adds, in the
    dot product's order: (N,) each."""
    x, y, z = world_pos[:, 0], world_pos[:, 1], world_pos[:, 2]
    return [x * m[j, 0] + y * m[j, 1] + z * m[j, 2] + m[j, 3] for j in rows]


def motion_vectors(world_pos, prev_view_proj, width: int, height: int):
    """Screen-space motion: previous-frame pixel coords of each world point.

    Returns (prev_px (N,2) float pixel coords, in_prev (N,) bool). The MV
    written to the G-buffer contract is ``prev_px - cur_px``."""
    cx, cy, w = _project(world_pos, prev_view_proj, (0, 1, 3))
    safe_w = torch.where(w.abs() < 1e-20, 1e-20, w)
    ndc = torch.stack([cx / safe_w, cy / safe_w], dim=-1)
    uv = ndc * 0.5 + 0.5  # Vulkan clip: y already flipped by perspectiveVK
    size = torch.tensor([width, height], dtype=torch.float32, device=world_pos.device)
    prev_px = uv * size - 0.5
    in_prev = (
        (w > 0.0)  # half-pixel slack: border pixel centres land on W-1 +- eps
        & (prev_px[:, 0] >= -0.5) & (prev_px[:, 0] <= width - 0.5)
        & (prev_px[:, 1] >= -0.5) & (prev_px[:, 1] <= height - 0.5)
    )
    return prev_px, in_prev


def _gather(img_flat, idx):
    return img_flat[idx]


# --- row-halo machinery ------------------------------------------------------
#
# The à-trous taps are periodic row shifts (roll semantics). Written as "pad
# k halo rows on each side, then slice", the same filter body runs on the
# full frame (halo = its own wrapped rows) and, given a ring halo, on row
# bands of a sharded frame.


def _periodic_halo(x, k: int):
    """Full-frame halo: periodic self-wrap (== roll's row semantics)."""
    return x[-k:], x[:k]


def _ring_halo(mesh):
    """The halo of a band on the mesh's tile axis: its top halo is the
    previous band's last k rows, its bottom halo the next band's first k
    rows, exchanged over the ring (which wraps, as roll's rows do). One
    band is the whole frame: the periodic self-wrap."""
    from vkrt_tpu_torch.parallel.mesh import ring_exchange

    if mesh.shape["tile"] == 1:
        return _periodic_halo

    def fetch(x, k: int):
        return ring_exchange(x[-k:], x[:k], mesh)

    return fetch


def _pad_rows(x, k: int, halo_fn):
    top, bottom = halo_fn(x, k)
    return torch.cat([top, x, bottom], dim=0)


def reproject(state: DenoiserState, world_pos, view_z, normal, width: int, height: int):
    """Bilinearly sample validated history at each pixel's previous position.

    Returns (hist_rad, m1, m2, hist_len) with hist_len = 0 where history is
    missing or disoccluded: the temporal accumulator then falls back to the
    current frame alone. ``view_z`` is part of the contract and unused, as
    in the JAX package (the expected depth is the projective w)."""
    prev_px, in_prev = motion_vectors(world_pos, state.prev_view_proj, width, height)
    x0 = torch.floor(prev_px[:, 0])
    y0 = torch.floor(prev_px[:, 1])
    fx = prev_px[:, 0] - x0
    fy = prev_px[:, 1] - y0
    x0 = torch.clamp(x0.to(torch.int32), 0, width - 1)
    y0 = torch.clamp(y0.to(torch.int32), 0, height - 1)
    x1 = torch.clamp_max(x0 + 1, width - 1)
    y1 = torch.clamp_max(y0 + 1, height - 1)

    # expected depth of this surface in the previous frame's view: the
    # projective w (= -viewZ under perspectiveVK, hello_vulkan.cpp:66-72)
    (w_prev,) = _project(world_pos, state.prev_view_proj, (3,))
    w_abs = w_prev.abs()
    taps = [
        (y0 * width + x0, (1 - fx) * (1 - fy)),
        (y0 * width + x1, fx * (1 - fy)),
        (y1 * width + x0, (1 - fx) * fy),
        (y1 * width + x1, fx * fy),
    ]
    # accumulators sized by the query rows, not the state
    nq = world_pos.shape[0]
    dev = world_pos.device
    acc_rad = torch.zeros((nq, 3), dtype=torch.float32, device=dev)
    acc_m1 = torch.zeros((nq,), dtype=torch.float32, device=dev)
    acc_m2 = torch.zeros_like(acc_m1)
    acc_len = torch.zeros_like(acc_m1)
    wsum = torch.zeros_like(acc_m1)
    for idx, wgt in taps:
        idx = idx.long()
        pz = _gather(state.prev_view_z, idx)
        pn = _gather(state.prev_normal, idx)
        ok = (
            in_prev
            & (_gather(state.hist_len, idx) > 0.0)
            & ((pz - w_abs).abs() <= DEPTH_REJECT * torch.clamp_min(w_abs, 1.0))
            & ((pn * normal).sum(dim=-1) >= NORMAL_REJECT)
        )
        wv = torch.where(ok, wgt, 0.0)
        acc_rad = acc_rad + _gather(state.hist_rad, idx) * wv[:, None]
        acc_m1 = acc_m1 + _gather(state.hist_m1, idx) * wv
        acc_m2 = acc_m2 + _gather(state.hist_m2, idx) * wv
        acc_len = acc_len + _gather(state.hist_len, idx) * wv
        wsum = wsum + wv
    valid = wsum > 1e-4
    inv = 1.0 / torch.clamp_min(wsum, 1e-4)
    return (
        torch.where(valid[:, None], acc_rad * inv[:, None], 0.0),
        torch.where(valid, acc_m1 * inv, 0.0),
        torch.where(valid, acc_m2 * inv, 0.0),
        torch.where(valid, acc_len * inv, 0.0),
    )


def _clamp_rows(x, halo_fn=None, mesh=None):
    """The rows above and below ``x`` (rows, W, ...) that the clamp's 3x3
    box reads. The full frame repeats its own edge rows (an index clamp, the
    JAX package's ``mode="edge"`` pad), not a roll: wrapped taps would let
    border pixels clamp against the opposite edge of the frame. With
    ``halo_fn`` (``_ring_halo(mesh)``; ``x`` a band) the band's inner
    borders take the neighbour bands' rows, and the first band's top and
    the last band's bottom repeat their own edge row, which is the
    full-frame edge pad exactly. The ring's wrap is not used there: this
    halo rule is not the à-trous filter's."""
    if halo_fn is None:
        return x[:1], x[-1:]
    top, bottom = halo_fn(x, 1)  # every band takes part in the exchange
    if mesh.tile == 0:
        top = x[:1]
    if mesh.tile == mesh.shape["tile"] - 1:
        bottom = x[-1:]
    return top, bottom


def _neighborhood_clamp(hist_rad, cur_rad, width: int, height: int, halo_fn=None,
                        mesh=None):
    """Clamp history to the 3x3 box of the current frame (anti-ghosting):
    rows beyond ``height`` (the frame's, or with ``halo_fn`` a band's) as
    ``_clamp_rows`` gives them, columns edge-replicated."""
    img = cur_rad.reshape(height, width, 3)
    top, bottom = _clamp_rows(img, halo_fn, mesh)
    img_rows = torch.cat([top, img, bottom], dim=0)
    cols = torch.clamp(torch.arange(-1, width + 1, device=img.device), 0, width - 1)
    padded = img_rows[:, cols]
    lo = img
    hi = img
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            q = padded[1 + dy:1 + dy + height, 1 + dx:1 + dx + width]
            lo = torch.minimum(lo, q)
            hi = torch.maximum(hi, q)
    return torch.clamp(hist_rad, lo.reshape(-1, 3), hi.reshape(-1, 3))


def _check_reach(height: int, iterations: int) -> None:
    # the largest tap reach must fit in one band (and in the self-wrap slices)
    if height < 2 ** iterations:
        raise ValueError(f"atrous_filter needs height >= {2 ** iterations}, got {height}")


def atrous_filter(radiance, normal, view_z, width: int, height: int, iterations: int = 3,
                  variance=None, hit_dist_norm=None, halo_fn=None):
    """Edge-aware à-trous filtering. All inputs flat (N,...) row-major.

    ``variance``: optional (N,) luminance variance, which adds the SVGF
    luminance edge-stopper (filtered alongside the image).
    ``hit_dist_norm``: optional (N,) in [0,1], which scales the spatial
    kernel weight so short-hit-distance (contact) regions blur less.
    ``halo_fn``: the row-halo source; None is the full frame (periodic
    self-wrap, the roll formulation), ``_ring_halo(mesh)`` a band whose
    neighbours' rows come over the ring (the ring's wrap is roll's
    periodicity, so the bands give the full-frame image).

    On the card one launch of ``csrc/denoise.cu`` an iteration (the inputs
    contiguous), on the CPU ``atrous_filter_plain``."""
    if radiance.device.type != "cuda":
        return atrous_filter_plain(radiance, normal, view_z, width, height, iterations,
                                   variance, hit_dist_norm, halo_fn)
    _check_reach(height, iterations)
    return dn_cuda.atrous(radiance, normal, view_z, width, height, iterations, variance,
                          hit_dist_norm, _periodic_halo if halo_fn is None else halo_fn,
                          (_KERNEL, SIGMA_Z, SIGMA_N, SIGMA_L))


def atrous_filter_plain(radiance, normal, view_z, width: int, height: int,
                        iterations: int = 3, variance=None, hit_dist_norm=None, halo_fn=None):
    """``atrous_filter`` in PyTorch: the taps as rolls of padded copies."""
    h, w = height, width
    halo = _periodic_halo if halo_fn is None else halo_fn
    _check_reach(h, iterations)
    img = radiance.reshape(h, w, 3)
    nrm = normal.reshape(h, w, 3)
    z = view_z.reshape(h, w)
    var = None if variance is None else torch.clamp_min(variance, 0.0).reshape(h, w)
    # hit distance 0 = no GI data (miss): nothing to preserve, full blur
    hd = None if hit_dist_norm is None else torch.where(
        hit_dist_norm <= 1e-4, 1.0, torch.clamp(hit_dist_norm, 0.05, 1.0)).reshape(h, w)

    for it in range(iterations):
        step = 1 << it
        k = 2 * step  # largest row reach this iteration
        img_p = _pad_rows(img, k, halo)
        nrm_p = _pad_rows(nrm, k, halo)
        z_p = _pad_rows(z, k, halo)
        var_p = None if var is None else _pad_rows(var, k, halo)
        lum_p = _luminance(img_p)

        def tap(p, sy, sx):
            return torch.roll(p[k + sy:k + sy + h], -sx, dims=1)

        acc = torch.zeros_like(img)
        vacc = None if var is None else torch.zeros_like(var)
        wsum = torch.zeros((h, w, 1), dtype=img.dtype, device=img.device)
        v_wsum = torch.zeros((h, w), dtype=img.dtype, device=img.device)
        lum = lum_p[k:k + h]
        sig_l = None
        if var is not None:
            # 3x3 pre-blur of the variance stabilizes the weight (SVGF)
            vb = torch.zeros_like(var)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    vb = vb + tap(var_p, dy, dx)
            sig_l = SIGMA_L * torch.sqrt(vb / 9.0) + 1e-4
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                kw = _KERNEL[dy + 2] * _KERNEL[dx + 2]
                sy, sx = dy * step, dx * step
                img_q = tap(img_p, sy, sx)
                nrm_q = tap(nrm_p, sy, sx)
                z_q = tap(z_p, sy, sx)
                w_n = torch.clamp_min((nrm * nrm_q).sum(dim=-1), 0.0) ** SIGMA_N
                w_z = torch.exp(-(z - z_q).abs()
                                / (SIGMA_Z * abs(sy) + SIGMA_Z * abs(sx) + 1e-3))
                wgt = kw * w_n * w_z
                if var is not None:
                    lum_q = tap(lum_p, sy, sx)
                    wgt = wgt * torch.exp(-(lum - lum_q).abs() / sig_l)
                if hd is not None and (dy or dx):
                    # short hit distances (contact occlusion) shrink the
                    # effective blur radius, gently: a floored fade, never
                    # below 25%
                    r = (dy * dy + dx * dx) ** 0.5 / 2.0
                    wgt = wgt * (0.5 + 0.5 * torch.clamp_max(hd * 6.0 / r, 1.0))
                acc = acc + img_q * wgt[..., None]
                wsum = wsum + wgt[..., None]
                if var is not None:
                    var_q = tap(var_p, sy, sx)
                    vacc = vacc + var_q * wgt * wgt
                    v_wsum = v_wsum + wgt
        img = acc / torch.clamp_min(wsum, 1e-8)
        if var is not None:
            var = vacc / torch.clamp_min(v_wsum * v_wsum, 1e-8)
    return img.reshape(-1, 3)


def denoise_gi(diff_rad_hitd, norm_rough_packed, view_z, width: int, height: int,
               iterations: int = 3):
    """The spatial-only REBLUR-contract entry: unpack, filter, return
    linear RGB (N,3)."""
    radiance = nrd.unpack_radiance_and_norm_hit_dist(diff_rad_hitd)[..., :3].contiguous()
    normal, _rough, _mid = nrd.unpack_normal_and_roughness(norm_rough_packed)
    return atrous_filter(radiance, normal, view_z, width, height, iterations)


def denoise_temporal(state: DenoiserState, diff_rad_hitd, norm_rough_packed, view_z,
                     world_pos, view_proj, width: int, height: int, iterations: int = 3):
    """Full temporal + spatial denoise, the ``NRD.Denoise`` dispatch the
    reference leaves disabled (main.cpp:566-602), REBLUR-style.

    All buffers in image (row-major) order. Returns (filtered radiance
    (N,3), new DenoiserState)."""
    return _denoise(state, diff_rad_hitd, norm_rough_packed, view_z, world_pos,
                    view_proj, width, height, height, iterations)


def denoise_temporal_plain(state: DenoiserState, diff_rad_hitd, norm_rough_packed, view_z,
                           world_pos, view_proj, width: int, height: int,
                           iterations: int = 3):
    """``denoise_temporal`` through the PyTorch bodies on any device: the
    plain version the card's kernels are held to."""
    return _denoise(state, diff_rad_hitd, norm_rough_packed, view_z, world_pos,
                    view_proj, width, height, height, iterations, plain=True)


def _gather_history(state: DenoiserState, mesh) -> DenoiserState:
    """The whole frame's history from the bands': the six per-pixel arrays
    packed into one (n, 10) block, gathered over the tile axis in one
    collective, then each contiguous again."""
    from vkrt_tpu_torch.parallel.mesh import all_gather_rows

    packed = torch.cat([state.hist_rad, state.hist_m1[:, None], state.hist_m2[:, None],
                        state.hist_len[:, None], state.prev_view_z[:, None],
                        state.prev_normal], dim=1)
    full = all_gather_rows(packed, mesh)
    return state._replace(hist_rad=full[:, 0:3].contiguous(), hist_m1=full[:, 3].contiguous(),
                          hist_m2=full[:, 4].contiguous(), hist_len=full[:, 5].contiguous(),
                          prev_view_z=full[:, 6].contiguous(),
                          prev_normal=full[:, 7:10].contiguous())


def denoise_temporal_tile(state: DenoiserState, diff_rad_hitd, norm_rough_packed, view_z,
                          world_pos, view_proj, width: int, height: int, mesh,
                          iterations: int = 3):
    """``denoise_temporal`` on this rank's band of whole rows (its band of
    the tile axis of ``mesh``), per pixel equal to the full-frame filter.

    * reprojection is a gather from anywhere in the frame (camera motion
      can carry a pixel's history across any band border), so the bands'
      histories are gathered (about 10 floats a pixel) and each band
      reprojects its own rows against the whole;
    * the clamp and the à-trous filter are stencils: boundary rows travel
      to the neighbour bands over the ring (``_ring_halo``), never a
      whole-frame gather.

    ``height`` is the whole frame's height; the per-pixel inputs and
    ``state`` are the band's rows. Returns (filtered band, new band
    state)."""
    if world_pos.shape[0] % width:
        raise ValueError("denoise_temporal_tile needs whole row bands")
    return _denoise(_gather_history(state, mesh), diff_rad_hitd, norm_rough_packed,
                    view_z, world_pos, view_proj, width, height,
                    world_pos.shape[0] // width, iterations, _ring_halo(mesh), mesh)


def temporal_pass(history: DenoiserState, diff_rad_hitd, norm_rough_packed, view_z,
                  world_pos, width: int, height: int, rows: int, halo_fn=None,
                  mesh=None) -> Temporal:
    """The temporal half of the denoiser over ``rows`` rows (the whole
    frame, or a band with its ``halo_fn`` and ``mesh``) reprojecting against
    ``history`` (the whole frame's): unpack, reprojection, the clamp, the
    accumulation and the moments. On the card one launch of
    ``csrc/denoise.cu``, on the CPU ``temporal_pass_plain``."""
    if world_pos.device.type != "cuda":
        return temporal_pass_plain(history, diff_rad_hitd, norm_rough_packed, view_z,
                                   world_pos, width, height, rows, halo_fn, mesh)
    return Temporal(*dn_cuda.temporal(
        history, diff_rad_hitd, norm_rough_packed, view_z, world_pos, width, height,
        lambda x: _clamp_rows(x, halo_fn, mesh), (MAX_HISTORY, DEPTH_REJECT, NORMAL_REJECT)))


def temporal_pass_plain(history: DenoiserState, diff_rad_hitd, norm_rough_packed, view_z,
                        world_pos, width: int, height: int, rows: int, halo_fn=None,
                        mesh=None) -> Temporal:
    """``temporal_pass`` in PyTorch."""
    unpacked = nrd.unpack_radiance_and_norm_hit_dist(diff_rad_hitd)
    cur_rad = unpacked[..., :3]
    hd_norm = unpacked[..., 3]
    normal, _rough, _ = nrd.unpack_normal_and_roughness(norm_rough_packed)

    h_rad, h_m1, h_m2, h_len = reproject(history, world_pos, view_z, normal, width, height)
    h_rad = _neighborhood_clamp(h_rad, cur_rad, width, rows, halo_fn, mesh)

    new_len = torch.clamp_max(h_len + 1.0, MAX_HISTORY)
    alpha = 1.0 / new_len
    rad_acc = h_rad * (1.0 - alpha[:, None]) + cur_rad * alpha[:, None]
    lum = _luminance(cur_rad)
    m1 = h_m1 * (1.0 - alpha) + lum * alpha
    m2 = h_m2 * (1.0 - alpha) + lum * lum * alpha
    variance = torch.clamp_min(m2 - m1 * m1, 0.0)
    # short history: inflate the variance so the spatial filter works harder
    variance = variance + torch.where(new_len < 4.0, 0.5 / new_len, 0.0)
    return Temporal(rad_acc=rad_acc, variance=variance, hit_dist=hd_norm, hist_m1=m1,
                    hist_m2=m2, hist_len=new_len, prev_view_z=view_z.abs(),
                    prev_normal=normal)


def _denoise(history: DenoiserState, diff_rad_hitd, norm_rough_packed, view_z, world_pos,
             view_proj, width: int, height: int, rows: int, iterations: int, halo_fn=None,
             mesh=None, plain: bool = False):
    """The temporal denoise of ``rows`` rows (the whole frame, or a band
    with its ``halo_fn``) reprojecting against ``history`` (the whole
    frame's); ``plain``: through the PyTorch bodies on any device."""
    t = (temporal_pass_plain if plain else temporal_pass)(
        history, diff_rad_hitd, norm_rough_packed, view_z, world_pos, width, height, rows,
        halo_fn, mesh)
    filtered = (atrous_filter_plain if plain else atrous_filter)(
        t.rad_acc, t.prev_normal, view_z, width, rows, iterations, variance=t.variance,
        hit_dist_norm=t.hit_dist, halo_fn=halo_fn)
    # SVGF feeds the first filtered result back as next frame's history;
    # this keeps the final filtered image (stabler under motion)
    new_state = DenoiserState(hist_rad=filtered, hist_m1=t.hist_m1, hist_m2=t.hist_m2,
                              hist_len=t.hist_len, prev_view_proj=view_proj,
                              prev_view_z=t.prev_view_z, prev_normal=t.prev_normal)
    return filtered, new_state
