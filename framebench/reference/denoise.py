"""The plain temporal denoiser at chosen pixels: the NRD packing its inputs
pass through, reprojection of the history, the history clamp, moments and
the variance-guided à-trous filter.

Written from the equations of ``vkrt_tpu_torch/models/denoiser.py`` and
``ops/nrd.py`` (commit 3c30f64), not from their code's form: every stencil
is explicit index arithmetic over a set of pixel ids (``PixelSet``). A tap
of pixel (x, y) at offset (dx, dy) is looked up by its id in the set: the
à-trous filter's taps wrap around the frame (periodic rows and columns),
the clamp's 3x3 box repeats the frame's edge pixels. A pixel's result is
known once every value it reads is known, so a set that holds a tile grown
by ``reach()`` gives the tile's pixels as the whole frame gives them.

The history is read anywhere in the frame: ``state`` holds the whole
frame's arrays in scanline order under the program's field names. Float
products are plain multiply-adds, never a matmul. Everything is computed
in the dtype of the inputs (float32; the control's bfloat16).
"""

from __future__ import annotations

import torch

KERNEL = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)  # B3 spline
RADIUS = len(KERNEL) // 2   # taps -2..2, times 2^iteration
ITERATIONS = 3
SIGMA_Z, SIGMA_N, SIGMA_L = 1.0, 64.0, 4.0
MAX_HISTORY = 32.0
DEPTH_REJECT = 0.05    # relative gap of the previous depth to the expected one
NORMAL_REJECT = 0.8    # least cosine of the previous normal to this one
FP16_MIN, FP16_MAX = 1e-7, 65504.0
HIT_DIST_PARAMS = (3.0, 1.0, 20.0, -25.0)
# the history's per-pixel fields, as the program names them
STATE = ("hist_rad", "hist_m1", "hist_m2", "hist_len", "prev_view_z", "prev_normal")


def reach(iterations: int = ITERATIONS) -> int:
    """How far (in x and in y) a filtered pixel reads: the clamp's box (1)
    around every pixel the à-trous taps reach (``RADIUS`` * 2^it an
    iteration; the variance's 3x3 pre-blur reads 1, inside that)."""
    return 1 + sum(RADIUS << it for it in range(iterations))


# --- the NRD packing (shaders/gltf.glsl:156-265) ------------------------------

def luminance(c):
    return 0.25 * c[..., 0] + 0.5 * c[..., 1] + 0.25 * c[..., 2]


def _sign(v):
    return torch.where(v >= 0.0, 1.0, -1.0).to(v.dtype)


def encode_normal(n):
    """Octahedral encoding to [0, 1]^2."""
    a = n.abs()
    v = n / torch.clamp_min((a[..., 0] + a[..., 1] + a[..., 2])[..., None], 1e-20)
    wrapped = torch.stack([(1.0 - v[..., 1].abs()) * _sign(v[..., 0]),
                           (1.0 - v[..., 0].abs()) * _sign(v[..., 1])], dim=-1)
    e = torch.where(v[..., 2:3] >= 0.0, v[..., :2], wrapped)
    return e * 0.5 + 0.5


def decode_normal(e):
    p = e * 2.0 - 1.0
    z = 1.0 - p[..., 0].abs() - p[..., 1].abs()
    t = torch.clamp(-z, 0.0, 1.0)
    n = torch.stack([p[..., 0] - t * _sign(p[..., 0]), p[..., 1] - t * _sign(p[..., 1]), z],
                    dim=-1)
    norm = torch.sqrt(n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1] + n[..., 2] * n[..., 2])
    return n / torch.clamp_min(norm, 1e-20)[..., None]


def pack_normal_roughness(n, roughness, material):
    return torch.cat([encode_normal(n), roughness[..., None],
                      torch.clamp(material / 3.0, 0.0, 1.0)[..., None]], dim=-1)


def norm_hit_dist(hit_dist, view_z, roughness):
    """REBLUR's hit distance over its normalisation, in [0, 1]."""
    a, b, c, d = HIT_DIST_PARAMS
    s = torch.clamp(torch.exp2(d * roughness * roughness), 0.0, 1.0)
    f = (a + view_z.abs() * b) * (1.0 + (c - 1.0) * s)
    return torch.clamp(hit_dist / torch.clamp_min(f, 1e-20), 0.0, 1.0)


def pack_radiance(rad, hit):
    """YCoCg radiance and the normalised hit distance; a pixel with a
    non-finite channel packs black, the rest clamps to [0, FP16_MAX]."""
    bad = (~torch.isfinite(rad)).any(dim=-1, keepdim=True)
    rad = torch.where(bad, 0.0, torch.clamp(rad, 0.0, FP16_MAX)).to(rad.dtype)
    hit = torch.where(torch.isfinite(hit), torch.clamp(hit, 0.0, 1.0), 0.0).to(hit.dtype)
    hit = torch.where(hit != 0.0, torch.clamp_min(hit, FP16_MIN), hit).to(hit.dtype)
    r, g, b = rad[..., 0], rad[..., 1], rad[..., 2]
    return torch.stack([0.25 * r + 0.5 * g + 0.25 * b, 0.5 * r - 0.5 * b,
                        -0.25 * r + 0.5 * g - 0.25 * b, hit], dim=-1)


def unpack_radiance(p):
    """(linear RGB clamped at 0, normalised hit distance)."""
    t = p[..., 0] - p[..., 2]
    rgb = torch.stack([t + p[..., 1], p[..., 0] + p[..., 2], t - p[..., 1]], dim=-1)
    return torch.clamp_min(rgb, 0.0), p[..., 3]


# --- pixels by id ---------------------------------------------------------------

class PixelSet:
    """Sorted unique scanline ids of a ``width`` x ``height`` frame, and the
    lookup of any pixel's row among them."""

    def __init__(self, pids, width: int, height: int):
        self.pids = torch.unique(torch.as_tensor(pids, dtype=torch.int64))
        self.width, self.height = width, height
        self.x, self.y = self.pids % width, self.pids // width

    def __len__(self):
        return self.pids.shape[0]

    def rows(self, x, y):
        """(row, present) of the pixels (x, y), already inside the frame."""
        q = y * self.width + x
        i = torch.clamp_max(torch.searchsorted(self.pids, q), len(self) - 1)
        return i, self.pids[i] == q

    def wrapped(self, dx: int, dy: int):
        return self.rows(torch.remainder(self.x + dx, self.width),
                         torch.remainder(self.y + dy, self.height))

    def edge(self, dx: int, dy: int):
        return self.rows(torch.clamp(self.x + dx, 0, self.width - 1),
                         torch.clamp(self.y + dy, 0, self.height - 1))


# --- the temporal step ----------------------------------------------------------

def reproject(state: dict, prev_view_proj, world_pos, normal, width: int, height: int):
    """The history at each pixel's place in the previous frame: four
    bilinear taps, each kept where it had history, its depth is within
    ``DEPTH_REJECT`` of the surface's depth in the previous view and its
    normal within ``NORMAL_REJECT``; averaged over the kept weights, 0 where
    none is kept. Returns (rad (N,3), m1, m2, len)."""
    dt = world_pos.dtype
    m = prev_view_proj.to(dt)
    x, y, z = world_pos[:, 0], world_pos[:, 1], world_pos[:, 2]

    def row(j):
        return x * m[j, 0] + y * m[j, 1] + z * m[j, 2] + m[j, 3]

    cx, cy, w = row(0), row(1), row(3)
    sw = torch.where(w.abs() < 1e-20, 1e-20, w).to(dt)
    px = (cx / sw * 0.5 + 0.5) * float(width) - 0.5
    py = (cy / sw * 0.5 + 0.5) * float(height) - 0.5
    inside = ((w > 0.0) & (px >= -0.5) & (px <= width - 0.5)
              & (py >= -0.5) & (py <= height - 0.5))
    fx0, fy0 = torch.floor(px), torch.floor(py)
    fx, fy = px - fx0, py - fy0
    # the pixel indices in float32, which holds every index exactly
    x0 = torch.clamp(torch.nan_to_num(fx0.float()), 0, width - 1).long()
    y0 = torch.clamp(torch.nan_to_num(fy0.float()), 0, height - 1).long()
    x1, y1 = torch.clamp_max(x0 + 1, width - 1), torch.clamp_max(y0 + 1, height - 1)
    depth = w.abs()  # the projective w: the surface's depth in the previous view
    n = world_pos.shape[0]
    acc_rad = torch.zeros((n, 3), dtype=dt, device=world_pos.device)
    acc_m1, acc_m2, acc_len, wsum = (torch.zeros(n, dtype=dt, device=world_pos.device)
                                     for _ in range(4))
    for tx, ty, wgt in ((x0, y0, (1 - fx) * (1 - fy)), (x1, y0, fx * (1 - fy)),
                        (x0, y1, (1 - fx) * fy), (x1, y1, fx * fy)):
        i = ty * width + tx
        pn = state["prev_normal"][i].to(dt)
        cos = pn[:, 0] * normal[:, 0] + pn[:, 1] * normal[:, 1] + pn[:, 2] * normal[:, 2]
        keep = (inside & (state["hist_len"][i] > 0.0)
                & ((state["prev_view_z"][i].to(dt) - depth).abs()
                   <= DEPTH_REJECT * torch.clamp_min(depth, 1.0))
                & (cos >= NORMAL_REJECT))
        wv = torch.where(keep, wgt, 0.0).to(dt)
        acc_rad = acc_rad + state["hist_rad"][i].to(dt) * wv[:, None]
        acc_m1 = acc_m1 + state["hist_m1"][i].to(dt) * wv
        acc_m2 = acc_m2 + state["hist_m2"][i].to(dt) * wv
        acc_len = acc_len + state["hist_len"][i].to(dt) * wv
        wsum = wsum + wv
    ok = wsum > 1e-4
    inv = 1.0 / torch.clamp_min(wsum, 1e-4)
    return (torch.where(ok[:, None], acc_rad * inv[:, None], 0.0).to(dt),
            *(torch.where(ok, a * inv, 0.0).to(dt) for a in (acc_m1, acc_m2, acc_len)))


def temporal_step(state: dict, prev_view_proj, pixels: PixelSet, diff_rad_hitd, norm_rough,
                  view_z, world_pos, iterations: int = ITERATIONS):
    """One frame of the temporal denoiser on the pixels of ``pixels`` (the
    per-pixel inputs one row each, in its order). Returns (filtered (N,3),
    new state fields at those pixels (``STATE``), known (N,) bool: the rows
    whose every read lay in the set)."""
    w, h = pixels.width, pixels.height
    cur, hd = unpack_radiance(diff_rad_hitd)
    normal = decode_normal(norm_rough[:, :2])
    h_rad, h_m1, h_m2, h_len = reproject(state, prev_view_proj, world_pos, normal, w, h)

    # the history clamped to the box of this frame's 3x3 neighbours, the
    # frame's edge pixels repeated past its border
    known = torch.ones(len(pixels), dtype=torch.bool, device=cur.device)
    lo, hi = cur, cur
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            i, present = pixels.edge(dx, dy)
            known = known & present
            lo, hi = torch.minimum(lo, cur[i]), torch.maximum(hi, cur[i])
    h_rad = torch.minimum(torch.maximum(h_rad, lo), hi)

    new_len = torch.clamp_max(h_len + 1.0, MAX_HISTORY)
    a = 1.0 / new_len
    img = h_rad * (1.0 - a[:, None]) + cur * a[:, None]
    lum = luminance(cur)
    m1 = h_m1 * (1.0 - a) + lum * a
    m2 = h_m2 * (1.0 - a) + lum * lum * a
    var = torch.clamp_min(m2 - m1 * m1, 0.0)
    var = var + torch.where(new_len < 4.0, 0.5 / new_len, 0.0)  # short history: blur harder
    var = torch.clamp_min(var, 0.0)
    # hit distance 0 (no GI data) blurs fully; short ones blur less
    hd = torch.where(hd <= 1e-4, 1.0, torch.clamp(hd, 0.05, 1.0)).to(cur.dtype)
    img, known = atrous(pixels, img, normal, view_z, known, iterations, var, hd)
    fields = dict(hist_rad=img, hist_m1=m1, hist_m2=m2, hist_len=new_len,
                  prev_view_z=view_z.abs(), prev_normal=normal)
    return img, fields, known


def spatial(pixels: PixelSet, diff_rad_hitd, norm_rough, view_z, iterations: int = ITERATIONS):
    """The spatial-only denoiser (no history): (filtered (N,3), known)."""
    known = torch.ones(len(pixels), dtype=torch.bool, device=diff_rad_hitd.device)
    return atrous(pixels, unpack_radiance(diff_rad_hitd)[0], decode_normal(norm_rough[:, :2]),
                  view_z, known, iterations)


def atrous(pixels: PixelSet, img, normal, view_z, known, iterations: int, var=None, hd=None):
    """The edge-aware à-trous filter: per iteration 5x5 B3 taps 2^it apart,
    wrapping around the frame, weighted by normal and depth, with ``var``
    by the luminance gap over the 3x3-blurred variance (the variance
    filtered alongside), with ``hd`` by the hit distance off the centre
    tap. Returns (image, known)."""
    for it in range(iterations):
        step = 1 << it
        lum = luminance(img)
        nxt = known
        sig_l = None
        if var is not None:
            vb = torch.zeros_like(var)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    i, present = pixels.wrapped(dx, dy)
                    nxt = nxt & present & known[i]
                    vb = vb + var[i]
            sig_l = SIGMA_L * torch.sqrt(vb / 9.0) + 1e-4
            vacc = torch.zeros_like(var)
        acc = torch.zeros_like(img)
        wsum = torch.zeros_like(lum)
        for dy in range(-RADIUS, RADIUS + 1):
            for dx in range(-RADIUS, RADIUS + 1):
                sy, sx = dy * step, dx * step
                i, present = pixels.wrapped(sx, sy)
                nxt = nxt & present & known[i]
                nq = normal[i]
                cos = normal[:, 0] * nq[:, 0] + normal[:, 1] * nq[:, 1] + normal[:, 2] * nq[:, 2]
                w_n = torch.clamp_min(cos, 0.0) ** SIGMA_N
                w_z = torch.exp(-(view_z - view_z[i]).abs()
                                / (SIGMA_Z * abs(sy) + SIGMA_Z * abs(sx) + 1e-3))
                wgt = KERNEL[dy + RADIUS] * KERNEL[dx + RADIUS] * w_n * w_z
                if var is not None:
                    wgt = wgt * torch.exp(-(lum - lum[i]).abs() / sig_l)
                if hd is not None and (dy or dx):
                    r = (dy * dy + dx * dx) ** 0.5 / 2.0
                    wgt = wgt * (0.5 + 0.5 * torch.clamp_max(hd * 6.0 / r, 1.0))
                acc = acc + img[i] * wgt[:, None]
                wsum = wsum + wgt
                if var is not None:
                    vacc = vacc + var[i] * wgt * wgt
        img = acc / torch.clamp_min(wsum, 1e-8)[:, None]
        if var is not None:
            var = vacc / torch.clamp_min(wsum * wsum, 1e-8)
        known = nxt
    return img, known
