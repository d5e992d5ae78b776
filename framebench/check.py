"""Whether the timed path's image is right: the plain reference renders
every frame that went into the final accumulation at pixels drawn from
the seed (path mode: ``reference/render.py``; hybrid mode: the G-buffer
once and the RT effects of every frame, ``reference/hybrid.py``), mixes
them as the engine does, composites as the engine does, and the numbers
below are held to the cell's limits (``framebench/limits/<workload>.json``).

Numbers (each lower is better; the limits file names those compared):

* ``diverged``: the share of drawn pixels whose relative error
  (``pixel_errors``) exceeds ``DIVERGED``. Two f32 implementations part on
  a rare lane, whose path then takes another way and moves its pixel's
  mean by a percent or so; such pixels stay few, while a broken frame or
  a lower precision moves most of them;
* ``nonfinite``: how many of the program's values at those pixels are
  not finite (a NaN or an infinity stays in the buffer for good);
* ``rel_l1``: sum over the drawn pixels and channels of |program -
  reference| over the sum of |reference|: a bias under ``DIVERGED`` a
  pixel that ``diverged`` does not see, such as a light's intensity or
  the accumulation's weights off by a fraction of a percent.

The control (``dtype=torch.bfloat16``) is the reference in the program's
place, its samples computed in bfloat16 and mixed into an f32 buffer as
the engine's is.

**A cell whose camera moves or that denoises** is checked one frame at a
time (``Reference.step``): its image depends on the denoiser's history
and, under motion, on a frame that restarts its accumulation at every
pose. The run renders one more frame after its window, the check frame,
and takes from the timed path, just before it, the RT buffer at the
compared pixels and the denoiser's whole history (cloned). Those are
taken as given: the reference follows the program one step from the
program's own state, so each step is held to the reference alone, not
the run as a whole. The compared pixels are ``TILE`` x ``TILE`` tiles
drawn from the seed; for each, the reference renders the G-buffer and
the RT effects of the check frame, at its pose and frame number, over
the tile grown by the denoiser's reach (``reference/denoise.py``), runs
the temporal step from the cloned history (whose reprojection reads
anywhere in the frame) and composites at the tiles' pixels. Beside the
numbers above:

* ``state_rel_l1``: the new history at the compared pixels (filtered
  radiance, moments, history length, depth and normal), for each field
  the summed gap over the summed reference, the largest of them: a frame
  whose image is right but whose history is not (never written, or
  written from other numbers) is wrong from the next frame on.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from framebench.reference import bvh as ref_bvh
from framebench.reference import denoise as ref_dn
from framebench.reference import hybrid as ref_hybrid
from framebench.reference import render as ref_render
from framebench.reference import scene as ref_scene
from framebench.cells import camera_pose

CHECK_SALT = 0x5EED
DIVERGED = 1e-2  # a pixel's relative error above this counts as parted
LANES = 1 << 20  # (pixel, frame) pairs the reference renders a run
TILE = 8  # side of the tiles of compared pixels in a check of one frame


def draw_pixels(seed: int, n_pixels: int, k: int) -> np.ndarray:
    s = int(seed) % (1 << 64)
    rng = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, CHECK_SALT])
    return np.sort(rng.choice(n_pixels, size=min(k, n_pixels), replace=False))


def draw_tiles(seed: int, width: int, height: int, k: int) -> np.ndarray:
    """Origins (x, y) of ``k`` distinct tiles of the frame's ``TILE`` grid,
    drawn from the seed."""
    s = int(seed) % (1 << 64)
    rng = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, CHECK_SALT, TILE])
    nx, ny = -(-width // TILE), -(-height // TILE)
    t = np.sort(rng.choice(nx * ny, size=min(k, nx * ny), replace=False))
    return np.stack([t % nx, t // nx], axis=1) * TILE


def tile_pixels(origins: np.ndarray, width: int, height: int, grow: int = 0) -> np.ndarray:
    """Sorted scanline ids of the tiles' pixels inside the frame, each tile
    grown by ``grow`` on every side, wrapping around the frame."""
    ids = []
    for x0, y0 in origins:
        xs = np.arange(x0 - grow, min(x0 + TILE, width) + grow) % width
        ys = np.arange(y0 - grow, min(y0 + TILE, height) + grow) % height
        ids.append((ys[:, None] * width + xs[None, :]).reshape(-1))
    return np.unique(np.concatenate(ids))


def step_pixels(cell, seed: int):
    """(compared pixels, footprint) of a check of one frame: tiles drawn
    from the seed, as many as fit ``LANES`` footprint pixels, and the tiles
    grown by the denoiser's reach where the cell denoises."""
    grow = ref_dn.reach() if denoises(cell) else 0
    k = max(1, LANES // (TILE + 2 * grow) ** 2)
    tiles = draw_tiles(seed, cell.width, cell.height, k)
    return (tile_pixels(tiles, cell.width, cell.height),
            tile_pixels(tiles, cell.width, cell.height, grow))


def stepwise(cell) -> bool:
    """Whether the cell is checked one frame at a time (``Reference.step``):
    its camera moves or it denoises."""
    return cell.traffic.get("camera", "static") != "static" or denoises(cell)


def denoises(cell) -> bool:
    """The engine's rule: the denoiser runs in hybrid mode with GI."""
    s = cell.traffic["settings"]
    return s.get("rt_mode", 0) == 0 and bool(s.get("use_denoiser")) and bool(s.get("use_gi"))


def _mix(accum, new, frame: int):
    """The progressive mix of one frame into ``accum`` (rgen:136-145)."""
    if frame <= 0:
        return new.float()
    a = (1.0 / (torch.tensor(float(frame)) + 1.0)).to(new.device)
    return accum.float().to(new.device) * (1.0 - a) + new.float() * a


class Reference:
    """The reference's tree and scene for one cell, built once; its camera
    at ``pose`` (eye, center, fov_deg), by default the config's."""

    def __init__(self, cell, inp, device, dtype=torch.float32, pose=None):
        self.cell, self.inp, self.device, self.dtype = cell, inp, device, dtype
        self.scn = ref_scene.build(inp, device, dtype)
        self.tree = ref_bvh.build_sah(inp.v0, inp.v1, inp.v2)
        self.walk = ref_bvh.Walk(self.tree, self.scn.tri_v0, self.scn.tri_e1,
                                 self.scn.tri_e2, device, dtype)
        self.pose = pose or camera_pose(cell.config["camera"])
        self.cam = ref_render.camera(*self.pose, cell.width, cell.height, device, dtype)

    def posed(self, pose) -> "Reference":
        """This reference with its camera at ``pose``."""
        ref = copy.copy(self)
        ref.pose = pose
        ref.cam = ref_render.camera(*pose, self.cell.width, self.cell.height, self.device,
                                    self.dtype)
        return ref

    def step(self, centres: np.ndarray, footprint: np.ndarray, frame: int, prev_pose,
             accum, state=None, chunk_lanes: int = 1 << 19):
        """The engine's output at scanline pixels ``centres`` after one frame
        numbered ``frame`` at this reference's pose, the frame before it at
        ``prev_pose``: (image (K, 3) f32, the denoiser's new history at the
        centres (``reference.denoise.STATE``) or None).

        ``accum``: the RT buffer before the frame at the centres (K, 4) (path
        mode: (K, 3)). ``state``: the denoiser's history before it, the whole
        frame's arrays in scanline order; the reference renders its inputs
        over ``footprint``, which holds the centres grown by its reach."""
        s = self.cell.traffic["settings"]
        hybrid = s.get("rt_mode", 0) == 0
        denoised = denoises(self.cell)
        w, h = self.cell.width, self.cell.height
        clear = self.cell.config.get("clear_color", (1.0, 1.0, 1.0, 1.0))
        pix = torch.as_tensor(footprint if denoised else centres, dtype=torch.int64,
                              device=self.device)
        view, _ = ref_hybrid.view_matrices(*self.pose, w, h, self.device, self.dtype)
        atlas = ref_hybrid.build_atlas(self.inp, self.device) if hybrid else None
        common = dict(depth=int(s.get("depth", 3)), corr=bool(s.get("corr_sampler", True)),
                      clamp_weights=bool(s.get("clamp_weights", False)))
        parts = []
        for i in range(0, pix.shape[0], chunk_lanes):
            pid = pix[i:i + chunk_lanes]
            fr = torch.full_like(pid, int(frame))
            if not hybrid:
                parts.append({"rt": ref_render.path_samples(
                    self.scn, self.walk, self.cam, w, h, pid, fr, clear_color=clear, **common)})
                continue
            g = ref_hybrid.gbuffer(self.scn, self.walk, atlas, self.cam, w, h, pid, clear)
            rt, gi, hit = ref_hybrid.effects_gi(
                self.scn, self.walk, g, self.cam, w, h, pid, fr,
                use_shadows=bool(s.get("use_shadows", True)), use_ao=bool(s.get("use_ao", True)),
                use_gi=bool(s.get("use_gi", False)), **common)
            part = {"rt": rt, "color": g.color}
            if denoised:
                part.update(ref_hybrid.denoiser_inputs(g, gi, hit, view)._asdict())
            parts.append(part)
        rows = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        at = torch.searchsorted(pix, torch.as_tensor(centres, dtype=torch.int64,
                                                     device=self.device))
        acc = _mix(accum, rows["rt"][at], frame)
        if not hybrid:
            return acc, None
        new_state = None
        if denoised:
            pixels = ref_dn.PixelSet(pix, w, h)
            if s.get("temporal_denoiser", True):
                _, prev_vp = ref_hybrid.view_matrices(*prev_pose, w, h, self.device, self.dtype)
                rgb, fields, known = ref_dn.temporal_step(
                    state, prev_vp, pixels, rows["diff_rad_hitd"], rows["norm_rough"],
                    rows["view_z"], rows["world_pos"])
                new_state = {k: v[at].float() for k, v in fields.items()}
            else:
                rgb, known = ref_dn.spatial(pixels, rows["diff_rad_hitd"], rows["norm_rough"],
                                            rows["view_z"])
            if not bool(known[at].all()):
                raise ValueError("the footprint does not hold every pixel the centres read")
            acc = torch.cat([rgb[at].float(), acc[:, 3:4]], dim=-1)
        return ref_hybrid.composite(rows["color"][at].float(), acc), new_state

    def image(self, pids: np.ndarray, frames, chunk_lanes: int = 1 << 19):
        """(K, 3) f32: the engine's output at scanline pixels ``pids`` after
        ``frames`` (in order, accumulated from a zero buffer)."""
        s = self.cell.traffic["settings"]
        hybrid = s.get("rt_mode", 0) == 0
        w, h = self.cell.width, self.cell.height
        clear = self.cell.config.get("clear_color", (1.0, 1.0, 1.0, 1.0))
        pid = torch.as_tensor(pids, dtype=torch.int64, device=self.device)
        k = pid.shape[0]
        if hybrid:
            atlas = ref_hybrid.build_atlas(self.inp, self.device)
            g = ref_hybrid.gbuffer(self.scn, self.walk, atlas, self.cam, w, h, pid, clear)
        per = max(1, chunk_lanes // k)
        out = []
        for i in range(0, len(frames), per):
            fr = torch.as_tensor(frames[i:i + per], dtype=torch.int64, device=self.device)
            lanes_f = fr.repeat_interleave(k)
            lanes_p = pid.repeat(fr.shape[0])
            common = dict(depth=int(s.get("depth", 3)), corr=bool(s.get("corr_sampler", True)),
                          clamp_weights=bool(s.get("clamp_weights", False)))
            if hybrid:
                rows = ref_hybrid.GBuffer(*(x.repeat(fr.shape[0], *([1] * (x.dim() - 1)))
                                            for x in g))
                rad = ref_hybrid.effects(
                    self.scn, self.walk, rows, self.cam, w, h, lanes_p, lanes_f,
                    use_shadows=bool(s.get("use_shadows", True)),
                    use_ao=bool(s.get("use_ao", True)), use_gi=bool(s.get("use_gi", False)),
                    **common)
            else:
                rad = ref_render.path_samples(self.scn, self.walk, self.cam, w, h, lanes_p,
                                              lanes_f, clear_color=clear, **common)
            out.append(rad.reshape(fr.shape[0], k, -1))
        acc = ref_render.accumulate(frames, torch.cat(out), torch.float32)
        return ref_hybrid.composite(g.color.float(), acc) if hybrid else acc


def pixel_errors(program: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """(K,) each drawn pixel's summed |program - reference| over its summed
    |reference|, the denominator floored at a thousandth of the mean pixel;
    a non-finite program value counts as black."""
    p, r = program.double(), reference.double()
    p = torch.where(torch.isfinite(p), p, 0.0)
    mag = r.abs().sum(dim=1)
    return (p - r).abs().sum(dim=1) / torch.clamp_min(mag, 1e-3 * float(mag.mean()) + 1e-30)


def numbers(program: torch.Tensor, reference: torch.Tensor) -> dict:
    err = pixel_errors(program, reference)
    p, r = program.double(), reference.double()
    p_fin = torch.where(torch.isfinite(p), p, 0.0)
    return {"diverged": float((err > DIVERGED).double().mean()),
            "nonfinite": float((~torch.isfinite(p)).sum()),
            "rel_l1": float((p_fin - r).abs().sum() / r.abs().sum())}


def state_rel_l1(program: dict, reference: dict) -> float:
    """The largest over the history's fields of the summed |program -
    reference| over the summed |reference|; a non-finite program value
    counts as 0."""
    worst = 0.0
    for name, r in reference.items():
        p, r = program[name].double(), r.double().cpu()
        p = torch.where(torch.isfinite(p), p, 0.0)
        worst = max(worst, float((p - r).abs().sum() / torch.clamp_min(r.abs().sum(), 1e-30)))
    return worst


def step_numbers(program, reference) -> dict:
    """The numbers of a check of one frame, from (image, new history or
    None) of each side: the image's, and ``state_rel_l1`` where the cell
    denoises."""
    nums = numbers(program[0], reference[0].cpu())
    if reference[1] is not None:
        nums["state_rel_l1"] = state_rel_l1(program[1], reference[1])
    return nums


def judge(nums: dict, limits: dict):
    """(correct, lines): every number at or under its limit; a non-finite
    number fails."""
    ok, lines = True, []
    for name, lim in limits.items():
        v = nums.get(name, float("nan"))
        good = bool(np.isfinite(v)) and v <= lim["limit"]
        ok &= good
        lines.append((name, v, lim["limit"], good))
    return ok, lines


def sample_count(n_frames: int) -> int:
    """Pixels to draw: ``LANES`` (pixel, frame) pairs in all."""
    return max(64, LANES // max(n_frames, 1))
