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
"""

from __future__ import annotations

import numpy as np
import torch

from framebench.reference import bvh as ref_bvh
from framebench.reference import hybrid as ref_hybrid
from framebench.reference import render as ref_render
from framebench.reference import scene as ref_scene
from framebench.cells import camera_pose

CHECK_SALT = 0x5EED
DIVERGED = 1e-2  # a pixel's relative error above this counts as parted
LANES = 1 << 20  # (pixel, frame) pairs the reference renders a run


def draw_pixels(seed: int, n_pixels: int, k: int) -> np.ndarray:
    s = int(seed) % (1 << 64)
    rng = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, CHECK_SALT])
    return np.sort(rng.choice(n_pixels, size=min(k, n_pixels), replace=False))


class Reference:
    """The reference's tree and scene for one cell, built once."""

    def __init__(self, cell, inp, device, dtype=torch.float32):
        self.cell, self.inp, self.device = cell, inp, device
        self.scn = ref_scene.build(inp, device, dtype)
        self.tree = ref_bvh.build_sah(inp.v0, inp.v1, inp.v2)
        self.walk = ref_bvh.Walk(self.tree, self.scn.tri_v0, self.scn.tri_e1,
                                 self.scn.tri_e2, device, dtype)
        eye, center, fov = camera_pose(cell.config["camera"])
        self.cam = ref_render.camera(eye, center, fov, cell.width, cell.height, device, dtype)

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
