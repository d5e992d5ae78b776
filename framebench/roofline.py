"""Peaks of one NVIDIA H100 SXM and the least time of the kernels whose
share of it the per-layer metrics report.

* Kernel A on a frame's primaries: the benchmark's own SAH tree
  (``reference/bvh.py``) walked by its plain walk over a fixed sample of
  the primaries (pixel centres, the benchmark's own camera), the box and
  triangle tests a ray scaled to W x H rays, at 26 FP32 instructions a box
  test and 52 a triangle test (none fused) over 33.5 T instructions/s;
  against 44 bytes a ray (the ray read once, 28 B, and its hit record
  written once, 16 B) over 3.35 TB/s. The larger binds.
* Kernel B's albedo instantiation at bounce 0: 223.2 bytes a lane (its
  inputs read once and outputs written once) x W x H over 3.35 TB/s.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

FP32_INSTR_PER_S = 33.5e12
HBM_BYTES_PER_S = 3.35e12
BOX_INSTR, TRI_INSTR = 26, 52
RAY_BYTES = 44
SHADE_LANE_BYTES = 223.2
PRIMARY_SAMPLE = 1 << 16


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def primary_tests(ref) -> tuple:
    """(box tests, triangle tests) a primary ray, over the fixed sample."""
    from framebench.reference import render

    w, h = ref.cell.width, ref.cell.height
    pid = np.sort(np.random.default_rng(0).choice(w * h, min(PRIMARY_SAMPLE, w * h),
                                                  replace=False))
    pid = torch.as_tensor(pid, dtype=torch.int64, device=ref.device)
    pix = torch.stack([pid % w, pid // w], dim=-1).to(torch.float32)
    o, d = render.generate_rays(ref.cam, w, h, torch.full_like(pix, 0.5), pix)
    ref.walk.closest(o, d, torch.full((pid.shape[0],), 1e4, device=ref.device))
    boxes, tris, rays = ref.walk.counts
    return boxes / rays, tris / rays


class Yardsticks:
    def __init__(self, cell, ref):
        self.cell, self.ref = cell, ref
        self._primary = None

    @property
    def pixels(self) -> int:
        return self.cell.width * self.cell.height

    def primary_bound_s(self) -> float:
        if self._primary is None:
            box, tri = primary_tests(self.ref)
            ops = (BOX_INSTR * box + TRI_INSTR * tri) * self.pixels / FP32_INSTR_PER_S
            self._primary = max(ops, RAY_BYTES * self.pixels / HBM_BYTES_PER_S)
        return self._primary

    def shade_bound_s(self) -> float:
        return SHADE_LANE_BYTES * self.pixels / HBM_BYTES_PER_S
