"""Post pass: composite + gamma (port of ``vkrt_tpu/models/post.py``, the
``post.frag`` pass, post.frag:36-60).

Path mode shows the accumulated RT image; hybrid mode composites
``raster.rgb * rt.a + rt.rgb`` (shadow/AO modulate, GI adds), with the
view-accumulated debug view; the output is gamma corrected with 1/2.2.
"""

from __future__ import annotations

import numpy as np
import torch


def composite(raster_rgb, rt_rgba, *, rt_mode: int, view_accumulated: bool,
              use_gi: bool) -> torch.Tensor:
    """(N,3)/(N,4) -> (N,3) linear before gamma (post.frag:41-56). Path
    mode (``rt_mode`` 1) shows ``rt_rgba[:, :3]``, or ``raster_rgb`` when
    ``rt_rgba`` is None."""
    if rt_mode == 1:  # path tracer: accumulated image as-is
        return raster_rgb if rt_rgba is None else rt_rgba[:, :3]
    if not view_accumulated:
        return raster_rgb * rt_rgba[:, 3:4] + rt_rgba[:, :3]
    if use_gi:
        return rt_rgba[:, :3] * rt_rgba[:, 3:4]
    return rt_rgba[:, 3:4].expand(-1, 3)


def tonemap(rgb: torch.Tensor) -> torch.Tensor:
    """pow(color, 1/2.2) (post.frag:58)."""
    return torch.pow(torch.clamp_min(rgb, 0.0), 1.0 / 2.2)


def to_u8_image(rgb_flat: torch.Tensor, width: int, height: int) -> np.ndarray:
    """Tonemapped linear (N,3) -> (H,W,3) uint8 for PNG output."""
    img = tonemap(rgb_flat).detach().cpu().numpy().reshape(height, width, 3)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
