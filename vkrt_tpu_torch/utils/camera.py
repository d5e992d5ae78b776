"""Camera: lookat/perspective matrices and primary-ray generation.

Port of ``vkrt_tpu/utils/camera.py``. The matrices are built in float64
numpy (as there) and carried as float32 tensors, or those float32 values
widened to another dtype (the float64 oracle's camera, as the JAX oracle
widens its f32 matrices); ray generation is written as explicit
multiply-adds in the same order as the JAX version, in the dtype of the
matrices and the jitter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

NEAR_PLANE = 0.1
FAR_PLANE = 1000.0


class CameraMatrices(NamedTuple):
    """GlobalUniforms equivalent (host_device.h:68-73), (4, 4) f32 each."""

    view_proj: torch.Tensor
    view: torch.Tensor
    view_inverse: torch.Tensor
    proj_inverse: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Camera:
    """CameraManip-equivalent state (main.cpp:158-160)."""

    eye: tuple = (0.0, 0.0, 15.0)
    center: tuple = (0.0, 0.0, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    fov_deg: float = 60.0

    def matrices(self, width: int, height: int, device=None,
                 dtype: torch.dtype = torch.float32) -> CameraMatrices:
        """The four matrices, rounded to float32 and carried in ``dtype``."""
        aspect = width / float(height)
        view = look_at(self.eye, self.center, self.up)
        proj = perspective_vk(self.fov_deg, aspect, NEAR_PLANE, FAR_PLANE)
        return camera_from_numpy(
            {
                "view_proj": proj @ view,
                "view": view,
                "view_inverse": np.linalg.inv(view),
                "proj_inverse": np.linalg.inv(proj),
            },
            device, dtype,
        )


def orbit_camera(t: float, center=(0.0, 0.0, 0.0), radius: float = 18.0,
                 height: float = 6.0, fov_deg: float = 60.0) -> Camera:
    """Fly-through camera: an orbit around ``center`` at parameter t in
    [0, 1), the headless stand-in for mouse navigation (the benchmark
    suite's city camera is ``orbit_camera(0.12, radius=300, height=48)``)."""
    ang = 2.0 * math.pi * t
    eye = (
        center[0] + radius * math.sin(ang),
        center[1] + height,
        center[2] + radius * math.cos(ang),
    )
    return Camera(eye=eye, center=tuple(center), fov_deg=fov_deg)


def camera_from_numpy(d: dict, device=None,
                      dtype: torch.dtype = torch.float32) -> CameraMatrices:
    """``CameraMatrices._asdict()`` of numpy arrays -> tensors of the values
    rounded to f32, in ``dtype``."""
    return CameraMatrices(**{
        k: torch.tensor(np.asarray(d[k], np.float32), device=device).to(dtype)
        for k in CameraMatrices._fields
    })


def look_at(eye, center, up) -> np.ndarray:
    """Right-handed GL-style view matrix (camera looks down -Z)."""
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    z = eye - center
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4)
    m[0, :3] = x
    m[1, :3] = y
    m[2, :3] = z
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def perspective_vk(fov_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    """nvmath::perspectiveVK — Vulkan clip space: Y flipped, depth [0, 1]."""
    f = 1.0 / math.tan(math.radians(fov_deg) * 0.5)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = -f
    m[2, 2] = far / (near - far)
    m[2, 3] = (near * far) / (near - far)
    m[3, 2] = -1.0
    return m


def pixel_coords(width: int, height: int, device=None) -> torch.Tensor:
    """Flat row-major pixel (x, y) coordinates, (H*W, 2) f32, pixel (0,0)
    top-left."""
    xs = torch.arange(width, dtype=torch.float32, device=device)
    ys = torch.arange(height, dtype=torch.float32, device=device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)
    return torch.stack([px.reshape(-1), py.reshape(-1)], dim=-1)


def tile_perm(width: int, height: int, tile: int = 32):
    """Pixel permutation tiling the frame into ``tile`` x ``tile`` blocks,
    row-major within a tile. Returns (perm, inv_perm) int32 numpy arrays
    with ``pixels_tiled = pixels[perm]`` and ``image = out[inv_perm]``."""
    ys, xs = np.mgrid[0:height, 0:width]
    key = (
        ((ys // tile) * ((width + tile - 1) // tile) + (xs // tile)).astype(np.int64)
        * (tile * tile)
        + (ys % tile) * tile
        + (xs % tile)
    ).reshape(-1)
    perm = np.argsort(key, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


def untile(out: torch.Tensor, width: int, height: int, tile: int = 32) -> torch.Tensor:
    """Tile order -> scanline order as reshape/transpose copies: exactly
    ``out[inv_perm]``. Requires ``width % tile == 0``."""
    if width % tile:
        raise ValueError(f"untile needs width % {tile} == 0, got {width}")
    n_tx = width // tile
    n_ty = height // tile
    feats = out.shape[1:]
    parts = []
    full = n_ty * tile * width
    if n_ty:
        seg = out[:full].reshape(n_ty, n_tx, tile, tile, *feats)
        # (ty, tx, y_in, x_in) -> (ty, y_in, tx, x_in)
        parts.append(seg.transpose(1, 2).reshape(full, *feats))
    rem = height - n_ty * tile
    if rem:
        seg = out[full:].reshape(n_tx, rem, tile, *feats)
        parts.append(seg.transpose(0, 1).reshape(rem * width, *feats))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def retile(img: torch.Tensor, width: int, height: int, tile: int = 32) -> torch.Tensor:
    """Scanline order -> tile order (the inverse of ``untile``) as
    reshape/transpose copies: exactly ``img[perm]``. Requires
    ``width % tile == 0``."""
    if width % tile:
        raise ValueError(f"retile needs width % {tile} == 0, got {width}")
    n_tx = width // tile
    n_ty = height // tile
    feats = img.shape[1:]
    parts = []
    full = n_ty * tile * width
    if n_ty:
        seg = img[:full].reshape(n_ty, tile, n_tx, tile, *feats)
        # (ty, y_in, tx, x_in) -> (ty, tx, y_in, x_in)
        parts.append(seg.transpose(1, 2).reshape(full, *feats))
    rem = height - n_ty * tile
    if rem:
        seg = img[full:].reshape(rem, n_tx, tile, *feats)
        parts.append(seg.transpose(0, 1).reshape(rem * width, *feats))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def generate_rays(cam: CameraMatrices, width: int, height: int, jitter, pix=None):
    """Primary rays exactly as raytrace.rgen:44-55.

    ``jitter``: (N, 2) in [0,1) or a broadcastable pair. ``pix``: optional
    (N, 2) pixel coordinates (defaults to the full frame, row-major).
    Returns (origin (N,3), direction (N,3)).
    """
    pi = cam.proj_inverse
    if pix is None:
        pix = pixel_coords(width, height, device=pi.device)
    pixel_center = pix + jitter
    in_uv = pixel_center / torch.tensor(
        [width, height], dtype=torch.float32, device=pix.device
    )
    d = in_uv * 2.0 - 1.0
    # target = projInverse @ (d.x, d.y, 1, 1); only .xyz used after normalize
    tdir = torch.stack(
        [
            pi[0, 0] * d[:, 0] + pi[0, 1] * d[:, 1] + pi[0, 2] + pi[0, 3],
            pi[1, 0] * d[:, 0] + pi[1, 1] * d[:, 1] + pi[1, 2] + pi[1, 3],
            pi[2, 0] * d[:, 0] + pi[2, 1] * d[:, 1] + pi[2, 2] + pi[2, 3],
        ],
        dim=-1,
    )
    tdir = tdir / torch.sqrt((tdir * tdir).sum(dim=-1, keepdim=True))
    vi = cam.view_inverse
    world_dir = torch.stack(
        [
            vi[0, 0] * tdir[:, 0] + vi[0, 1] * tdir[:, 1] + vi[0, 2] * tdir[:, 2],
            vi[1, 0] * tdir[:, 0] + vi[1, 1] * tdir[:, 1] + vi[1, 2] * tdir[:, 2],
            vi[2, 0] * tdir[:, 0] + vi[2, 1] * tdir[:, 1] + vi[2, 2] * tdir[:, 2],
        ],
        dim=-1,
    )
    origin = vi[:3, 3].expand(world_dir.shape)
    return origin, world_dir
