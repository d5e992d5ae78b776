"""The procedural city: a grid of textured boxes ("buildings") on a ground
slab under four point lights, the Sponza-class stand-in that the port's
benchmark suite renders (rows 3-5).

A frozen copy of ``vkrt_tpu_torch/scene.py::make_city`` with its helpers
``_boxes``, ``_boxes_uvs`` and ``_procedural_textures`` (commit 400863e),
returning raw arrays: the random draws in the same order give the same
triangles, uvs, materials, lights and images. ``grid=96`` is 143,568
triangles.
"""

from __future__ import annotations

import numpy as np

from framebench.scenes import Light, Material, SceneInput

_QUADS = [(4, 5, 6, 7), (1, 0, 3, 2), (5, 1, 2, 6), (0, 4, 7, 3), (7, 6, 2, 3), (0, 1, 5, 4)]
_SIGNS = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                   [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float64)


def _boxes(centers, halves, rots):
    """(N,3),(N,3),(N,) -> (N*12, 3, 3) f64 triangles of rotated boxes."""
    centers = np.asarray(centers, np.float64)
    halves = np.asarray(halves, np.float64)
    rots = np.asarray(rots, np.float64)
    corners = _SIGNS[None, :, :] * halves[:, None, :]
    c, s = np.cos(rots), np.sin(rots)
    zero, one = np.zeros_like(c), np.ones_like(c)
    r = np.stack([np.stack([c, zero, s], -1), np.stack([zero, one, zero], -1),
                  np.stack([-s, zero, c], -1)], axis=1)
    corners = np.matmul(corners, np.swapaxes(r, 1, 2)) + centers[:, None, :]
    tri_idx = np.array([t for a, b, c_, d in _QUADS for t in ((a, b, c_), (a, c_, d))],
                       np.int64)
    return corners[:, tri_idx, :].reshape(-1, 3, 3)


def _boxes_uvs(halves, tiles):
    """Per-corner uvs of ``_boxes``' triangles, each face tiled with its size."""
    halves = np.asarray(halves, np.float64)
    tiles = np.asarray(tiles, np.float64)
    hx, hy, hz = halves[:, 0], halves[:, 1], halves[:, 2]
    su = np.stack([2 * hx, 2 * hx, 2 * hz, 2 * hz, 2 * hx, 2 * hx], -1) * tiles[:, None]
    sv = np.stack([2 * hy, 2 * hy, 2 * hy, 2 * hy, 2 * hz, 2 * hz], -1) * tiles[:, None]
    zero = np.zeros_like(su)
    u = np.stack([zero, su, su, zero, su, zero], -1)
    v = np.stack([zero, zero, sv, zero, sv, sv], -1)
    return np.stack([u, v], -1).reshape(-1, 2, 3, 2).reshape(-1, 3, 2)


def _textures():
    """Checker, brick and window-grid images (RGBA u8, 64x64)."""
    rng = np.random.default_rng(42)
    checker = np.zeros((64, 64, 4), np.uint8)
    checker[..., :3] = 110
    checker[:32, :32, :3] = 190
    checker[32:, 32:, :3] = 190
    checker[..., 3] = 255
    brick = np.full((64, 64, 4), 150, np.uint8)
    brick[..., :3] = (160, 82, 60)
    for row in range(0, 64, 16):
        brick[row:row + 2, :, :3] = 200
        off = 0 if (row // 16) % 2 == 0 else 16
        for col in range(off, 64, 32):
            brick[row:row + 16, col:col + 2, :3] = 200
    brick[..., :3] = np.clip(brick[..., :3].astype(np.int16)
                             + rng.integers(-12, 12, (64, 64, 1)), 0, 255).astype(np.uint8)
    brick[..., 3] = 255
    windows = np.full((64, 64, 4), 70, np.uint8)
    windows[..., :3] = (90, 95, 105)
    for row in range(4, 64, 16):
        for col in range(4, 64, 16):
            windows[row:row + 8, col:col + 8, :3] = (30, 40, 70)
    windows[..., 3] = 255
    return [checker, brick, windows]


def make(params: dict, asset_dir: str) -> SceneInput:
    del asset_dir  # nothing on disk
    grid = int(params["grid"])
    rng = np.random.default_rng(int(params["seed"]))
    mats = [
        Material((0.7, 0.7, 0.68, 1.0), base_tex=0, metallic=0.0),
        Material((1.0, 1.0, 1.0, 1.0), base_tex=1, metallic=0.0),
        Material((0.8, 0.8, 0.85, 1.0), roughness=0.2),
        Material((1.0, 1.0, 1.0, 1.0), base_tex=2, metallic=0.3, roughness=0.4),
    ]
    centers, halves, rots, box_mats, tiles = [], [], [], [], []

    def add(center, half, mid, rot=0.0, tile=0.5):
        centers.append(center)
        halves.append(half)
        rots.append(rot)
        box_mats.append(mid)
        tiles.append(tile)

    span = grid * 2.0
    add((0, -0.25, 0), (span, 0.25, span), 0, tile=0.25)
    for i in range(grid):
        for j in range(grid):
            x = (i - grid / 2) * 4.0 + rng.uniform(-0.5, 0.5)
            z = (j - grid / 2) * 4.0 + rng.uniform(-0.5, 0.5)
            h = rng.uniform(1.0, 8.0)
            w = rng.uniform(0.6, 1.6)
            rot = rng.uniform(0, 3.14)
            add((x, h / 2, z), (w, h / 2, w), int(rng.integers(1, 4)), rot=rot)
            if rng.uniform() < 0.3:
                add((x, h + 0.4, z), (w * 0.4, 0.4, w * 0.4), 2)
    tris = _boxes(centers, halves, rots).astype(np.float32)
    uvs = _boxes_uvs(halves, tiles).astype(np.float32)
    lights = []
    for _ in range(4):
        pos = np.array([rng.uniform(-span / 2, span / 2), rng.uniform(6, 14),
                        rng.uniform(-span / 2, span / 2)], np.float32)
        lights.append(Light(tuple(pos.tolist()), (1.0, 1.0, 1.0), 200.0, 0))
    return SceneInput(
        kind="soup", v0=tris[:, 0].copy(), v1=tris[:, 1].copy(), v2=tris[:, 2].copy(),
        uv=uvs, tri_mat=np.repeat(np.asarray(box_mats, np.int32), 12),
        materials=mats, lights=lights, images=_textures(), srgb=[True, True, True])
