"""The sponzoid: a generated Sponza-layout hall on disk (glTF, one external
.bin buffer, PNG textures): four textured materials, two of them with
normal maps, marble columns, and a rig of five KHR point lights.

A frozen copy of ``vkrt_tpu_torch/utils/sponzoid.py::write_sponzoid`` in
its PNG form, with its texture and geometry helpers (commit 400863e); the
asset is written by ``scenes/gltf_asset.py``, which other generators share
(``_generate``, ``materials`` and ``lights`` are theirs to build on). The
asset is written once into ``asset_dir`` (a marker names its parameters)
for the program's glTF loader, and ``make`` returns the same arrays,
expanded to triangles, for the reference. ``tess=4`` is 161,920 triangles.
"""

from __future__ import annotations

import os

import numpy as np

from framebench.scenes import Light, Material, SceneInput, gltf_asset

_W, _H, _L = 20.0, 12.0, 60.0


def _normal_from_height(h, strength=2.0):
    gx = np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)
    gy = np.roll(h, -1, axis=0) - np.roll(h, 1, axis=0)
    n = np.stack([-gx * strength, -gy * strength, np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    out = np.empty(h.shape + (4,), np.uint8)
    out[..., :3] = np.clip((n * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    out[..., 3] = 255
    return out


def _tex_stone(rng, n=256):
    yy, xx = np.mgrid[0:n, 0:n]
    tx, ty = xx // (n // 8), yy // (n // 8)
    checker = ((tx + ty) % 2).astype(np.float32)
    jit = rng.uniform(-0.08, 0.08, size=(64,))[ty * 8 + tx]
    base = 0.55 + 0.12 * checker + jit
    grout = ((xx % (n // 8) < 2) | (yy % (n // 8) < 2)).astype(np.float32)
    v = np.clip(base * (1.0 - 0.45 * grout), 0, 1)
    return np.stack([v * 255, v * 245, v * 230], axis=-1), _normal_from_height(v - 0.5 * grout, 3.0)


def _tex_plaster(rng, n=256):
    noise = rng.normal(0, 1, size=(n, n)).astype(np.float32)
    for _ in range(4):
        noise = (noise + np.roll(noise, 1, 0) + np.roll(noise, 1, 1)
                 + np.roll(noise, -1, 0) + np.roll(noise, -1, 1)) / 5.0
    v = np.clip(0.82 + 0.05 * noise, 0, 1)
    return np.stack([v * 250, v * 244, v * 232], axis=-1)


def _tex_brick(rng, n=256):
    yy, xx = np.mgrid[0:n, 0:n]
    bh, bw = n // 8, n // 4
    row = yy // bh
    xoff = (xx + (row % 2) * (bw // 2)) % bw
    mortar = ((xoff < 3) | (yy % bh < 3)).astype(np.float32)
    brick_id = row * 8 + (xx + (row % 2) * (bw // 2)) // bw
    jit = rng.uniform(-0.1, 0.1, size=(96,))[brick_id % 96]
    r = np.clip((0.62 + jit) * (1 - mortar) + 0.70 * mortar, 0, 1)
    g = np.clip((0.30 + jit * 0.6) * (1 - mortar) + 0.68 * mortar, 0, 1)
    b = np.clip((0.24 + jit * 0.4) * (1 - mortar) + 0.64 * mortar, 0, 1)
    return (np.stack([r * 255, g * 255, b * 255], axis=-1),
            _normal_from_height((1.0 - mortar) * (0.5 + jit), 2.5))


def _tex_marble(rng, n=256):
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    turb = np.zeros((n, n), np.float32)
    for f, a in ((2, 1.0), (5, 0.5), (11, 0.25)):
        ph = rng.uniform(0, 2 * np.pi, size=2)
        turb += a * np.sin(2 * np.pi * f * xx / n + ph[0]) * np.sin(2 * np.pi * f * yy / n + ph[1])
    v = np.clip(0.78 + 0.16 * np.sin(2 * np.pi * (xx + yy) / n * 3 + 2.5 * turb), 0, 1)
    return np.stack([v * 250, v * 248, v * 240], axis=-1)


def _plane(origin, u_vec, v_vec, nu, nv, uv_rep=(1.0, 1.0)):
    s = np.linspace(0.0, 1.0, nu + 1, dtype=np.float32)
    t = np.linspace(0.0, 1.0, nv + 1, dtype=np.float32)
    ss, tt = np.meshgrid(s, t, indexing="ij")
    pos = (np.asarray(origin, np.float32)[None, None]
           + ss[..., None] * np.asarray(u_vec, np.float32)[None, None]
           + tt[..., None] * np.asarray(v_vec, np.float32)[None, None])
    n = np.cross(np.asarray(u_vec, np.float32), np.asarray(v_vec, np.float32))
    n = n / np.linalg.norm(n)
    tang = np.asarray(u_vec, np.float32)
    tang = tang / np.linalg.norm(tang)
    npts = (nu + 1) * (nv + 1)
    nrm = np.broadcast_to(n, (npts, 3)).copy()
    tan4 = np.concatenate([np.broadcast_to(tang, (npts, 3)), np.ones((npts, 1), np.float32)],
                          axis=1)
    uv = np.stack([ss.reshape(-1) * uv_rep[0], tt.reshape(-1) * uv_rep[1]],
                  axis=1).astype(np.float32)
    i0 = (np.arange(nu)[:, None] * (nv + 1) + np.arange(nv)[None, :]).reshape(-1)
    quad = np.stack([i0, i0 + (nv + 1), i0 + (nv + 1) + 1, i0, i0 + (nv + 1) + 1, i0 + 1],
                    axis=1)
    return pos.reshape(npts, 3), nrm, tan4, uv, quad.reshape(-1).astype(np.uint32)


def _cylinder(center, radius, height, nrad, nh, uv_rep=(3.0, 2.0)):
    th = np.linspace(0, 2 * np.pi, nrad + 1, dtype=np.float32)
    ys = np.linspace(0.0, height, nh + 1, dtype=np.float32)
    tt, yy = np.meshgrid(th, ys, indexing="ij")
    cx, cy, cz = (float(c) for c in center)
    pos = np.stack([cx + radius * np.cos(tt), cy + yy, cz + radius * np.sin(tt)], axis=-1)
    nrm = np.stack([np.cos(tt), np.zeros_like(tt), np.sin(tt)], axis=-1)
    tan = np.stack([-np.sin(tt), np.zeros_like(tt), np.cos(tt)], axis=-1)
    npts = (nrad + 1) * (nh + 1)
    uv = np.stack([tt.reshape(-1) / (2 * np.pi) * uv_rep[0],
                   yy.reshape(-1) / height * uv_rep[1]], axis=1)
    i0 = (np.arange(nrad)[:, None] * (nh + 1) + np.arange(nh)[None, :]).reshape(-1)
    quad = np.stack([i0, i0 + (nh + 1), i0 + (nh + 1) + 1, i0, i0 + (nh + 1) + 1, i0 + 1],
                    axis=1)
    tan4 = np.concatenate([tan.reshape(npts, 3), np.ones((npts, 1), np.float32)], axis=1)
    return (pos.reshape(npts, 3).astype(np.float32), nrm.reshape(npts, 3).astype(np.float32),
            tan4.astype(np.float32), uv.astype(np.float32),
            quad.reshape(-1).astype(np.uint32))


def _box(center, size, nu, uv_rep=(1.0, 1.0)):
    cx, cy, cz = center
    sx, sy, sz = (s / 2.0 for s in size)
    faces = [
        ([cx - sx, cy - sy, cz + sz], [2 * sx, 0, 0], [0, 2 * sy, 0]),
        ([cx + sx, cy - sy, cz - sz], [-2 * sx, 0, 0], [0, 2 * sy, 0]),
        ([cx + sx, cy - sy, cz + sz], [0, 0, -2 * sz], [0, 2 * sy, 0]),
        ([cx - sx, cy - sy, cz - sz], [0, 0, 2 * sz], [0, 2 * sy, 0]),
        ([cx - sx, cy + sy, cz + sz], [2 * sx, 0, 0], [0, 0, -2 * sz]),
        ([cx - sx, cy - sy, cz - sz], [2 * sx, 0, 0], [0, 0, 2 * sz]),
    ]
    return [_plane(o, u, v, nu, nu, uv_rep) for (o, u, v) in faces]


def _merge(pieces):
    pos, nrm, tan, uv, idx = [], [], [], [], []
    base = 0
    for (p, n, t, u, i) in pieces:
        pos.append(p)
        nrm.append(n)
        tan.append(t)
        uv.append(u)
        idx.append(i + base)
        base += len(p)
    return (np.concatenate(pos), np.concatenate(nrm), np.concatenate(tan),
            np.concatenate(uv), np.concatenate(idx))


_MATERIALS = [  # (name, baseColor image, normal image, metallic, roughness)
    ("stone_floor", 0, 1, 0.0, 0.55),
    ("plaster", 2, -1, 0.0, 0.9),
    ("brick", 3, 4, 0.0, 0.85),
    ("marble", 5, -1, 0.05, 0.25),
]
_IMAGES = ["stone", "stone_n", "plaster", "brick", "brick_n", "marble"]


def _generate(tess: int, seed: int):
    rng = np.random.default_rng(seed)
    stone_rgb, stone_n = _tex_stone(rng)
    plaster_rgb = _tex_plaster(rng)
    brick_rgb, brick_n = _tex_brick(rng)
    marble_rgb = _tex_marble(rng)
    images = {"stone": stone_rgb.astype(np.uint8), "stone_n": stone_n,
              "plaster": plaster_rgb.astype(np.uint8), "brick": brick_rgb.astype(np.uint8),
              "brick_n": brick_n, "marble": marble_rgb.astype(np.uint8)}
    t = max(1, int(tess))
    hw, hl = _W / 2, _L / 2
    floor = [_plane([-hw, 0, -hl], [0, 0, _L], [_W, 0, 0], 48 * t, 16 * t, uv_rep=(24, 8))]
    plaster = [
        _plane([-hw, _H, -hl], [_W, 0, 0], [0, 0, _L], 16 * t, 48 * t, uv_rep=(6, 18)),
        _plane([-hw, 0, -hl], [_W, 0, 0], [0, _H, 0], 16 * t, 10 * t, uv_rep=(5, 3)),
        _plane([hw, 0, hl], [-_W, 0, 0], [0, _H, 0], 16 * t, 10 * t, uv_rep=(5, 3)),
    ]
    brick = [
        _plane([-hw, 0, hl], [0, 0, -_L], [0, _H, 0], 48 * t, 10 * t, uv_rep=(18, 4)),
        _plane([hw, 0, -hl], [0, 0, _L], [0, _H, 0], 48 * t, 10 * t, uv_rep=(18, 4)),
    ]
    marble = []
    for x in (-6.0, 6.0):
        for z in np.arange(-hl + 5.0, hl - 4.0, 5.0):
            marble.append(_cylinder([x, 0.8, z], 0.8, _H - 0.8, 24, 16 * t))
            marble.extend(_box([x, 0.4, z], [2.0, 0.8, 2.0], 4))
    groups = [_merge(floor), _merge(plaster), _merge(brick), _merge(marble)]
    light_z = np.arange(-24.0, 25.0, 12.0)
    return images, groups, light_z


def materials():
    """The hall's materials, (name, Material) in group order."""
    return [(name, Material((1.0, 1.0, 1.0, 1.0), base_tex=base, metallic=metal,
                            roughness=rough, normal_tex=nmap))
            for name, base, nmap, metal, rough in _MATERIALS]


def lights(light_z):
    return [Light((0.0, _H - 2.5, float(z)), (1.0, 0.96, 0.9), 600.0, 0) for z in light_z]


def make(params: dict, asset_dir: str) -> SceneInput:
    tess, seed = int(params["tess"]), int(params["seed"])
    images, groups, light_z = _generate(tess, seed)
    mats, lts = materials(), lights(light_z)
    d = os.path.join(asset_dir, f"sponzoid_t{tess}_s{seed}")
    path = os.path.join(d, "sponzoid.gltf")
    marker = os.path.join(d, "complete")
    if not os.path.exists(marker):  # written once per checkout
        gltf_asset.write_gltf(d, "sponzoid", groups, mats,
                              [(name, images[name]) for name in _IMAGES], lts)
        with open(marker, "w") as f:
            f.write("ok")
    v, n, tg, uv, mat = gltf_asset.triangles(groups)
    return SceneInput(
        kind="gltf", v0=v[:, 0].copy(), v1=v[:, 1].copy(), v2=v[:, 2].copy(),
        uv=uv, tri_mat=mat, materials=[m for _, m in mats], lights=lts,
        images=[gltf_asset.rgba(images[name]) for name in _IMAGES],
        srgb=[i in (0, 2, 3, 5) for i in range(len(_IMAGES))],
        normal=n, tangent=tg, path=path)
