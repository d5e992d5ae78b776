"""The sponzoid hall with alpha-tested geometry, as the glTF Sponza holds
it: potted plants of crossed leaf cards and chains hanging from the
ceiling, MASK materials whose baseColor textures carry cutout alpha, and,
where ``veils`` asks for them, translucent veils across the hall, a BLEND
material. The hall is ``scenes/sponzoid.py``'s (its groups, materials,
images and lights), and the asset is written by ``scenes/gltf_asset.py``
for the program's glTF loader.

Parameters: ``tess`` and ``seed`` (the hall's, and the textures'),
``plants`` a side of the hall (between the columns, 5 apart from the +z
end, where the sponzoid's camera stands), ``chains`` (alternately left and
right of a light, from the +z end), ``veils`` (16 apart from the +z end)
and ``cutoff`` (the MASK materials' alphaCutoff, default 0.5).
"""

from __future__ import annotations

import os

import numpy as np

from framebench.scenes import Material, SceneInput, gltf_asset
from framebench.scenes import sponzoid as hall

PLANT_X = 3.6  # the plants' rows, inside the columns at x = +-6
POT = 0.8      # a pot's side and height
CARD_W, CARD_H = 2.2, 2.4
CHAIN_W, CHAIN_LEN, CHAIN_X = 0.25, 2.2, 1.5


def _tex_leaves(rng, n=256):
    """Leaves (ellipses at random angles) on alpha 0."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) + 0.5
    rgba = np.zeros((n, n, 4), np.float32)
    for _ in range(28):
        cx, cy = rng.uniform(0.15, 0.85, size=2) * n
        ang = rng.uniform(0.0, np.pi)
        half_l, half_w = rng.uniform(0.10, 0.20) * n, rng.uniform(0.035, 0.06) * n
        du = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
        dv = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
        inside = (du / half_l) ** 2 + (dv / half_w) ** 2 <= 1.0
        vein = np.clip(np.abs(dv) / half_w, 0.0, 1.0)
        shade = rng.uniform(0.55, 1.0) * (0.75 + 0.25 * vein)
        rgba[inside] = np.stack([60.0 * shade, 150.0 * shade, 45.0 * shade,
                                 np.full_like(shade, 255.0)], axis=-1)[inside]
    return rgba.astype(np.uint8)


def _tex_chain(n=256, links=4):
    """Links down the middle, alternately face-on (rings) and edge-on
    (bars), on alpha 0."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) + 0.5
    step = n / links
    cy = (np.floor(yy / step) + 0.5) * step
    dx, dy = (xx - n / 2) / (0.30 * n), (yy - cy) / (0.55 * step)
    r = np.sqrt(dx * dx + dy * dy)
    ring = (r <= 1.0) & (r >= 0.55)
    bar = (np.abs(xx - n / 2) <= 0.06 * n) & (np.abs(yy - cy) <= 0.55 * step)
    face_on = (np.floor(yy / step) % 2) == 0
    solid = np.where(face_on, ring, bar)
    v = 150.0 + 60.0 * (1.0 - np.clip(r, 0.0, 1.0))
    out = np.zeros((n, n, 4), np.uint8)
    out[..., 0], out[..., 1], out[..., 2] = v * 0.9, v * 0.85, v * 0.8
    out[..., 3] = np.where(solid, 255, 0)
    return out


def _tex_veil(n=256):
    """A striped gauze: alpha between about 0.3 and 0.9."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    a = 0.6 + 0.3 * np.sin(2 * np.pi * xx / n * 6) * np.cos(2 * np.pi * yy / n * 2)
    out = np.empty((n, n, 4), np.uint8)
    out[..., 0], out[..., 1], out[..., 2] = 180, 40, 50
    out[..., 3] = np.clip(a * 255.0, 0, 255).astype(np.uint8)
    return out


def _cards(center, width, height, angles, nu, nv, uv_rep=(1.0, 1.0)):
    """Vertical quads through a vertical axis at ``center`` (its foot), one
    an angle."""
    cx, cy, cz = center
    out = []
    for a in angles:
        u = np.array([np.cos(a), 0.0, np.sin(a)], np.float32) * width
        out.append(hall._plane([cx - u[0] / 2, cy, cz - u[2] / 2], u, [0.0, height, 0.0],
                               nu, nv, uv_rep))
    return out


def make(params: dict, asset_dir: str) -> SceneInput:
    tess, seed = int(params["tess"]), int(params["seed"])
    plants, chains = int(params.get("plants", 10)), int(params.get("chains", 10))
    veils, cutoff = int(params.get("veils", 0)), float(params.get("cutoff", 0.5))
    images, groups, light_z = hall._generate(tess, seed)
    rng = np.random.default_rng([seed, 0xF011A6E])
    t = max(1, tess)
    names = list(hall._IMAGES) + ["leaves", "chain"] + (["veil"] if veils else [])
    images.update(leaves=_tex_leaves(rng), chain=_tex_chain())
    mats = hall.materials() + [
        ("pot", Material((0.8, 0.45, 0.3, 1.0), base_tex=names.index("plaster"),
                         metallic=0.0, roughness=0.8)),
        ("leaves", Material(base_tex=names.index("leaves"), metallic=0.0, roughness=0.7,
                            alpha_mode=1, alpha_cutoff=cutoff)),
        ("chain", Material(base_tex=names.index("chain"), metallic=0.9, roughness=0.4,
                           alpha_mode=1, alpha_cutoff=cutoff))]
    zs = np.arange(hall._L / 2 - 7.5, -hall._L / 2, -5.0)[:plants]
    pots, leaves = [], []
    for x in (-PLANT_X, PLANT_X):
        for z in zs:
            pots.extend(hall._box([x, POT / 2, float(z)], [POT, POT, POT], 2 * t))
            leaves.extend(_cards((x, POT, float(z)), CARD_W, CARD_H,
                                 (0.3, 0.3 + np.pi / 3, 0.3 + 2 * np.pi / 3), 2 * t, 2 * t))
    hang = []
    for k in range(chains):
        x, z = (-CHAIN_X, CHAIN_X)[k % 2], float(light_z[::-1][k // 2 % len(light_z)])
        hang.extend(_cards((x, hall._H - CHAIN_LEN, z), CHAIN_W, CHAIN_LEN,
                           (0.0, np.pi / 2), 1, 2 * t, uv_rep=(1.0, 4.0)))
    groups = groups + [hall._merge(pots), hall._merge(leaves), hall._merge(hang)]
    if veils:
        images["veil"] = _tex_veil()
        mats.append(("veil", Material((1.0, 1.0, 1.0, 0.8), base_tex=names.index("veil"),
                                      metallic=0.0, roughness=0.9, alpha_mode=2)))
        vz = np.arange(hall._L / 2 - 12.0, -hall._L / 2, -16.0)[:veils]
        groups.append(hall._merge([hall._plane([-4.0, 3.5, float(z)], [8.0, 0.0, 0.0],
                                               [0.0, 5.5, 0.0], 4 * t, 3 * t, (2.0, 1.0))
                                   for z in vz]))
    lights = hall.lights(light_z)
    d = os.path.join(asset_dir, f"foliage_t{tess}_s{seed}_p{plants}_c{chains}_v{veils}"
                                f"_a{cutoff:g}")
    path = os.path.join(d, "foliage.gltf")
    marker = os.path.join(d, "complete")
    if not os.path.exists(marker):  # written once per checkout
        gltf_asset.write_gltf(d, "foliage", groups, mats, [(n, images[n]) for n in names],
                              lights)
        with open(marker, "w") as f:
            f.write("ok")
    v, n, tg, uv, mat = gltf_asset.triangles(groups)
    srgb = {"stone", "plaster", "brick", "marble", "leaves", "chain", "veil"}
    return SceneInput(
        kind="gltf", v0=v[:, 0].copy(), v1=v[:, 1].copy(), v2=v[:, 2].copy(),
        uv=uv, tri_mat=mat, materials=[m for _, m in mats], lights=lights,
        images=[gltf_asset.rgba(images[n]) for n in names], srgb=[n in srgb for n in names],
        normal=n, tangent=tg, path=path)
