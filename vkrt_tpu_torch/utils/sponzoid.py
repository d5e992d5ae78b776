"""Sponzoid: a generated Sponza-layout asset on disk (the port's copy of
``vkrt_tpu/utils/sponzoid.py``).

The reference's headline workloads are real-world glTF scenes (Sponza,
fireplace, suntemple; config.json:3-6) shipped as a .gltf JSON, an external
.bin buffer and external JPEG/PNG texture files, loaded through tinygltf and
stb_image (hello_vulkan.cpp:445-513). Those assets are not in the reference
repo, so this module writes that asset class from scratch: a colonnaded
hall with

  * four materials (stone floor, plaster ceiling, brick walls, marble
    columns), each with its own external texture file,
  * baseColor textures and PNG normal maps,
  * full per-vertex attributes: POSITION / NORMAL / TANGENT (vec4 with
    handedness) / TEXCOORD_0, uint32 indices,
  * a KHR_lights_punctual point-light rig,
  * one external little-endian .bin buffer referenced by URI,

so ``parse_gltf -> build_scene -> Engine`` runs on the file layout Sponza
ships with. The triangle count scales with ``tess`` (tess=4: 162,624
triangles, the Sponza class).

``texture_format`` picks how the four colour textures are stored:
``"jpeg"`` (the default: the JAX package's file layout byte for byte,
written through PIL) or ``"png"`` (lossless, through ``utils/png.py``, so a
machine without PIL writes and decodes every texture at full size; without
PIL a JPEG decodes to a 1x1 placeholder).

Everything is deterministic (fixed numpy seed), so renders are reproducible
across runs and machines.
"""

from __future__ import annotations

import json
import os

import numpy as np


# --- texture synthesis -------------------------------------------------------


def _save_jpeg(path: str, rgb: np.ndarray, quality: int = 92) -> None:
    from PIL import Image

    Image.fromarray(rgb.astype(np.uint8)).save(
        path, format="JPEG", quality=quality
    )


def _save_png(path: str, img: np.ndarray) -> None:
    """Lossless RGB or RGBA (u8) through the port's own PNG encoder."""
    from vkrt_tpu_torch.utils.png import encode_png

    with open(path, "wb") as f:
        f.write(encode_png(img.astype(np.uint8)))


# texture_format -> (file extension, writer) of the four colour textures
_COLOUR_WRITERS = {"jpeg": ("jpg", _save_jpeg), "png": ("png", _save_png)}


def _normal_from_height(h: np.ndarray, strength: float = 2.0) -> np.ndarray:
    """Height field -> tangent-space normal map RGBA (u8)."""
    gx = np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)
    gy = np.roll(h, -1, axis=0) - np.roll(h, 1, axis=0)
    n = np.stack([-gx * strength, -gy * strength, np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    out = np.empty(h.shape + (4,), np.uint8)
    out[..., :3] = np.clip((n * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    out[..., 3] = 255
    return out


def _tex_stone(rng, n=256):
    """Checkered stone tiles with per-tile brightness jitter + grout lines."""
    yy, xx = np.mgrid[0:n, 0:n]
    tx, ty = xx // (n // 8), yy // (n // 8)
    checker = ((tx + ty) % 2).astype(np.float32)
    tile_id = ty * 8 + tx
    jit = rng.uniform(-0.08, 0.08, size=(64,))[tile_id]
    base = 0.55 + 0.12 * checker + jit
    grout = ((xx % (n // 8) < 2) | (yy % (n // 8) < 2)).astype(np.float32)
    v = np.clip(base * (1.0 - 0.45 * grout), 0, 1)
    rgb = np.stack([v * 255, v * 245, v * 230], axis=-1)
    height = v - 0.5 * grout
    return rgb, _normal_from_height(height, 3.0)


def _tex_plaster(rng, n=256):
    noise = rng.normal(0, 1, size=(n, n)).astype(np.float32)
    # cheap blur: 4 box passes, axis-alternating
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
    rgb = np.stack([r * 255, g * 255, b * 255], axis=-1)
    height = (1.0 - mortar) * (0.5 + jit)
    return rgb, _normal_from_height(height, 2.5)


def _tex_marble(rng, n=256):
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    turb = np.zeros((n, n), np.float32)
    for f, a in ((2, 1.0), (5, 0.5), (11, 0.25)):
        ph = rng.uniform(0, 2 * np.pi, size=2)
        turb += a * np.sin(2 * np.pi * f * xx / n + ph[0]) \
            * np.sin(2 * np.pi * f * yy / n + ph[1])
    v = 0.78 + 0.16 * np.sin(2 * np.pi * (xx + yy) / n * 3 + 2.5 * turb)
    v = np.clip(v, 0, 1)
    return np.stack([v * 250, v * 248, v * 240], axis=-1)


# --- geometry ---------------------------------------------------------------


def _plane(origin, u_vec, v_vec, nu, nv, uv_rep=(1.0, 1.0)):
    """Tessellated parallelogram patch: origin + s*u_vec + t*v_vec,
    s,t in [0,1]. Normal = normalize(u x v); tangent = normalize(u), w=+1.
    Returns (pos, nrm, tan4, uv, idx)."""
    s = np.linspace(0.0, 1.0, nu + 1, dtype=np.float32)
    t = np.linspace(0.0, 1.0, nv + 1, dtype=np.float32)
    ss, tt = np.meshgrid(s, t, indexing="ij")            # (nu+1, nv+1)
    pos = (np.asarray(origin, np.float32)[None, None]
           + ss[..., None] * np.asarray(u_vec, np.float32)[None, None]
           + tt[..., None] * np.asarray(v_vec, np.float32)[None, None])
    n = np.cross(np.asarray(u_vec, np.float32), np.asarray(v_vec, np.float32))
    n = n / np.linalg.norm(n)
    tang = np.asarray(u_vec, np.float32)
    tang = tang / np.linalg.norm(tang)
    npts = (nu + 1) * (nv + 1)
    pos = pos.reshape(npts, 3)
    nrm = np.broadcast_to(n, (npts, 3)).copy()
    tan4 = np.concatenate(
        [np.broadcast_to(tang, (npts, 3)), np.ones((npts, 1), np.float32)],
        axis=1,
    )
    uv = np.stack(
        [ss.reshape(-1) * uv_rep[0], tt.reshape(-1) * uv_rep[1]], axis=1
    ).astype(np.float32)
    i0 = (np.arange(nu)[:, None] * (nv + 1) + np.arange(nv)[None, :]).reshape(-1)
    quad = np.stack([i0, i0 + (nv + 1), i0 + (nv + 1) + 1,
                     i0, i0 + (nv + 1) + 1, i0 + 1], axis=1)
    return pos, nrm, tan4, uv, quad.reshape(-1).astype(np.uint32)


def _cylinder(center, radius, height, nrad, nh, uv_rep=(3.0, 2.0)):
    """Open cylinder around +y through center (base at center.y)."""
    th = np.linspace(0, 2 * np.pi, nrad + 1, dtype=np.float32)
    ys = np.linspace(0.0, height, nh + 1, dtype=np.float32)
    tt, yy = np.meshgrid(th, ys, indexing="ij")          # (nrad+1, nh+1)
    cx, cy, cz = (float(c) for c in center)
    pos = np.stack([cx + radius * np.cos(tt), cy + yy,
                    cz + radius * np.sin(tt)], axis=-1)
    nrm = np.stack([np.cos(tt), np.zeros_like(tt), np.sin(tt)], axis=-1)
    # tangent along increasing theta (the u direction of the uv map)
    tan = np.stack([-np.sin(tt), np.zeros_like(tt), np.cos(tt)], axis=-1)
    npts = (nrad + 1) * (nh + 1)
    uv = np.stack([tt.reshape(-1) / (2 * np.pi) * uv_rep[0],
                   yy.reshape(-1) / height * uv_rep[1]], axis=1)
    i0 = (np.arange(nrad)[:, None] * (nh + 1) + np.arange(nh)[None, :]).reshape(-1)
    quad = np.stack([i0, i0 + (nh + 1), i0 + (nh + 1) + 1,
                     i0, i0 + (nh + 1) + 1, i0 + 1], axis=1)
    tan4 = np.concatenate(
        [tan.reshape(npts, 3), np.ones((npts, 1), np.float32)], axis=1
    )
    return (pos.reshape(npts, 3).astype(np.float32),
            nrm.reshape(npts, 3).astype(np.float32),
            tan4.astype(np.float32), uv.astype(np.float32),
            quad.reshape(-1).astype(np.uint32))


def _box(center, size, nu, uv_rep=(1.0, 1.0)):
    """Axis-aligned box from 6 plane patches (outward normals)."""
    cx, cy, cz = center
    sx, sy, sz = (s / 2.0 for s in size)
    faces = [
        # origin, u, v  (u x v = outward normal)
        ([cx - sx, cy - sy, cz + sz], [2 * sx, 0, 0], [0, 2 * sy, 0]),  # +z
        ([cx + sx, cy - sy, cz - sz], [-2 * sx, 0, 0], [0, 2 * sy, 0]),  # -z
        ([cx + sx, cy - sy, cz + sz], [0, 0, -2 * sz], [0, 2 * sy, 0]),  # +x
        ([cx - sx, cy - sy, cz - sz], [0, 0, 2 * sz], [0, 2 * sy, 0]),  # -x
        ([cx - sx, cy + sy, cz + sz], [2 * sx, 0, 0], [0, 0, -2 * sz]),  # +y
        ([cx - sx, cy - sy, cz - sz], [2 * sx, 0, 0], [0, 0, 2 * sz]),  # -y
    ]
    return [_plane(o, u, v, nu, nu, uv_rep) for (o, u, v) in faces]


def _merge(pieces):
    """Concatenate (pos, nrm, tan, uv, idx) pieces into one primitive."""
    pos, nrm, tan, uv, idx = [], [], [], [], []
    base = 0
    for (p, n, t, u, i) in pieces:
        pos.append(p); nrm.append(n); tan.append(t); uv.append(u)
        idx.append(i + base)
        base += len(p)
    return (np.concatenate(pos), np.concatenate(nrm), np.concatenate(tan),
            np.concatenate(uv), np.concatenate(idx))


# --- asset writer -----------------------------------------------------------

# hall dimensions
_W, _H, _L = 20.0, 12.0, 60.0


def write_sponzoid(dir_path: str, tess: int = 4, seed: int = 7,
                   texture_format: str = "jpeg") -> str:
    """Write the sponzoid asset into ``dir_path`` (created if needed).
    Returns the path of the .gltf entry file. Layout (``ext``: ``jpg`` for
    ``texture_format="jpeg"``, ``png`` for ``"png"``):

        dir_path/sponzoid.gltf
        dir_path/sponzoid.bin
        dir_path/textures/{stone,plaster,brick,marble}.<ext>
        dir_path/textures/{stone,brick}_n.png
    """
    if texture_format not in _COLOUR_WRITERS:
        raise ValueError(f"texture_format must be one of {sorted(_COLOUR_WRITERS)}, "
                         f"got {texture_format!r}")
    ext, save_colour = _COLOUR_WRITERS[texture_format]
    os.makedirs(os.path.join(dir_path, "textures"), exist_ok=True)
    rng = np.random.default_rng(seed)

    stone_rgb, stone_n = _tex_stone(rng)
    plaster_rgb = _tex_plaster(rng)
    brick_rgb, brick_n = _tex_brick(rng)
    marble_rgb = _tex_marble(rng)
    for name, rgb in (("stone", stone_rgb), ("plaster", plaster_rgb),
                      ("brick", brick_rgb), ("marble", marble_rgb)):
        save_colour(os.path.join(dir_path, "textures", f"{name}.{ext}"), rgb)
    _save_png(os.path.join(dir_path, "textures", "stone_n.png"), stone_n)
    _save_png(os.path.join(dir_path, "textures", "brick_n.png"), brick_n)

    t = max(1, int(tess))
    hw, hl = _W / 2, _L / 2

    # material 0: stone floor (u x v = +y, into the hall)
    floor = [_plane([-hw, 0, -hl], [0, 0, _L], [_W, 0, 0],
                    48 * t, 16 * t, uv_rep=(24, 8))]
    # material 1: plaster ceiling + end walls (ceiling u x v = -y)
    plaster = [
        _plane([-hw, _H, -hl], [_W, 0, 0], [0, 0, _L],
               16 * t, 48 * t, uv_rep=(6, 18)),
        _plane([-hw, 0, -hl], [_W, 0, 0], [0, _H, 0],
               16 * t, 10 * t, uv_rep=(5, 3)),          # back (+z normal)
        _plane([hw, 0, hl], [-_W, 0, 0], [0, _H, 0],
               16 * t, 10 * t, uv_rep=(5, 3)),          # front (-z normal)
    ]
    # material 2: brick side walls
    brick = [
        _plane([-hw, 0, hl], [0, 0, -_L], [0, _H, 0],
               48 * t, 10 * t, uv_rep=(18, 4)),         # left (+x normal)
        _plane([hw, 0, -hl], [0, 0, _L], [0, _H, 0],
               48 * t, 10 * t, uv_rep=(18, 4)),         # right (-x normal)
    ]
    # material 3: marble columns + plinths
    marble = []
    zs = np.arange(-hl + 5.0, hl - 4.0, 5.0)
    for x in (-6.0, 6.0):
        for z in zs:
            marble.append(_cylinder([x, 0.8, z], 0.8, _H - 0.8, 24, 16 * t))
            marble.extend(_box([x, 0.4, z], [2.0, 0.8, 2.0], 4))

    groups = [
        ("floor", _merge(floor), 0),
        ("plaster", _merge(plaster), 1),
        ("brick", _merge(brick), 2),
        ("marble", _merge(marble), 3),
    ]

    # --- one external .bin buffer, accessors per primitive ---------------
    bin_parts, views = [], []
    offset = 0

    def add_view(data: bytes):
        nonlocal offset
        pad = (4 - len(data) % 4) % 4
        data = data + b"\x00" * pad
        views.append(
            {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        )
        bin_parts.append(data)
        offset += len(data)
        return len(views) - 1

    accessors, primitives = [], []

    def add_acc(arr, gl_type, comp):
        accessors.append({
            "bufferView": add_view(np.ascontiguousarray(arr).tobytes()),
            "componentType": comp,
            "count": int(len(arr)),
            "type": gl_type,
            **({"min": np.asarray(arr, np.float64).min(0).tolist(),
                "max": np.asarray(arr, np.float64).max(0).tolist()}
               if gl_type == "VEC3" and comp == 5126 else {}),
        })
        return len(accessors) - 1

    for _name, (pos, nrm, tan, uv, idx), mat in groups:
        primitives.append({
            "attributes": {
                "POSITION": add_acc(pos, "VEC3", 5126),
                "NORMAL": add_acc(nrm, "VEC3", 5126),
                "TANGENT": add_acc(tan, "VEC4", 5126),
                "TEXCOORD_0": add_acc(uv, "VEC2", 5126),
            },
            "indices": add_acc(idx, "SCALAR", 5125),
            "material": mat,
        })

    images = [
        {"uri": f"textures/stone.{ext}", "name": "stone"},
        {"uri": "textures/stone_n.png", "name": "stone_n"},
        {"uri": f"textures/plaster.{ext}", "name": "plaster"},
        {"uri": f"textures/brick.{ext}", "name": "brick"},
        {"uri": "textures/brick_n.png", "name": "brick_n"},
        {"uri": f"textures/marble.{ext}", "name": "marble"},
    ]
    textures = [{"source": i, "sampler": 0} for i in range(len(images))]
    materials = [
        {"name": "stone_floor",
         "pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                  "metallicFactor": 0.0,
                                  "roughnessFactor": 0.55},
         "normalTexture": {"index": 1}},
        {"name": "plaster",
         "pbrMetallicRoughness": {"baseColorTexture": {"index": 2},
                                  "metallicFactor": 0.0,
                                  "roughnessFactor": 0.9}},
        {"name": "brick",
         "pbrMetallicRoughness": {"baseColorTexture": {"index": 3},
                                  "metallicFactor": 0.0,
                                  "roughnessFactor": 0.85},
         "normalTexture": {"index": 4}},
        {"name": "marble",
         "pbrMetallicRoughness": {"baseColorTexture": {"index": 5},
                                  "metallicFactor": 0.05,
                                  "roughnessFactor": 0.25}},
    ]
    lights = [
        {"type": "point", "color": [1.0, 0.96, 0.9], "intensity": 600.0}
        for _ in range(5)
    ]
    light_nodes = [
        {"translation": [0.0, _H - 2.5, float(z)],
         "extensions": {"KHR_lights_punctual": {"light": i}}}
        for i, z in enumerate(np.arange(-24.0, 25.0, 12.0))
    ]
    doc = {
        "asset": {"version": "2.0", "generator": "vkrt_tpu sponzoid"},
        "scene": 0,
        "scenes": [{"nodes": list(range(1 + len(light_nodes)))}],
        "nodes": [{"mesh": 0}] + light_nodes,
        "meshes": [{"primitives": primitives}],
        "accessors": accessors,
        "bufferViews": views,
        "buffers": [{"uri": "sponzoid.bin", "byteLength": offset}],
        "images": images,
        "samplers": [{}],
        "textures": textures,
        "materials": materials,
        "extensions": {"KHR_lights_punctual": {"lights": lights}},
        "extensionsUsed": ["KHR_lights_punctual"],
    }
    with open(os.path.join(dir_path, "sponzoid.bin"), "wb") as f:
        f.write(b"".join(bin_parts))
    gltf_path = os.path.join(dir_path, "sponzoid.gltf")
    with open(gltf_path, "w") as f:
        json.dump(doc, f)
    return gltf_path


def sponzoid_path(dir_path: str, tess: int = 4, seed: int = 7,
                  texture_format: str = "jpeg") -> str:
    """Write the asset unless ``dir_path`` already holds it for these
    generator parameters; returns the .gltf path. A marker file names the
    parameters (``tess``, ``seed`` and ``texture_format``); writing another
    form first removes every marker, so two forms never mix in one
    directory."""
    tag = os.path.join(dir_path, f".sponzoid_t{tess}_s{seed}_{texture_format}")
    gltf_path = os.path.join(dir_path, "sponzoid.gltf")
    if not (os.path.exists(tag) and os.path.exists(gltf_path)):
        if os.path.isdir(dir_path):
            for name in os.listdir(dir_path):
                if name.startswith(".sponzoid_"):
                    os.remove(os.path.join(dir_path, name))
        write_sponzoid(dir_path, tess=tess, seed=seed, texture_format=texture_format)
        with open(tag, "w") as f:
            f.write("ok")
    return gltf_path


def load_sponzoid(dir_path: str, tess: int = 4, seed: int = 7,
                  texture_format: str = "jpeg", device=None, instanced: bool = False):
    """Write (if absent), parse and build the scene on ``device`` (None: the
    card). The copy on disk is reused when its generator parameters match.
    ``instanced``: return an ``InstancedScene`` (``scene_instances``), whose
    primitives can be moved, instead of the flat ``SceneTensors``."""
    from vkrt_tpu_torch.scene import build_scene
    from vkrt_tpu_torch.scene_instances import build_instanced
    from vkrt_tpu_torch.utils.gltf import parse_gltf

    doc = parse_gltf(sponzoid_path(dir_path, tess, seed, texture_format))
    return build_instanced(doc, device=device) if instanced else build_scene(doc, device=device)
