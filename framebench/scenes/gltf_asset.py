"""Writing a generated scene as a glTF asset on disk (one external .bin
buffer, PNG textures) for the program's glTF loader, and expanding the
same arrays to triangles for the reference.

A scene here is a list of groups, one a material, each
``(positions, normals, tangents, uvs, indices)``, with the materials and
images it names (``framebench.scenes.Material``; an image is (H, W, 3) or
(H, W, 4) uint8, written as PNG colour type 2 or 6, so a texture with
alpha keeps it) and point lights. A material writes only what differs
from glTF's defaults, and ``alphaMode`` and ``alphaCutoff`` where it is not
opaque. The sponzoid (``scenes/sponzoid.py``) is written by it byte for
byte as before it was shared.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

ALPHA_MODES = ("OPAQUE", "MASK", "BLEND")


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 -> PNG bytes (filter 0)."""
    h, w, c = img.shape

    def chunk(ctype: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + ctype + data
                + struct.pack(">I", zlib.crc32(ctype + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    scan = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(scan.tobytes(), 6)) + chunk(b"IEND", b""))


def _material(name: str, m) -> dict:
    pbr = {}
    if tuple(m.base_color) != (1.0, 1.0, 1.0, 1.0):
        pbr["baseColorFactor"] = [float(c) for c in m.base_color]
    if m.base_tex >= 0:
        pbr["baseColorTexture"] = {"index": m.base_tex}
    pbr["metallicFactor"] = m.metallic
    pbr["roughnessFactor"] = m.roughness
    if m.mr_tex >= 0:
        pbr["metallicRoughnessTexture"] = {"index": m.mr_tex}
    out = {"name": name, "pbrMetallicRoughness": pbr}
    if m.normal_tex >= 0:
        out["normalTexture"] = {"index": m.normal_tex}
    if tuple(m.emissive) != (0.0, 0.0, 0.0):
        out["emissiveFactor"] = [float(c) for c in m.emissive]
    if m.emissive_tex >= 0:
        out["emissiveTexture"] = {"index": m.emissive_tex}
    if m.alpha_mode != 0:
        out["alphaMode"] = ALPHA_MODES[m.alpha_mode]
        out["alphaCutoff"] = float(m.alpha_cutoff)
    return out


def write_gltf(dir_path: str, stem: str, groups, materials, images, lights) -> str:
    """Writes ``<stem>.gltf``, ``<stem>.bin`` and ``textures/<name>.png``
    under ``dir_path``; returns the .gltf's path. ``groups``: one
    ``(pos, nrm, tan, uv, idx)`` a material, in order; ``materials``:
    ``(name, Material)`` pairs, whose texture indices index ``images``:
    ``(name, array)`` pairs; ``lights``: point ``Light``s."""
    if any(lt.type != 0 for lt in lights):
        raise ValueError("write_gltf writes point lights only")
    os.makedirs(os.path.join(dir_path, "textures"), exist_ok=True)
    for name, img in images:
        with open(os.path.join(dir_path, "textures", f"{name}.png"), "wb") as f:
            f.write(encode_png(img))
    bin_parts, views, accessors, primitives = [], [], [], []
    offset = 0

    def add_acc(arr, gl_type, comp):
        nonlocal offset
        data = np.ascontiguousarray(arr).tobytes()
        data += b"\x00" * ((4 - len(data) % 4) % 4)
        views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(data)})
        bin_parts.append(data)
        offset += len(data)
        acc = {"bufferView": len(views) - 1, "componentType": comp, "count": int(len(arr)),
               "type": gl_type}
        if gl_type == "VEC3" and comp == 5126:
            acc["min"] = np.asarray(arr, np.float64).min(0).tolist()
            acc["max"] = np.asarray(arr, np.float64).max(0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    for mat, (pos, nrm, tan, uv, idx) in enumerate(groups):
        primitives.append({
            "attributes": {"POSITION": add_acc(pos, "VEC3", 5126),
                           "NORMAL": add_acc(nrm, "VEC3", 5126),
                           "TANGENT": add_acc(tan, "VEC4", 5126),
                           "TEXCOORD_0": add_acc(uv, "VEC2", 5126)},
            "indices": add_acc(idx, "SCALAR", 5125), "material": mat})
    light_nodes = [{"translation": [float(c) for c in lt.position],
                    "extensions": {"KHR_lights_punctual": {"light": i}}}
                   for i, lt in enumerate(lights)]
    doc = {
        "asset": {"version": "2.0", "generator": f"framebench {stem}"},
        "scene": 0,
        "scenes": [{"nodes": list(range(1 + len(light_nodes)))}],
        "nodes": [{"mesh": 0}] + light_nodes,
        "meshes": [{"primitives": primitives}],
        "accessors": accessors, "bufferViews": views,
        "buffers": [{"uri": f"{stem}.bin", "byteLength": offset}],
        "images": [{"uri": f"textures/{n}.png", "name": n} for n, _ in images],
        "samplers": [{}],
        "textures": [{"source": i, "sampler": 0} for i in range(len(images))],
        "materials": [_material(name, m) for name, m in materials],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "point", "color": [float(c) for c in lt.color],
             "intensity": float(lt.intensity)} for lt in lights]}},
        "extensionsUsed": ["KHR_lights_punctual"],
    }
    with open(os.path.join(dir_path, f"{stem}.bin"), "wb") as f:
        f.write(b"".join(bin_parts))
    path = os.path.join(dir_path, f"{stem}.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def rgba(img: np.ndarray) -> np.ndarray:
    """An image as the program holds it: four channels, alpha 255 where the
    file has none."""
    if img.shape[2] == 4:
        return img
    return np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)


def triangles(groups):
    """The groups expanded to triangles, as a ``SceneInput`` holds them:
    (corners (T, 3, 3), normals (T, 3, 3), tangents (T, 3, 4), uvs (T, 3, 2),
    material ids (T,) int32), each float array f32."""
    v, n, tg, uv, mat = [], [], [], [], []
    for m, (pos, nrm, tan, tex, idx) in enumerate(groups):
        tri = idx.astype(np.int64).reshape(-1, 3)
        v.append(pos[tri])
        n.append(nrm[tri])
        tg.append(tan[tri])
        uv.append(tex[tri])
        mat.append(np.full(len(tri), m, np.int32))
    return (np.concatenate(v).astype(np.float32), np.concatenate(n).astype(np.float32),
            np.concatenate(tg).astype(np.float32), np.concatenate(uv).astype(np.float32),
            np.concatenate(mat))
