"""First-party minimal glTF 2.0 parser (numpy, host-side); the port's copy
of ``vkrt_tpu/utils/gltf.py``.

The TPU-native replacement for tinygltf + ``nvh::GltfScene`` (reference
hello_vulkan.cpp:327-394): parses .gltf/.glb, flattens the node hierarchy into
drawable (primitive, world-matrix) instances, imports pbrMetallicRoughness
materials in the exact ``GltfPBRMaterial`` field set (host_device.h:119-129)
and ``KHR_lights_punctual`` lights in the ``GltfLight`` field set
(host_device.h:131-137, world position = worldMatrix.col(3),
hello_vulkan.cpp:237-240).

Supports: external .bin buffers, embedded base64 data URIs, GLB containers,
strided bufferViews, u8/u16/u32 indices, normalized integer attributes,
node TRS + matrix composition. Unsupported glTF corners (sparse accessors,
morph targets, skins, Draco) raise clearly.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import struct
from typing import List, Optional

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_NCOMP = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}
_LIGHT_TYPE = {"point": 0, "directional": 1, "spot": 2}  # hello_vulkan.cpp:230-233


@dataclasses.dataclass
class GltfMaterial:
    """GltfPBRMaterial mirror (host_device.h:119-129); *_texture = image index or -1."""

    base_color_factor: np.ndarray  # (4,)
    base_color_texture: int = -1
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    metallic_roughness_texture: int = -1
    normal_texture: int = -1
    emissive_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    emissive_texture: int = -1
    # transparency: 0=OPAQUE, 1=MASK (alpha_cutoff), 2=BLEND (stochastic).
    # The reference's any-hit shader gates on WaveFrontMaterial illum==4 +
    # dissolve (raytrace_rahit_todo.glsl:32-38); glTF expresses the same
    # through alphaMode/alphaCutoff + baseColor alpha.
    alpha_mode: int = 0
    alpha_cutoff: float = 0.5


@dataclasses.dataclass
class GltfLight:
    """GltfLight mirror (host_device.h:131-137)."""

    position: np.ndarray  # (3,) world space
    color: np.ndarray     # (3,)
    intensity: float
    type: int             # 0 point / 1 directional / 2 spot


@dataclasses.dataclass
class GltfPrimitiveInstance:
    """One drawable primitive baked with its node's world matrix."""

    positions: np.ndarray            # (V,3) f32, object space
    indices: np.ndarray              # (I,) u32
    normals: Optional[np.ndarray]    # (V,3) or None
    tangents: Optional[np.ndarray]   # (V,4) or None
    uvs: Optional[np.ndarray]        # (V,2) or None
    material: int                    # material index (may be -1)
    world_matrix: np.ndarray         # (4,4)


@dataclasses.dataclass
class GltfImage:
    data: np.ndarray                 # (H,W,4) uint8
    name: str = ""


@dataclasses.dataclass
class GltfDocument:
    primitives: List[GltfPrimitiveInstance]
    materials: List[GltfMaterial]
    lights: List[GltfLight]
    images: List[GltfImage]


def _node_local_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T  # column-major
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        t = np.eye(4)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _load_buffers(doc: dict, base_dir: str, glb_bin: Optional[bytes]) -> List[bytes]:
    out = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if glb_bin is None:
                raise ValueError("glTF buffer without uri outside a GLB container")
            out.append(glb_bin)
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _read_accessor(doc: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    if "sparse" in acc:
        raise NotImplementedError("sparse accessors not supported")
    count = acc["count"]
    ncomp = _TYPE_NCOMP[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    itemsize = np.dtype(dtype).itemsize * ncomp
    if "bufferView" not in acc:
        data = np.zeros((count, ncomp), dtype)
    else:
        bv = doc["bufferViews"][acc["bufferView"]]
        raw = buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", itemsize)
        if stride == itemsize:
            data = np.frombuffer(raw, dtype, count * ncomp, start).reshape(count, ncomp)
        else:
            rows = []
            for i in range(count):
                rows.append(np.frombuffer(raw, dtype, ncomp, start + i * stride))
            data = np.stack(rows)
    if acc.get("normalized") and np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        data = data.astype(np.float32) / float(info.max)
        if info.min < 0:
            data = np.maximum(data, -1.0)
    return np.array(data)  # copy: frombuffer views are read-only


def _decode_image(blob: bytes, name: str) -> np.ndarray:
    from vkrt_tpu_torch.utils import png as _png

    if blob[:8] == b"\x89PNG\r\n\x1a\n":
        return _png.decode_png(blob)
    try:  # JPEG and friends: use PIL when present
        import io

        from PIL import Image  # type: ignore

        img = Image.open(io.BytesIO(blob)).convert("RGBA")
        return np.asarray(img, np.uint8)
    except Exception:
        # Unknown codec: 1x1 white placeholder (parity with the reference's
        # dummy texture path, hello_vulkan.cpp:458-466).
        return np.full((1, 1, 4), 255, np.uint8)


def parse_gltf(path: str) -> GltfDocument:
    base_dir = os.path.dirname(os.path.abspath(path))
    glb_bin = None
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head == b"glTF":  # GLB container
            magic, version, _length = struct.unpack("<III", f.read(12))
            del magic, version
            doc = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                clen, ctype = struct.unpack("<II", hdr)
                payload = f.read(clen)
                if ctype == 0x4E4F534A:  # 'JSON'
                    doc = json.loads(payload)
                elif ctype == 0x004E4942:  # 'BIN'
                    glb_bin = payload
            if doc is None:
                raise ValueError("GLB missing JSON chunk")
        else:
            doc = json.load(open(path, "r"))

    buffers = _load_buffers(doc, base_dir, glb_bin)

    # Images
    images: List[GltfImage] = []
    for img in doc.get("images", []):
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                blob = base64.b64decode(uri.split(",", 1)[1])
            else:
                from urllib.parse import unquote

                with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
                    blob = f.read()
        else:
            bv = doc["bufferViews"][img["bufferView"]]
            off = bv.get("byteOffset", 0)
            blob = buffers[bv["buffer"]][off : off + bv["byteLength"]]
        images.append(GltfImage(_decode_image(blob, img.get("name", "")), img.get("name", "")))

    # texture index -> image index
    tex_to_img = [t.get("source", -1) for t in doc.get("textures", [])]

    def _tex(info) -> int:
        if info is None:
            return -1
        t = info.get("index", -1)
        return tex_to_img[t] if 0 <= t < len(tex_to_img) else -1

    materials: List[GltfMaterial] = []
    for m in doc.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        materials.append(
            GltfMaterial(
                base_color_factor=np.asarray(
                    pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32
                ),
                base_color_texture=_tex(pbr.get("baseColorTexture")),
                metallic_factor=float(pbr.get("metallicFactor", 1.0)),
                roughness_factor=float(pbr.get("roughnessFactor", 1.0)),
                metallic_roughness_texture=_tex(pbr.get("metallicRoughnessTexture")),
                normal_texture=_tex(m.get("normalTexture")),
                emissive_factor=np.asarray(m.get("emissiveFactor", [0, 0, 0]), np.float32),
                emissive_texture=_tex(m.get("emissiveTexture")),
                alpha_mode={"OPAQUE": 0, "MASK": 1, "BLEND": 2}.get(
                    m.get("alphaMode", "OPAQUE"), 0
                ),
                alpha_cutoff=float(m.get("alphaCutoff", 0.5)),
            )
        )
    if not materials:
        materials.append(GltfMaterial(base_color_factor=np.ones(4, np.float32)))

    light_defs = (
        doc.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])
    )

    primitives: List[GltfPrimitiveInstance] = []
    lights: List[GltfLight] = []

    def visit(node_idx: int, parent: np.ndarray):
        node = doc["nodes"][node_idx]
        world = parent @ _node_local_matrix(node)
        if "mesh" in node:
            mesh = doc["meshes"][node["mesh"]]
            for prim in mesh.get("primitives", []):
                if prim.get("mode", 4) != 4:  # triangles only
                    continue
                attrs = prim["attributes"]
                positions = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
                if "indices" in prim:
                    indices = _read_accessor(doc, buffers, prim["indices"]).reshape(-1)
                    indices = indices.astype(np.uint32)
                else:
                    indices = np.arange(len(positions), dtype=np.uint32)
                normals = (
                    _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
                    if "NORMAL" in attrs
                    else None
                )
                tangents = (
                    _read_accessor(doc, buffers, attrs["TANGENT"]).astype(np.float32)
                    if "TANGENT" in attrs
                    else None
                )
                uvs = (
                    _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
                    if "TEXCOORD_0" in attrs
                    else None
                )
                primitives.append(
                    GltfPrimitiveInstance(
                        positions=positions,
                        indices=indices,
                        normals=normals,
                        tangents=tangents,
                        uvs=uvs,
                        material=int(prim.get("material", -1)),
                        world_matrix=world.copy(),
                    )
                )
        lt = node.get("extensions", {}).get("KHR_lights_punctual", {})
        if "light" in lt:
            ld = light_defs[lt["light"]]
            lights.append(
                GltfLight(
                    position=world[:3, 3].astype(np.float32),
                    color=np.asarray(ld.get("color", [1, 1, 1]), np.float32),
                    intensity=float(ld.get("intensity", 1.0)),
                    type=_LIGHT_TYPE.get(ld.get("type", "point"), 0),
                )
            )
        for child in node.get("children", []):
            visit(child, world)

    scene_idx = doc.get("scene", 0)
    scene_nodes = doc.get("scenes", [{}])[scene_idx].get("nodes", [])
    for n in scene_nodes:
        visit(n, np.eye(4))

    return GltfDocument(primitives, materials, lights, images)
