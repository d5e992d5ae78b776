"""Scene representation: flat SoA tensors (port of ``vkrt_tpu/scene.py``).

The numpy baking of the JAX package is kept line for line, so both packages
build equal arrays from one glTF document or triangle soup, textured scenes
and their mip atlas included (bf16 unless ``VKRT_TEX_BF16=0``). Which
texture slots a scene uses is decided once, from the host arrays
(``tex_slots_used``), so the shading paths pick their branches without
reading the device back every frame.

Every constructor takes ``device``: ``None`` means the card
(``device.select()``, which raises without one); the CPU tests pass
``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from vkrt_tpu_torch.config import EngineConfig, resolve_scene_path
from vkrt_tpu_torch.device import select
from vkrt_tpu_torch.ops.texture import pack_mip_atlas, srgb_to_linear
from vkrt_tpu_torch.utils import gltf as gltf_mod

TRI_PAD = 64  # pad triangle count to a lane-friendly multiple


class SceneTensors(NamedTuple):
    """Flat scene. T triangles (padded), M materials, L lights, K textures.
    The fields of ``vkrt_tpu.scene.SceneArrays``, as tensors."""

    tri_v0: torch.Tensor           # (T,3) f32
    tri_e1: torch.Tensor           # (T,3)
    tri_e2: torch.Tensor           # (T,3)
    corner_normal: torch.Tensor    # (T,3,3)
    corner_tangent: torch.Tensor   # (T,3,4)  xyz + handedness w
    corner_uv: torch.Tensor        # (T,3,2)
    tri_mat: torch.Tensor          # (T,) i32
    mat_base_color: torch.Tensor   # (M,4)
    mat_base_tex: torch.Tensor     # (M,) i32  (-1 = none)
    mat_metallic: torch.Tensor     # (M,)
    mat_roughness: torch.Tensor    # (M,)
    mat_mr_tex: torch.Tensor       # (M,) i32
    mat_normal_tex: torch.Tensor   # (M,) i32
    mat_emissive: torch.Tensor     # (M,3)
    mat_emissive_tex: torch.Tensor  # (M,) i32
    mat_alpha_mode: torch.Tensor   # (M,) i32: 0 opaque / 1 mask / 2 blend
    mat_alpha_cutoff: torch.Tensor  # (M,) f32
    light_pos: torch.Tensor        # (L,3)
    light_color: torch.Tensor      # (L,3)
    light_intensity: torch.Tensor  # (L,)
    light_type: torch.Tensor       # (L,) i32
    tex_rgba: torch.Tensor         # (K,TH,TW,4) f32
    tex_size: torch.Tensor         # (K,2) i32 (w,h)
    tex_mip_atlas: torch.Tensor    # (K,TH,2*TW,4) bf16 (f32 with VKRT_TEX_BF16=0)
    tex_level_size: torch.Tensor   # (K,L,2) i32
    tex_level_off: torch.Tensor    # (K,L) i32
    tex_n_levels: torch.Tensor     # (K,) i32
    tri_uv_density: torch.Tensor   # (T,) f32

    @property
    def num_tris(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device


# Fallback point-light rig used when a scene ships no KHR_lights_punctual
# lights (hello_vulkan.cpp:247-321).
FALLBACK_LIGHTS = [
    ((1.0, 5.0, -1.33), (1.0, 1.0, 1.0), 50.0, 0),
    ((0.0, 3.0, 67.0), (1.0, 0.01, 0.1), 50.0, 0),
    ((-1.3, 7.62, 59.0), (1.0, 1.0, 1.0), 50.0, 0),
    ((2.4, 2.05, 40.6), (1.0, 1.0, 1.0), 50.0, 0),
    ((-0.33, 6.85, 30.0), (1.0, 1.0, 1.0), 50.0, 0),
    ((-6.2, 9.6, 20.18), (1.0, 1.0, 1.0), 50.0, 0),
    ((-0.23, 6.93, 12.21), (1.0, 1.0, 0.0), 50.0, 0),
    ((0.24, 3.03, 49.94), (0.0, 0.0, 1.0), 50.0, 0),
]

_TEX_SLOTS = ("mat_base_tex", "mat_mr_tex", "mat_normal_tex", "mat_emissive_tex")
# which texture slots a scene uses, decided once: keyed by its mat_base_tex
# tensor, the value holds the other three slot tensors and the answer
_SLOTS_USED = WeakIdKeyDictionary()


def _flat_normals(v0, v1, v2):
    n = np.cross(v1 - v0, v2 - v0)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(ln, 1e-20)


def _compute_tangents(positions, normals, uvs, indices):
    """Per-vertex tangents from UV gradients. Returns (V,4)."""
    v = positions
    t_accum = np.zeros_like(v)
    i0, i1, i2 = indices[0::3], indices[1::3], indices[2::3]
    e1 = v[i1] - v[i0]
    e2 = v[i2] - v[i0]
    duv1 = uvs[i1] - uvs[i0]
    duv2 = uvs[i2] - uvs[i0]
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)[:, None]
    tan = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * r
    for idx in (i0, i1, i2):
        np.add.at(t_accum, idx, tan)
    # Gram-Schmidt per vertex, with an ONB fallback for degenerate tangents
    n = normals
    t = t_accum - n * np.sum(t_accum * n, axis=-1, keepdims=True)
    ln = np.linalg.norm(t, axis=-1, keepdims=True)
    bad = ln[:, 0] < 1e-8
    if bad.any():
        nb = n[bad]
        alt = np.where(
            (np.abs(nb[:, 0:1]) > np.abs(nb[:, 1:2])),
            np.stack([nb[:, 2], np.zeros(len(nb)), -nb[:, 0]], -1),
            np.stack([np.zeros(len(nb)), -nb[:, 2], nb[:, 1]], -1),
        )
        t[bad] = alt
        ln = np.linalg.norm(t, axis=-1, keepdims=True)
    t = t / np.maximum(ln, 1e-20)
    return np.concatenate([t, np.ones((len(v), 1), np.float32)], axis=-1)


def _bake_primitive(prim):
    """World-bake one glTF primitive: (v0, v1, v2, corner_normal,
    corner_tangent, corner_uv, mat_ids) numpy arrays."""
    m = prim.world_matrix.astype(np.float64)
    inv = np.linalg.inv(m)
    pos = prim.positions @ m[:3, :3].T + m[:3, 3]
    idx = prim.indices.astype(np.int64)
    tri = idx.reshape(-1, 3)
    v0, v1, v2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]

    if prim.normals is not None:
        nrm = prim.normals @ inv[:3, :3]  # (M^-1)^T n (raytrace.rchit:74)
        ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm = nrm / np.maximum(ln, 1e-20)
        cn = np.stack([nrm[tri[:, 0]], nrm[tri[:, 1]], nrm[tri[:, 2]]], axis=1)
    else:
        fn = _flat_normals(v0, v1, v2)
        cn = np.repeat(fn[:, None, :], 3, axis=1)

    uv = prim.uvs if prim.uvs is not None else np.zeros((len(pos), 2), np.float32)
    cuv = np.stack([uv[tri[:, 0]], uv[tri[:, 1]], uv[tri[:, 2]]], axis=1)

    if prim.tangents is not None:
        tg_xyz = prim.tangents[:, :3] @ inv[:3, :3]
        ln = np.linalg.norm(tg_xyz, axis=-1, keepdims=True)
        tg_xyz = tg_xyz / np.maximum(ln, 1e-20)
        tg = np.concatenate([tg_xyz, prim.tangents[:, 3:4]], axis=-1)
    else:
        vertex_n = (
            prim.normals @ inv[:3, :3]
            if prim.normals is not None
            else np.zeros((len(pos), 3), np.float32)
        )
        ln = np.linalg.norm(vertex_n, axis=-1, keepdims=True)
        vertex_n = np.where(ln > 1e-12, vertex_n / np.maximum(ln, 1e-20), [0, 0, 1.0])
        tg = _compute_tangents(pos.astype(np.float32), vertex_n.astype(np.float32), uv, idx)
    ctg = np.stack([tg[tri[:, 0]], tg[tri[:, 1]], tg[tri[:, 2]]], axis=1)

    mat_id = max(0, prim.material)  # raytrace.rchit:38
    return v0, v1, v2, cn, ctg, cuv, np.full(len(tri), mat_id, np.int32)


def _uv_density(v0, v1, v2, cuv):
    """Per-triangle sqrt(uv area / world area) for mip LOD selection."""
    e1f = (v1 - v0).astype(np.float64)
    e2f = (v2 - v0).astype(np.float64)
    world_area = 0.5 * np.linalg.norm(np.cross(e1f, e2f), axis=-1)
    duv1 = (cuv[:, 1] - cuv[:, 0]).astype(np.float64)
    duv2 = (cuv[:, 2] - cuv[:, 0]).astype(np.float64)
    uv_area = 0.5 * np.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
    return np.sqrt(
        np.where(world_area > 1e-20, uv_area / np.maximum(world_area, 1e-20), 0.0)
    ).astype(np.float32)


def _tex_store_dtype() -> torch.dtype:
    """The mip atlas's storage dtype, read when a scene is built: bf16
    unless ``VKRT_TEX_BF16=0``, as the JAX package decides it
    (``vkrt_tpu/scene.py::_tex_store_dtype``). Texel fetches cast to f32
    after the gather; ``tex_rgba`` (level 0, read by the path tracer and
    kernel B) stays f32 either way."""
    return torch.bfloat16 if os.environ.get("VKRT_TEX_BF16", "1") == "1" else torch.float32


def _slots_used(arrays: dict) -> dict:
    return {k: bool((np.asarray(arrays[k]) >= 0).any()) for k in _TEX_SLOTS}


def _device(device) -> torch.device:
    """``None`` -> the card (raises without one); else as given."""
    return select() if device is None else torch.device(device)


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays from the JAX package
        return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def scene_from_numpy(d: dict, device=None) -> SceneTensors:
    """``SceneArrays._asdict()`` (after ``np.asarray``) -> SceneTensors.
    The state carry-over by which tests give both packages one scene."""
    device = _device(device)
    scene = SceneTensors(**{k: _to_tensor(d[k], device) for k in SceneTensors._fields})
    slots = [getattr(scene, k) for k in _TEX_SLOTS]
    _SLOTS_USED[slots[0]] = (slots[1:], _slots_used(d))  # from the host arrays
    return scene


def build_scene(doc: gltf_mod.GltfDocument, pad_to: int = TRI_PAD,
                device=None, tri_mat=None) -> SceneTensors:
    """Flatten a parsed glTF document into SceneTensors (bake world xforms).
    ``tri_mat``: optional per-triangle material ids overriding the
    primitives' (procedural soups)."""
    device = _device(device)  # before the host build: no card, no build
    return scene_from_arrays(scene_arrays(doc, pad_to, tri_mat), device)


def scene_from_arrays(arrays: dict, device) -> SceneTensors:
    """``scene_arrays``' host arrays -> SceneTensors on ``device``, the mip
    atlas in its storage dtype."""
    scene = scene_from_numpy(arrays, device)
    return scene._replace(tex_mip_atlas=scene.tex_mip_atlas.to(_tex_store_dtype()))


def scene_arrays(doc: gltf_mod.GltfDocument, pad_to: int = TRI_PAD, tri_mat=None) -> dict:
    """``build_scene``'s host side: {SceneTensors field: numpy array}, the
    arrays the device tensors are made from (the mip atlas in f32)."""
    all_v0, all_v1, all_v2 = [], [], []
    all_n, all_tg, all_uv, all_mat = [], [], [], []
    for prim in doc.primitives:
        v0, v1, v2, cn, ctg, cuv, mat_ids = _bake_primitive(prim)
        all_v0.append(v0)
        all_v1.append(v1)
        all_v2.append(v2)
        all_n.append(cn)
        all_tg.append(ctg)
        all_uv.append(cuv)
        all_mat.append(mat_ids)

    v0 = np.concatenate(all_v0).astype(np.float32)
    v1 = np.concatenate(all_v1).astype(np.float32)
    v2 = np.concatenate(all_v2).astype(np.float32)
    cn = np.concatenate(all_n).astype(np.float32)
    ctg = np.concatenate(all_tg).astype(np.float32)
    cuv = np.concatenate(all_uv).astype(np.float32)
    mat = np.concatenate(all_mat)

    n_tri = len(v0)
    n_pad = (-n_tri) % pad_to
    if n_pad:
        z3 = np.zeros((n_pad, 3), np.float32)
        v0, v1, v2 = (np.concatenate([a, z3]) for a in (v0, v1, v2))
        cn = np.concatenate([cn, np.zeros((n_pad, 3, 3), np.float32)])
        ctg = np.concatenate([ctg, np.zeros((n_pad, 3, 4), np.float32)])
        cuv = np.concatenate([cuv, np.zeros((n_pad, 3, 2), np.float32)])
        mat = np.concatenate([mat, np.zeros(n_pad, np.int32)])
    if tri_mat is not None:
        mat = np.zeros(len(mat), np.int32)
        mat[: len(tri_mat)] = tri_mat

    mats = doc.materials
    lights = doc.lights
    if not lights:
        lights = [
            gltf_mod.GltfLight(np.asarray(p, np.float32), np.asarray(c, np.float32), i, t)
            for (p, c, i, t) in FALLBACK_LIGHTS
        ]

    srgb_images = set()
    for mt in mats:  # baseColor/emissive sources are sRGB
        if mt.base_color_texture >= 0:
            srgb_images.add(mt.base_color_texture)
        if mt.emissive_texture >= 0:
            srgb_images.add(mt.emissive_texture)
    images = [im.data for im in doc.images]
    if not images:
        images = [np.full((1, 1, 4), 255, np.uint8)]  # dummy white
    th = max(im.shape[0] for im in images)
    tw = max(im.shape[1] for im in images)
    tex = np.zeros((len(images), th, tw, 4), np.float32)
    tex_size = np.zeros((len(images), 2), np.int32)
    for k, im in enumerate(images):
        f = im.astype(np.float32) / 255.0
        if k in srgb_images:
            f = np.concatenate([srgb_to_linear(f[..., :3]), f[..., 3:]], axis=-1)
        tex[k, : im.shape[0], : im.shape[1]] = f
        tex_size[k] = (im.shape[1], im.shape[0])
    atlas, level_size, level_off, n_levels = pack_mip_atlas(
        images, [k in srgb_images for k in range(len(images))]
    )
    density = _uv_density(v0, v1, v2, cuv)

    f32, i32 = np.float32, np.int32
    arrays = {
        "tri_v0": (v0, f32),
        "tri_e1": (v1 - v0, f32),
        "tri_e2": (v2 - v0, f32),
        "corner_normal": (cn, f32),
        "corner_tangent": (ctg, f32),
        "corner_uv": (cuv, f32),
        "tri_mat": (mat, i32),
        "mat_base_color": (np.stack([m.base_color_factor for m in mats]), f32),
        "mat_base_tex": ([m.base_color_texture for m in mats], i32),
        "mat_metallic": ([m.metallic_factor for m in mats], f32),
        "mat_roughness": ([m.roughness_factor for m in mats], f32),
        "mat_mr_tex": ([m.metallic_roughness_texture for m in mats], i32),
        "mat_normal_tex": ([m.normal_texture for m in mats], i32),
        "mat_emissive": (np.stack([m.emissive_factor for m in mats]), f32),
        "mat_emissive_tex": ([m.emissive_texture for m in mats], i32),
        "mat_alpha_mode": ([m.alpha_mode for m in mats], i32),
        "mat_alpha_cutoff": ([m.alpha_cutoff for m in mats], f32),
        "light_pos": (np.stack([lt.position for lt in lights]), f32),
        "light_color": (np.stack([lt.color for lt in lights]), f32),
        "light_intensity": ([lt.intensity for lt in lights], f32),
        "light_type": ([lt.type for lt in lights], i32),
        "tex_rgba": (tex, f32),
        "tex_size": (tex_size, i32),
        "tex_mip_atlas": (atlas, f32),
        "tex_level_size": (level_size, i32),
        "tex_level_off": (level_off, i32),
        "tex_n_levels": (n_levels, i32),
        "tri_uv_density": (density, f32),
    }
    return {k: np.asarray(a, dt) for k, (a, dt) in arrays.items()}


def load_scene(path: str, device=None) -> SceneTensors:
    """glTF file -> SceneTensors (loadGltfScene equivalent)."""
    return build_scene(gltf_mod.parse_gltf(path), device=device)


def scene_to_dtype(scene: SceneTensors, dtype: torch.dtype = torch.float64) -> SceneTensors:
    """Every float32 tensor of the scene in ``dtype``; the integer tables and
    the mip atlas (bf16 by default) stay as they are, as the JAX oracle's
    ``jax.tree.map`` over the float32 leaves leaves them. The integer
    tensors are the same objects, so ``tex_slots_used`` still knows them."""
    return SceneTensors(*(t.to(dtype) if t.dtype == torch.float32 else t for t in scene))


def tex_slots_used(scene: SceneTensors) -> dict:
    """{slot name: whether any material references a texture there}, for
    the four slots ``mat_base_tex``, ``mat_mr_tex``, ``mat_normal_tex`` and
    ``mat_emissive_tex`` (``vkrt_tpu/scene.py::_tex_slot_used`` of each).
    Decided once per set of slot columns: ``scene_from_numpy`` records it
    from the host arrays; a scene assembled otherwise reads its four (M,)
    columns back once."""
    slots = [getattr(scene, k) for k in _TEX_SLOTS]
    known = _SLOTS_USED.get(slots[0])
    if known is None or any(a is not b for a, b in zip(known[0], slots[1:])):
        known = (slots[1:], _slots_used({k: t.cpu().numpy() for k, t in zip(_TEX_SLOTS, slots)}))
        _SLOTS_USED[slots[0]] = known
    return known[1]


def scene_is_textured(scene: SceneTensors) -> bool:
    """True if any material references a texture."""
    return any(tex_slots_used(scene).values())


def scene_base_only_textured(scene: SceneTensors) -> bool:
    """True when the scene's only texture use is baseColor: kernel B then
    fetches the albedo itself, and the other slots are white."""
    used = tex_slots_used(scene)
    return used["mat_base_tex"] and not any(used[k] for k in _TEX_SLOTS[1:])


# ---------------------------------------------------------------------------
# Procedural scenes
# ---------------------------------------------------------------------------


def _quad(a, b, c, d):
    """Two triangles for quad a-b-c-d (counter-clockwise)."""
    return [(a, b, c), (a, c, d)]


def _box(center, half, rot_y: float = 0.0):
    cx, cy, cz = center
    hx, hy, hz = half
    corners = np.array(
        [
            [-hx, -hy, -hz], [hx, -hy, -hz], [hx, hy, -hz], [-hx, hy, -hz],
            [-hx, -hy, hz], [hx, -hy, hz], [hx, hy, hz], [-hx, hy, hz],
        ]
    )
    if rot_y:
        c, s = np.cos(rot_y), np.sin(rot_y)
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        corners = corners @ r.T
    p = corners + np.array([cx, cy, cz])
    tris = []
    tris += _quad(p[4], p[5], p[6], p[7])  # +z
    tris += _quad(p[1], p[0], p[3], p[2])  # -z
    tris += _quad(p[5], p[1], p[2], p[6])  # +x
    tris += _quad(p[0], p[4], p[7], p[3])  # -x
    tris += _quad(p[7], p[6], p[2], p[3])  # +y
    tris += _quad(p[0], p[1], p[5], p[4])  # -y
    return tris


def _boxes(centers, halves, rots):
    """Vectorized ``_box`` over N boxes: (N,3),(N,3),(N,) -> (N*12,3,3) f64
    triangles, equal to ``np.concatenate([_box(c,h,r) for ...])`` (same
    corner order, same rotate-then-translate op order)."""
    centers = np.asarray(centers, np.float64)
    halves = np.asarray(halves, np.float64)
    rots = np.asarray(rots, np.float64)
    signs = np.array(
        [
            [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
            [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
        ],
        np.float64,
    )
    corners = signs[None, :, :] * halves[:, None, :]  # (N,8,3)
    c, s = np.cos(rots), np.sin(rots)
    zero, one = np.zeros_like(c), np.ones_like(c)
    # _box's r = [[c,0,s],[0,1,0],[-s,0,c]]; corners @ r.T, batched
    r = np.stack(
        [
            np.stack([c, zero, s], -1),
            np.stack([zero, one, zero], -1),
            np.stack([-s, zero, c], -1),
        ],
        axis=1,
    )  # (N,3,3)
    corners = np.matmul(corners, np.swapaxes(r, 1, 2))
    corners = corners + centers[:, None, :]
    # the 12 (a,b,c) corner index triples _box emits, in order
    quads = [(4, 5, 6, 7), (1, 0, 3, 2), (5, 1, 2, 6),
             (0, 4, 7, 3), (7, 6, 2, 3), (0, 1, 5, 4)]
    tri_idx = np.array(
        [t for a, b, c_, d in quads for t in ((a, b, c_), (a, c_, d))],
        np.int64,
    )  # (12,3)
    return corners[:, tri_idx, :].reshape(-1, 3, 3)


def _boxes_uvs(halves, tiles):
    """Per-corner UVs of ``_boxes``' triangles: (N,3),(N,) -> (N*12,3,2)
    f64, each face mapped 0..extent*tile so textures tile with world
    size."""
    halves = np.asarray(halves, np.float64)
    tiles = np.asarray(tiles, np.float64)
    hx, hy, hz = halves[:, 0], halves[:, 1], halves[:, 2]
    # per-face (su, sv) extents: +z, -z, +x, -x, +y, -y
    su = np.stack([2 * hx, 2 * hx, 2 * hz, 2 * hz, 2 * hx, 2 * hx], -1)
    sv = np.stack([2 * hy, 2 * hy, 2 * hy, 2 * hy, 2 * hz, 2 * hz], -1)
    su = su * tiles[:, None]  # (N,6)
    sv = sv * tiles[:, None]
    zero = np.zeros_like(su)
    # quad corners a=(0,0) b=(su,0) c=(su,sv) d=(0,sv); tris (a,b,c),(a,c,d)
    u = np.stack([zero, su, su, zero, su, zero], -1)   # (N,6,6)
    v = np.stack([zero, zero, sv, zero, sv, sv], -1)
    uv = np.stack([u, v], -1)                          # (N,6,6,2)
    return uv.reshape(-1, 2, 3, 2).reshape(-1, 3, 2)


def _procedural_textures():
    """Checker / brick / window-grid images for the city stand-in."""
    rng = np.random.default_rng(42)
    checker = np.zeros((64, 64, 4), np.uint8)
    checker[..., :3] = 110
    checker[:32, :32, :3] = 190
    checker[32:, 32:, :3] = 190
    checker[..., 3] = 255

    brick = np.full((64, 64, 4), 150, np.uint8)
    brick[..., :3] = (160, 82, 60)
    for row in range(0, 64, 16):
        brick[row : row + 2, :, :3] = 200  # mortar lines
        off = 0 if (row // 16) % 2 == 0 else 16
        for col in range(off, 64, 32):
            brick[row : row + 16, col : col + 2, :3] = 200
    brick[..., :3] = np.clip(
        brick[..., :3].astype(np.int16) + rng.integers(-12, 12, (64, 64, 1)), 0, 255
    ).astype(np.uint8)
    brick[..., 3] = 255

    windows = np.full((64, 64, 4), 70, np.uint8)
    windows[..., :3] = (90, 95, 105)
    for row in range(4, 64, 16):
        for col in range(4, 64, 16):
            windows[row : row + 8, col : col + 8, :3] = (30, 40, 70)
    windows[..., 3] = 255
    return [
        gltf_mod.GltfImage(checker, "checker"),
        gltf_mod.GltfImage(brick, "brick"),
        gltf_mod.GltfImage(windows, "windows"),
    ]


def scene_from_soup(
    tris: List,
    mat_ids: List[int],
    materials: List[gltf_mod.GltfMaterial],
    lights: List[gltf_mod.GltfLight],
    images: Optional[List[gltf_mod.GltfImage]] = None,
    uvs: Optional[np.ndarray] = None,
    device=None,
) -> SceneTensors:
    """Assemble SceneTensors from python triangle lists (flat normals).
    ``uvs``: optional (T, 3, 2) per-corner texture coordinates."""
    arr = np.asarray(tris, np.float32)  # (T,3,3)
    doc = gltf_mod.GltfDocument(
        primitives=[
            gltf_mod.GltfPrimitiveInstance(
                positions=arr.reshape(-1, 3),
                indices=np.arange(arr.size // 3, dtype=np.uint32),
                normals=None,
                tangents=None,
                uvs=None if uvs is None else np.asarray(uvs, np.float32).reshape(-1, 2),
                material=0,
                world_matrix=np.eye(4),
            )
        ],
        materials=materials,
        lights=lights,
        images=images or [],
    )
    return build_scene(doc, device=device, tri_mat=mat_ids)


def make_cornell_box(device=None) -> SceneTensors:
    """Procedural Cornell-style box (96 triangles padded to 128, 5
    materials, 1 point light): the stand-in for cornell.gltf. Dimensions
    mirror the real asset (10-unit box, light at y=4.5, camera at z=15)."""
    mats = [
        gltf_mod.GltfMaterial(np.array([0.73, 0.73, 0.73, 1], np.float32), metallic_factor=0.0),
        gltf_mod.GltfMaterial(np.array([1.0, 0.0, 0.0, 1], np.float32), metallic_factor=0.0),
        gltf_mod.GltfMaterial(np.array([0.05, 1.0, 0.0, 1], np.float32), metallic_factor=0.0),
        gltf_mod.GltfMaterial(
            np.array([1.0, 1.0, 1.0, 1], np.float32),
            metallic_factor=0.0,
            roughness_factor=0.0,
            emissive_factor=np.array([10.0, 10.0, 10.0], np.float32),
        ),
        gltf_mod.GltfMaterial(
            np.array([0.5, 0.5, 0.5, 1], np.float32),
            metallic_factor=0.0,
            roughness_factor=0.9,
        ),
    ]
    tris, mat_ids = [], []

    def add(ts, mid):
        tris.extend(ts)
        mat_ids.extend([mid] * len(ts))

    add(_box((0, 0, -5.5), (5, 5, 0.5)), 0)        # back wall
    add(_box((0, -5.5, 0), (5, 0.5, 5)), 0)        # floor
    add(_box((0, 5.5, 0), (5, 0.5, 5)), 0)         # ceiling
    add(_box((-5.5, 0, 0), (0.5, 5, 5)), 1)        # left (red)
    add(_box((5.5, 0, 0), (0.5, 5, 5)), 2)         # right (green)
    add(_box((0, 4.7, 0), (1.5, 0.1, 1.5)), 3)     # area light panel
    add(_box((1.8, -3.2, 1.2), (1.2, 1.8, 1.2), 0.5), 4)   # tall box
    add(_box((-2.0, -4.0, -1.5), (1.0, 1.0, 1.0), -0.3), 4)  # small box
    lights = [
        gltf_mod.GltfLight(
            np.array([0.0, 4.5, 0.0], np.float32),
            np.array([1.0, 1.0, 1.0], np.float32),
            100.0,
            0,
        )
    ]
    return scene_from_soup(tris, mat_ids, mats, lights, device=device)


def make_random_soup(n_tris: int, seed: int = 0, extent: float = 1.0,
                     device=None) -> SceneTensors:
    """Random triangle soup for BVH correctness fuzzing."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (n_tris, 1, 3))
    offsets = rng.normal(0, 0.08 * extent, (n_tris, 3, 3))
    tris = (centers + offsets).astype(np.float32)
    mats = [gltf_mod.GltfMaterial(np.array([0.8, 0.8, 0.8, 1], np.float32))]
    lights = [
        gltf_mod.GltfLight(np.zeros(3, np.float32), np.ones(3, np.float32), 10.0, 0)
    ]
    return scene_from_soup(list(tris), [0] * n_tris, mats, lights, device=device)


def make_city(grid: int = 16, seed: int = 7, device=None) -> SceneTensors:
    """Sponza-substitute: a grid of boxes ("buildings") + floor + lights.

    Gives the BVH a real workload (thousands to hundreds of thousands of
    triangles with uneven density): ``grid=96`` is 143,568 triangles,
    the trace probes' city."""
    device = _device(device)  # before the host build: no card, no build
    rng = np.random.default_rng(seed)
    mats = [
        gltf_mod.GltfMaterial(np.array([0.7, 0.7, 0.68, 1], np.float32),
                              metallic_factor=0.0, base_color_texture=0),  # checker
        gltf_mod.GltfMaterial(np.array([1.0, 1.0, 1.0, 1], np.float32),
                              metallic_factor=0.0, base_color_texture=1),  # brick
        gltf_mod.GltfMaterial(np.array([0.8, 0.8, 0.85, 1], np.float32),
                              roughness_factor=0.2),
        gltf_mod.GltfMaterial(np.array([1.0, 1.0, 1.0, 1], np.float32),
                              metallic_factor=0.3, roughness_factor=0.4,
                              base_color_texture=2),  # window grid
    ]

    # Parameter collection stays a Python loop (rng draw ORDER defines the
    # scene); geometry/UV generation is one vectorized pass (_boxes /
    # _boxes_uvs).
    centers, halves, rots, box_mats, tiles = [], [], [], [], []

    def add(center, half, mid, rot=0.0, tile=0.5):
        centers.append(center)
        halves.append(half)
        rots.append(rot)
        box_mats.append(mid)
        tiles.append(tile)

    span = grid * 2.0
    add((0, -0.25, 0), (span, 0.25, span), 0, tile=0.25)  # ground slab
    for i in range(grid):
        for j in range(grid):
            x = (i - grid / 2) * 4.0 + rng.uniform(-0.5, 0.5)
            z = (j - grid / 2) * 4.0 + rng.uniform(-0.5, 0.5)
            h = rng.uniform(1.0, 8.0)
            w = rng.uniform(0.6, 1.6)
            half = (w, h / 2, w)
            rot = rng.uniform(0, 3.14)  # drawn before the material pick
            add((x, h / 2, z), half, int(rng.integers(1, 4)), rot=rot)
            if rng.uniform() < 0.3:  # rooftop structure
                rh = (w * 0.4, 0.4, w * 0.4)
                add((x, h + 0.4, z), rh, 2)

    tris = _boxes(centers, halves, rots)
    uvs = _boxes_uvs(halves, tiles)
    mat_ids = np.repeat(np.asarray(box_mats, np.int32), 12).tolist()
    lights = [
        gltf_mod.GltfLight(
            np.array([rng.uniform(-span / 2, span / 2), rng.uniform(6, 14),
                      rng.uniform(-span / 2, span / 2)], np.float32),
            np.ones(3, np.float32),
            200.0,
            0,
        )
        for _ in range(4)
    ]
    return scene_from_soup(
        tris, mat_ids, mats, lights,
        images=_procedural_textures(), uvs=np.asarray(uvs, np.float32),
        device=device,
    )


def find_reference_cornell() -> Optional[str]:
    """cornell.gltf (config.json scene index 2) where the config's search
    path finds it: the working directory, the repository, or the reference
    media mount."""
    path = resolve_scene_path(EngineConfig(scene=2))
    return path if os.path.exists(path) else None


def load_cornell(device=None) -> SceneTensors:
    """The default benchmark scene; the procedural box when cornell.gltf
    is not reachable."""
    path = find_reference_cornell()
    if path is not None:
        return load_scene(path, device=device)
    return make_cornell_box(device=device)
