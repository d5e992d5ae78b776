"""The reference's scene tables, derived again from a ``SceneInput``: edges,
per-corner normals and tangents, material and light rows, and the level-0
textures in linear f32.

Mirrors the baking of ``vkrt_tpu_torch/scene.py`` (``_bake_primitive``,
``_flat_normals``, ``_compute_tangents``, the texture stack of
``scene_arrays`` and ``ops/texture.py::srgb_to_linear``; commit 400863e):
a soup gets flat normals and tangents from its uv gradients (Gram-Schmidt
against +z, as the loader does with no vertex normals); a glTF mesh's own
normals and tangents are renormalised in f64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RefScene(NamedTuple):
    tri_v0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    corner_normal: torch.Tensor
    corner_tangent: torch.Tensor
    corner_uv: torch.Tensor
    tri_mat: torch.Tensor
    mat_base_color: torch.Tensor
    mat_base_tex: torch.Tensor
    mat_metallic: torch.Tensor
    mat_roughness: torch.Tensor
    mat_mr_tex: torch.Tensor
    mat_normal_tex: torch.Tensor
    mat_emissive: torch.Tensor
    mat_emissive_tex: torch.Tensor
    light_pos: torch.Tensor
    light_color: torch.Tensor
    light_intensity: torch.Tensor
    light_type: torch.Tensor
    tex_rgba: torch.Tensor
    tex_size: torch.Tensor
    slots_used: dict


def _unit64(x):
    x = np.asarray(x, np.float64)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-20)


def _soup_tangents(pos, uvs):
    """``_compute_tangents`` on unshared corners with the +z fallback normal."""
    v = pos.reshape(-1, 3).astype(np.float32)
    uv = uvs.reshape(-1, 2).astype(np.float32)
    idx = np.arange(len(v))
    i0, i1, i2 = idx[0::3], idx[1::3], idx[2::3]
    e1, e2 = v[i1] - v[i0], v[i2] - v[i0]
    duv1, duv2 = uv[i1] - uv[i0], uv[i2] - uv[i0]
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)[:, None]
    tan = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * r
    acc = np.zeros_like(v)
    for i in (i0, i1, i2):
        np.add.at(acc, i, tan)
    n = np.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32), v.shape)
    t = acc - n * np.sum(acc * n, axis=-1, keepdims=True)
    ln = np.linalg.norm(t, axis=-1, keepdims=True)
    bad = ln[:, 0] < 1e-8
    if bad.any():
        t[bad] = np.array([0.0, -1.0, 0.0], np.float32)  # the ONB fallback for +z
        ln = np.linalg.norm(t, axis=-1, keepdims=True)
    t = t / np.maximum(ln, 1e-20)
    t4 = np.concatenate([t, np.ones((len(v), 1), np.float32)], axis=-1)
    return t4.reshape(-1, 3, 4).astype(np.float32)


def _srgb_to_linear(c):
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


def build(inp, device, dtype=torch.float32) -> RefScene:
    """``inp``: ``framebench.scenes.SceneInput``."""
    v0, v1, v2 = (np.asarray(a, np.float32) for a in (inp.v0, inp.v1, inp.v2))
    if inp.normal is None:
        fn = _unit64(np.cross(v1.astype(np.float64) - v0, v2.astype(np.float64) - v0))
        cn = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
    else:
        cn = _unit64(inp.normal).astype(np.float32)
    if inp.tangent is None:
        ctg = _soup_tangents(np.stack([v0, v1, v2], axis=1), inp.uv)
    else:
        ctg = np.concatenate([_unit64(inp.tangent[..., :3]), inp.tangent[..., 3:]],
                             axis=-1).astype(np.float32)
    th = max(im.shape[0] for im in inp.images)
    tw = max(im.shape[1] for im in inp.images)
    tex = np.zeros((len(inp.images), th, tw, 4), np.float32)
    size = np.zeros((len(inp.images), 2), np.int32)
    for k, im in enumerate(inp.images):
        f = im.astype(np.float32) / 255.0
        if inp.srgb[k]:
            f = np.concatenate([_srgb_to_linear(f[..., :3]), f[..., 3:]], axis=-1)
        tex[k, :im.shape[0], :im.shape[1]] = f
        size[k] = (im.shape[1], im.shape[0])
    mats = inp.materials

    def fl(x):
        return torch.tensor(np.asarray(x, np.float32), device=device).to(dtype)

    def it(x):
        return torch.tensor(np.asarray(x, np.int32), device=device)

    slots = {"base": "base_tex", "mr": "mr_tex", "normal": "normal_tex",
             "emissive": "emissive_tex"}
    return RefScene(
        tri_v0=fl(v0), tri_e1=fl(v1 - v0), tri_e2=fl(v2 - v0), corner_normal=fl(cn),
        corner_tangent=fl(ctg), corner_uv=fl(inp.uv), tri_mat=it(inp.tri_mat),
        mat_base_color=fl([m.base_color for m in mats]),
        mat_base_tex=it([m.base_tex for m in mats]),
        mat_metallic=fl([m.metallic for m in mats]),
        mat_roughness=fl([m.roughness for m in mats]),
        mat_mr_tex=it([m.mr_tex for m in mats]),
        mat_normal_tex=it([m.normal_tex for m in mats]),
        mat_emissive=fl([m.emissive for m in mats]),
        mat_emissive_tex=it([m.emissive_tex for m in mats]),
        light_pos=fl([lt.position for lt in inp.lights]),
        light_color=fl([lt.color for lt in inp.lights]),
        light_intensity=fl([lt.intensity for lt in inp.lights]),
        light_type=it([lt.type for lt in inp.lights]),
        tex_rgba=fl(tex), tex_size=it(size),
        slots_used={k: any(getattr(m, a) >= 0 for m in mats) for k, a in slots.items()})
