"""Instance layer: re-pose scene nodes without a full rebuild (port of
``vkrt_tpu/scene_instances.py``).

The reference keeps per-node instances in the TLAS: moving a node
re-records only the top-level structure while every BLAS persists
(createTopLevelAsGltf, hello_vulkan.cpp:1031-1047). Here world transforms
are baked into the flat triangle soup at load, so re-posing a node would
naively force a full SAH rebuild and re-upload. This module restores the
capability:

* ``InstancedScene`` keeps the parsed document (object-space geometry),
  each primitive's triangle range inside the flat soup, and host mirrors of
  the geometry (``_HOST_FIELDS``);
* ``repose`` re-bakes only the moved primitive (``scene._bake_primitive``,
  the math of the load) and writes its rows into the device tensors from
  one upload, reading nothing back;
* ``repose_tracer`` refits kernel A's trace structure (``ops/cuda/trace.py::
  refit_bvh``): the SAH topology stays and only the dirty rows of kernel
  A's tables are rewritten, the equivalent of the reference's TLAS-only
  update. The ``bvh`` backend rebuilds its LBVH from the re-posed device
  triangles instead, as the JAX package does.

Device tensors are copy on write, as the JAX package's functional updates
are: an earlier ``InstancedScene`` or tracer still holds its pose.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vkrt_tpu_torch import scene as scene_mod
from vkrt_tpu_torch.utils import gltf as gltf_mod

# Host mirrors kept per InstancedScene, so a re-pose never reads device
# tensors back: the refit runs on these numpy copies and the device only
# receives the rows. Keys are SceneTensors field names.
_HOST_FIELDS = ("tri_v0", "tri_e1", "tri_e2", "corner_normal",
                "corner_tangent", "corner_uv", "tri_mat")
# the fields a re-pose rewrites, in the order of its one upload
_POSED = ("tri_v0", "tri_e1", "tri_e2", "corner_normal", "corner_tangent",
          "tri_uv_density")


class InstancedScene(NamedTuple):
    scene: scene_mod.SceneTensors
    doc: gltf_mod.GltfDocument                # object-space source of truth
    prim_ranges: Tuple[Tuple[int, int], ...]  # per-primitive [start, end) tris
    host: Optional[dict] = None               # numpy mirrors (_HOST_FIELDS)

    @property
    def num_nodes(self) -> int:
        return len(self.prim_ranges)

    def tri_arrays(self):
        """(v0, e1, e2) on the host: the mirrors, else read from the device."""
        if self.host is not None:
            return [self.host[k] for k in ("tri_v0", "tri_e1", "tri_e2")]
        return [getattr(self.scene, k).cpu().numpy() for k in ("tri_v0", "tri_e1", "tri_e2")]


def build_instanced(doc: gltf_mod.GltfDocument, device=None) -> InstancedScene:
    """``build_scene`` on ``device`` (None: the card), keeping the document,
    the primitives' triangle ranges and the host arrays the geometry was
    uploaded from."""
    device = scene_mod._device(device)
    arrays = scene_mod.scene_arrays(doc)
    scene = scene_mod.scene_from_arrays(arrays, device)
    ranges, start = [], 0
    for prim in doc.primitives:
        n = prim.indices.size // 3
        ranges.append((start, start + n))
        start += n
    return InstancedScene(scene=scene, doc=doc, prim_ranges=tuple(ranges),
                          host={k: arrays[k] for k in _HOST_FIELDS})


def load_scene_instanced(path: str, device=None) -> InstancedScene:
    return build_instanced(gltf_mod.parse_gltf(path), device=device)


def repose(inst: InstancedScene, prim_idx: int, world_matrix):
    """Move one primitive (node). Returns (new InstancedScene, moved):
    ``moved`` is (T,) bool over the padded triangles, for
    ``repose_tracer``.

    The primitive is re-baked with its new world matrix in the JAX
    package's arithmetic (edges ``v1 - v0`` formed in f64 from the f32
    ``v0``, then rounded), and its rows of ``_POSED`` go to the device in
    one upload, written into copies of the scene's tensors on the current
    stream, so the next frame's launches read them. Only geometry fields
    are replaced: the material and texture tensors stay the same objects,
    and with them what ``scene.tex_slots_used`` decided."""
    prim = copy.copy(inst.doc.primitives[prim_idx])
    prim.world_matrix = np.asarray(world_matrix, np.float64)
    doc = copy.copy(inst.doc)
    doc.primitives = list(inst.doc.primitives)
    doc.primitives[prim_idx] = prim

    v0, v1, v2, cn, ctg, cuv, _ = scene_mod._bake_primitive(prim)
    s, e = inst.prim_ranges[prim_idx]
    if e - s != len(v0):
        raise ValueError(f"primitive {prim_idx} bakes {len(v0)} triangles, its range "
                         f"holds {e - s}")
    v0 = v0.astype(np.float32)
    e1 = (v1 - v0).astype(np.float32)
    e2 = (v2 - v0).astype(np.float32)
    density = scene_mod._uv_density(v0, v1, v2, cuv.astype(np.float32))
    fresh = (v0, e1, e2, cn.astype(np.float32), ctg.astype(np.float32), density)

    sc = inst.scene
    n = e - s
    rows = torch.as_tensor(np.concatenate([f.reshape(n, -1) for f in fresh], axis=1),
                           device=sc.device)
    posed, col = {}, 0
    for k in _POSED:
        t = getattr(sc, k)
        width = int(np.prod(t.shape[1:]))
        new = t.clone()
        new[s:e] = rows[:, col:col + width].reshape((n,) + tuple(t.shape[1:]))
        posed[k], col = new, col + width
    sc = sc._replace(**posed)

    # keep the host mirrors in sync, copy on write (earlier InstancedScene
    # objects stay valid), so the tracer refit never reads device tensors
    host = None
    if inst.host is not None:
        host = dict(inst.host)
        for k, f in zip(_POSED[:5], fresh[:5]):
            a = host[k].copy()
            a[s:e] = f
            host[k] = a
    moved = np.zeros(sc.num_tris, bool)
    moved[s:e] = True
    return InstancedScene(scene=sc, doc=doc, prim_ranges=inst.prim_ranges, host=host), moved


def repose_tracer(tracer, inst: InstancedScene, moved: np.ndarray):
    """A tracer rebound to a re-posed scene: the ``bvh`` backend
    (``LbvhTracer``) rebuilds its LBVH on the device from the scene's
    triangles; kernel A's tracer refits its tables (``refit_bvh``: the cost
    scales with the moved subset, no SAH build runs); the brute-force
    ``Tracer`` takes the new triangles; an ``AlphaTracer`` wraps its inner
    tracer, rebound, again."""
    from vkrt_tpu_torch.ops.alpha import AlphaTracer
    from vkrt_tpu_torch.ops.cuda.trace import CudaTracer
    from vkrt_tpu_torch.ops.cuda.trace_variants import LbvhTracer, make_lbvh_tracer
    from vkrt_tpu_torch.ops.trace import Tracer

    sc = inst.scene
    if isinstance(tracer, AlphaTracer):
        return AlphaTracer(sc, repose_tracer(tracer.inner, inst, moved),
                           tracer.rounds, tracer.seed)
    if isinstance(tracer, LbvhTracer):
        return make_lbvh_tracer(sc)
    if isinstance(tracer, CudaTracer):
        return tracer.refit(sc, inst.tri_arrays(), moved)
    if isinstance(tracer, Tracer):
        return dataclasses.replace(tracer, scene=sc)
    raise TypeError(f"unknown tracer type {type(tracer)}")
