"""Kernel A: the CUDA trace kernel (``csrc/trace.cu``) and its tracer.

Replaces ``vkrt_tpu/ops/pallas/trace.py::_trace_kernel``. The tree is the
threaded preorder SAH BVH of ``utils.native.build_sah_bvh`` (one
triangle per leaf, skip links), built on the host and packed into one
(M, 8) f32 node table. Leaves carry scene triangle ids, so there is no
``tri_remap``. The TPU kernel's cluster tree, vote words, pre-pivoted
tables and ``TraceSpec`` knobs exist only because Mosaic has no per-lane
gathers and are not ported.

``trace_kernel`` is the wrapper: on CUDA tensors it launches the kernel
(or raises); on CPU tensors it runs the kernel's plain version, the brute
force of ``ops/trace.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vkrt_tpu_torch import device as dev
from vkrt_tpu_torch.ops.intersect import T_MIN
from vkrt_tpu_torch.ops.trace import RayHits, Tracer, trace_rays_bruteforce
from vkrt_tpu_torch.scene import SceneTensors
from vkrt_tpu_torch.utils import native


def pack_bvh_nodes(node_min, node_max, node_skip, node_tri) -> np.ndarray:
    """The four arrays of native.build_sah_bvh -> the kernel's (M, 8) f32
    node table, rows [min.xyz | skip (i32 bits) | max.xyz | tri (i32
    bits)] with tri = -1 at inner nodes."""
    nodes = np.zeros((len(node_min), 8), np.float32)
    nodes[:, 0:3] = node_min
    nodes[:, 3] = np.asarray(node_skip, np.int32).view(np.float32)
    nodes[:, 4:7] = node_max
    nodes[:, 7] = np.asarray(node_tri, np.int32).view(np.float32)
    return nodes


def build_bvh_arrays(scene: SceneTensors):
    """(node_min, node_max, node_skip, node_tri) from the native SAH
    builder (compiled at first use; a failed build raises: there is no
    Morton fallback)."""
    arrs = [np.asarray(t.detach().cpu(), np.float32)
            for t in (scene.tri_v0, scene.tri_e1, scene.tri_e2)]
    res = native.build_sah_bvh(*arrs)
    if res is None:
        raise ValueError("scene has no non-degenerate triangle to build a BVH over")
    return res


def build_bvh(scene: SceneTensors) -> torch.Tensor:
    """The scene's (M, 8) node table on the scene's device."""
    return torch.as_tensor(pack_bvh_nodes(*build_bvh_arrays(scene)),
                           device=scene.device)


def _check_f32(name, t, shape):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want f32 {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def check_rays(name: str, o, d, t_lim, tables=()) -> int:
    """Validate a CUDA launch's rays ((N,3) o and d, maybe strided; (N,)
    contiguous t_lim) and contiguous tables on their device. Returns N."""
    if o.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {o.device}")
    n = o.shape[0]
    _check_f32("o", o, (n, 3))
    _check_f32("d", d, (n, 3))
    _check_f32("t_lim", t_lim, (n,))
    if not t_lim.is_contiguous():
        raise ValueError("t_lim must be contiguous")
    for t in (d, t_lim) + tuple(tables):
        if t.device != o.device:
            raise ValueError(f"{name}: tensor on {t.device}, rays on {o.device}")
    if not all(t.is_contiguous() for t in tables):
        raise ValueError(f"{name}: scene tables must be contiguous")
    return n


def check_scene(nodes: torch.Tensor, scene: SceneTensors):
    """The node table and triangle tables a traversal kernel reads."""
    n_tris = scene.tri_v0.shape[0]
    _check_f32("nodes", nodes, (nodes.shape[0], 8))
    for name in ("tri_v0", "tri_e1", "tri_e2"):
        _check_f32(name, getattr(scene, name), (n_tris, 3))
    return (nodes, scene.tri_v0, scene.tri_e1, scene.tri_e2)


def trace_kernel(nodes: torch.Tensor, scene: SceneTensors, o, d, t_lim,
                 t_min: float = T_MIN, any_hit: bool = False) -> RayHits:
    """Trace (N,3) o and d with (N,) limits; the kernel's contract (see
    ``ops/trace.py``). ``o`` and ``d`` may be strided views, e.g. rows of a
    (7, N) ray block transposed; ``t_lim`` must be contiguous."""
    if o.device.type == "cpu":
        return trace_rays_bruteforce(scene.tri_v0, scene.tri_e1, scene.tri_e2,
                                     o, d, t_lim, t_min)
    n = check_rays("trace_kernel", o, d, t_lim, check_scene(nodes, scene))
    t_out = torch.empty(n, dtype=torch.float32, device=o.device)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty(n, dtype=torch.float32, device=o.device)
    v = torch.empty(n, dtype=torch.float32, device=o.device)
    err = dev.kernels().vkrt_trace(
        nodes.data_ptr(), nodes.shape[0],
        scene.tri_v0.data_ptr(), scene.tri_e1.data_ptr(), scene.tri_e2.data_ptr(),
        o.data_ptr(), o.stride(0), o.stride(1),
        d.data_ptr(), d.stride(0), d.stride(1),
        t_lim.data_ptr(), n, float(t_min), int(any_hit),
        t_out.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
        dev.stream_ptr(o.device),
    )
    dev.check("vkrt_trace", err)
    trace_kernel.launches += 1
    return RayHits(t_out, tri, u, v)


trace_kernel.launches = 0


@dataclasses.dataclass(frozen=True)
class CudaTracer(Tracer):
    """Tracer running kernel A over the scene's BVH."""

    nodes: torch.Tensor = None  # build_bvh's node table

    def trace(self, o, d, t_lim, t_min: float = T_MIN,
              any_hit: bool = False) -> RayHits:
        return trace_kernel(self.nodes, self.scene, o, d, t_lim, t_min, any_hit)


def make_cuda_tracer(scene: SceneTensors) -> CudaTracer:
    return CudaTracer(scene=scene, nodes=build_bvh(scene))
