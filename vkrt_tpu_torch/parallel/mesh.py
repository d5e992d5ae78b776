"""Ranks on a (tile, spp) mesh for multi-device rendering (port of
``vkrt_tpu/parallel/mesh.py``).

The JAX package drives one ``jax.sharding.Mesh`` from a single process
under ``shard_map``. The port runs one process a rank (``torch.distributed``)
on a ``DeviceMesh`` with the JAX mesh's two axes:

* ``tile``: pixel bands. A rank renders its band of the frame, with the
  scene and its BVH replicated in every rank (read-only, and every ray
  needs all of it). No collective in the frame: the image stays in bands
  until a rank gathers it for display.
* ``spp``: sample groups of the same pixels, combined with one mean a
  frame (``pmean`` over the spp group, the port of ``pmean(..., "spp")``).

``make_render_mesh`` runs inside a rank; ``launch`` starts the ranks. The
mesh's coordinates take the place of ``axis_index``.

The backend is chosen, never fallen back to: NCCL when every rank has a
card of its own, gloo on the CPU and when ranks share a card (NCCL refuses
two ranks on one GPU). With gloo, a collective on a CUDA tensor is staged
through the host (gloo's CUDA support has no send/recv); the kernels and
everything else in the frame stay on the card. A collective over a
one-rank group is skipped, since its result is its input (XLA elides it
the same way).

The JAX module's ``replicated`` and ``tile_sharded`` shardings have no
counterpart: a rank holds its own band and its own copy of the scene, so
there is nothing to place.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

from vkrt_tpu_torch.device import select

AXES = ("tile", "spp")
# the ring exchange's two messages (a band's last rows go to the next band,
# its first rows to the previous one): with two bands both go to one peer
_TAG_TO_NEXT, _TAG_TO_PREV = 1, 2


@dataclass
class RenderMesh:
    """One rank's view of the (tile, spp) mesh."""

    shape: dict           # {"tile": n_tile, "spp": n_spp}
    tile: int             # this rank's coordinate on the tile axis (its band)
    spp: int              # ... and on the spp axis (its sample group)
    groups: dict          # axis name -> ProcessGroup
    backend: str          # "nccl" or "gloo"
    device: torch.device  # where this rank renders

    @property
    def size(self) -> int:
        return self.shape["tile"] * self.shape["spp"]


def factor_mesh(n_devices: int):
    """Split n devices into (tile, spp): prefer tiles, give spp the factor 2
    when available, which exercises both axes and the spp mean."""
    if n_devices % 2 == 0 and n_devices > 2:
        return n_devices // 2, 2
    return n_devices, 1


def backend_for(device: torch.device, world: int) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def make_render_mesh(n_tile: int = None, n_spp: int = 1, device=None) -> RenderMesh:
    """This rank's (tile, spp) mesh over the initialised process group
    (``launch`` initialises it). Defaults: every rank on the tile axis.
    ``device`` None means the card (the current one)."""
    if not dist.is_initialized():
        raise RuntimeError("make_render_mesh runs inside a rank: start the ranks with launch()")
    device = select() if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    if n_tile is None:
        n_tile = world // n_spp
    if n_tile < 1 or n_spp < 1 or n_tile * n_spp != world:
        raise ValueError(f"mesh ({n_tile}, {n_spp}) does not cover the {world} ranks")
    backend = dist.get_backend()
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", (n_tile, n_spp),
                          mesh_dim_names=AXES)
    tile, spp = dm.get_coordinate()
    return RenderMesh(shape={"tile": n_tile, "spp": n_spp}, tile=tile, spp=spp,
                      groups={a: dm.get_group(a) for a in AXES}, backend=backend,
                      device=device)


# --- collectives -------------------------------------------------------------


def _group(mesh: RenderMesh, axes):
    """(process group, size) of one axis or of both (the whole mesh)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if set(axes) == set(AXES):
        return dist.group.WORLD, mesh.size
    (axis,) = axes
    return mesh.groups[axis], mesh.shape[axis]


def _wire(x: torch.Tensor, mesh: RenderMesh) -> torch.Tensor:
    """What a collective sends: a contiguous tensor, on the host under gloo."""
    return x.detach().cpu() if mesh.backend == "gloo" and x.is_cuda else x.contiguous()


def psum(x: torch.Tensor, mesh: RenderMesh, axes=AXES) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (one axis or both)."""
    group, size = _group(mesh, axes)
    if size == 1:
        return x
    y = _wire(x, mesh).clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.device)


def pmean(x: torch.Tensor, mesh: RenderMesh, axis: str = "spp") -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``axis``: the sum over the size,
    as ``jax.lax.pmean``."""
    n = mesh.shape[axis]
    return x if n == 1 else psum(x, mesh, axis) / n


def all_gather_rows(x: torch.Tensor, mesh: RenderMesh, axis: str = "tile") -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated in the axis's order
    (``all_gather(..., tiled=True)``). Every rank gets the whole."""
    group, size = _group(mesh, axis)
    if size == 1:
        return x
    w = _wire(x, mesh)
    parts = [torch.empty_like(w) for _ in range(size)]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=0).to(x.device)


def ring_exchange(to_next: torch.Tensor, to_prev: torch.Tensor, mesh: RenderMesh):
    """One step of the ring of the tile axis: send ``to_next`` to the next
    band's rank and ``to_prev`` to the previous one (both wrap around).
    Returns (what the previous rank sent on, what the next rank sent back).
    The two messages carry distinct tags and go out in one fixed order, so
    with two bands, where previous and next are one peer, they stay apart."""
    group, n = _group(mesh, "tile")
    if n == 1:
        return to_next, to_prev
    ranks = dist.get_process_group_ranks(group)  # global ranks in band order
    nxt, prv = ranks[(mesh.tile + 1) % n], ranks[(mesh.tile - 1) % n]
    send_next, send_prev = _wire(to_next, mesh), _wire(to_prev, mesh)
    from_prev, from_next = torch.empty_like(send_next), torch.empty_like(send_prev)
    ops = [dist.P2POp(dist.isend, send_next, nxt, group=group, tag=_TAG_TO_NEXT),
           dist.P2POp(dist.isend, send_prev, prv, group=group, tag=_TAG_TO_PREV),
           dist.P2POp(dist.irecv, from_prev, prv, group=group, tag=_TAG_TO_NEXT),
           dist.P2POp(dist.irecv, from_next, nxt, group=group, tag=_TAG_TO_PREV)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev.to(to_next.device), from_next.to(to_prev.device)


def gather_objects(obj, mesh: RenderMesh) -> list:
    """Every rank's ``obj`` (picklable), in rank order."""
    if mesh.size == 1:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


# --- launcher ----------------------------------------------------------------


def _to_cpu(x):
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_cpu(v) for v in x)
    if hasattr(x, "_fields"):  # a NamedTuple
        return type(x)(*(_to_cpu(v) for v in x))
    return x


def _rank_main(rank: int, fn, n_tile: int, n_spp: int, device_type: str, init: str,
               result: str, spawned: bool, args) -> None:
    """One rank: its card, the process group, the mesh, then ``fn(mesh,
    *args)``; rank 0 saves its result to ``result``."""
    world = n_tile * n_spp
    if spawned:
        torch.set_num_threads(1)  # the ranks share the host's cores
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend_for(torch.device(device_type), world),
                            init_method=init, rank=rank, world_size=world)
    try:
        mesh = make_render_mesh(n_tile, n_spp, device_type)
        out = fn(mesh, *args)
        if rank == 0:
            torch.save(_to_cpu(out), result)
        if world > 1:
            dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn, n_tile: int, n_spp: int, device, *args):
    """Run ``fn(mesh, *args)`` on ``n_tile * n_spp`` ranks, one process a
    rank, and return rank 0's result (its tensors on the host). ``fn``
    must be importable by name (a module-level function of this package):
    the ranks are spawned. On the card rank r takes ``cuda:(r % count)``;
    the kernels are built here first, so the ranks do not each run nvcc.
    A one-rank mesh runs in the calling process. An exception in any rank
    ends the others and raises here."""
    device = select(device) if isinstance(device, str) else torch.device(device)
    world = n_tile * n_spp
    if n_tile < 1 or n_spp < 1:
        raise ValueError(f"mesh ({n_tile}, {n_spp}) has no ranks")
    if device.type == "cuda":
        from vkrt_tpu_torch.device import kernels

        kernels()
    with tempfile.TemporaryDirectory(prefix="vkrt_mesh_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        result = os.path.join(tmp, "result.pt")
        spec = (fn, n_tile, n_spp, device.type, init, result, world > 1, args)
        if world == 1:
            if dist.is_initialized():
                raise RuntimeError("launch: this process already belongs to a process group")
            _rank_main(0, *spec)
        else:
            torch.multiprocessing.start_processes(_rank_main, args=spec, nprocs=world,
                                                  join=True, start_method="spawn")
        return torch.load(result, weights_only=False)
