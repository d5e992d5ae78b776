"""A dry run of the sharded path step on CPU ranks (the port's counterpart
of ``__graft_entry__.dryrun_multichip``): no card needed.

    python -m vkrt_tpu_torch.parallel.dryrun [N]

``dryrun_multichip(n)`` starts ``n`` gloo ranks on the CPU as the mesh
``factor_mesh(n)``, runs one sharded path-mode step of the Cornell box at
32 x max(8, n_tile) with the default correlated sampler, and asserts a
finite, non-black accumulator and a positive ray count.
"""

from __future__ import annotations

import sys

import numpy as np


def dryrun_multichip(n_devices: int) -> dict:
    """Run the dry run on ``n_devices`` CPU ranks; returns rank 0's
    {"mesh", "width", "height", "rays"} after printing it."""
    from vkrt_tpu_torch.parallel.mesh import factor_mesh, launch

    n_tile, n_spp = factor_mesh(n_devices)
    width, height = 32, max(8, n_tile)
    if (width * height) % n_tile:
        height = n_tile
    out = launch(dryrun_rank, n_tile, n_spp, "cpu", width, height)
    print(f"dryrun_multichip OK: mesh(tile={n_tile}, spp={n_spp}) over gloo, "
          f"{width}x{height}, rays={out['rays']:.0f}")
    return out


def dryrun_rank(mesh, width: int, height: int) -> dict:
    """One rank of the dry run: one step, then the checks on the gathered
    accumulator."""
    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.ops.trace import make_tracer
    from vkrt_tpu_torch.parallel import render
    from vkrt_tpu_torch.parallel.mesh import all_gather_rows
    from vkrt_tpu_torch.scene import make_cornell_box
    from vkrt_tpu_torch.utils.camera import Camera

    scene = make_cornell_box(device=mesh.device)
    step, inv_perm = render.make_sharded_pathtrace_step(
        scene, make_tracer(scene, "auto"), mesh, width=width, height=height,
        samples=mesh.shape["spp"], depth=2, corr=RenderSettings().corr_sampler)
    accum, rays = step(Camera().matrices(width, height, mesh.device), 0,
                       render.zeros_accum(mesh, width, height), (1.0, 1.0, 1.0, 1.0))
    a = all_gather_rows(accum, mesh)[inv_perm].numpy()
    if not np.isfinite(a).all():
        raise AssertionError(f"sharded path step produced {int((~np.isfinite(a)).sum())} "
                             "non-finite accum elements")
    if float(a.max()) <= 0.0:
        raise AssertionError("sharded path step rendered all-black")
    if float(rays) <= 0.0:
        raise AssertionError("sharded path step traced no rays")
    return {"mesh": dict(mesh.shape), "width": width, "height": height,
            "rays": float(rays)}


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
