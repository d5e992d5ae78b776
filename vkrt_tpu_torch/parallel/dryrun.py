"""A dry run of the sharded frame steps on CPU ranks (the port's
counterpart of ``__graft_entry__.dryrun_multichip``): no card needed.

    python -m vkrt_tpu_torch.parallel.dryrun [N]

``dryrun_multichip(n)`` runs two legs, each on ``n`` gloo ranks on the CPU,
with the default correlated sampler, and asserts for each a finite,
non-black accumulator and a positive ray count:

* the path step: one sharded path-mode frame of the Cornell box at
  32 x max(8, n_tile) on the mesh ``factor_mesh(n)``;
* the hybrid step (``dryrun_hybrid``): the Cornell box at 32 x 8n on an
  (n, 1) mesh, depth 2, with shadows, AO, GI and the temporal denoiser in
  its band form, two frames, so that the second reprojects the history
  and exchanges the ring halos.
"""

from __future__ import annotations

import sys

import numpy as np


def dryrun_multichip(n_devices: int) -> dict:
    """Run both legs on ``n_devices`` CPU ranks; returns rank 0's
    {"mesh", "width", "height", "rays"} of the path leg, with the hybrid
    leg's under "hybrid", after printing each."""
    from vkrt_tpu_torch.parallel.mesh import factor_mesh, launch

    n_tile, n_spp = factor_mesh(n_devices)
    width, height = 32, max(8, n_tile)
    if (width * height) % n_tile:
        height = n_tile
    out = launch(dryrun_rank, n_tile, n_spp, "cpu", width, height)
    print(f"dryrun_multichip OK: mesh(tile={n_tile}, spp={n_spp}) over gloo, "
          f"{width}x{height}, rays={out['rays']:.0f}")
    out["hybrid"] = dryrun_hybrid(n_devices)
    return out


def dryrun_hybrid(n_devices: int) -> dict:
    """The hybrid leg on an (n_devices, 1) mesh of CPU ranks, with the
    default correlated sampler. Returns rank 0's {"mesh", "width",
    "height", "rays"}, ``rays`` the second frame's, after printing it."""
    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.parallel.mesh import launch

    width, height = 32, 8 * n_devices
    out = launch(dryrun_hybrid_rank, n_devices, 1, "cpu", width, height,
                 RenderSettings().corr_sampler)
    print(f"dryrun_multichip hybrid+denoiser OK: mesh(tile={n_devices}, spp=1) over gloo, "
          f"{width}x{height}, rays={out['rays']:.0f}")
    return out


def _check_image(a: np.ndarray, rays: float, what: str) -> None:
    if not np.isfinite(a).all():
        raise AssertionError(f"{what} produced {int((~np.isfinite(a)).sum())} "
                             "non-finite accum elements")
    if float(a.max()) <= 0.0:
        raise AssertionError(f"{what} rendered all-black")
    if rays <= 0.0:
        raise AssertionError(f"{what} traced no rays")


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
    _check_image(a, float(rays), "sharded path step")
    return {"mesh": dict(mesh.shape), "width": width, "height": height,
            "rays": float(rays)}


def dryrun_hybrid_rank(mesh, width: int, height: int, corr: bool) -> dict:
    """One rank of the hybrid leg: two frames of the denoised hybrid step
    on the rank's band (``corr``: the correlated sampler), then the checks
    on the gathered ``accum_rt``."""
    from vkrt_tpu_torch.models.denoiser import init_state
    from vkrt_tpu_torch.ops.trace import make_tracer
    from vkrt_tpu_torch.parallel import render
    from vkrt_tpu_torch.parallel.mesh import all_gather_rows
    from vkrt_tpu_torch.scene import make_cornell_box
    from vkrt_tpu_torch.utils.camera import Camera

    scene = make_cornell_box(device=mesh.device)
    step = render.make_sharded_hybrid_step(
        scene, make_tracer(scene, "auto"), mesh, width=width, height=height, depth=2,
        use_shadows=True, use_ao=True, use_gi=True, use_denoiser=True, corr=corr)
    cam = Camera().matrices(width, height, mesh.device)
    accum = render.zeros_accum(mesh, width, height, 4)
    state = init_state(width, height // mesh.shape["tile"], mesh.device)
    for f in range(2):  # frame 1 reprojects the history and exchanges the halos
        _, accum, rays, state = step(cam, f, accum, (1.0, 1.0, 1.0, 1.0), state)
    _check_image(all_gather_rows(accum, mesh).numpy(), float(rays),
                 "sharded hybrid step")
    return {"mesh": dict(mesh.shape), "width": width, "height": height,
            "rays": float(rays)}


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
