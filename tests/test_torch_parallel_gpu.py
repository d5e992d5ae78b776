"""Mesh rendering on the card (``vkrt_tpu_torch/parallel``). Marked
``gpu``; each test skips without a CUDA device (decided in a fixture, not
at import). The card's machine has no JAX: run with ``python -m pytest
--noconftest tests/test_torch_parallel_gpu.py -q``.

* mesh (1,1) (NCCL on one card), path mode with the correlated sampler on,
  bit for bit the single-process engine, and kernels A and B launched 6
  and 3 times a frame;
* meshes (2,1) and (4,1), the ranks sharing one card (gloo; NCCL when
  there is a card a rank): path mode bit for bit the engine (corr off),
  and the denoised hybrid frame with GI per pixel the engine's over 2
  frames, the band form's denoiser kernels launched 1 + 3 times a frame;
* kernel A launched on a tensor of the second card while the first is
  current (skips with one card): the launch goes to the tensor's card."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

W, H = 160, 120
CLEAR = (1.0, 1.0, 1.0, 1.0)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return torch.device("cuda")


def _engine(cuda, frames, **kw):
    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.scene import make_cornell_box
    from vkrt_tpu_torch.utils.camera import Camera

    e = Engine(make_cornell_box(device=cuda), W, H, RenderSettings(**kw), Camera(), CLEAR)
    for _ in range(frames):
        e.render_frame()
    return e


def _job(kind, frames, **kw):
    from vkrt_tpu_torch.utils.camera import Camera

    job = dict(kind=kind, scene=("cornell_box",), width=W, height=H, clear_color=CLEAR,
               depth=3, **kw)
    if kind == "path":
        return dict(job, cameras=[Camera()], samples=1, frames=frames)
    return dict(job, cameras=[Camera()] * frames)


def _kernels_a_b(launches: dict):
    """Kernel A's and B's launches, and B's albedo launches, in a rank's
    ``device.counts`` copy."""
    return launches["vkrt_trace"], launches["vkrt_shade"], launches["vkrt_shade.albedo"]


def test_mesh11_matches_engine_on_the_card(cuda):
    from vkrt_tpu_torch.parallel.mesh import launch
    from vkrt_tpu_torch.parallel.render import run_jobs

    (res,) = launch(run_jobs, 1, 1, "cuda", [_job("path", 2, corr=True)])
    assert res["backend"] == "nccl"
    assert [_kernels_a_b(c) for c in res["launches"]] == [(12, 6, 0)]
    e = _engine(cuda, 2, rt_mode=1, corr_sampler=True)
    assert torch.equal(res["accum"], e.accum[e._inv_perm].cpu())
    assert res["rays"] == e.total_rays


@pytest.mark.parametrize("n_tile", [2, 4])
def test_ranks_match_engine(cuda, n_tile):
    """``n_tile`` bands (30 or 60 rows): path mode bit for bit the engine,
    the denoised hybrid frames (ring halos, gathered history) per pixel."""
    from vkrt_tpu_torch.parallel.mesh import launch
    from vkrt_tpu_torch.parallel.render import run_jobs

    path, hyb = launch(run_jobs, n_tile, 1, "cuda", [
        _job("path", 2, corr=False),
        _job("hybrid", 2, use_gi=True, use_denoiser=True, corr=False)])
    want = "nccl" if torch.cuda.device_count() >= n_tile else "gloo"
    assert path["backend"] == hyb["backend"] == want
    assert [_kernels_a_b(c) for c in path["launches"]] == [(12, 6, 0)] * n_tile
    assert [_kernels_a_b(c) for c in hyb["launches"]] == [(12, 4, 0)] * n_tile
    assert [(c["vkrt_denoise_temporal"], c["vkrt_denoise_atrous"])
            for c in hyb["launches"]] == [(2, 6)] * n_tile  # 1 + 3 a frame
    e = _engine(cuda, 2, rt_mode=1, corr_sampler=False)
    assert torch.equal(path["accum"], e.accum[e._inv_perm].cpu())
    assert path["rays"] == e.total_rays
    e = _engine(cuda, 2, rt_mode=0, use_gi=True, use_denoiser=True, corr_sampler=False)
    np.testing.assert_allclose(hyb["images"][-1]["accum"].numpy(),
                               e.accum_rt[e._inv_perm].cpu().numpy(), rtol=1e-4, atol=1e-5)
    assert hyb["rays"] == e.total_rays


def test_kernel_launches_on_the_tensors_card(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from vkrt_tpu_torch.ops.cuda.trace import build_bvh, trace_kernel
    from vkrt_tpu_torch.ops.trace import trace_rays_bruteforce
    from vkrt_tpu_torch.scene import make_cornell_box
    from vkrt_tpu_torch.utils.camera import Camera, generate_rays

    second = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    scene = make_cornell_box(device=second)
    o, d = generate_rays(Camera().matrices(W, H, second), W, H,
                         torch.full((W * H, 2), 0.5, device=second))
    t_lim = torch.full((W * H,), 1e30, device=second)
    hits = trace_kernel(build_bvh(scene), scene, o, d, t_lim)
    torch.cuda.synchronize(second)
    assert torch.cuda.current_device() == 0 and hits.t.device == second
    ref = trace_rays_bruteforce(*(x.cpu() for x in (scene.tri_v0, scene.tri_e1,
                                                    scene.tri_e2, o, d, t_lim)))
    assert torch.equal(hits.tri.cpu(), ref.tri)
