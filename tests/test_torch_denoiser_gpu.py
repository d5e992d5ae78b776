"""The denoiser and the alpha tracer on the card (kernels A and B, PyTorch
around them) against the CPU (the kernels' plain versions). Marked
``gpu``; each test skips without a CUDA device (decided in the fixture,
not at import). The card's machine has no JAX: run with
``python -m pytest --noconftest tests/test_torch_denoiser_gpu.py -q``.

* ``denoise_temporal`` twice with the state carried (seeded inputs at
  160x120, the camera moving): every float within atol 1e-5 + rtol 1e-4,
  the history's validity equal;
* ``make_city(grid=8)`` at 160x120, depth 3, 2 frames of a fly-through
  with the temporal denoiser: the display gate of
  tests/test_accuracy_oracle.py:83-88, rays within 0.1%, 6 launches of
  kernel A and 2 of kernel B a frame (the denoiser launches none);
* the same city with a BLEND and a MASK material and ``alpha_test``, path
  mode at depth 4 and hybrid mode: the same gate, 25 launches of kernel A
  a frame (5 traces of 1 + 4 rounds), none of kernel B."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

W, H, FRAMES = 160, 120, 2


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return torch.device("cuda")


def _gate(a, b):
    da, db = (np.clip(np.clip(x, 0, None) ** (1.0 / 2.2), 0, 1) for x in (a, b))
    err = np.abs(da - db).max(-1)
    assert np.percentile(err, 99) <= 1e-3, np.percentile(err, 99)
    diverged = err > 1e-2
    assert diverged.mean() < 0.01, diverged.mean()
    assert float(np.sqrt(np.mean((da - db)[~diverged] ** 2))) <= 1e-3


def test_denoise_temporal_on_card_matches_cpu(cuda):
    from vkrt_tpu_torch.models import denoiser as dn
    from vkrt_tpu_torch.ops import nrd
    from vkrt_tpu_torch.utils.camera import generate_rays, orbit_camera

    n = W * H
    rng = np.random.default_rng(3)
    rad = torch.from_numpy(rng.uniform(0, 2, (n, 3)).astype(np.float32))
    hd = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    nrm = torch.tensor([[0.3, 0.0, 1.0]]) / float(np.hypot(0.3, 1.0))
    packed = nrd.pack_radiance_and_norm_hit_dist(rad, hd)
    norm_rough = nrd.pack_normal_and_roughness(nrm.expand(n, 3), torch.full((n,), 0.5),
                                               torch.zeros(n))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        state = dn.init_state(W, H, dev)
        for step in range(2):
            cam = orbit_camera(0.01 * step, radius=15.0, height=0.5 + 0.2 * step).matrices(
                W, H, "cpu")
            o, d = generate_rays(cam, W, H, torch.full((n, 2), 0.5))
            t = (-2.0 - o @ nrm[0]) / (d @ nrm[0])  # the plane z = -2 - 0.3 x
            pos = o + t[:, None] * d
            view_z = -(pos @ cam.view_proj[3, :3] + cam.view_proj[3, 3]).abs()
            args = [x.to(dev) for x in (packed, norm_rough, view_z, pos, cam.view_proj)]
            filtered, state = dn.denoise_temporal(state, *args, W, H)
        out[dev.type] = [x.cpu().numpy() for x in (filtered, *state)]
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(out["cuda"][4] > 1.0, out["cpu"][4] > 1.0)
    assert (out["cpu"][4] > 1.0).mean() > 0.5  # the first call's history was reprojected


def _render(dev, scene, settings, pose, frames=FRAMES):
    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.engine import Engine

    eng = Engine(scene, W, H, settings, pose(0))
    kdev.reset_counts()
    for f in range(frames):
        eng.camera = pose(f)
        img = eng.render_frame()
    return (img.cpu().numpy().astype(np.float64), eng.total_rays,
            (kdev.counts["vkrt_trace"]["launches"], kdev.counts["vkrt_shade"]["launches"]))


def _city(dev, alpha: bool):
    from vkrt_tpu_torch.scene import make_city

    scene = make_city(grid=8, device=dev)
    if not alpha:
        return scene
    mode, base = scene.mat_alpha_mode.clone(), scene.mat_base_color.clone()
    mode[3], base[3, 3] = 2, 0.5  # the window grid: BLEND 0.5
    mode[2], base[2, 3] = 1, 0.3  # plain grey: MASK 0.3 under the 0.5 cutoff
    return scene._replace(mat_alpha_mode=mode, mat_base_color=base)


@pytest.mark.parametrize("case", ["denoised", "alpha-path", "alpha-hybrid"])
def test_city_matches_cpu(cuda, case):
    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.utils.camera import orbit_camera

    settings = {
        "denoised": RenderSettings(use_gi=True, use_denoiser=True),
        "alpha-path": RenderSettings(rt_mode=1, depth=4, alpha_test=True),
        "alpha-hybrid": RenderSettings(use_gi=True, alpha_test=True),
    }[case]

    def pose(f):
        return orbit_camera(0.12 + 0.004 * f, radius=25.0, height=4.0)

    got = {dev.type: _render(dev, _city(dev, case != "denoised"), settings, pose)
           for dev in (cuda, torch.device("cpu"))}
    img, rays, launches = got["cuda"]
    assert np.isfinite(img).all() and img.max() > 0
    _gate(img, got["cpu"][0])
    assert abs(rays - got["cpu"][1]) <= 1e-3 * got["cpu"][1], (rays, got["cpu"][1])
    want = (6, 2) if case == "denoised" else (25, 0)
    assert launches == (want[0] * FRAMES, want[1] * FRAMES), launches
