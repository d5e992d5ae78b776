"""Hybrid frames on the card (kernels A and B) against the CPU (their plain
versions). Marked ``gpu``; each test skips without a CUDA device (decided
in the fixture, not at import). The card's machine has no JAX: run with
``python -m pytest --noconftest tests/test_torch_hybrid_gpu.py -q``.

``make_city(grid=8)`` at 160x120, the camera of chip_smoke.py's small city,
depth 3, 2 frames, correlated sampler on, GI off and on: the G-buffer's
hit/miss mask equal on every pixel and its fields within 1e-4 (absolute, or
relative above 1) on >= 99.9% of them; the display gate of
tests/test_accuracy_oracle.py:83-88 on the composite; ray counts within
0.1%; on the card kernel A runs 2 launches a frame without GI and 6 with
it, kernel B 0 and 2 (its albedo instantiation: the city's only texture is
baseColor)."""

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


@pytest.mark.parametrize("gi", [False, True])
def test_hybrid_city_frame_matches_cpu(cuda, gi):
    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.scene import make_city
    from vkrt_tpu_torch.utils.camera import orbit_camera

    cam = orbit_camera(0.12, radius=25.0, height=4.0)
    out, gbuf, rays = {}, {}, {}
    for dev in (cuda, torch.device("cpu")):
        eng = Engine(make_city(grid=8, device=dev), W, H, RenderSettings(use_gi=gi), cam)
        kdev.reset_counts()
        for _ in range(FRAMES):
            img = eng.render_frame()
        out[dev.type] = img.cpu().numpy().astype(np.float64)
        gbuf[dev.type] = [x.cpu().numpy() for x in eng.gbuffer]
        rays[dev.type] = eng.total_rays
        if dev.type == "cuda":
            want = (6, 2) if gi else (2, 0)
            assert tuple(kdev.counts[e]["launches"] for e in (
                "vkrt_trace", "vkrt_shade", kdev.SHADE_ALBEDO)) == (
                want[0] * FRAMES, want[1] * FRAMES, want[1] * FRAMES)
    g, c = gbuf["cuda"], gbuf["cpu"]

    def miss(x):
        return (x[1][:, :3] == 0).all(1) & (x[2][:, :3] == 0).all(1)

    np.testing.assert_array_equal(miss(g), miss(c))
    assert 0.05 < miss(c).mean() < 0.95
    for a, b in zip(g, c):
        close = np.isclose(a, b, rtol=1e-4, atol=1e-4).reshape(a.shape[0], -1).all(1)
        assert close.mean() >= 0.999, close.mean()
    assert np.isfinite(out["cuda"]).all() and out["cuda"].max() > 0
    _gate(out["cuda"], out["cpu"])
    assert abs(rays["cuda"] - rays["cpu"]) <= 1e-3 * rays["cpu"], rays
