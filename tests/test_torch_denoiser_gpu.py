"""The denoiser's kernels (``csrc/denoise.cu``) and the alpha tracer on the
card (kernels A and B, PyTorch around them) against their plain versions.
Marked ``gpu``; each test skips without a CUDA device (decided in the
fixture, not at import). The card's machine has no JAX: run with
``python -m pytest --noconftest tests/test_torch_denoiser_gpu.py -q``.

* the à-trous kernel against ``atrous_filter_plain`` on the card, bit for
  bit, at 160x120, 3840x16, 100x37 (a width and a height that are no
  multiple of the block) and 50x8 (the least height, 2^3), with and
  without the variance and the hit distance, miss pixels (zero normals,
  a zero or negative variance, hit distances at 0 and under 1e-4) and,
  in one set, non-finite view depths; the taps wrap over every edge;
* the temporal kernel against ``temporal_pass_plain`` on the card, every
  output bit for bit, at the same shapes over a history reprojected by a
  moving camera, with history lengths of 0 and, in one set, miss pixels
  (zero packed inputs) and non-finite depths and positions;
* the band form through ring halos (bands in threads, the halos passed
  between them as ``_ring_halo`` does) equal per pixel to the full frame;
* a denoised frame launches the temporal kernel once and the à-trous
  kernel 3 times (the spatial-only filter 3 times), each kernel call under
  ``torch.cuda.set_sync_debug_mode("error")``;
* ``denoise_temporal`` twice with the state carried (seeded inputs at
  160x120, the camera moving) against the CPU: every float within atol
  1e-5 + rtol 1e-4, the history's validity equal;
* ``make_city(grid=8)`` at 160x120, depth 3, 2 frames of a fly-through
  with the temporal denoiser: the display gate of
  tests/test_accuracy_oracle.py:83-88, rays within 0.1%, 6 launches of
  kernel A, 2 of kernel B and 1 + 3 of the denoiser a frame;
* the same city with a BLEND and a MASK material and ``alpha_test``, path
  mode at depth 4 and hybrid mode: the same gate, 25 launches of kernel A
  a frame (5 traces of 1 + 4 rounds), none of kernel B."""

import contextlib
import threading
import types

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


SHAPES = [(160, 120), (3840, 16), (100, 37), (50, 8)]
ITERATIONS = 3


@contextlib.contextmanager
def _no_sync():
    """Every synchronise of the device inside raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _same(got, want, what: str):
    """Bit for bit up to NaN payloads: NaN where the plain path has one,
    every other value equal (a zero's sign aside)."""
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), f"{what}: NaN at other pixels"
    bad = (got != want) & ~nan
    if bad.any():
        err = (got - want).abs()[bad].max()
        raise AssertionError(f"{what}: {int(bad.sum())} of {got.numel()} values differ "
                             f"(max abs {float(err):.3g})")


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _atrous_inputs(w: int, h: int, nonfinite: bool, cuda):
    """Seeded filter inputs: radiance in [0, 2), normals near one direction
    (so the normal weight is neither 0 nor 1), depths in [-6, -5), a
    variance with zeros and negatives, hit distances with zeros and values
    under 1e-4; 5% of the pixels misses (zero normal, zero depth)."""
    rng = np.random.default_rng(w * 1000 + h)
    n = w * h
    rad = rng.uniform(0, 2, (n, 3))
    nrm = _unit(np.array([0.3, 0.0, 1.0]) + 0.15 * rng.normal(size=(n, 3)))
    z = -rng.uniform(5, 6, n)
    var = rng.uniform(-0.05, 0.5, n)
    var[rng.random(n) < 0.05] = 0.0
    hd = rng.uniform(0, 1, n)
    hd[rng.random(n) < 0.05] = 0.0
    hd[rng.random(n) < 0.05] = 5e-5
    miss = rng.random(n) < 0.05
    nrm[miss], z[miss] = 0.0, 0.0
    if nonfinite:
        for value in (np.inf, -np.inf, np.nan):
            z[rng.choice(n, 3, replace=False)] = value
    return [torch.from_numpy(np.ascontiguousarray(x).astype(np.float32)).to(cuda)
            for x in (rad, nrm, z, var, hd)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("with_var,with_hd", [(True, True), (True, False), (False, True),
                                              (False, False)], ids=["var-hd", "var", "hd", "bare"])
@pytest.mark.parametrize("depth", ["finite", "nonfinite"])
def test_atrous_kernel_matches_plain(cuda, shape, with_var, with_hd, depth):
    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.models import denoiser as dn

    w, h = shape
    rad, nrm, z, var, hd = _atrous_inputs(w, h, depth == "nonfinite", cuda)
    kw = dict(variance=var if with_var else None, hit_dist_norm=hd if with_hd else None)
    want = dn.atrous_filter_plain(rad, nrm, z, w, h, ITERATIONS, **kw)
    kdev.reset_counts()
    with _no_sync():
        got = dn.atrous_filter(rad, nrm, z, w, h, ITERATIONS, **kw)
    assert kdev.counts["vkrt_denoise_atrous"] == {"launches": ITERATIONS,
                                                  "lanes": ITERATIONS * w * h}
    _same(got, want, f"atrous {w}x{h}")
    if depth == "finite":
        assert torch.isfinite(want).all()


def _plane_frame(w: int, h: int, step: int, cuda):
    """Seeded denoiser inputs of the plane z = -2 - 0.3 x under an orbiting
    camera, pose ``step``: packed radiance and hit distance, packed
    normals, view depth, world positions, view_proj."""
    from vkrt_tpu_torch.ops import nrd
    from vkrt_tpu_torch.utils.camera import generate_rays, orbit_camera

    n = w * h
    rng = np.random.default_rng(3 + step)
    rad = torch.from_numpy(rng.uniform(0, 2, (n, 3)).astype(np.float32))
    hd = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    nrm = torch.tensor([[0.3, 0.0, 1.0]]) / float(np.hypot(0.3, 1.0))
    packed = nrd.pack_radiance_and_norm_hit_dist(rad, hd)
    norm_rough = nrd.pack_normal_and_roughness(nrm.expand(n, 3), torch.full((n,), 0.5),
                                               torch.zeros(n))
    cam = orbit_camera(0.01 * step, radius=15.0, height=0.5 + 0.2 * step).matrices(w, h, "cpu")
    o, d = generate_rays(cam, w, h, torch.full((n, 2), 0.5))
    t = (-2.0 - o @ nrm[0]) / (d @ nrm[0])
    pos = o + t[:, None] * d
    view_z = -(pos @ cam.view_proj[3, :3] + cam.view_proj[3, 3]).abs()
    return [x.contiguous().to(cuda) for x in (packed, norm_rough, view_z, pos, cam.view_proj)]


def _history(w: int, h: int, cuda):
    """The plain path's state after one frame at pose 0, with 10% of the
    history lengths set to 0."""
    from vkrt_tpu_torch.models import denoiser as dn

    _, state = dn.denoise_temporal_plain(dn.init_state(w, h, cuda), *_plane_frame(w, h, 0, cuda),
                                         w, h)
    drop = torch.from_numpy(np.random.default_rng(w + h).random(w * h) < 0.1).to(cuda)
    return state._replace(hist_len=torch.where(drop, 0.0, state.hist_len))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", ["moving", "misses"])
def test_temporal_kernel_matches_plain(cuda, shape, case):
    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.models import denoiser as dn

    w, h = shape
    history = _history(w, h, cuda)
    packed, norm_rough, view_z, pos, view_proj = _plane_frame(w, h, 1, cuda)
    if case == "misses":  # the G-buffer's background: everything packed as 0
        rng = np.random.default_rng(w * h)
        miss = torch.from_numpy(rng.random(w * h) < 0.1).to(cuda)
        packed, norm_rough, pos = (torch.where(miss[:, None], 0.0, x)
                                   for x in (packed, norm_rough, pos))
        view_z = torch.where(miss, 0.0, view_z)
        for value in (np.inf, -np.inf, np.nan):
            view_z[torch.from_numpy(rng.choice(w * h, 3, replace=False))] = value
            pos[torch.from_numpy(rng.choice(w * h, 3, replace=False)), 1] = value
    args = (history, packed, norm_rough, view_z, pos, w, h, h)
    want = dn.temporal_pass_plain(*args)
    kdev.reset_counts()
    with _no_sync():
        got = dn.temporal_pass(*args)
    assert kdev.counts["vkrt_denoise_temporal"] == {"launches": 1, "lanes": w * h}
    for field in dn.Temporal._fields:
        _same(getattr(got, field), getattr(want, field), f"temporal {w}x{h} {field}")
    assert (want.hist_len > 1.0).any()  # some history was reprojected


class _ThreadRing:
    """Bands of one frame in threads of one process, their halos passed as
    ``models.denoiser._ring_halo`` passes them over a mesh: a band's top
    halo is the previous band's last k rows, its bottom halo the next
    band's first k rows, the ring wrapping."""

    def __init__(self, bands: int):
        self.bands = bands
        self.slots = [None] * bands
        self.barrier = threading.Barrier(bands, timeout=60)

    def halo_fn(self, band: int):
        def fetch(x, k: int):
            self.slots[band] = (x[-k:], x[:k])
            self.barrier.wait()
            top = self.slots[(band - 1) % self.bands][0]
            bottom = self.slots[(band + 1) % self.bands][1]
            self.barrier.wait()
            return top, bottom
        return fetch

    def mesh(self, band: int):
        return types.SimpleNamespace(tile=band, shape={"tile": self.bands, "spp": 1})


@pytest.mark.parametrize("bands", [2, 4])
def test_band_form_matches_full_frame(cuda, bands):
    """``_denoise`` on row bands with ring halos (the band form's kernels,
    the whole frame's history) equals the full frame per pixel, the new
    state too."""
    from vkrt_tpu_torch.models import denoiser as dn

    w, h = 160, 120
    rows = h // bands
    history = _history(w, h, cuda)
    frame = _plane_frame(w, h, 1, cuda)
    full, full_state = dn.denoise_temporal(history, *frame, w, h)
    ring = _ThreadRing(bands)
    out, errors = [None] * bands, []

    def run(b):
        try:
            band = [x[b * rows * w:(b + 1) * rows * w] for x in frame[:4]]
            out[b] = dn._denoise(history, *band, frame[4], w, h, rows, ITERATIONS,
                                 ring.halo_fn(b), ring.mesh(b))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            ring.barrier.abort()

    threads = [threading.Thread(target=run, args=(b,)) for b in range(bands)]
    with _no_sync():
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    _same(torch.cat([o[0] for o in out]), full, f"{bands} bands, filtered")
    for field in dn.DenoiserState._fields:
        if field != "prev_view_proj":
            _same(torch.cat([getattr(o[1], field) for o in out]), getattr(full_state, field),
                  f"{bands} bands, {field}")


def test_denoiser_launches(cuda):
    """A temporal denoise is 1 + 3 launches, the spatial-only filter 3."""
    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.models import denoiser as dn

    w, h = 160, 120
    state = dn.init_state(w, h, cuda)
    packed, norm_rough, view_z, pos, view_proj = _plane_frame(w, h, 0, cuda)
    kdev.reset_counts()
    with _no_sync():
        dn.denoise_temporal(state, packed, norm_rough, view_z, pos, view_proj, w, h)
    assert [kdev.counts[e]["launches"] for e in ("vkrt_denoise_temporal",
                                                 "vkrt_denoise_atrous")] == [1, 3]
    kdev.reset_counts()
    dn.denoise_gi(packed, norm_rough, view_z, w, h)
    assert [kdev.counts[e]["launches"] for e in ("vkrt_denoise_temporal",
                                                 "vkrt_denoise_atrous")] == [0, 3]
    assert sum(c["launches"] for c in kdev.counts.values()) == 3


def _gate(a, b):
    da, db = (np.clip(np.clip(x, 0, None) ** (1.0 / 2.2), 0, 1) for x in (a, b))
    err = np.abs(da - db).max(-1)
    assert np.percentile(err, 99) <= 1e-3, np.percentile(err, 99)
    diverged = err > 1e-2
    assert diverged.mean() < 0.01, diverged.mean()
    assert float(np.sqrt(np.mean((da - db)[~diverged] ** 2))) <= 1e-3


def test_denoise_temporal_on_card_matches_cpu(cuda):
    from vkrt_tpu_torch.models import denoiser as dn

    out = {}
    for dev in (cuda, torch.device("cpu")):
        state = dn.init_state(W, H, dev)
        for step in range(2):
            filtered, state = dn.denoise_temporal(state, *_plane_frame(W, H, step, dev), W, H)
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
            tuple(kdev.counts[e]["launches"] for e in (
                "vkrt_trace", "vkrt_shade", "vkrt_denoise_temporal", "vkrt_denoise_atrous")))


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
    want = (6, 2, 1, 3) if case == "denoised" else (25, 0, 0, 0)
    assert launches == tuple(k * FRAMES for k in want), launches
