"""The port's denoiser (``vkrt_tpu_torch/models/denoiser.py``) against
``vkrt_tpu/models/denoiser.py`` on seeded numpy inputs at 48x32:

* ``motion_vectors`` and ``reproject`` for one camera pair (world points on
  a slanted plane, a history with empty, rejected and accepted taps):
  ``in_prev`` and the history's validity bit for bit away from ulp ties,
  the floats within atol 1e-5 + rtol 1e-4;
* ``_neighborhood_clamp`` bit for bit, its border pixels against an
  edge-padded numpy box;
* ``atrous_filter`` with and without ``variance`` / ``hit_dist_norm``,
  ``denoise_gi``, and two chained ``denoise_temporal`` calls with the state
  carried (the camera moves between them), within the same tolerance;
* the port's versions of the four tests of tests/test_denoiser.py: a static
  camera reprojects onto itself, static history accumulates, an empty
  history is rejected, and on a fly-through the temporal denoiser beats the
  spatial-only one and the noisy input (corr sampler off, as there), with
  the port's ``utils/metrics.rmse``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vkrt_tpu.models import denoiser as jd
from vkrt_tpu.ops import nrd as jnrd
from vkrt_tpu.utils.camera import generate_rays as j_generate_rays
from vkrt_tpu.utils.camera import orbit_camera as j_orbit_camera
from vkrt_tpu_torch.config import RenderSettings
from vkrt_tpu_torch.engine import Engine
from vkrt_tpu_torch.models import denoiser as dn
from vkrt_tpu_torch.scene import make_cornell_box
from vkrt_tpu_torch.utils.camera import Camera, generate_rays, orbit_camera, pixel_coords
from vkrt_tpu_torch.utils.metrics import rmse

torch.set_num_threads(2)
W, H = 48, 32
N = W * H
TOL = dict(rtol=1e-4, atol=1e-5)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=err_msg, **TOL)


def _plane_points(cam_j):
    """World points where the camera's pixel-centre rays meet the slanted
    plane z = -2 - 0.3 x (every ray of the default and nearby cameras hits
    it in front), and its unit normal."""
    o, d = j_generate_rays(cam_j, W, H, jnp.full((N, 2), 0.5))
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    nrm = np.array([0.3, 0.0, 1.0]) / np.linalg.norm([0.3, 0.0, 1.0])
    t = (-2.0 - (o @ np.array([0.3, 0.0, 1.0]))) / (d @ np.array([0.3, 0.0, 1.0]))
    return (o + t[:, None] * d).astype(np.float32), np.tile(nrm, (N, 1)).astype(np.float32)


def _w(p, m):
    """|w| of world points under a view-projection matrix (float64)."""
    return np.abs(np.asarray(p, np.float64) @ np.asarray(m, np.float64)[3, :3]
                  + np.asarray(m, np.float64)[3, 3])


@pytest.fixture(scope="module")
def frames():
    """Three camera poses, the plane seen from each, a seeded history of the
    first pose, and packed denoiser inputs of the second. (The camera moves
    at every step: with a static camera the previous positions land on
    pixel centres, and at the frame's first row and column an ulp below 0
    takes the neighbouring pixel's history, an ulp above its own.)"""
    rng = np.random.default_rng(3)
    cams = [j_orbit_camera(0.01 * i, radius=15.0, height=0.5 + 0.2 * i).matrices(W, H)
            for i in range(3)]
    p0, n0 = _plane_points(cams[0])
    p1, n1 = _plane_points(cams[1])
    p2, _ = _plane_points(cams[2])
    # lengths 2 and 3 left out: the variance boost switches at a new length
    # of 4, and a reprojected length of 3 (or 2, one call later) from one
    # valid tap comes back as 3 +- an ulp, so the two packages would sit on
    # either side of the switch (an ulp tie, like in_prev's at the borders)
    hist_len = rng.choice(np.r_[0, 1, 4:33], N).astype(np.float32)
    hist_len[rng.random(N) < 0.2] = 0.0
    prev_normal = n0.copy()
    flip = rng.random(N) < 0.1  # rejected by the normal test
    prev_normal[flip] = -prev_normal[flip]
    prev_z = _w(p0, cams[0].view_proj).astype(np.float32)
    prev_z[rng.random(N) < 0.1] *= 1.5  # rejected by the depth test
    # an accumulated moment pair has m2 >= m1^2; with m2 < m1^2 the clamped
    # zero variance makes the luminance stopper exp(-|dl| / 1e-4), which
    # turns last-ulp differences of the reprojection (multiply-adds here, a
    # dot product there) into 1e-4 relative
    m1 = rng.uniform(0, 1, N)
    state = dict(hist_rad=rng.uniform(0, 1, (N, 3)), hist_m1=m1,
                 hist_m2=m1 * m1 + rng.uniform(0.01, 0.3, N), hist_len=hist_len,
                 prev_view_proj=np.asarray(cams[0].view_proj), prev_view_z=prev_z,
                 prev_normal=prev_normal)
    state = {k: np.asarray(v, np.float32) for k, v in state.items()}
    rad = rng.uniform(0, 2, (N, 3)).astype(np.float32)
    hd = rng.uniform(0, 1, N).astype(np.float32)
    hd[rng.random(N) < 0.2] = 0.0
    rough = rng.uniform(0.1, 1, N).astype(np.float32)
    return dict(cams=cams, p0=p0, n0=n0, p1=p1, n1=n1, p2=p2, state=state,
                packed=np.asarray(jnrd.pack_radiance_and_norm_hit_dist(_j(rad), _j(hd))),
                norm_rough=np.asarray(jnrd.pack_normal_and_roughness(
                    _j(n1), _j(rough), jnp.zeros(N))),
                view_z=-_w(p1, cams[1].view_proj).astype(np.float32),
                view_z2=-_w(p2, cams[2].view_proj).astype(np.float32))


def _states(fr):
    js = jd.DenoiserState(**{k: _j(v) for k, v in fr["state"].items()})
    ts = dn.DenoiserState(**{k: _t(v) for k, v in fr["state"].items()})
    return js, ts


def test_motion_vectors_and_reproject_match_jax(frames):
    fr = frames
    js, ts = _states(fr)
    m = fr["state"]["prev_view_proj"]
    jpx, jin = jd.motion_vectors(_j(fr["p1"]), _j(m), W, H)
    tpx, tin = dn.motion_vectors(_t(fr["p1"]), _t(m), W, H)
    _close(tpx, jpx)
    px = np.asarray(jpx)
    tie = ((np.abs(px + 0.5) < 1e-3) | (np.abs(px - [W - 0.5, H - 0.5]) < 1e-3)).any(1)
    np.testing.assert_array_equal(tin.numpy()[~tie], np.asarray(jin)[~tie])
    assert 0.5 < np.asarray(jin).mean() < 1.0  # some points leave the old view

    want = jd.reproject(js, _j(fr["p1"]), _j(fr["view_z"]), _j(fr["n1"]), W, H)
    got = dn.reproject(ts, _t(fr["p1"]), _t(fr["view_z"]), _t(fr["n1"]), W, H)
    for name, g, w_ in zip(("hist_rad", "m1", "m2", "hist_len"), got, want):
        _close(g, w_, name)
    valid = np.asarray(want[3]) > 0
    np.testing.assert_array_equal(got[3].numpy() > 0, valid)
    assert 0.3 < valid.mean() < 0.95, valid.mean()  # accepted and rejected taps


def test_neighborhood_clamp_bit_exact_with_borders():
    rng = np.random.default_rng(5)
    w, h = 12, 9
    hist = rng.uniform(-0.5, 1.5, (w * h, 3)).astype(np.float32)
    cur = rng.uniform(0, 1, (w * h, 3)).astype(np.float32)
    want = np.asarray(jd._neighborhood_clamp(_j(hist), _j(cur), w, h))
    got = dn._neighborhood_clamp(_t(hist), _t(cur), w, h).numpy()
    np.testing.assert_array_equal(got, want)
    # the border pixels on their own, against an edge-padded numpy box
    img = np.pad(cur.reshape(h, w, 3), ((1, 1), (1, 1), (0, 0)), mode="edge")
    win = np.stack([img[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                    for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    ref = np.clip(hist.reshape(h, w, 3), win.min(0), win.max(0))
    border = np.zeros((h, w), bool)
    border[[0, -1], :] = border[:, [0, -1]] = True
    np.testing.assert_array_equal(got.reshape(h, w, 3)[border], ref[border])
    assert (got != hist).any(1).reshape(h, w)[border].any()


@pytest.mark.parametrize("variance,hit_dist", [(False, False), (True, False), (False, True),
                                               (True, True)])
def test_atrous_filter_matches_jax(variance, hit_dist):
    rng = np.random.default_rng(7)
    rad = rng.uniform(0, 2, (N, 3)).astype(np.float32)
    nrm = (rng.normal(size=(N, 3)) * 0.2 + [0, 0, 1]).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    z = rng.uniform(4, 6, N).astype(np.float32)
    kw = {}
    if variance:
        kw["variance"] = rng.uniform(-0.05, 0.3, N).astype(np.float32)
    if hit_dist:
        hd = rng.uniform(0, 1, N).astype(np.float32)
        hd[::7] = 0.0
        kw["hit_dist_norm"] = hd
    want = jd.atrous_filter(_j(rad), _j(nrm), _j(z), W, H, **{k: _j(v) for k, v in kw.items()})
    got = dn.atrous_filter(_t(rad), _t(nrm), _t(z), W, H, **{k: _t(v) for k, v in kw.items()})
    _close(got, want)
    assert np.abs(np.asarray(want) - rad).max() > 0.1  # it filtered


def test_denoise_gi_and_chained_temporal_match_jax(frames):
    fr = frames
    args = ("packed", "norm_rough", "view_z")
    want = jd.denoise_gi(*(_j(fr[a]) for a in args), W, H)
    got = dn.denoise_gi(*(_t(fr[a]) for a in args), W, H)
    _close(got, want, "denoise_gi")

    # two frames: the seeded history seen from pose 0, then pose 1's inputs,
    # then pose 2's (the second call reprojects the first call's state)
    js, ts = _states(fr)
    for step, (pos, vz) in enumerate((("p1", "view_z"), ("p2", "view_z2"))):
        cam = fr["cams"][step + 1]
        inputs = (fr["packed"], fr["norm_rough"], fr[vz], fr[pos])
        jf, js = jd.denoise_temporal(js, *(_j(a) for a in inputs), cam.view_proj, W, H)
        tf, ts = dn.denoise_temporal(ts, *(_t(a) for a in inputs), _t(cam.view_proj), W, H)
        assert not (np.abs(np.asarray(js.hist_len) - 4.0) < 1e-4).any()  # no tie
        _close(tf, jf, f"filtered, call {step}")
        for name in dn.DenoiserState._fields:
            _close(getattr(ts, name), getattr(js, name), f"{name}, call {step}")
        np.testing.assert_array_equal(ts.hist_len.numpy() > 1.0, np.asarray(js.hist_len) > 1.0)
    assert (ts.hist_len.numpy() > 1.5).mean() > 0.5  # history grew on the second call


# --- the port's versions of tests/test_denoiser.py -------------------------


def test_motion_vectors_identity():
    """A static camera reprojects every pixel onto itself."""
    cam = Camera().matrices(W, H, "cpu")
    pix = pixel_coords(W, H)
    origin, direction = generate_rays(cam, W, H, torch.full((N, 2), 0.5))
    world_pos = origin + 5.0 * direction
    prev_px, in_prev = dn.motion_vectors(world_pos, cam.view_proj, W, H)
    np.testing.assert_allclose(prev_px.numpy(), pix.numpy(), atol=1e-2)
    assert bool(in_prev.all())


def test_reproject_static_accumulates():
    """With an identical previous frame, reprojection returns the history."""
    cam = Camera().matrices(W, H, "cpu")
    origin, direction = generate_rays(cam, W, H, torch.full((N, 2), 0.5))
    world_pos = origin + 5.0 * direction
    normal = torch.tensor([[0.0, 0.0, 1.0]]).repeat(N, 1)
    w_prev = _t(_w(world_pos.numpy(), cam.view_proj.numpy()).astype(np.float32))
    st = dn.init_state(W, H, "cpu")._replace(
        hist_rad=torch.full((N, 3), 0.5), hist_len=torch.ones(N),
        prev_view_proj=cam.view_proj, prev_view_z=w_prev, prev_normal=normal)
    h_rad, _, _, h_len = dn.reproject(st, world_pos, torch.full((N,), -5.0), normal, W, H)
    np.testing.assert_allclose(h_rad.numpy(), 0.5, atol=1e-4)
    np.testing.assert_allclose(h_len.numpy(), 1.0, atol=1e-3)


def test_reproject_rejects_empty_history():
    """Zero hist_len (a fresh state) yields no reprojected history."""
    cam = Camera().matrices(W, H, "cpu")
    origin, direction = generate_rays(cam, W, H, torch.full((N, 2), 0.5))
    st = dn.init_state(W, H, "cpu")._replace(prev_view_proj=cam.view_proj)
    normal = torch.tensor([[0.0, 0.0, 1.0]]).repeat(N, 1)
    _, _, _, h_len = dn.reproject(st, origin + 5.0 * direction, torch.full((N,), -5.0),
                                  normal, W, H)
    assert float(h_len.max()) == 0.0


def _orbit_cam(t):
    return orbit_camera(t, center=(0.0, 0.0, 0.0), radius=15.0, height=0.5)


def _flythrough(box, settings, frames=5):
    e = Engine(box, W, H, settings)
    out = None
    for f in range(frames):
        e.camera = _orbit_cam(0.002 * f)
        out = e.render_frame()
    return out.numpy()


def test_temporal_beats_noisy_and_spatial():
    """Fly-through RMSE: temporal < spatial-only and temporal < no-denoise,
    corr sampler off (the filter's design assumes white per-pixel noise)."""
    frames = 5
    box = make_cornell_box(device="cpu")
    base = RenderSettings(rt_mode=0, use_gi=True, corr_sampler=False)
    noisy = _flythrough(box, base, frames)
    spatial = _flythrough(box, base.replace(use_denoiser=True, temporal_denoiser=False),
                          frames)
    temporal = _flythrough(box, base.replace(use_denoiser=True, temporal_denoiser=True),
                           frames)
    ref_engine = Engine(box, W, H, base)
    ref_engine.camera = _orbit_cam(0.002 * (frames - 1))
    for _ in range(64):
        ref = ref_engine.render_frame()
    ref = ref.numpy()
    r_noisy, r_spatial, r_temporal = (rmse(x, ref) for x in (noisy, spatial, temporal))
    assert r_temporal < r_noisy, (r_temporal, r_noisy)
    assert r_temporal < r_spatial, (r_temporal, r_spatial)


def test_app_denoiser_and_alpha_flags(tmp_path, monkeypatch):
    """``--denoiser`` and ``--alpha-test`` reach the settings; the denoised
    frame is written."""
    import vkrt_tpu_torch.engine as engine_mod
    from vkrt_tpu.utils.png import decode_png
    from vkrt_tpu_torch import app

    seen = []

    class Recording(engine_mod.Engine):
        def __init__(self, scene, width, height, settings, *a):
            seen.append(settings)
            super().__init__(scene, width, height, settings, *a)

    monkeypatch.setattr(engine_mod, "Engine", Recording)
    out = tmp_path / "dn.png"
    base = ["--procedural", "cornell", "--width", "32", "--height", "24", "--device", "cpu",
            "--out", str(out)]
    assert app.main(base + ["--gi", "--denoiser", "--frames", "2"]) == 0
    assert seen[-1] == RenderSettings(use_gi=True, use_denoiser=True)
    assert decode_png(out.read_bytes())[..., :3].mean() > 10
    assert app.main(base + ["--alpha-test", "--mode", "path"]) == 0
    assert seen[-1] == RenderSettings(rt_mode=1, alpha_test=True)
    args = app.build_argparser().parse_args([])
    assert not (args.denoiser or args.alpha_test)
