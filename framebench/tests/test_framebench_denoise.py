"""The check of a denoised cell whose camera moves, on the CPU at 64x48: the
plain denoiser (``reference/denoise.py``) against the port's, the reference
on a footprint against the reference on the whole frame, whole runs of the
small orbit cell correct on several seeds, and each planted fault and the
bfloat16 control not correct."""

import math

import numpy as np
import pytest
import torch

from framebench import check, scenes
from framebench.cells import make_engine, resolve
from framebench.reference import denoise as ref_dn
from framebench.run import check_frame, poses, renderer, run_cell

W, H = 64, 48
CELL = "cityorbit.hybrid-denoised-orbit"
# The reference computes the port's equations in float32 but not its code:
# it sums its dot products term by term where the port reduces over a
# dimension, and a cosine raised to the 64th power multiplies a rounding
# there by 64. A few float32 ulps, so 1e-5 relative (with 1e-6 absolute for
# values near 0); the two agree bit for bit on this CPU.
RTOL, ATOL = 1e-5, 1e-6


def _quiet(*_):
    pass


def _frame_inputs(step: int, g: torch.Generator):
    """The denoiser's inputs of frame ``step`` of an orbit over a ground
    plane with a smooth bump field: pixels whose ray misses it are
    background (position, normal and depth 0), the GI radiance and hit
    distances are noise drawn from ``g``. Returns (packed radiance, packed
    normal, view_z, world_pos, view_proj)."""
    from vkrt_tpu_torch.ops import nrd
    from vkrt_tpu_torch.utils.camera import generate_rays, orbit_camera

    cam = orbit_camera(0.1 + 0.01 * step, radius=15.0, height=6.0).matrices(W, H, "cpu")
    o, d = generate_rays(cam, W, H, torch.full((W * H, 2), 0.5))
    t = -o[:, 1] / torch.where(d[:, 1] < 0, d[:, 1], -1.0)
    hit = (d[:, 1] < -1e-3) & (t < 60.0)
    pos = torch.where(hit[:, None], o + t[:, None] * d, 0.0)
    nrm = torch.stack([0.3 * torch.sin(pos[:, 0]), torch.ones(W * H), 0.3 * torch.cos(pos[:, 2])],
                      dim=-1)
    nrm = torch.where(hit[:, None], torch.nn.functional.normalize(nrm, dim=-1), 0.0)
    view = cam.view
    vz = torch.where(hit, view[2, 0] * pos[:, 0] + view[2, 1] * pos[:, 1]
                     + view[2, 2] * pos[:, 2] + view[2, 3], 0.0)
    rad = torch.rand(W * H, 3, generator=g) * 2.0
    hd = torch.rand(W * H, generator=g)
    hd[torch.rand(W * H, generator=g) < 0.2] = 0.0
    rough = torch.rand(W * H, generator=g)
    packed = nrd.pack_radiance_and_norm_hit_dist(torch.where(hit[:, None], rad, 0.0), hd)
    nr = torch.where(hit[:, None], nrd.pack_normal_and_roughness(nrm, rough, torch.ones(W * H)),
                     0.0)
    return packed, nr, vz, pos, cam.view_proj


def _states(steps: int = 4):
    """The port's temporal denoiser over ``steps`` frames of the orbit:
    per step (state before, inputs, filtered, state after)."""
    from vkrt_tpu_torch.models import denoiser as dn

    g = torch.Generator().manual_seed(18)
    state = dn.init_state(W, H, "cpu")
    out = []
    for k in range(steps):
        inputs = _frame_inputs(k, g)
        filtered, new = dn.denoise_temporal(state, *inputs, W, H)
        out.append((state, inputs, filtered, new))
        state = new
    return out


def test_reference_denoiser_equals_the_program():
    """Four frames of an orbit, each from the port's history before it:
    the filtered image and every field of the new history agree, and the
    history is reprojected (most pixels keep it past the first frame)."""
    every = ref_dn.PixelSet(torch.arange(W * H), W, H)
    for k, (state, (packed, nr, vz, pos, _), filtered, new) in enumerate(_states()):
        img, fields, known = ref_dn.temporal_step(
            {f: getattr(state, f) for f in ref_dn.STATE}, state.prev_view_proj, every,
            packed, nr, vz, pos)
        assert bool(known.all())
        torch.testing.assert_close(img, filtered, rtol=RTOL, atol=ATOL)
        for f in ref_dn.STATE:
            torch.testing.assert_close(fields[f], getattr(new, f), rtol=RTOL, atol=ATOL)
        if k:
            assert float((new.hist_len > 1.5).float().mean()) > 0.5, k


def test_spatial_reference_equals_the_program():
    from vkrt_tpu_torch.models import denoiser as dn

    packed, nr, vz, _, _ = _frame_inputs(0, torch.Generator().manual_seed(5))
    img, known = ref_dn.spatial(ref_dn.PixelSet(torch.arange(W * H), W, H), packed, nr, vz)
    assert bool(known.all())
    torch.testing.assert_close(img, dn.denoise_gi(packed, nr, vz, W, H), rtol=RTOL, atol=ATOL)


# tiles at every corner and along every border, where the à-trous taps wrap
# and the clamp repeats the edge, and one inside
TILES = np.array([[0, 0], [W - 8, 0], [0, H - 8], [W - 8, H - 8], [24, 0], [0, 16],
                  [W - 8, 24], [32, H - 8], [32, 24]])


def test_footprint_equals_the_whole_frame():
    """The reference over the tiles grown by ``reach()`` gives their pixels
    bit for bit as over the whole frame; grown by one pixel less, some
    pixel of theirs reads outside the set."""
    state, (packed, nr, vz, pos, _), _, _ = _states(3)[-1]
    hist = {f: getattr(state, f) for f in ref_dn.STATE}
    whole, _, _ = ref_dn.temporal_step(hist, state.prev_view_proj,
                                       ref_dn.PixelSet(torch.arange(W * H), W, H),
                                       packed, nr, vz, pos)
    for tile in TILES:
        centres = torch.as_tensor(check.tile_pixels(tile[None], W, H))
        for grow in (ref_dn.reach(), ref_dn.reach() - 1):
            fp = torch.as_tensor(check.tile_pixels(tile[None], W, H, grow))
            assert len(fp) == (8 + 2 * grow) ** 2
            img, _, known = ref_dn.temporal_step(hist, state.prev_view_proj,
                                                 ref_dn.PixelSet(fp, W, H), packed[fp], nr[fp],
                                                 vz[fp], pos[fp])
            at = torch.searchsorted(fp, centres)
            if grow == ref_dn.reach():
                assert bool(known[at].all()), tile
                assert torch.equal(img[at], whole[centres]), tile
            else:
                assert not bool(known[at].all()), tile


def test_tiles_and_reach():
    assert ref_dn.reach() == 15  # 1 + 2 * (1 + 2 + 4)
    t = check.draw_tiles(2**40 + 3, 3840, 2160, 726)
    assert len(t) == len({tuple(x) for x in t}) == 726
    assert (t % check.TILE == 0).all() and (t[:, 0] < 3840).all() and (t[:, 1] < 2160).all()
    assert np.array_equal(t, check.draw_tiles(2**40 + 3, 3840, 2160, 726))
    ids = check.tile_pixels(np.array([[W - 4, H - 4]]), W, H)  # a tile cut by the frame
    assert len(ids) == 16 and ids.max() == W * H - 1


def test_poses(tiny_root):
    """Call j renders at the config's orbit plus (start frame + j) turns a
    frame; a static camera has no poses."""
    from framebench.run import frame_start

    cell = resolve(CELL, root=tiny_root)
    x = cell.traffic["camera"]["orbit_turns_per_frame"]
    seed = 2**33 + 11
    pose_at = poses(cell, seed)
    for j in (0, 1, 7):
        ang = 2 * math.pi * (frame_start(seed) + j) * x
        eye, center, fov = pose_at(j)
        assert np.allclose(eye, (20 * math.sin(ang), 8.0, 20 * math.cos(ang)))
        assert center == (0.0, 2.0, 0.0) and fov == 60.0
    assert pose_at(0) != poses(cell, seed + 1)(0)
    assert poses(resolve("citytiny.hybrid-gi", root=tiny_root), seed) is None


@pytest.mark.parametrize("seed", [3, 2**33 + 11, 2**31 + 7])
def test_orbit_run_is_correct(tiny_root, seed):
    cell = resolve(CELL, root=tiny_root)
    res = run_cell(cell, seed, 0.0, False, "cpu", log=_quiet)
    assert res["correct"], res["numbers"]
    assert res["numbers"]["diverged"] == 0.0 and res["numbers"]["state_rel_l1"] < 1e-4
    assert res["pixels"] == W * H


def _fault(monkeypatch, kind):
    from vkrt_tpu_torch import engine as engine_mod
    from vkrt_tpu_torch.models import denoiser as dn

    if kind == "history_not_written":
        real = dn.denoise_temporal

        def temporal(state, *a, **kw):
            return real(state, *a, **kw)[0], state
        monkeypatch.setattr(dn, "denoise_temporal", temporal)
    elif kind == "current_view_proj":
        real = dn._denoise

        def denoise(history, rad, nr, vz, pos, view_proj, *a, **kw):
            return real(history._replace(prev_view_proj=view_proj), rad, nr, vz, pos, view_proj,
                        *a, **kw)
        monkeypatch.setattr(dn, "_denoise", denoise)
    elif kind == "one_iteration_fewer":
        real = dn.atrous_filter

        def atrous(radiance, normal, view_z, width, height, iterations=3, **kw):
            return real(radiance, normal, view_z, width, height, iterations - 1, **kw)
        monkeypatch.setattr(dn, "atrous_filter", atrous)
    elif kind == "no_clamp":
        monkeypatch.setattr(dn, "_neighborhood_clamp", lambda hist, *a, **kw: hist)
    else:  # "first_pose": the engine renders every frame at the first camera it saw
        real = engine_mod.Engine.update_frame

        def update(self):
            self.__dict__.setdefault("_first_camera", self.camera)
            self.camera = self._first_camera
            real(self)
        monkeypatch.setattr(engine_mod.Engine, "update_frame", update)


@pytest.mark.parametrize("workload", ["cityorbit.path-orbit", "cityorbit.hybrid-orbit"])
@pytest.mark.parametrize("kind", ["sound", "unchanged"])
def test_undenoised_orbits(tiny_root, workload, kind, monkeypatch):
    """An orbit in path mode, and in hybrid mode without the denoiser, is
    checked on its check frame too: sound runs are correct, a frame that
    returns its RT buffer unchanged is not."""
    from vkrt_tpu_torch import engine as engine_mod

    if kind == "unchanged":
        mode = "pathtrace_frame" if "path" in workload else "hybrid_frame"
        real = getattr(engine_mod, mode)

        def frame(scene, tracer, cam, frame, accum, *a, **kw):
            res = real(scene, tracer, cam, frame, accum, *a, **kw)
            return (accum, res[1]) if mode == "pathtrace_frame" else (res[0], accum, *res[2:])
        monkeypatch.setattr(engine_mod, mode, frame)
    res = run_cell(resolve(workload, root=tiny_root), 2**32 + 9, 0.0, False, "cpu", log=_quiet)
    assert res["correct"] == (kind == "sound"), res["numbers"]
    assert "state_rel_l1" not in res["numbers"]


@pytest.mark.parametrize("kind", ["history_not_written", "current_view_proj",
                                  "one_iteration_fewer", "no_clamp", "first_pose"])
def test_denoiser_faults_are_not_correct(tiny_root, kind, monkeypatch):
    cell = resolve(CELL, root=tiny_root)
    _fault(monkeypatch, kind)
    res = run_cell(cell, 77, 0.0, False, "cpu", log=_quiet)
    assert not res["correct"], res["numbers"]


def test_orbit_control_is_not_correct(tiny_root):
    """The reference in bfloat16 in the program's place, from the same
    history, fails the cell's limits."""
    cell = resolve(CELL, root=tiny_root)
    inp = scenes.make("city", cell.config["scene"], "")
    engine = make_engine(cell, inp, "cpu")
    seed = 12345
    pose_at = poses(cell, seed)
    render = renderer(engine, pose_at)
    frames = []
    for _ in range(4):
        render()
        frames.append(engine.frame)
    _, pose, inputs = check_frame(engine, cell, seed, render, pose_at, frames[-1])
    want = check.Reference(cell, inp, "cpu", pose=pose).step(**inputs)
    got = check.Reference(cell, inp, "cpu", torch.bfloat16, pose=pose).step(**inputs)
    nums = check.step_numbers((got[0].float(), {k: v.float() for k, v in got[1].items()}), want)
    assert not check.judge(nums, cell.limits)[0], nums
    assert nums["diverged"] > 0.1 and nums["state_rel_l1"] > 0.05
