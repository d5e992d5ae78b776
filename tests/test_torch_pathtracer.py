"""The port's slice end to end against the JAX package: a 64x48 Cornell box,
depth 3, 3 frames, tile-ordered pixels seeded by their original pixel id
(the engine's layout), correlated sampler on and off. The JAX leg is the
production path: the Pallas trace kernel and the packed shade kernel in
interpret mode. Gate: the display-domain gate of
tests/test_accuracy_oracle.py (p99 <= 1e-3, diverged (> 1e-2) < 1%, RMSE
<= 1e-3 on the rest); total rays within 0.1%. Plus Engine and app smoke."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vkrt_tpu.ops.pallas.shade as jshade
import vkrt_tpu.scene as jscene
from vkrt_tpu.models.pathtracer import pathtrace_frame as j_pathtrace_frame
from vkrt_tpu.models.post import tonemap as j_tonemap
from vkrt_tpu.ops.pallas.trace import make_pallas_tracer
from vkrt_tpu.ops.rng import tea as j_tea
from vkrt_tpu.utils.camera import Camera as JCamera, pixel_coords as j_pixel_coords
from vkrt_tpu.utils.camera import tile_perm
from vkrt_tpu_torch.models.pathtracer import pathtrace_frame
from vkrt_tpu_torch.models.post import tonemap
from vkrt_tpu_torch.ops.rng import tea
from vkrt_tpu_torch.ops.trace import make_tracer
from vkrt_tpu_torch.scene import scene_from_numpy
from vkrt_tpu_torch.utils.camera import camera_from_numpy

torch.set_num_threads(2)
W, H, FRAMES, DEPTH = 64, 48, 3, 3
CLEAR = (1.0, 1.0, 1.0, 1.0)


def display_gate(img_a: np.ndarray, img_b: np.ndarray):
    """tests/test_accuracy_oracle.py:83-88 on displayed (gamma, [0,1])
    images."""
    da = np.clip(img_a, 0, None) ** (1.0 / 2.2)
    db = np.clip(img_b, 0, None) ** (1.0 / 2.2)
    da, db = np.clip(da, 0, 1), np.clip(db, 0, 1)
    err = np.abs(da - db).max(-1)
    assert np.percentile(err, 99) <= 1e-3, np.percentile(err, 99)
    diverged = err > 1e-2
    assert diverged.mean() < 0.01, diverged.mean()
    rmse = float(np.sqrt(np.mean((da - db)[~diverged] ** 2)))
    assert rmse <= 1e-3, rmse
    return err


@pytest.fixture(scope="module")
def jit_shade_call():
    """Run the JAX leg's shade launches jitted. Called eagerly, an
    interpret-mode pallas_call is traced and compiled anew at every launch
    (about 2 s each on a CPU, 18 launches here); jitted, each static variant
    compiles once. The kernel and its arithmetic are the same."""
    static = ("d", "first", "resolve_hd", "n_mats", "n_lights", "hitdist_weight",
              "hitdist_accumulate", "t_min", "t_max", "interpret", "corr")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jshade, "shade_call",
                   jax.jit(jshade.shade_call, static_argnames=static))
        yield


def _render_jax(js, corr):
    perm, _ = tile_perm(W, H)
    pix = jnp.take(j_pixel_coords(W, H), jnp.asarray(perm), axis=0)
    pid = jnp.asarray(perm.astype(np.uint32))
    pt = make_pallas_tracer(js, interpret=True)
    cam = JCamera().matrices(W, H)

    def frame(f, accum):
        return j_pathtrace_frame(js, pt, cam, f, accum, jnp.asarray(CLEAR),
                                 width=W, height=H, samples=1, depth=DEPTH,
                                 corr=corr, pix=pix, seeds=j_tea(pid, f))

    # eager: the trace and shade launches are jitted on their own and compile
    # once for all frames (the traces for both sampler settings too); a jit
    # of the whole frame costs minutes of interpret-mode compile per setting
    accum = jnp.zeros((W * H, 3), jnp.float32)
    rays = 0.0
    for f in range(FRAMES):
        accum, r = frame(f, accum)
        rays += float(r)
    return np.asarray(accum, np.float64), rays, cam


def _render_port(ts, cam, corr):
    perm, _ = tile_perm(W, H)
    pix = torch.from_numpy(np.asarray(j_pixel_coords(W, H))[perm])
    pid = torch.from_numpy(perm.astype(np.int64))
    tracer = make_tracer(ts)
    accum = torch.zeros((W * H, 3))
    rays = 0.0
    for f in range(FRAMES):
        accum, r = pathtrace_frame(ts, tracer, cam, f, accum, CLEAR,
                                   width=W, height=H, samples=1, depth=DEPTH,
                                   corr=corr, pix=pix, seeds=tea(pid, f))
        rays += float(r)
    return accum.numpy().astype(np.float64), rays


@pytest.mark.parametrize("corr", [True, False])
def test_frames_match_jax(jit_shade_call, corr):
    js = jscene.make_cornell_box()
    ts = scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu")
    img_j, rays_j, jcam = _render_jax(js, corr)
    cam = camera_from_numpy({k: np.asarray(v) for k, v in jcam._asdict().items()})
    img_t, rays_t = _render_port(ts, cam, corr)
    assert np.isfinite(img_t).all()
    assert abs(rays_t - rays_j) <= 1e-3 * rays_j, (rays_t, rays_j)
    display_gate(img_t, img_j)
    disp = np.clip(tonemap(torch.from_numpy(img_t)).numpy(), 0, 1)
    assert disp.mean() > 0.05
    np.testing.assert_allclose(
        tonemap(torch.from_numpy(img_t)).numpy(),
        np.asarray(j_tonemap(jnp.asarray(img_t))), rtol=1e-5, atol=1e-6,
    )


def test_engine_and_app_smoke(tmp_path):
    from vkrt_tpu.config import RenderSettings
    from vkrt_tpu.utils.png import decode_png
    from vkrt_tpu_torch import app
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.scene import make_cornell_box

    eng = Engine(make_cornell_box(device="cpu"), 32, 24, RenderSettings(rt_mode=1, depth=2))
    img = eng.render(2)
    assert img.shape == (24, 32, 3) and img.dtype == np.uint8 and img.mean() > 10
    assert eng.frame == 1 and eng.total_rays > 32 * 24 * 2
    # a camera change resets accumulation; a settings change does too
    eng.camera = eng.camera.__class__(eye=(0.0, 1.0, 14.0))
    eng.render_frame()
    assert eng.frame == 0
    eng.update_settings(eng.settings.replace(depth=3))
    assert eng.frame == -1
    # hybrid mode is the default (tests/test_torch_hybrid_engine.py holds it
    # to the JAX package)
    hybrid = Engine(make_cornell_box(device="cpu"), 32, 24)
    assert hybrid.settings.rt_mode == 0 and hybrid.render(1).mean() > 10

    out = tmp_path / "pt.png"
    rc = app.main(["--procedural", "cornell", "--mode", "path", "--width", "32",
                   "--height", "24", "--frames", "2", "--device", "cpu",
                   "--out", str(out)])
    assert rc == 0
    png = decode_png(out.read_bytes())
    assert png.shape[:2] == (24, 32) and png[..., :3].mean() > 10
    rc = app.main(["--procedural", "cornell", "--mode", "hybrid", "--width", "32",
                   "--height", "24", "--device", "cpu", "--out", str(out)])
    assert rc == 0 and decode_png(out.read_bytes())[..., :3].mean() > 10
    if not torch.cuda.is_available():  # no silent fall back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            app.main(["--procedural", "cornell", "--out", str(out)])
