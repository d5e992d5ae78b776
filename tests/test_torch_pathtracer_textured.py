"""The port's textured path tracing end to end against the JAX package.

Two scenes, tile-ordered pixels seeded by their original pixel id (the
engine's layout), depth 3, 3 frames, correlated sampler on and off:

* ``make_city(grid=4)`` at 64x48, a baseColor-only scene: the port's packed
  loop with kernel B's albedo branch (its plain version here) against the
  JAX production path, the Pallas trace kernel and the packed shade kernel
  in interpret mode, fed ``xla_albedo_block``;
* the textured GLB of tests/test_textured_glb.py (baseColor + normal map)
  at 48x36: the port's general loop against the JAX package's XLA path
  (``make_tracer(js, "auto")``, brute force on the CPU), at depth 9 too.

Gate: the display-domain gate of tests/test_accuracy_oracle.py (p99 <=
1e-3, diverged (> 1e-2) < 1%, RMSE <= 1e-3 on the rest); total rays within
0.1%. Plus Engine and app smoke on the city, ``orbit_camera``,
``load_obj_scene`` and ``alpha_test`` on an opaque scene (no wrapper, the
same frames)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vkrt_tpu.scene as jscene
from test_textured_glb import _build_glb
from test_torch_pathtracer import display_gate, jit_shade_call  # noqa: F401 (fixture)
from vkrt_tpu.models.pathtracer import pathtrace_frame as j_pathtrace_frame
from vkrt_tpu.ops.pallas.trace import make_pallas_tracer
from vkrt_tpu.ops.rng import tea as j_tea
from vkrt_tpu.ops.trace import make_tracer as j_make_tracer
from vkrt_tpu.utils.camera import Camera as JCamera, orbit_camera as j_orbit_camera
from vkrt_tpu.utils.camera import pixel_coords as j_pixel_coords, tile_perm
from vkrt_tpu_torch.models.pathtracer import pathtrace_frame
from vkrt_tpu_torch.ops.cuda.shade import kernel_shading_available
from vkrt_tpu_torch.ops.rng import tea
from vkrt_tpu_torch.ops.trace import make_tracer
from vkrt_tpu_torch.scene import scene_from_numpy
from vkrt_tpu_torch.utils.camera import camera_from_numpy, orbit_camera

torch.set_num_threads(2)
FRAMES, DEPTH = 3, 3
CLEAR = (1.0, 1.0, 1.0, 1.0)
CITY_CAM = dict(t=0.12, radius=14.0, height=5.0)


def _render_jax(js, tracer, jcam, w, h, corr, depth=DEPTH):
    perm, _ = tile_perm(w, h)
    pix = jnp.take(j_pixel_coords(w, h), jnp.asarray(perm), axis=0)
    pid = jnp.asarray(perm.astype(np.uint32))
    cam = jcam.matrices(w, h)
    accum = jnp.zeros((w * h, 3), jnp.float32)
    rays = 0.0
    for f in range(FRAMES):
        accum, r = j_pathtrace_frame(js, tracer, cam, f, accum, jnp.asarray(CLEAR),
                                     width=w, height=h, samples=1, depth=depth,
                                     corr=corr, pix=pix, seeds=j_tea(pid, f))
        rays += float(r)
    return np.asarray(accum, np.float64), rays, cam


def _render_port(ts, cam, w, h, corr, depth=DEPTH):
    perm, _ = tile_perm(w, h)
    pix = torch.from_numpy(np.asarray(j_pixel_coords(w, h))[perm])
    pid = torch.from_numpy(perm.astype(np.int64))
    tracer = make_tracer(ts)
    accum = torch.zeros((w * h, 3))
    rays = 0.0
    for f in range(FRAMES):
        accum, r = pathtrace_frame(ts, tracer, cam, f, accum, CLEAR, width=w, height=h,
                                   samples=1, depth=depth, corr=corr, pix=pix,
                                   seeds=tea(pid, f))
        rays += float(r)
    return accum.numpy().astype(np.float64), rays


def _compare(js, jtracer, jcam, w, h, corr, packed: bool, depth=DEPTH):
    ts = scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu")
    assert kernel_shading_available(ts) == packed
    img_j, rays_j, jm = _render_jax(js, jtracer, jcam, w, h, corr, depth)
    cam = camera_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})
    img_t, rays_t = _render_port(ts, cam, w, h, corr, depth)
    assert np.isfinite(img_t).all()
    assert abs(rays_t - rays_j) <= 1e-3 * rays_j, (rays_t, rays_j)
    display_gate(img_t, img_j)
    assert np.clip(img_t, 0, 1).mean() > 0.05
    return img_t


@pytest.mark.parametrize("corr", [True, False])
def test_city_matches_jax(jit_shade_call, corr):
    js = jscene.make_city(grid=4)
    jcam = j_orbit_camera(CITY_CAM["t"], radius=CITY_CAM["radius"], height=CITY_CAM["height"])
    _compare(js, make_pallas_tracer(js, interpret=True), jcam, 64, 48, corr, packed=True)


@pytest.fixture(scope="module")
def glb_scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("glb") / "tex.glb")
    _build_glb(path)
    return path, jscene.load_scene(path)


@pytest.mark.parametrize("corr,depth", [(True, DEPTH), (False, DEPTH), (True, 9)])
def test_textured_glb_matches_jax(glb_scene, corr, depth):
    """Depth 9 takes the JAX loop's deep-bounce form (a fori loop that traces
    the fused pool on the last bounce too and takes its main rays off the
    count again): the port's unrolled loop counts the same rays."""
    _, js = glb_scene
    jcam = JCamera(eye=(0.0, 0.0, 6.0), center=(0.0, 0.0, 0.0))
    img = _compare(js, j_make_tracer(js, "auto"), jcam, 48, 36, corr, packed=False,
                   depth=depth)
    # the checker's two colours show: red and green each lead somewhere
    lit = img[img.sum(1) > 0.05]
    assert (lit[:, 0] > 1.5 * lit[:, 1]).any() and (lit[:, 1] > 1.5 * lit[:, 0]).any()


def test_engine_app_and_entry_points_on_the_city(tmp_path, glb_scene):
    from vkrt_tpu.utils import obj as jobj
    from vkrt_tpu.utils.png import decode_png
    from vkrt_tpu_torch import app
    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.scene import load_scene, make_city
    from vkrt_tpu_torch.utils import obj as tobj

    # orbit_camera is the JAX package's
    for t, kw in ((0.12, dict(radius=300, height=48)), (0.7, dict(center=(1.0, 2.0, 3.0)))):
        a, b = orbit_camera(t, **kw), j_orbit_camera(t, **kw)
        assert np.allclose(a.eye, b.eye, rtol=0, atol=1e-12) and a.center == tuple(b.center)

    city = make_city(grid=4, device="cpu")
    cam = orbit_camera(**CITY_CAM)
    eng = Engine(city, 32, 24, RenderSettings(rt_mode=1, depth=4), cam)
    img = eng.render(2)
    assert img.shape == (24, 32, 3) and img.mean() > 10 and eng.total_rays > 32 * 24 * 2
    glb = Engine(load_scene(glb_scene[0], device="cpu"), 32, 24,
                 RenderSettings(rt_mode=1, depth=2), cam.__class__(eye=(0.0, 0.0, 6.0)))
    assert glb.render(1).mean() > 10
    # alpha test, at construction and on a settings change: the city is
    # opaque, so it keeps its plain tracer and renders the same frames
    alpha = Engine(city, 32, 24, RenderSettings(rt_mode=1, depth=4, alpha_test=True), cam)
    assert not hasattr(alpha.tracer, "with_seed")
    assert np.array_equal(alpha.render(2), img)
    eng.update_settings(eng.settings.replace(alpha_test=True))
    assert not hasattr(eng.tracer, "with_seed") and eng.frame == -1

    out = tmp_path / "city.png"
    rc = app.main(["--procedural", "city", "--city-grid", "2", "--width", "32", "--height",
                   "24", "--depth", "4", "--frames", "1", "--device", "cpu", "--eye", "0",
                   "6", "12", "--out", str(out)])
    assert rc == 0 and decode_png(out.read_bytes())[..., :3].mean() > 10

    # load_obj_scene: the JAX package's arrays, on the requested device
    (tmp_path / "test.mtl").write_text("newmtl red\nKd 1 0 0\nNs 50\nnewmtl blue\n"
                                       "Kd 0 0 1\nKe 0.5 0.5 0.5\nd 0.5\nillum 4\n")
    (tmp_path / "scene.obj").write_text(
        "mtllib test.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvn 0 0 1\nvt 0 0\nvt 1 0\n"
        "vt 0 1\nusemtl red\nf 1/1/1 2/2/1 3/3/1\nusemtl blue\nf -3/-3/-1 -2/-2/-1 -1/-1/-1\n"
        "f 1 2 4 3\n")
    path = str(tmp_path / "scene.obj")
    js, ts = jobj.load_obj_scene(path), tobj.load_obj_scene(path, device="cpu")
    for k in js._fields:
        a, b = getattr(ts, k), np.asarray(getattr(js, k))
        np.testing.assert_array_equal(a.float().numpy() if a.dtype == torch.bfloat16
                                      else a.numpy(), b.astype(np.float32)
                                      if b.dtype.name == "bfloat16" else b, err_msg=k)
    assert ts.num_tris % 64 == 0 and ts.num_lights == 8
    assert tobj.parse_obj(path).materials[1].alpha_mode == 2
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tobj.load_obj_scene(path)
