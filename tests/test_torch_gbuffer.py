"""The port's G-buffer pass (``vkrt_tpu_torch/models/gbuffer.py``) against
``vkrt_tpu/models/gbuffer.py`` at 64x48 on three scenes: the Cornell box,
``make_city(grid=4)`` and the textured GLB of tests/test_textured_glb.py
(seen at a slant, so the footprints are anisotropic) under the default 4x
anisotropic branch and under ``VKRT_ANISO=0``. The JAX leg runs eagerly on
its brute-force tracer.

* Given the same hits (``JaxTracer``: the JAX tracer behind the port's
  tracer contract), the hit/miss mask is exact, misses hold the clear
  colour and exact zeros, and every field is within 1e-5 (absolute, or
  relative above 1).
* With the port's own tracer the mask is exact too, and the fields are
  within 1e-5 on every pixel whose ray both tracers give the same
  triangle; the others (rays through a shared edge, where the last ulp
  decides) stay under 1% of the frame.
* ``direct_lighting`` on seeded random surface points, with every second
  light made directional (the reference's L = normalize(position) quirk).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vkrt_tpu.scene as jscene
from test_textured_glb import _build_glb
from vkrt_tpu.models.gbuffer import direct_lighting as j_direct_lighting
from vkrt_tpu.models.gbuffer import gbuffer_pass as j_gbuffer_pass
from vkrt_tpu.ops.trace import make_tracer as j_make_tracer
from vkrt_tpu.utils.camera import Camera as JCamera, generate_rays as j_generate_rays
from vkrt_tpu.utils.camera import orbit_camera as j_orbit_camera
from vkrt_tpu_torch.models.gbuffer import GBuffer, direct_lighting, gbuffer_pass
from vkrt_tpu_torch.ops.intersect import T_MAX, T_MIN
from vkrt_tpu_torch.ops.trace import HitInfo, RayHits, make_tracer
from vkrt_tpu_torch.scene import scene_from_numpy
from vkrt_tpu_torch.utils.camera import camera_from_numpy, generate_rays

torch.set_num_threads(2)
W, H = 64, 48
CLEAR = (0.2, 0.3, 0.4, 1.0)
FIELD_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x) -> np.ndarray:
    return np.array(x)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


class JaxTracer:
    """The port's tracer contract (``closest``, ``any``, ``trace_block``)
    answered by a JAX tracer, so that a module of each package sees the same
    hits. A negative limit bounds the trace by its magnitude, as kernel A's
    first-hit-kills lanes do (a zero limit never hits)."""

    anyhit_kill_capable = True

    def __init__(self, jtracer):
        self.jt = jtracer

    def closest(self, orig, direction, t_min, t_max, t_lim=None) -> HitInfo:
        lim = t_max if t_lim is None else jnp.asarray(t_lim.abs().numpy())
        h = self.jt.closest(jnp.asarray(orig.numpy()), jnp.asarray(direction.numpy()),
                            t_min, lim)
        return HitInfo(*(_t(x) for x in h))

    def any(self, orig, direction, t_min, t_max) -> torch.Tensor:
        lim = jnp.asarray(torch.as_tensor(t_max).abs().numpy())
        return _t(self.jt.any(jnp.asarray(orig.numpy()), jnp.asarray(direction.numpy()),
                              t_min, lim))

    def trace_block(self, rays, t_min) -> RayHits:
        lim = rays[6]
        h = self.closest(rays[0:3].T.contiguous(), rays[3:6].T.contiguous(), t_min, None,
                         t_lim=lim)
        return RayHits(torch.where(h.hit, h.t, lim.abs()), h.tri, h.u, h.v)


def port_scene(js):
    return scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu")


def port_cam(jm):
    return camera_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """name -> (JAX scene, JAX Camera)."""
    path = str(tmp_path_factory.mktemp("glb") / "tex.glb")
    _build_glb(path)
    return {
        "cornell": (jscene.make_cornell_box(), JCamera()),
        "city": (jscene.make_city(grid=4), j_orbit_camera(0.12, radius=14.0, height=5.0)),
        "glb": (jscene.load_scene(path), JCamera(eye=(3.0, 1.0, 3.5), center=(0.0, 0.0, 0.0))),
    }


def _miss(g) -> np.ndarray:
    """The hybrid pass's background test: position and normal exactly 0."""
    pos, nrm = _np(g.position[:, :3]), _np(g.normal[:, :3])
    return (pos == 0.0).all(-1) & (nrm == 0.0).all(-1)


def _assert_fields(tg: GBuffer, jg, rows=slice(None)):
    for f in GBuffer._fields:
        np.testing.assert_allclose(_np(getattr(tg, f))[rows], _np(getattr(jg, f))[rows],
                                   err_msg=f, **FIELD_TOL)


@pytest.mark.parametrize("case", ["cornell", "city", "glb-aniso", "glb-iso"])
def test_gbuffer_pass_matches_jax(scenes, case, monkeypatch):
    js, jcamera = scenes[case.split("-")[0]]
    if case == "glb-iso":
        monkeypatch.setenv("VKRT_ANISO", "0")  # read by both packages' passes
    jm = jcamera.matrices(W, H)
    jt = j_make_tracer(js, "auto")
    jg = j_gbuffer_pass(js, jt, jm, W, H, jnp.asarray(CLEAR))
    ts, cam = port_scene(js), port_cam(jm)
    miss = _miss(jg)
    assert 0.05 < miss.mean() < 0.95 or case == "cornell"

    # the same hits: every field
    tg = gbuffer_pass(ts, JaxTracer(jt), cam, W, H, CLEAR)
    np.testing.assert_array_equal(_miss(tg), miss)
    _assert_fields(tg, jg)
    np.testing.assert_array_equal(_np(tg.color[miss, :3]), np.tile(CLEAR[:3], (miss.sum(), 1))
                                  .astype(np.float32))
    for f in ("rough_metal", "view_z", "norm_rough", "motion"):
        assert not _np(getattr(tg, f))[miss].any(), f
    if case.startswith("glb"):  # the checker shows through the filtered fetch
        lit = _np(tg.color[~miss, :3])
        assert (lit[:, 0] > 1.5 * lit[:, 1]).any() and (lit[:, 1] > 1.5 * lit[:, 0]).any()

    # the port's own tracer: the mask exact, the fields wherever the
    # triangle is the same
    og = gbuffer_pass(ts, make_tracer(ts), cam, W, H, CLEAR)
    np.testing.assert_array_equal(_miss(og), miss)
    o, d = generate_rays(cam, W, H, torch.full((W * H, 2), 0.5))
    tri = make_tracer(ts).closest(o, d, T_MIN, T_MAX).tri.numpy()
    jo, jd = j_generate_rays(jm, W, H, jnp.full((W * H, 2), 0.5))
    same = tri == _np(jt.closest(jo, jd, T_MIN, T_MAX).tri)
    assert same.mean() > 0.99, same.mean()
    _assert_fields(og, jg, same)


@pytest.mark.parametrize("name", ["cornell", "city", "glb"])
def test_direct_lighting_matches_jax(scenes, name):
    js = scenes[name][0]
    n_l = int(js.num_lights)
    js = js._replace(light_type=jnp.asarray(np.arange(n_l) % 2, jnp.int32))  # 1: directional
    rng = np.random.default_rng(7)
    n = 4096
    lo, hi = np.asarray(js.tri_v0).min(0), np.asarray(js.tri_v0).max(0)
    p = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    base = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    metal = rng.uniform(0, 1, n).astype(np.float32)
    rough = rng.uniform(0.05, 1, n).astype(np.float32)
    args = (p, nrm, v, base, metal, rough)
    want = _np(j_direct_lighting(js, *(jnp.asarray(a) for a in args)))
    got = direct_lighting(port_scene(js), *(torch.from_numpy(a) for a in args)).numpy()
    assert (want > 0).any(-1).mean() > 0.2
    np.testing.assert_allclose(got, want, **FIELD_TOL)
