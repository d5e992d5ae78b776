"""The port's alpha-tested transparency (``vkrt_tpu_torch/ops/alpha.py``)
against ``vkrt_tpu/ops/alpha.py`` and tests/test_alpha.py:

* the port's versions of the eight tests of tests/test_alpha.py (the
  opaque scene is not wrapped, the opacity modes, a fully transparent
  layer, two stacked layers, alpha 1 as opaque, the punch rate, a shadow
  through a MASK cutout, a frame that runs);
* ``opacity_at_hit`` on seeded hits, and ``AlphaTracer.closest`` / ``any``
  on stacked BLEND and MASK layers, against the JAX package given the same
  inner hits (``JaxTracer``): hits, triangle ids and punch decisions bit
  for bit, t, u and v within 1e-5, for N and 2N rays on N seeds (the
  tiling JAX can run) and for the arange fallback seed;
* a punched lane whose hit lies within its advance of its limit misses, as
  in the JAX package's tracers, with the port's own tracer too (to kernel
  A's contract a negative limit would be a first-hit-kills lane);
* the engine with ``alpha_test`` in path mode and in hybrid mode with AO off
  against the JAX package's frames (the display gate of
  tests/test_accuracy_oracle.py:83-88, rays within 0.1%); hybrid mode with
  AO on, which tiles 5N visibility lanes on N seeds: it runs in the port,
  with the repeats r >= 2 decorrelated by the wrapped uint32 product, where
  the JAX package raises OverflowError;
* the general loop seeds its tracer as the JAX loop does: the seeds handed
  to ``with_seed`` at every trace, bit for bit, at depth 2 and 4."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vkrt_tpu.scene as jscene
from test_torch_gbuffer import JaxTracer, port_cam, port_scene
from test_torch_hybrid_engine import SeededTracer
from test_torch_pathtracer import display_gate
from vkrt_tpu.models.hybrid import hybrid_frame as j_hybrid_frame
from vkrt_tpu.models.pathtracer import pathtrace_frame as j_pathtrace_frame
from vkrt_tpu.models.pathtracer import trace_pixels as j_trace_pixels
from vkrt_tpu.models.post import composite as j_composite
from vkrt_tpu.ops import alpha as jalpha
from vkrt_tpu.ops.rng import tea as j_tea
from vkrt_tpu.ops.trace import make_tracer as j_make_tracer
from vkrt_tpu.utils.camera import Camera as JCamera, pixel_coords as j_pixel_coords
from vkrt_tpu.utils.camera import tile_perm
from vkrt_tpu_torch.config import RenderSettings
from vkrt_tpu_torch.engine import Engine
from vkrt_tpu_torch.models.pathtracer import pathtrace_frame, trace_pixels
from vkrt_tpu_torch.ops import alpha as talpha
from vkrt_tpu_torch.ops.alpha import AlphaTracer, alpha_closest, opacity_at_hit, scene_has_alpha
from vkrt_tpu_torch.ops.rng import MASK32
from vkrt_tpu_torch.ops.trace import HitInfo, Tracer, make_tracer
from vkrt_tpu_torch.scene import make_cornell_box, scene_from_soup
from vkrt_tpu_torch.utils import gltf as gltf_mod
from vkrt_tpu_torch.utils.camera import Camera

torch.set_num_threads(2)
CLEAR = (1.0, 1.0, 1.0, 1.0)
LIGHT = dict(position=np.array([0, 0, 4.0], np.float32), color=np.ones(3, np.float32),
             intensity=50.0, type=0)


def _quad(z):
    return [((-2, -2, z), (2, -2, z), (2, 2, z)), ((-2, -2, z), (2, 2, z), (-2, 2, z))]


def _mat(alpha, mode=0, **kw):
    return gltf_mod.GltfMaterial(np.array([1, 1, 1, alpha], np.float32), metallic_factor=0.0,
                                 alpha_mode=mode, **kw)


def _two_quads(front_mat):
    """A front quad (material 1 = ``front_mat``) at z=1 and an opaque back
    quad (material 0) at z=0, both facing +z; rays shot from z=5 down -z."""
    return scene_from_soup(_quad(0) + _quad(1), [0, 0, 1, 1], [_mat(1.0), front_mat],
                           [gltf_mod.GltfLight(**LIGHT)], device="cpu")


def _rays(n=64, lo=-1.5, hi=1.5):
    orig = np.zeros((n, 3), np.float32)
    orig[:, 2] = 5.0
    orig[:, 0] = np.linspace(lo, hi, n)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = -1.0
    return torch.from_numpy(orig), torch.from_numpy(d)


def _jax_twin(ts):
    """The JAX package's scene with the port scene's arrays."""
    return jscene.SceneArrays(**{k: jnp.asarray(getattr(ts, k).float().numpy()
                                                if getattr(ts, k).dtype == torch.bfloat16
                                                else getattr(ts, k).numpy())
                                 for k in jscene.SceneArrays._fields})


def _u32(seed: torch.Tensor) -> np.ndarray:
    return seed.numpy().astype(np.int64).astype(np.uint32)


# --- the port's versions of tests/test_alpha.py ------------------------------


def test_opaque_scene_not_wrapped():
    box = make_cornell_box(device="cpu")
    assert not scene_has_alpha(box)
    tr = make_tracer(box, alpha=True)
    assert not hasattr(tr, "with_seed")  # wrapper skipped entirely


def test_opacity_modes():
    scene = _two_quads(_mat(0.25, mode=2))
    assert scene_has_alpha(scene)
    tri = torch.tensor([0, 2], dtype=torch.int32)  # back (opaque), front (blend .25)
    uv = torch.tensor([0.2, 0.2])
    np.testing.assert_allclose(opacity_at_hit(scene, tri, uv, uv).numpy(), [1.0, 0.25],
                               atol=1e-6)
    # MASK: alpha .25 under the default .5 cutoff -> opacity 0
    scene_m = _two_quads(_mat(0.25, mode=1))
    np.testing.assert_allclose(opacity_at_hit(scene_m, tri, uv, uv).numpy(), [1.0, 0.0],
                               atol=1e-6)


def test_fully_transparent_punches_to_back_quad():
    """alpha=0 BLEND front quad: every ray lands on the back quad with t
    measured from the ORIGINAL origin."""
    tr = make_tracer(_two_quads(_mat(0.0, mode=2)), alpha=True)
    assert hasattr(tr, "with_seed")
    orig, d = _rays()
    hi = tr.closest(orig, d, 1e-3, 100.0)
    assert bool(hi.hit.all())
    np.testing.assert_allclose(hi.t.numpy(), 5.0, atol=1e-3)
    assert bool((hi.tri < 2).all())  # back-quad triangles


def test_two_stacked_transparent_layers():
    """Two fully transparent BLEND quads (z=3, z=2) in front of an opaque
    wall (z=0): every ray punches both layers and lands on the wall at t=5
    (the advance is measured from the original origin, never twice)."""
    scene = scene_from_soup(_quad(0) + _quad(2) + _quad(3), [0, 0, 1, 1, 1, 1],
                            [_mat(1.0), _mat(0.0, mode=2)], [gltf_mod.GltfLight(**LIGHT)],
                            device="cpu")
    orig, d = _rays()
    hi = make_tracer(scene, alpha=True).closest(orig, d, 1e-3, 100.0)
    assert bool(hi.hit.all())
    np.testing.assert_allclose(hi.t.numpy(), 5.0, atol=1e-3)
    assert bool((hi.tri < 2).all())


def test_opaque_alpha_one_matches_unwrapped():
    """alpha=1 BLEND behaves exactly like an opaque trace (never punches)."""
    tr = make_tracer(_two_quads(_mat(1.0, mode=2)), alpha=True)
    assert isinstance(tr, AlphaTracer)
    orig, d = _rays()
    hi_a = tr.closest(orig, d, 1e-3, 100.0)
    hi_b = tr.inner.closest(orig, d, 1e-3, 100.0)
    assert torch.equal(hi_a.t, hi_b.t) and torch.equal(hi_a.tri, hi_b.tri)
    np.testing.assert_allclose(hi_a.t.numpy(), 4.0, atol=1e-3)  # front quad at z=1


def test_stochastic_punch_rate():
    """alpha=0.3 BLEND: ~30% of rays stop on the front quad, ~70% punch."""
    tr = make_tracer(_two_quads(_mat(0.3, mode=2)), alpha=True)
    n = 4096
    orig, d = _rays(n, -1.9, 1.9)
    seeds = (torch.arange(n, dtype=torch.int64) * 2654435761) & MASK32
    t = tr.with_seed(seeds).closest(orig, d, 1e-3, 100.0).t.numpy()
    stopped_front = np.isclose(t, 4.0, atol=1e-3)
    punched = np.isclose(t, 5.0, atol=1e-3)
    assert (stopped_front | punched).all()
    assert 0.25 < stopped_front.mean() < 0.35  # 3 sigma of Binomial(4096, .3) ~ 0.021


def _cutout_scene():
    """A MASK quad at z=1 whose texture's left half has alpha 0."""
    img = np.full((8, 8, 4), 255, np.uint8)
    img[:, :4, 3] = 0
    uvs = np.array([((0, 0), (1, 0), (1, 1)), ((0, 0), (1, 1), (0, 1))], np.float32)
    mat = _mat(1.0, mode=1, base_color_texture=0, alpha_cutoff=0.5)
    return scene_from_soup(_quad(1), [0, 0], [mat], [gltf_mod.GltfLight(**LIGHT)],
                           images=[gltf_mod.GltfImage(img, "cutout")], uvs=uvs, device="cpu")


def test_shadow_through_cutout():
    """Shadow rays punch the transparent half of a MASK cutout (the alpha
    texture sampled at the hit UV) deterministically."""
    tr = make_tracer(_cutout_scene(), alpha=True)
    n = 32
    orig = torch.zeros((n, 3))
    orig[:, 0] = torch.linspace(-1.8, 1.8, n)
    d = torch.zeros((n, 3))
    d[:, 2] = 1.0
    blocked = tr.any(orig, d, 1e-3, 10.0).numpy()
    x = orig[:, 0].numpy()
    assert not blocked[x < -0.2].any()
    assert blocked[x > 0.2].all()


def test_pathtrace_frame_runs_with_alpha():
    """pathtrace_frame over a scene with a transparent quad: finite radiance."""
    tr = make_tracer(_two_quads(_mat(0.5, mode=2)), alpha=True)
    w, h = 16, 12
    cam = Camera(eye=(0, 0, 5.0), center=(0, 0, 0), up=(0, 1, 0.0)).matrices(w, h, "cpu")
    accum, rays = pathtrace_frame(tr.scene, tr, cam, 0, torch.zeros((w * h, 3)), CLEAR,
                                  width=w, height=h, samples=1, depth=2)
    assert torch.isfinite(accum).all() and float(rays) > 0


# --- parity with the JAX package on the same inner hits ----------------------


def _layers():
    """An opaque wall at z=0 behind BLEND 0.5 (z=1), BLEND 0.7 (z=2) and
    MASK 0.3 under cutoff 0.5 (z=3, always punched)."""
    mats = [_mat(1.0), _mat(0.5, mode=2), _mat(0.7, mode=2), _mat(0.3, mode=1)]
    tris = _quad(0) + _quad(1) + _quad(2) + _quad(3)
    return scene_from_soup(tris, [0, 0, 1, 1, 2, 2, 3, 3], mats,
                           [gltf_mod.GltfLight(**LIGHT)], device="cpu")


def test_opacity_at_hit_matches_jax():
    rng = np.random.default_rng(2)
    for ts in (_layers(), _cutout_scene()):
        js = _jax_twin(ts)
        n = 512
        tri = rng.integers(0, int((ts.tri_mat >= 0).sum()), n).astype(np.int32)
        u = rng.uniform(0, 1, n).astype(np.float32)
        v = (rng.uniform(0, 1, n) * (1 - u)).astype(np.float32)
        want = np.asarray(jalpha.opacity_at_hit(js, jnp.asarray(tri), jnp.asarray(u),
                                                jnp.asarray(v)))
        got = opacity_at_hit(ts, *(torch.from_numpy(a) for a in (tri, u, v))).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got == 0, want == 0)


def _assert_hits(got, want):
    for name in ("hit", "tri"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for name in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_alpha_tracer_matches_jax_on_the_same_hits():
    ts = _layers()
    js = _jax_twin(ts)
    jt = j_make_tracer(js, "bruteforce")
    rng = np.random.default_rng(4)
    n = 384
    orig = np.zeros((n, 3), np.float32)
    orig[:, :2] = rng.uniform(-1.8, 1.8, (n, 2))
    orig[:, 2] = 5.0
    d = np.stack([rng.normal(0, 0.05, n), rng.normal(0, 0.05, n), -np.ones(n)], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    lim = np.where(rng.random(n) < 0.7, 100.0, rng.uniform(1.5, 4.5, n)).astype(np.float32)
    lim[::13] = 0.0  # a skipped query
    seeds = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    tseeds = torch.from_numpy(seeds.view(np.int32))  # the carry's int32 bits
    j_at = jalpha.AlphaTracer(js, jt)
    t_at = AlphaTracer(ts, JaxTracer(jt))
    o_t, d_t = torch.from_numpy(orig), torch.from_numpy(d)

    @jax.jit
    def j_closest(o, d_, lim_, seed):  # jitted: eager, every lax.cond is traced anew
        return j_at.with_seed(seed).closest(o, d_, 1e-3, 100.0, t_lim=lim_)

    # N rays, N seeds; then 2N rays (the fused pool) on N seeds, r <= 1
    want = j_closest(jnp.asarray(orig), jnp.asarray(d), jnp.asarray(lim), jnp.asarray(seeds))
    got = t_at.with_seed(tseeds).closest(o_t, d_t, 1e-3, 100.0, t_lim=torch.from_numpy(lim))
    _assert_hits(got, want)
    front = got.hit & (got.tri >= 2)  # stopped on a transparent layer
    assert 0.2 < float(front.float().mean()) < 0.8 and bool((got.tri[got.hit] < 2).any())
    o2, d2, l2 = (np.concatenate([a, a]) for a in (orig, d, lim))
    want = j_closest(jnp.asarray(o2), jnp.asarray(d2), jnp.asarray(l2), jnp.asarray(seeds))
    got = t_at.with_seed(tseeds).closest(*(torch.from_numpy(a) for a in (o2, d2)), 1e-3, 100.0,
                                         t_lim=torch.from_numpy(l2))
    _assert_hits(got, want)
    assert (got.hit[:n] != got.hit[n:]).any()  # the repeat draws its own punches
    # any (positive limits, a closest trace underneath) and the arange seed
    want_any = jax.jit(lambda o, d_, lim_, seed: j_at.with_seed(seed).any(o, d_, 1e-3, lim_))(
        jnp.asarray(orig), jnp.asarray(d), jnp.asarray(lim), jnp.asarray(seeds))
    np.testing.assert_array_equal(
        t_at.with_seed(tseeds).any(o_t, d_t, 1e-3, torch.from_numpy(lim)).numpy(),
        np.asarray(want_any))
    _assert_hits(t_at.closest(o_t, d_t, 1e-3, 100.0),
                 jax.jit(lambda o, d_: j_at.closest(o, d_, 1e-3, 100.0))(jnp.asarray(orig),
                                                                        jnp.asarray(d)))


def test_punched_lane_past_its_limit_misses():
    """A lane whose transparent hit lies within its advance of its limit
    (t = 100, limit 100.0005, advance 100.011) has no segment left: with an
    opaque quad 0.005 behind the advanced origin it still misses, in the
    JAX package's brute force, through ``JaxTracer`` and with the port's
    own tracer, whose contract reads a negative limit as a first-hit-kills
    lane."""
    scene = scene_from_soup(_quad(-95.016) + _quad(-95.0), [0, 0, 1, 1],
                            [_mat(1.0), _mat(0.0, mode=2)], [gltf_mod.GltfLight(**LIGHT)],
                            device="cpu")
    js = _jax_twin(scene)
    orig, d = _rays(8)
    lim = torch.full((8,), 100.0005)
    lim[4:] = 200.0  # these reach the opaque quad
    seeds = torch.arange(8)
    want = jax.jit(lambda o, d_, lim_: jalpha.alpha_closest(
        js, j_make_tracer(js, "bruteforce"), o, d_, 1e-3, 200.0, lim_,
        jnp.arange(8, dtype=jnp.uint32)))(*(jnp.asarray(a.numpy()) for a in (orig, d, lim)))
    for inner in (JaxTracer(j_make_tracer(js, "bruteforce")), Tracer(scene)):
        got = alpha_closest(scene, inner, orig, d, 1e-3, 200.0, lim, seeds)
        _assert_hits(got, want)
        assert not got.hit[:4].any() and got.hit[4:].all()
        np.testing.assert_allclose(got.t[4:].numpy(), 100.016, atol=1e-3)
        # the lane past its limit: t is the advance, as in the JAX package
        np.testing.assert_allclose(got.t[:4].numpy(), 100.0 * 1.0001 + 1e-3, rtol=1e-6)


# --- the engine against the JAX package --------------------------------------

W, H = 32, 24


def _alpha_box():
    """The Cornell box with the boxes' material BLEND at 0.5 and the red
    wall's MASK at 0.3 under cutoff 0.5 (always punched)."""
    js = jscene.make_cornell_box()
    mode = np.asarray(js.mat_alpha_mode).copy()
    base = np.asarray(js.mat_base_color).copy()
    mode[4], base[4, 3] = 2, 0.5
    mode[1], base[1, 3] = 1, 0.3
    js = js._replace(mat_alpha_mode=jnp.asarray(mode), mat_base_color=jnp.asarray(base))
    return js, port_scene(js)


def _jax_frames(js, settings, frames):
    """The JAX engine's frames, jitted as its engine runs them (eager, each
    ``lax.cond`` of the alpha rounds is traced anew at every call), on its
    alpha tracer over brute force: tile-ordered pixels seeded by their
    pixel ids, the composite, scanline order. Returns (image (N,3), rays)."""
    perm, inv = tile_perm(W, H)
    pix = jnp.take(j_pixel_coords(W, H), jnp.asarray(perm), axis=0)
    pid = jnp.asarray(perm.astype(np.uint32))
    jt = j_make_tracer(js, "auto", alpha=True)
    assert isinstance(jt, jalpha.AlphaTracer)
    cam = JCamera().matrices(W, H)
    rays = 0.0
    if settings.rt_mode == 1:
        step = jax.jit(lambda f, accum: j_pathtrace_frame(
            js, jt, cam, f, accum, jnp.asarray(CLEAR), width=W, height=H, samples=1,
            depth=settings.depth, corr=settings.corr_sampler, pix=pix,
            seeds=j_tea(pid, f.astype(jnp.uint32))))
        accum = jnp.zeros((W * H, 3), jnp.float32)
        for f in range(frames):
            accum, r = step(jnp.int32(f), accum)
            rays += float(r)
        out = j_composite(None, jnp.concatenate([accum, jnp.ones_like(accum[:, :1])], 1),
                          rt_mode=1, view_accumulated=False, use_gi=settings.use_gi)
    else:
        step = jax.jit(lambda f, accum: j_hybrid_frame(
            js, jt, cam, f, accum, jnp.asarray(CLEAR), width=W, height=H,
            depth=settings.depth, use_shadows=settings.use_shadows, use_ao=settings.use_ao,
            use_gi=settings.use_gi, use_denoiser=False, corr=settings.corr_sampler, pix=pix,
            seeds=j_tea(pid, f.astype(jnp.uint32)))[:3])
        accum = jnp.zeros((W * H, 4), jnp.float32)
        for f in range(frames):
            gbuf, accum, r = step(jnp.int32(f), accum)
            rays += float(r)
        out = j_composite(gbuf.color[:, :3], accum, rt_mode=0, view_accumulated=False,
                          use_gi=settings.use_gi)
    return np.asarray(out, np.float64)[inv], rays


@pytest.mark.parametrize("mode", ["path", "hybrid-no-ao"])
def test_engine_with_alpha_matches_jax(mode):
    js, ts = _alpha_box()
    settings = (RenderSettings(rt_mode=1, alpha_test=True) if mode == "path" else
                RenderSettings(rt_mode=0, use_ao=False, use_gi=True, alpha_test=True))
    want, rays_j = _jax_frames(js, settings, 2)
    eng = Engine(ts, W, H, settings, clear_color=CLEAR)
    assert isinstance(eng.tracer, AlphaTracer)
    for _ in range(2):
        got = eng.render_frame().numpy().astype(np.float64)
    assert np.isfinite(got).all()
    display_gate(got, want)
    assert abs(eng.total_rays - rays_j) <= 1e-3 * rays_j, (eng.total_rays, rays_j)
    # the same settings without alpha_test render another image
    plain = Engine(ts, W, H, dataclasses.replace(settings, alpha_test=False),
                   clear_color=CLEAR)
    for _ in range(2):
        other = plain.render_frame().numpy()
    assert np.abs(other - got).max() > 0.05


def test_hybrid_with_ao_runs_where_jax_overflows(monkeypatch):
    """Shadows + AO + GI: the visibility pool traces 5N lanes on N seeds.
    The JAX package's tiling raises for the repeats r >= 2
    (``seed ^ jnp.uint32(r * 0x9E3779B9)``); the port wraps the uint32
    product and renders."""
    js, ts = _alpha_box()
    jt = j_make_tracer(js, "auto", alpha=True)
    with pytest.raises(OverflowError):
        jt.with_seed(jnp.arange(4, dtype=jnp.uint32)).any(
            jnp.zeros((20, 3)), jnp.ones((20, 3)), 0.1, jnp.ones(20))
    eng = Engine(ts, W, H, RenderSettings(rt_mode=0, use_gi=True, alpha_test=True),
                 clear_color=CLEAR)
    for _ in range(2):
        out = eng.render_frame()
    assert torch.isfinite(out).all() and float(out.mean()) > 0.05
    assert (eng.accum_rt[:, 3] < 0.99).any()  # shadows and AO darken somewhere

    # the tiling itself: five repeats of the N seeds, repeat r XORed with
    # the uint32 product r * 0x9E3779B9 (r <= 1 as in the JAX package)
    n = 64
    seed = torch.from_numpy(np.random.default_rng(9).integers(0, 2 ** 32, n, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))
    seen = {}

    def record(scene, tracer, orig, direction, t_min, t_max, t_lim, seed, rounds):
        seen["seed"] = seed
        return _hit_info(orig.shape[0])

    monkeypatch.setattr(talpha, "alpha_closest", record)
    AlphaTracer(ts, None).with_seed(seed).any(torch.zeros((5 * n, 3)), torch.zeros((5 * n, 3)),
                                              0.1, torch.zeros(5 * n))
    u = _u32(seed)
    want = np.concatenate([u ^ np.uint32((r * 0x9E3779B9) & MASK32) for r in range(5)])
    np.testing.assert_array_equal(seen["seed"].numpy().astype(np.uint32), want)
    two = np.asarray(jnp.concatenate([jnp.asarray(u) ^ jnp.uint32(r * 0x9E3779B9)
                                      for r in range(2)]))
    np.testing.assert_array_equal(want[:2 * n], two)


def _hit_info(n):
    return HitInfo(hit=torch.zeros(n, dtype=torch.bool), t=torch.zeros(n),
                   tri=torch.full((n,), -1, dtype=torch.int32), u=torch.zeros(n),
                   v=torch.zeros(n))


@pytest.mark.parametrize("depth", [2, 4])
def test_general_loop_seeds_like_jax(depth):
    """Every trace of the general loop gets the seeds of the carry the JAX
    loop hands over at the same site: the start's closest trace, each fused
    2N closest trace and the last bounce's ``any``."""
    js = jscene.make_cornell_box()
    jt = j_make_tracer(js, "auto")
    jm = JCamera().matrices(W, H)
    jlog, log = [], []
    j_trace_pixels(js, SeededTracer(jt, jlog), jm, W, H, 1, jnp.asarray(CLEAR), samples=1,
                   depth=depth, corr=True)
    trace_pixels(port_scene(js), SeededTracer(JaxTracer(jt), log), port_cam(jm), W, H, 1,
                 CLEAR, samples=1, depth=depth, corr=True)
    assert [k for k, _ in log] == [k for k, _ in jlog]
    seeds = [(s, js_) for (k, s), (_, js_) in zip(log, jlog) if k == "seed"]
    assert len(seeds) == depth + 1  # the start, depth - 1 fused pools, the last any
    for s, js_ in seeds:
        np.testing.assert_array_equal(_u32(s), np.asarray(js_))
    assert not all(np.array_equal(_u32(a), _u32(b)) for (a, _), (b, _) in
                   zip(seeds, seeds[1:]))  # the seeds move on between bounces
