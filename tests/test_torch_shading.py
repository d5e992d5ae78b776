"""Port vs JAX package: ``utils/smath.py``, ``ops/sampling.py``,
``ops/brdf.py`` and ``models/shading.py`` on the same seeded inputs.

The shading cases run on the textured GLB of tests/test_textured_glb.py
(baseColor + normal map, TANGENT attributes), with a metallic-roughness
and an emissive texture added to its material so that every texture slot
is taken; the scene crosses over with ``scene_from_numpy``. Tolerances:
1e-6 (elementwise math) to 1e-5 (after a texture fetch and a TBN frame)
absolute-or-relative; ``sample_bsdf``'s lobe pick equal on every lane,
its seeds bit-equal, its floats within 1e-4 relative (1e-5 absolute)
on >= 99.9% of lanes (the GGX weight's tails amplify an ulp of the half
vector)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkrt_tpu.models.shading as jsh
import vkrt_tpu.ops.brdf as jbrdf
import vkrt_tpu.ops.sampling as jsmp
import vkrt_tpu.utils.smath as jsm
import vkrt_tpu_torch.models.shading as tsh
import vkrt_tpu_torch.ops.brdf as tbrdf
import vkrt_tpu_torch.ops.sampling as tsmp
import vkrt_tpu_torch.utils.smath as tsm
from test_textured_glb import _build_glb
from vkrt_tpu.scene import build_scene as j_build_scene
from vkrt_tpu.utils.gltf import parse_gltf as j_parse_gltf
from vkrt_tpu_torch.scene import scene_from_numpy, tex_slots_used

torch.set_num_threads(2)
N = 2048


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=1e-6):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got.astype(np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_smath_matches_jax():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(2, N, 3)).astype(np.float32)
    a4 = rng.normal(size=(N, 4)).astype(np.float32)
    t = rng.random((N, 1)).astype(np.float32)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
    _close(tsm.dot(ta, tb), jsm.dot(ja, jb))
    _close(tsm.dot(_t(a4), _t(a4), keepdims=True), jsm.dot(jnp.asarray(a4), jnp.asarray(a4),
                                                           keepdims=True))
    _close(tsm.length(ta), jsm.length(ja))
    _close(tsm.normalize(ta), jsm.normalize(ja))
    _close(tsm.cross(ta, tb), jsm.cross(ja, jb))
    _close(tsm.reflect(ta, tsm.normalize(tb)), jsm.reflect(ja, jsm.normalize(jb)))
    _close(tsm.mix(ta, tb, _t(t)), jsm.mix(ja, jb, jnp.asarray(t)))
    for name in ("transform_point", "transform_dir", "transform_normal"):
        _close(getattr(tsm, name)(_t(m), ta), getattr(jsm, name)(jnp.asarray(m), ja))
    _close(tsm.luminance(ta), jsm.luminance(ja))


def test_sampling_matches_jax():
    rng = np.random.default_rng(2)
    r1, r2 = rng.random((2, N)).astype(np.float32)
    x, y, z = (_unit(rng, N) for _ in range(3))
    alpha2 = rng.random(N).astype(np.float32) ** 4
    seed = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    _close(tsmp.hemisphere_from_uniforms(_t(r1), _t(r2), _t(x), _t(y), _t(z)),
           jsmp.hemisphere_from_uniforms(*map(jnp.asarray, (r1, r2, x, y, z))))
    for corr in (None, (r1, r2)):
        ts, td = tsmp.sampling_hemisphere(_t(seed), _t(x), _t(y), _t(z),
                                          uniforms=None if corr is None else tuple(map(_t, corr)))
        js, jd = jsmp.sampling_hemisphere(jnp.asarray(seed), *map(jnp.asarray, (x, y, z)),
                                          uniforms=None if corr is None
                                          else tuple(map(jnp.asarray, corr)))
        np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js))
        _close(td, jd)
        ts, th = tsmp.sampling_ndf_ggxtr(_t(seed), _t(alpha2),
                                         uniforms=None if corr is None else tuple(map(_t, corr)))
        js, jh = jsmp.sampling_ndf_ggxtr(jnp.asarray(seed), jnp.asarray(alpha2),
                                         uniforms=None if corr is None
                                         else tuple(map(jnp.asarray, corr)))
        np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js))
        _close(th, jh)
    _close(tsmp.ggxtr_half_from_uniforms(_t(r1), _t(r2), _t(alpha2)),
           jsmp.ggxtr_half_from_uniforms(*map(jnp.asarray, (r1, r2, alpha2))))
    n = _unit(rng, N)
    n[:8] = [[0, 0, 1], [0, 1, 0], [1, 0, 0], [0, 0, -1], [0.6, 0.8, 0], [-0.8, 0.6, 0],
             [0, 0.6, 0.8], [0.6, 0, -0.8]]
    for got, want in zip(tsmp.create_coordinate_system(_t(n)),
                         jsmp.create_coordinate_system(jnp.asarray(n))):
        _close(got, want)
    _close(tsmp.local_to_world(_t(x), _t(y), _t(z), _t(n)),
           jsmp.local_to_world(*map(jnp.asarray, (x, y, z, n))))


def test_brdf_matches_jax():
    rng = np.random.default_rng(3)
    n, v, l = (_unit(rng, N) for _ in range(3))
    v[:, 2] = np.abs(v[:, 2])
    h = (l + v) / np.linalg.norm(l + v, axis=1, keepdims=True)
    f0 = rng.random((N, 3)).astype(np.float32)
    base = rng.random((N, 3)).astype(np.float32)
    metal, rough, ratio = rng.random((3, N)).astype(np.float32)
    a = rough * rough
    J = lambda *xs: tuple(map(jnp.asarray, xs))  # noqa: E731
    T = lambda *xs: tuple(map(_t, xs))  # noqa: E731
    _close(tbrdf.ndf_ggxtr(*T(n, h, a)), jbrdf.ndf_ggxtr(*J(n, h, a)), 1e-5)
    _close(tbrdf.g_smith(*T(n, v, l, rough)), jbrdf.g_smith(*J(n, v, l, rough)))
    _close(tbrdf.f_schlick(*T(h, v, f0)), jbrdf.f_schlick(*J(h, v, f0)), 1e-5)
    _close(tbrdf.specular_brdf_cook_torrance(*T(n, h, v, l, f0, rough)),
           jbrdf.specular_brdf_cook_torrance(*J(n, h, v, l, f0, rough)), 1e-5)
    _close(tbrdf.specular_brdf_over_pdf_cook_torrance(*T(n, h, v, l, f0, rough, ratio)),
           jbrdf.specular_brdf_over_pdf_cook_torrance(*J(n, h, v, l, f0, rough, ratio)), 1e-4)
    _close(tbrdf.compute_pbr_brdf(*T(n, v, l, h, base, metal, rough)),
           jbrdf.compute_pbr_brdf(*J(n, v, l, h, base, metal, rough)), 1e-5)
    # the reference's quirks: the 1e-4 NDF stabiliser, zero below the
    # horizon, and a non-point light at zero BRDF
    up = np.array([[0, 0, 1.0]], np.float32)
    assert float(tbrdf.ndf_ggxtr(_t(up), _t(up), torch.tensor([0.0]))) == 0.0
    assert float(tbrdf.ndf_ggxtr(_t(up), _t(-up), torch.tensor([0.5]))) == 0.0
    lpos = rng.normal(size=(N, 3)).astype(np.float32) * 3
    lcol = rng.random((N, 3)).astype(np.float32)
    lint = rng.random(N).astype(np.float32) * 50
    ltype = rng.integers(0, 2, N).astype(np.int32)
    p = rng.normal(size=(N, 3)).astype(np.float32)
    got = tbrdf.direct_light(*T(lpos, lcol, lint, ltype, p, n, v, base, metal, rough))
    want = jbrdf.direct_light(*J(lpos, lcol, lint, ltype, p, n, v, base, metal, rough))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    assert (got[0][_t(ltype) == 1] == 0).all()


@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    """The textured GLB with every slot taken: the scene in both packages."""
    path = str(tmp_path_factory.mktemp("glb") / "tex.glb")
    _build_glb(path)
    doc = j_parse_gltf(path)
    mt = doc.materials[0]
    mt.metallic_roughness_texture = 1  # the normal ramp: G, B vary
    mt.metallic_factor = 0.7
    mt.emissive_texture = 0
    mt.emissive_factor = np.array([0.5, 0.3, 0.2], np.float32)
    js = j_build_scene(doc)
    ts = scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu")
    assert all(tex_slots_used(ts).values())
    return js, ts


def _hits(rng):
    tri = rng.integers(0, 2, N).astype(np.int32)
    u = rng.random(N).astype(np.float32)
    v = (rng.random(N) * (1 - u)).astype(np.float32)
    d = _unit(rng, N)
    d[:, 2] = -np.abs(d[:, 2]) - 0.2
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tri, u, v, d


SURF_FIELDS = tsh.SurfaceSample._fields


@pytest.mark.parametrize("mode", ["level0", "lod", "aniso"])
def test_surface_at_hit_matches_jax(glb, mode):
    js, ts = glb
    rng = np.random.default_rng(4)
    tri, u, v, d = _hits(rng)
    kw_j, kw_t = {}, {}
    if mode == "lod":
        lod = rng.uniform(0, 4, N).astype(np.float32)
        kw_j, kw_t = {"lod": jnp.asarray(lod)}, {"lod": _t(lod)}
    elif mode == "aniso":
        g = (rng.normal(size=(2, N, 2)) * 0.05).astype(np.float32)
        kw_j = {"uv_grads": (jnp.asarray(g[0]), jnp.asarray(g[1]))}
        kw_t = {"uv_grads": (_t(g[0]), _t(g[1]))}
    want = jsh.surface_at_hit(js, jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v),
                              jnp.asarray(d), **kw_j)
    got = tsh.surface_at_hit(ts, _t(tri), _t(u), _t(v), _t(d), **kw_t)
    for name in SURF_FIELDS:
        _close(getattr(got, name), getattr(want, name), 1e-5)
    # every slot shows: the texture varies the base colour, the mr map the
    # roughness, the emissive map the emission, the normal map the normal
    assert got.base_color.std(0).max() > 0.01 and got.roughness.std() > 0.01
    assert got.emissive.std(0).max() > 0.01
    assert (got.shading_normal - got.geo_normal).abs().max() > 0.05


@pytest.mark.parametrize("corr", [False, True])
def test_sample_bsdf_matches_jax(glb, corr):
    js, ts = glb
    rng = np.random.default_rng(5)
    tri, u, v, d = _hits(rng)
    seed = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    gate = rng.random(N) < 0.5
    cu = rng.random((N, 6)).astype(np.float32) if corr else None
    jsurf = jsh.surface_at_hit(js, jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v),
                               jnp.asarray(d))
    tsurf = tsh.surface_at_hit(ts, _t(tri), _t(u), _t(v), _t(d))
    want = jsh.sample_bsdf(js, jsurf, jnp.asarray(d), jnp.asarray(seed), jnp.asarray(gate),
                           corr=None if cu is None else jnp.asarray(cu))
    got = tsh.sample_bsdf(ts, tsurf, _t(d), _t(seed), _t(gate),
                          corr=None if cu is None else _t(cu))
    np.testing.assert_array_equal(got.is_specular.numpy(), np.asarray(want.is_specular))
    assert 0.05 < got.is_specular.float().mean() < 0.95
    np.testing.assert_array_equal(got.seed.numpy().view(np.uint32), np.asarray(want.seed))
    for name in ("next_dir", "weight", "emit_plus_nee", "shadow_dir", "light_dist"):
        a = getattr(got, name).numpy().astype(np.float64)
        b = np.asarray(getattr(want, name), np.float64)
        ok = np.isclose(a, b, rtol=1e-4, atol=1e-5) | (np.isnan(a) & np.isnan(b))
        assert ok.reshape(N, -1).all(1).mean() >= 0.999, (name, ok.mean())
    assert tsh.clamp_bounds(True) == (0.0, 50.0)
    np.testing.assert_array_equal(np.asarray(jsh.clamp_bounds(False)),
                                  np.asarray(tsh.clamp_bounds(False), np.float32))
