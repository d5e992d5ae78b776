"""The port's NRD/REBLUR packing (``vkrt_tpu_torch/ops/nrd.py``) against
``vkrt_tpu/ops/nrd.py`` on the same seeded numpy inputs: every function,
with the octahedron's z < 0 half, the zero vector, axis vectors, and
non-finite and out-of-range radiance and hit distances. Tolerance: equal,
or within 1e-6 (absolute; 1e-6 relative on the unbounded outputs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vkrt_tpu.ops.nrd as jnrd
import vkrt_tpu_torch.ops.nrd as tnrd

TOL = dict(rtol=1e-6, atol=1e-6)


def _both(fn, *args, **kw):
    """(JAX result, port result) of ``fn`` on numpy inputs, as numpy."""
    j = getattr(jnrd, fn)(*(jnp.asarray(a) for a in args), **kw)
    t = getattr(tnrd, fn)(*(torch.from_numpy(np.array(a)) for a in args), **kw)
    if isinstance(j, tuple):
        return [np.asarray(x) for x in j], [x.numpy() for x in t]
    return np.asarray(j), t.numpy()


def _vectors(n=4096):
    """Unit vectors of both z halves, unnormalized ones, the zero vector,
    the six axis vectors and sign-of-zero cases."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v[: n // 2] /= np.linalg.norm(v[: n // 2], axis=1, keepdims=True)
    v[n // 2: n // 2 + 256] *= 1e-3
    special = np.array([[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                        [0, 0, -1], [0.0, -0.0, -1], [-0.0, 0.0, 1], [1, 1, -1e-8],
                        [-1, 1, -1], [1, -1, -1]], np.float32)
    return np.concatenate([v, special])


@pytest.mark.parametrize("signed", [False, True])
def test_oct_encode_decode(signed):
    v = _vectors()
    assert (v[:, 2] < 0).sum() > 1000  # the z < 0 half is exercised
    j, t = _both("encode_unit_vector", v, signed=signed)
    np.testing.assert_allclose(t, j, **TOL)
    for normalize in (False, True):
        dj, dt = _both("decode_unit_vector", j, signed=signed, normalize=normalize)
        np.testing.assert_allclose(dt, dj, **TOL)
    # round trip of the unit vectors
    unit = v[:2048]
    back = tnrd.decode_unit_vector(tnrd.encode_unit_vector(torch.from_numpy(unit),
                                                           signed=signed), signed=signed)
    np.testing.assert_allclose(back.numpy(), unit, atol=1e-5)
    # the zero vector encodes to the octahedron's centre
    zero = tnrd.encode_unit_vector(torch.zeros(1, 3), signed=signed).numpy()
    np.testing.assert_array_equal(zero, np.zeros((1, 2)) if signed else np.full((1, 2), 0.5))


def test_pack_unpack_normal_and_roughness():
    v = _vectors()
    rng = np.random.default_rng(1)
    rough = rng.uniform(0, 1, len(v)).astype(np.float32)
    mat = rng.integers(-2, 8, len(v)).astype(np.float32)  # mat_id / 3 clamps to [0, 1]
    j, t = _both("pack_normal_and_roughness", v, rough, mat)
    np.testing.assert_allclose(t, j, **TOL)
    assert t[:, 3].min() == 0.0 and t[:, 3].max() == 1.0
    uj, ut = _both("unpack_normal_and_roughness", j)
    for a, b in zip(ut, uj):
        np.testing.assert_allclose(a, b, **TOL)


def test_ycocg_round_trip():
    rng = np.random.default_rng(2)
    c = rng.uniform(-1, 50, (4096, 3)).astype(np.float32)
    j, t = _both("linear_to_ycocg", c)
    np.testing.assert_allclose(t, j, **TOL)
    lj, lt = _both("ycocg_to_linear", j)
    np.testing.assert_allclose(lt, lj, **TOL)
    assert lt.min() >= 0.0  # negative channels clamp


@pytest.mark.parametrize("sanitize", [True, False])
def test_pack_radiance_and_norm_hit_dist(sanitize):
    rng = np.random.default_rng(3)
    n = 4096
    rad = rng.uniform(-2, 10, (n, 3)).astype(np.float32)
    hd = rng.uniform(-0.5, 1.5, n).astype(np.float32)
    rad[:8] = [[np.nan, 1, 1], [1, np.inf, 1], [1, 1, -np.inf], [1e6, 2, 3], [7e4, 7e4, 7e4],
               [0, 0, 0], [-1, -1, -1], [np.nan, np.nan, np.nan]]
    hd[:12] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-9, 5e-8, 1e-7, 2.0, -3.0, 1.0, 0.5]
    j, t = _both("pack_radiance_and_norm_hit_dist", rad, hd, sanitize=sanitize)
    np.testing.assert_allclose(t, j, equal_nan=not sanitize, **TOL)
    if sanitize:
        assert np.isfinite(t).all()
        np.testing.assert_array_equal(t[:3, :3], 0.0)  # a non-finite pixel packs as black
        np.testing.assert_array_equal(t[:3, 3], 0.0)   # as does a non-finite distance
        assert t[5, 3] == 1e-7 and t[6, 3] == 1e-7   # tiny distances lift to NRD_FP16_MIN
    uj, ut = _both("unpack_radiance_and_norm_hit_dist", j)
    np.testing.assert_allclose(ut, uj, equal_nan=not sanitize, **TOL)


def test_hit_distance_normalization():
    rng = np.random.default_rng(4)
    n = 4096
    view_z = rng.uniform(-500, 500, n).astype(np.float32)
    rough = rng.uniform(0, 1, n).astype(np.float32)
    hit = rng.uniform(-5, 400, n).astype(np.float32)
    j, t = _both("hit_distance_normalization", view_z, rough)
    np.testing.assert_allclose(t, j, **TOL)
    j, t = _both("norm_hit_dist", hit, view_z, rough)
    np.testing.assert_allclose(t, j, **TOL)
    assert t.min() == 0.0 and t.max() == 1.0
    assert tnrd.HIT_DIST_PARAMS == jnrd.HIT_DIST_PARAMS
    assert (tnrd.NRD_FP16_MIN, tnrd.NRD_FP16_MAX) == (jnrd.NRD_FP16_MIN, jnrd.NRD_FP16_MAX)
