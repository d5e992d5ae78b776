"""The port's ray sorting (``vkrt_tpu_torch/ops/sort_rays.py``) against
``vkrt_tpu/ops/sort_rays.py`` and the sorting cases of
tests/test_pallas_trace.py.

* ``ray_sort_keys`` bit for bit against the JAX package's (its uint32 keys)
  on rays in and around the Cornell box, with and without dead lanes;
  dead lanes sort to the tail; keys group by octant and cell;
* ``SortingTracer`` over brute force equal to brute force bit for bit (t,
  tri, u, v as uint32, the verdicts) for ``closest`` (with and without
  per-lane limits, dead lanes included) and ``any``;
* the same rays through the JAX package's ``SortingTracer`` over its brute
  force: the sorted keys equal (the order within equal keys is free: the
  trace is per ray), verdicts equal, t within 1e-5 relative (XLA's CPU
  arithmetic contracts some products; see tests/test_torch_probes.py),
  and the triangles equal but on at most 0.5% of the hits, where the
  box's coplanar faces meet at a t equal within that tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkrt_tpu.ops.sort_rays as jsort
import vkrt_tpu.scene as jscene
from vkrt_tpu.ops.trace import make_tracer as j_make_tracer
from vkrt_tpu_torch.ops.sort_rays import (
    DEAD_KEY, SortingTracer, make_sorting_tracer, ray_sort_keys,
)
from vkrt_tpu_torch.ops.trace import make_tracer
from vkrt_tpu_torch.scene import scene_from_numpy

torch.set_num_threads(2)
T_MIN, T_MAX = 1e-3, 1e4


@pytest.fixture(scope="module")
def box():
    js = jscene.make_cornell_box()
    return js, scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                                device="cpu")


def _rays(n, seed):
    """Origins in and around the box (beyond its bounds too, where the key
    clamps), random directions, some with a zero component."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8.0, 8.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d[rng.random((n, 3)) < 0.05] = 0.0
    d[:, 2] += 1e-3 * (np.abs(d).sum(1) == 0)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def _lim(n, seed):
    """Per-lane limits: closest lanes, dead lanes (-1) and zero limits."""
    rng = np.random.default_rng(seed)
    lim = np.full(n, T_MAX, np.float32)
    lane = rng.integers(0, 4, n)
    lim[lane == 1] = -1.0
    lim[lane == 2] = rng.uniform(0.5, 6.0, (lane == 2).sum())
    lim[lane == 3] = 0.0
    return torch.from_numpy(lim)


def _bits(x) -> np.ndarray:
    x = x.numpy()
    return x.view(np.uint32) if x.itemsize == 4 else x


@pytest.mark.parametrize("dead", [False, True])
def test_keys_match_jax(box, dead):
    js, ts = box
    o, d = _rays(4096, 1)
    st = make_sorting_tracer(None, ts)
    jst = jsort.make_sorting_tracer(None, js)
    np.testing.assert_array_equal(_bits(st.lo), np.asarray(jst.lo).view(np.uint32))
    np.testing.assert_array_equal(_bits(st.hi), np.asarray(jst.hi).view(np.uint32))
    mask = (_lim(4096, 2) < 0) if dead else None
    got = ray_sort_keys(o, d, st.lo, st.hi, dead=mask)
    want = jsort.ray_sort_keys(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jst.lo, jst.hi,
                               dead=None if mask is None else jnp.asarray(mask.numpy()))
    assert got.dtype == torch.int64 and int(got.min()) >= 0 and int(got.max()) <= DEAD_KEY
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))
    if dead:
        assert (got[mask] == DEAD_KEY).all() and (got[~mask] < 1 << 24).all()


def test_dead_lanes_sort_to_the_tail(box):
    _, ts = box
    o, d = _rays(1024, 3)
    lim = _lim(1024, 4)
    st = make_sorting_tracer(None, ts)
    perm = st.perm(o, d, dead=lim < 0)
    n_dead = int((lim < 0).sum())
    assert 0 < n_dead < 1024
    assert (lim[perm[-n_dead:]] < 0).all() and (lim[perm[:-n_dead]] >= 0).all()
    keys = ray_sort_keys(o, d, st.lo, st.hi)[perm[:-n_dead]]
    assert (keys[1:] >= keys[:-1]).all()
    assert sorted(perm.tolist()) == list(range(1024))


def test_keys_group_by_octant_and_cell():
    lo, hi = torch.zeros(3), torch.ones(3) * 10
    o = torch.tensor([[1.0, 1.0, 1.0], [1.01, 1.0, 1.0], [9.0, 9.0, 9.0]])
    d = torch.tensor([[1.0, 0.0, 0.1], [1.0, 0.0, 0.1], [1.0, 0.0, 0.1]])
    k = ray_sort_keys(o, d, lo, hi)
    assert k[0] == k[1]  # same cell, same octant
    assert k[0] != k[2]  # far cell differs
    k2 = ray_sort_keys(o[:1], torch.tensor([[-1.0, 0.0, 0.1]]), lo, hi)
    assert k2[0] != k[0]  # octant differs
    assert int(k[0]) >> 21 == 7 and int(k2[0]) >> 21 == 3


@pytest.mark.parametrize("limits", [False, True])
def test_sorting_tracer_equals_inner(box, limits):
    """Sorted, traced and unsorted: brute force's hits bit for bit."""
    _, ts = box
    bf = make_tracer(ts, "bruteforce")
    st = make_sorting_tracer(bf, ts)
    assert isinstance(st, SortingTracer)
    o, d = _rays(2000, 5)
    t_lim = _lim(2000, 6) if limits else None
    ref = bf.closest(o, d, T_MIN, T_MAX, t_lim=t_lim)
    got = st.closest(o, d, T_MIN, T_MAX, t_lim=t_lim)
    for f, a, b in zip(ref._fields, got, ref):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f)
    assert ref.hit.float().mean() > 0.1
    for bound in (2.0, torch.from_numpy(np.linspace(0.0, 6.0, 2000, dtype=np.float32))):
        np.testing.assert_array_equal(st.any(o, d, T_MIN, bound).numpy(),
                                      bf.any(o, d, T_MIN, bound).numpy())


def test_sorting_tracer_matches_jax(box):
    """The port's and the JAX package's sorting tracers over their brute
    force on the same rays: the sorted keys equal, the results equal."""
    js, ts = box
    o, d = _rays(2000, 7)
    st = make_sorting_tracer(make_tracer(ts, "bruteforce"), ts)
    jst = jsort.make_sorting_tracer(j_make_tracer(js, "bruteforce"), js)
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    keys = ray_sort_keys(o, d, st.lo, st.hi)
    jperm = np.asarray(jst._perm(jo, jd))
    np.testing.assert_array_equal(keys[st.perm(o, d)].numpy().astype(np.uint32),
                                  np.asarray(jsort.ray_sort_keys(jo, jd, jst.lo, jst.hi))[jperm])
    got, ref = st.closest(o, d, T_MIN, T_MAX), jst.closest(jo, jd, T_MIN, T_MAX)
    hit = got.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-5, atol=0)
    # another winner only at a (near-)equal t: the box's coplanar faces
    other = hit & (got.tri.numpy() != np.asarray(ref.tri))
    assert other.sum() <= 0.005 * hit.sum()
    np.testing.assert_array_equal(st.any(o, d, T_MIN, 2.0).numpy(),
                                  np.asarray(jst.any(jo, jd, T_MIN, 2.0)))
