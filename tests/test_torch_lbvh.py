"""The port's LBVH (``vkrt_tpu_torch/bvh/lbvh.py``) and the ``bvh`` backend
over it (``ops/cuda/trace_variants.py::LbvhTracer``) against
``vkrt_tpu/bvh/lbvh.py`` and tests/test_bvh.py.

* tests/test_bvh.py case for case on the port: ``_clz32``, Morton
  locality, the tree's structure for n in {2, 3, 7, 64, 333}, the single
  triangle, traversal against brute force, ``t_max``, duplicate centroids,
  Cornell rendered with ``bvh`` against ``bruteforce``. The JAX walk keeps
  the triangle met first at an equal t; the port's takes the lower id, as
  brute force does, so here every comparison with brute force is exact
  (t, tri, u, v as uint32; verdicts equal), where the JAX test allows ties;
* ``build_lbvh`` bit for bit against the JAX package's (all four arrays as
  uint32) on the padded 333-triangle soup, the padded Cornell box,
  ``make_city(grid=4)`` and 16 triangles with one centroid; on each the
  JAX leaves' order among equal Morton codes is asserted ascending by
  triangle id (the port sorts stably; ``jax.lax.sort`` does not promise
  it); ``morton3d`` and ``_clz32`` bit for bit on random inputs;
* the ``bvh`` tracer against JAX's ``trace_closest_bvh`` /
  ``trace_any_bvh`` over JAX's LBVH on the soup and the Cornell box, half
  of the rays aimed at triangles: verdicts equal; the triangle the same except on exact ties
  (equal t), whose count is asserted at most 1% of the hits and printed;
  where the triangle is the same and the ray meets its plane at a cosine
  above 0.05, t within 1e-5 relative and u, v within 1e-3 (XLA's CPU
  arithmetic contracts some products of the Moller-Trumbore test, which
  loses digits on grazing hits of small triangles; see
  tests/test_torch_probes.py); the port's hits are brute force's bit for
  bit;
* ``threaded_tables`` (the device packing) equal to the host packing
  (``pack_bvh_nodes`` with leaf slots, ``pack_tris``) bit for bit;
* the engine re-posed with ``bvh``: the tracer's tree is ``build_lbvh`` of
  the re-posed scene, and the image is brute force's.

JAX's ``build_lbvh`` is jitted and compiles once a shape: the JAX leg uses
four shapes (384, 128, 256 and 16 triangles)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkrt_tpu.bvh.lbvh as jlbvh
import vkrt_tpu.scene as jscene
from vkrt_tpu.ops.trace import trace_any_bvh, trace_closest_bvh
from vkrt_tpu_torch.bvh.lbvh import FlatBVH, _clz32, _expand_bits, build_lbvh, morton3d
from vkrt_tpu_torch.config import RenderSettings
from vkrt_tpu_torch.engine import Engine
from vkrt_tpu_torch.ops.cuda.trace import pack_bvh_nodes, pack_tris, threaded_tables
from vkrt_tpu_torch.ops.cuda.trace_variants import LbvhTracer, trace_threaded
from vkrt_tpu_torch.ops.trace import (
    Tracer, _mt_pairs, make_tracer, trace_rays_bruteforce, trace_rays_bvh,
)
from vkrt_tpu_torch.scene import make_cornell_box, make_random_soup, scene_from_numpy
from vkrt_tpu_torch.scene_instances import build_instanced
from vkrt_tpu_torch.utils.camera import Camera

torch.set_num_threads(2)
T_MIN, T_MAX = 1e-3, 1e4


def _soup(n, seed=0):
    sc = make_random_soup(n, seed, device="cpu")
    return sc.tri_v0, sc.tri_e1, sc.tri_e2


def _u32(x) -> np.ndarray:
    """The bits of a 4-byte array as uint32 (other arrays as they are)."""
    x = np.asarray(x)
    return x.view(np.uint32) if x.itemsize == 4 else x


def _rays(n, rng, scale=2.0, aim=None):
    """tests/test_bvh.py's rays (origins normal * ``scale``, random
    directions); with ``aim`` = (v0, e1, e2), every other ray points at a
    random triangle's centroid, so that a soup of small triangles is hit."""
    o = rng.normal(size=(n, 3)) * scale
    d = rng.normal(size=(n, 3))
    if aim is not None:
        v0, e1, e2 = (np.asarray(a, np.float64) for a in aim)
        k = rng.integers(0, len(v0), n // 2)
        d[::2][:n // 2] = v0[k] + (e1[k] + e2[k]) / 3 - o[::2][:n // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32)


def _tables(v0, e1, e2):
    return threaded_tables(build_lbvh(v0, e1, e2), v0, e1, e2)


def _assert_bits(a, b):
    for field, x, y in zip(a._fields, a, b):
        np.testing.assert_array_equal(_u32(x.numpy()), _u32(y.numpy()), err_msg=field)


# --- tests/test_bvh.py on the port --------------------------------------------


def test_clz32():
    xs = np.array([0, 1, 2, 3, 0x80000000, 0x40000000, 0xFFFFFFFF, 1 << 20], np.uint32)
    want = [32, 31, 30, 30, 0, 1, 0, 11]
    np.testing.assert_array_equal(_clz32(torch.from_numpy(xs.astype(np.int64))).numpy(), want)
    # the same bits given as int32
    np.testing.assert_array_equal(_clz32(torch.from_numpy(xs.view(np.int32))).numpy(), want)


def test_morton_ordering_locality():
    # points along the diagonal get monotonically increasing codes
    p = torch.linspace(0, 1, 64)[:, None] * torch.ones((1, 3))
    codes = morton3d(p).numpy()
    assert (np.diff(codes) >= 0).all()


def _validate_structure(bvh: FlatBVH, n_tris: int):
    m = bvh.node_min.shape[0]
    assert m == 2 * n_tris - 1
    skip, tri = bvh.node_skip.numpy(), bvh.node_tri.numpy()
    nmin, nmax = bvh.node_min.numpy(), bvh.node_max.numpy()
    # every triangle appears exactly once
    leaves = tri[tri >= 0]
    assert sorted(leaves.tolist()) == list(range(n_tris))
    # preorder skip invariants: leaf skip = idx+1; inner skip > idx+1
    is_leaf = tri >= 0
    idx = np.arange(m)
    np.testing.assert_array_equal(skip[is_leaf], idx[is_leaf] + 1)
    assert (skip[~is_leaf] > idx[~is_leaf] + 1).all()
    assert (skip <= m).all()
    # parent boxes contain child boxes: node i+1 (first child of inner i)
    inner = ~is_leaf
    assert (nmin[inner] <= nmin[inner.nonzero()[0] + 1] + 1e-6).all()
    assert (nmax[inner] >= nmax[inner.nonzero()[0] + 1] - 1e-6).all()


@pytest.mark.parametrize("n", [2, 3, 7, 64, 333])
def test_lbvh_structure(n):
    v0, e1, e2 = _soup(n)
    # only the real (unpadded) triangles
    bvh = build_lbvh(v0[:n], e1[:n], e2[:n])
    assert bvh.node_skip.dtype == bvh.node_tri.dtype == torch.int32
    _validate_structure(bvh, n)


def test_lbvh_single_triangle():
    v0 = torch.tensor([[0.0, 0.0, 0.0]])
    e1 = torch.tensor([[1.0, 0.0, 0.0]])
    e2 = torch.tensor([[0.0, 1.0, 0.0]])
    bvh = build_lbvh(v0, e1, e2)
    assert bvh.node_tri.tolist() == [0] and bvh.node_skip.tolist() == [1]
    nodes, tris = threaded_tables(bvh, v0, e1, e2)
    o, d = torch.tensor([[0.2, 0.2, 3.0]]), torch.tensor([[0.0, 0.0, -1.0]])
    h = trace_threaded(nodes, tris, o, d, torch.tensor([T_MAX]), T_MIN)
    assert int(h.tri[0]) == 0 and abs(float(h.t[0]) - 3.0) < 1e-5


@pytest.mark.parametrize("n_tris,n_rays", [(33, 200), (500, 300)])
def test_traversal_matches_bruteforce(n_tris, n_rays, rng):
    """Exact here: the walk breaks ties as brute force does."""
    v0, e1, e2 = _soup(n_tris, seed=n_tris)
    o, d = _rays(n_rays, rng, aim=(v0[:n_tris], e1[:n_tris], e2[:n_tris]))
    nodes, tris = _tables(v0, e1, e2)
    lim = torch.full((n_rays,), T_MAX)
    ref = trace_rays_bruteforce(v0, e1, e2, o, d, lim, T_MIN)
    got = trace_threaded(nodes, tris, o, d, lim, T_MIN)
    _assert_bits(got, ref)
    assert int((ref.tri >= 0).sum()) > n_rays // 10
    # any: first-hit-kills lanes, the verdict alone
    any_got = trace_threaded(nodes, tris, o, d, lim, T_MIN, any_hit=True).tri >= 0
    np.testing.assert_array_equal(any_got.numpy(), (ref.tri >= 0).numpy())


def test_traversal_respects_tmax(rng):
    v0, e1, e2 = _soup(50, seed=5)
    nodes, tris = _tables(v0, e1, e2)
    o, d = _rays(100, rng, aim=(v0[:50], e1[:50], e2[:50]))
    lim = torch.full((100,), -2.0)  # first-hit-kills lanes bounded by 2
    short = trace_threaded(nodes, tris, o, d, lim, T_MIN).tri >= 0
    ref = trace_rays_bruteforce(v0, e1, e2, o, d, lim, T_MIN).tri >= 0
    np.testing.assert_array_equal(short.numpy(), ref.numpy())
    assert short.any() and not short.all()


def _duplicates():
    base = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    tris = np.stack([base for _ in range(16)])  # all identical
    return tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]


def test_duplicate_centroids_build():
    """Degenerate Morton case: identical centroids still build a valid
    tree (index-bit tiebreak); the hit is the lowest id, as brute force's."""
    v0, e1, e2 = (torch.from_numpy(a) for a in _duplicates())
    bvh = build_lbvh(v0, e1, e2)
    _validate_structure(bvh, 16)
    nodes, tris = threaded_tables(bvh, v0, e1, e2)
    o, d = torch.tensor([[0.2, 0.2, 4.0]]), torch.tensor([[0.0, 0.0, -1.0]])
    h = trace_threaded(nodes, tris, o, d, torch.tensor([T_MAX]), T_MIN)
    assert int(h.tri[0]) == 0


def test_cornell_render_with_bvh_matches_bruteforce():
    """Exact here (the JAX test allows 2% of pixels for its tie rule)."""
    box = make_cornell_box(device="cpu")
    a = Engine(box, 48, 36, RenderSettings(rt_mode=1, backend="bruteforce")).render(2)
    eng = Engine(box, 48, 36, RenderSettings(rt_mode=1, backend="bvh"))
    assert isinstance(eng.tracer, LbvhTracer)
    b = eng.render(2)
    np.testing.assert_array_equal(b, a)
    assert a.std() > 0


# --- against the JAX package --------------------------------------------------


def _arrays(kind):
    """(v0, e1, e2) numpy f32 arrays both packages build over."""
    if kind == "duplicates":
        return _duplicates()
    js = {"soup": lambda: jscene.make_random_soup(333),
          "cornell": jscene.make_cornell_box,
          "city": lambda: jscene.make_city(grid=4)}[kind]()
    return tuple(np.asarray(getattr(js, k), np.float32) for k in ("tri_v0", "tri_e1", "tri_e2"))


@pytest.mark.parametrize("kind", ["soup", "cornell", "city", "duplicates"])
def test_build_matches_jax(kind):
    """All four arrays bit for bit, pads included (they move the centroid
    bounds and so the codes); and the JAX leaves' order among equal codes
    is ascending by triangle id, which the port's stable sort gives."""
    arrs = _arrays(kind)
    want = jlbvh.build_lbvh(*(jnp.asarray(a) for a in arrs))
    got = build_lbvh(*(torch.from_numpy(a) for a in arrs))
    for name, g, w in zip(FlatBVH._fields, got, want):
        np.testing.assert_array_equal(_u32(g.numpy()), _u32(w), err_msg=name)
    # the leaves in preorder are the sorted order: JAX's codes (formed as
    # its build forms them) non-decreasing and, within a run of equal
    # codes, triangle ids ascending
    tri = np.asarray(want.node_tri)
    order = tri[tri >= 0]
    v0, e1, e2 = (jnp.asarray(a) for a in arrs)
    v1, v2 = v0 + e1, v0 + e2
    c = 0.5 * (jnp.minimum(jnp.minimum(v0, v1), v2) + jnp.maximum(jnp.maximum(v0, v1), v2))
    lo, hi = c.min(0), c.max(0)
    codes = np.asarray(jlbvh.morton3d((c - lo) / jnp.maximum(hi - lo, 1e-12))).astype(np.int64)
    sc = codes[order]
    assert (np.diff(sc) >= 0).all()
    equal = np.diff(sc) == 0
    assert (np.diff(order)[equal] > 0).all()
    if kind == "duplicates":
        assert equal.all()  # 16 equal codes


def test_morton_and_clz_match_jax():
    rng = np.random.default_rng(11)
    p = rng.uniform(-0.1, 1.1, (4096, 3)).astype(np.float32)
    np.testing.assert_array_equal(morton3d(torch.from_numpy(p)).numpy().astype(np.uint32),
                                  _u32(jlbvh.morton3d(jnp.asarray(p))))
    x = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:64] = 1 << np.arange(32).repeat(2)[:64].astype(np.uint32)  # every bit length
    x[64] = 0
    got = _clz32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlbvh._clz32(jnp.asarray(x))))
    q = x & np.uint32(0x3FF)
    np.testing.assert_array_equal(_expand_bits(torch.from_numpy(q.astype(np.int64))).numpy(),
                                  np.asarray(jlbvh._expand_bits(jnp.asarray(q))))


@pytest.mark.parametrize("kind", ["soup", "cornell"])
def test_bvh_tracer_matches_jax(rng, kind):
    """The ``bvh`` backend against the JAX package's LBVH walk on the soup
    and on the Cornell box (whose boxes rest on the floor: coplanar faces
    give exact ties)."""
    arrs = _arrays(kind)
    js = jscene.make_random_soup(333) if kind == "soup" else jscene.make_cornell_box()
    ts = scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu")
    tracer = make_tracer(ts, "bvh")
    assert isinstance(tracer, LbvhTracer)
    jbvh = jlbvh.build_lbvh(*(jnp.asarray(a) for a in arrs))
    live = (np.abs(arrs[1]) + np.abs(arrs[2])).any(1)  # not padding
    o, d = _rays(2048, rng, scale=2.0 if kind == "soup" else 3.0,
                 aim=tuple(a[live] for a in arrs))
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    ref = trace_closest_bvh(jbvh, *arrs, jo, jd, T_MIN, T_MAX)
    got = tracer.closest(o, d, T_MIN, T_MAX)
    hit = got.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    assert hit.mean() > 0.2
    same = got.tri.numpy()[hit] == np.asarray(ref.tri)[hit]
    ties = int((~same).sum())
    print(f"bvh tracer vs JAX LBVH walk, {kind}: {int(hit.sum())} hits, {ties} exact "
          "ties decided differently")
    assert ties <= 0.01 * hit.sum()
    # a tie: JAX's triangle, tested in the port's arithmetic, is hit at the
    # port's t, and the port took the lower id
    lanes = np.nonzero(hit)[0][~same]
    jtri = torch.from_numpy(np.asarray(ref.tri)[lanes]).long()
    ok, tj, _, _ = _mt_pairs(o[lanes], d[lanes], ts.tri_v0[jtri], ts.tri_e1[jtri],
                             ts.tri_e2[jtri], torch.tensor(T_MIN), None)
    assert ok.all() and torch.equal(tj, got.t[lanes])
    assert (got.tri[lanes].long() < jtri).all()
    # t, u and v are the Moller-Trumbore test's, whose f32 arithmetic
    # differs between XLA on the CPU (contracted products) and torch; it
    # loses digits on grazing hits of the soup's small triangles (there
    # both packages are that far from a float64 recomputation), so the
    # values are compared where the ray meets the plane at a cosine above
    # 0.05; the walk's own hits are brute force's bit for bit
    tri = got.tri.numpy()[hit]
    n = np.cross(arrs[1][tri], arrs[2][tri])
    cos = np.abs((n * d.numpy()[hit]).sum(1)) / np.linalg.norm(n, axis=1)
    ok = same & (cos > 0.05)
    assert ok.mean() > 0.9
    t, rt = got.t.numpy()[hit][ok], np.asarray(ref.t)[hit][ok]
    np.testing.assert_allclose(t, rt, rtol=1e-5, atol=0)
    for a, b in ((got.u, ref.u), (got.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[hit][ok], np.asarray(b)[hit][ok], rtol=0,
                                   atol=1e-3)
    brute = Tracer(ts).closest(o, d, T_MIN, T_MAX)
    _assert_bits(got, brute)
    any_ref = trace_any_bvh(jbvh, *arrs, jo, jd, T_MIN, 0.5)
    np.testing.assert_array_equal(tracer.any(o, d, T_MIN, 0.5).numpy(), np.asarray(any_ref))


@pytest.mark.parametrize("kind", ["cornell", "city"])
def test_device_packing_matches_host(kind):
    """``threaded_tables`` against the host packing of the same tree:
    ``pack_bvh_nodes`` with each leaf's slot for its triangle id (as
    ``probe_tables`` fills it) and ``pack_tris`` in leaf order."""
    v0, e1, e2 = (torch.from_numpy(a) for a in _arrays(kind))
    flat = build_lbvh(v0, e1, e2)
    nodes, tris = threaded_tables(flat, v0, e1, e2)
    host = [a.numpy() for a in flat]
    want = pack_bvh_nodes(*host)
    tri = host[3]
    want.view(np.int32)[:, 7] = np.where(tri >= 0, np.cumsum(tri >= 0) - 1, -1)
    np.testing.assert_array_equal(_u32(nodes.numpy()), _u32(want))
    want_tris = pack_tris(v0.numpy(), e1.numpy(), e2.numpy(), tri[tri >= 0])
    np.testing.assert_array_equal(_u32(tris.numpy()), _u32(want_tris))
    # the walk over the slot table is the walk over the triangle-id table
    o, d = _rays(256, np.random.default_rng(3), scale=3.0)
    lim = torch.full((256,), T_MAX)
    js = jscene.make_cornell_box() if kind == "cornell" else jscene.make_city(grid=4)
    sc = scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu")
    by_id = trace_rays_bvh(torch.from_numpy(pack_bvh_nodes(*host)), sc, o, d, lim, count=True)
    by_slot = trace_rays_bvh(nodes, None, o, d, lim, count=True, tris=tris)
    _assert_bits(by_slot[0], by_id[0])
    assert all(torch.equal(a, b) for a, b in zip(by_slot[1], by_id[1]))


def test_engine_repose_rebuilds():
    """``set_node_transform`` with ``bvh``: the tracer's LBVH is
    ``build_lbvh`` of the re-posed scene bit for bit, and the frame is
    brute force's on the same pose."""
    from test_torch_instances import _doc, _translate

    cam = Camera(eye=(0, 0, 12.0), center=(0, 0, 0.0))
    imgs = {}
    for backend in ("bvh", "bruteforce"):
        e = Engine(build_instanced(_doc(), device="cpu"), 48, 32,
                   RenderSettings(rt_mode=1, depth=2, backend=backend), cam)
        e.render_frame()
        e.set_node_transform(1, _translate(2, 1, -3))
        imgs[backend] = e.render_frame().numpy()
        if backend == "bvh":
            assert isinstance(e.tracer, LbvhTracer) and e.tracer.scene is e.scene
            sc = e.scene
            for a, b in zip(e.tracer.flat, build_lbvh(sc.tri_v0, sc.tri_e1, sc.tri_e2)):
                np.testing.assert_array_equal(_u32(a.numpy()), _u32(b.numpy()))
    np.testing.assert_array_equal(imgs["bvh"], imgs["bruteforce"])
