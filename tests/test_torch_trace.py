"""Port vs JAX package: the brute-force tracer (the plain version of the
CUDA trace kernel) against the Pallas tracer in interpret mode; the
threaded BVH of the native builder, traversed by a small torch reference;
and the tables the CUDA kernel walks (child-box records, triangle records)
with the kernel's front-to-back walk in plain torch, against brute force
(bit-equal on closest lanes, triangle id included) and the Pallas tracer.

Tolerances: hit verdicts equal except at ties or grazing edges (>= 99.9%
of lanes), t to 1e-5 relative, u and v to 1e-5 absolute, resolved
attributes to 1e-6 where both hit the same triangle. First-hit-kills lanes
promise only their verdict (the Pallas kernel stops at its first hit)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vkrt_tpu.scene as jscene
from vkrt_tpu.ops.pallas.trace import make_pallas_tracer
from vkrt_tpu_torch.ops.cuda.trace import build_bvh_arrays, pack_bvh_nodes
from vkrt_tpu_torch.ops.intersect import T_MAX, T_MIN, _cross, _dot, safe_inv_dir
from vkrt_tpu_torch.ops.trace import Tracer, make_tracer, trace_rays_bruteforce
from vkrt_tpu_torch.scene import scene_from_numpy

torch.set_num_threads(2)
N_RAYS = 4096


def _rays(kind: str, seed: int = 0, n: int = N_RAYS):
    """Rays with closest, first-hit-kills, dead (1e30 / d = 0 / -1) and
    zero-limit (+0 and -0) lanes."""
    rng = np.random.default_rng(seed)
    if kind == "box":
        o = rng.uniform(-4.5, 4.5, (n, 3))
    else:
        o = rng.uniform(-1.5, 1.5, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lim = np.full(n, T_MAX)
    lane = rng.integers(0, 6, n)
    lim[lane == 1] = -rng.uniform(0.05, 6.0, (lane == 1).sum())  # kill lanes
    lim[lane == 2] = rng.uniform(0.05, 3.0, (lane == 2).sum())   # short closest
    lim[lane == 3] = 0.0
    lim[lane == 4] = -0.0
    dead = lane == 5
    o[dead] = 1e30
    d[dead] = 0.0
    lim[dead] = -1.0
    return (o.astype(np.float32), d.astype(np.float32), lim.astype(np.float32),
            lane)


def _scenes(kind: str):
    js = jscene.make_cornell_box() if kind == "box" else jscene.make_random_soup(2048)
    return js, scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                                device="cpu")


def check_against_pallas(kind: str):
    """closest and any of the port's brute force against the hits and
    verdicts of one Pallas resolve launch (interpret mode; one compile per
    scene). The Pallas ``any`` is the same kernel with every limit negated,
    so its verdicts are those of the resolve launch on -|t_lim|."""
    js, ts = _scenes(kind)
    pt = make_pallas_tracer(js, interpret=True)
    o, d, lim, lane = _rays(kind)
    lim_any = -np.abs(lim)
    jh, _ = pt.closest_surface(jnp.asarray(np.concatenate([o, o])),
                               jnp.asarray(np.concatenate([d, d])), T_MIN, T_MAX,
                               t_lim=jnp.asarray(np.concatenate([lim, lim_any])))
    jany = np.asarray(jh.hit)[N_RAYS:]
    jh = jh._replace(**{k: getattr(jh, k)[:N_RAYS] for k in jh._fields})

    tracer = make_tracer(ts)
    assert isinstance(tracer, Tracer)
    to, td, tl = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lim)
    th = tracer.closest(to, td, T_MIN, T_MAX, t_lim=tl)
    jhit, thit = np.asarray(jh.hit), th.hit.numpy()
    assert (jhit == thit).mean() >= 0.999, (jhit != thit).sum()
    # zero-limit and dead lanes never hit
    never = (lane == 3) | (lane == 4) | (lane == 5)
    assert not thit[never].any() and not jhit[never].any()
    assert thit.mean() > 0.1

    both = jhit & thit & (lane != 1)
    same = both & (np.asarray(jh.tri) == th.tri.numpy())
    assert same.sum() >= 0.99 * both.sum()  # other winners only at ties
    np.testing.assert_allclose(th.t.numpy()[both], np.asarray(jh.t)[both], rtol=1e-5)
    np.testing.assert_allclose(th.u.numpy()[same], np.asarray(jh.u)[same], atol=1e-5, rtol=0)
    np.testing.assert_allclose(th.v.numpy()[same], np.asarray(jh.v)[same], atol=1e-5, rtol=0)
    # miss lanes: HitInfo t = 0, tri = -1
    assert (th.t.numpy()[~thit] == 0).all() and (th.tri.numpy()[~thit] == -1).all()

    tany = tracer.any(to, td, T_MIN, torch.from_numpy(np.abs(lim))).numpy()
    assert (jany == tany).mean() >= 0.999
    assert not tany[never].any() and tany.mean() > 0.1

    # kernel A's front-to-back walk in plain torch against the same launch
    from vkrt_tpu_torch.ops.cuda.trace import build_bvh
    from vkrt_tpu_torch.ops.trace import trace_rays_bvh_ordered

    bvh = build_bvh(ts)
    w = trace_rays_bvh_ordered(bvh, to, td, tl)
    whit = w.tri.numpy() >= 0
    assert (whit == jhit).mean() >= 0.999
    both = jhit & whit & (lane != 1)
    same = both & (np.asarray(jh.tri) == w.tri.numpy())
    assert same.sum() >= 0.99 * both.sum()
    np.testing.assert_allclose(w.t.numpy()[both], np.asarray(jh.t)[both], rtol=1e-5)
    np.testing.assert_allclose(w.u.numpy()[same], np.asarray(jh.u)[same], atol=1e-5, rtol=0)
    np.testing.assert_allclose(w.v.numpy()[same], np.asarray(jh.v)[same], atol=1e-5, rtol=0)
    wany = trace_rays_bvh_ordered(bvh, to, td, torch.from_numpy(lim_any)).tri.numpy() >= 0
    assert (wany == jany).mean() >= 0.999 and not wany[never].any()


def test_box_matches_pallas():
    check_against_pallas("box")


@pytest.mark.parametrize("kind", ["box", "soup"])
def test_kernel_contract_on_misses(kind):
    """trace(): the kernel's raw contract — miss t = |t_lim|, tri -1, u=v=0."""
    _, ts = _scenes(kind)
    o, d, lim, _ = _rays(kind, seed=5)
    h = Tracer(ts).trace(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lim))
    miss = h.tri.numpy() < 0
    np.testing.assert_array_equal(h.t.numpy()[miss], np.abs(lim)[miss])
    assert (h.u.numpy()[miss] == 0).all() and (h.v.numpy()[miss] == 0).all()
    # a (7, N) block with strided o/d views gives the same answer
    block = torch.from_numpy(np.concatenate([o.T, d.T, lim[None]]).copy())
    hb = Tracer(ts).trace_block(block)
    for a, b in zip(h, hb):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _mt_lanes(o, d, v0, e1, e2, t_min, t_max):
    """ops.intersect.mt_block for one triangle per lane."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    ok = det.abs() > 1e-9
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min) & (t < t_max)
    return hit, t, u, v


def _traverse_reference(nodes, v0, e1, e2, o, d, t_lim, t_min):
    """Lane-parallel torch walk of the threaded BVH, as csrc/trace.cu
    walks it: box hit at an inner node -> node + 1, otherwise the skip
    link; a kill lane stops at its first hit."""
    n = o.shape[0]
    nodes = torch.from_numpy(nodes)
    lo, hi = nodes[:, 0:3], nodes[:, 4:7]
    skip = nodes[:, 3].contiguous().view(torch.int32).long()
    leaf = nodes[:, 7].contiguous().view(torch.int32).long()
    inv = safe_inv_dir(d)
    best = t_lim.abs().clone()
    tri = torch.full((n,), -1, dtype=torch.int32)
    u = torch.zeros(n)
    v = torch.zeros(n)
    kill = t_lim < 0
    node = torch.zeros(n, dtype=torch.long)
    live = torch.ones(n, dtype=torch.bool)
    scale = 1.0 + 2.0 * 1.7881396e-7
    while True:
        live &= node < nodes.shape[0]
        if not live.any():
            break
        idx = torch.where(live, node, torch.zeros_like(node))
        t0 = (lo[idx] - o) * inv
        t1 = (hi[idx] - o) * inv
        tnear = torch.clamp_min(torch.minimum(t0, t1).amax(1), t_min)
        tfar = torch.minimum(torch.maximum(t0, t1).amin(1), best)
        box = live & (tnear <= tfar * scale)
        is_leaf = leaf[idx] >= 0
        k = torch.clamp_min(leaf[idx], 0)
        h, t, uu, vv = _mt_lanes(o, d, v0[k], e1[k], e2[k], t_min, best)
        h = h & box & is_leaf
        best = torch.where(h, t, best)
        tri = torch.where(h, leaf[idx].int(), tri)
        u = torch.where(h, uu, u)
        v = torch.where(h, vv, v)
        live &= ~(h & kill)
        node = torch.where(box & ~is_leaf, node + 1, skip[idx])
    return best, tri, u, v


@pytest.mark.parametrize("kind", ["box", "soup"])
def test_threaded_bvh_layout_vs_bruteforce(kind):
    js = jscene.make_cornell_box() if kind == "box" else jscene.make_random_soup(512, 4)
    ts = scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu")
    arrs = build_bvh_arrays(ts)
    nodes = pack_bvh_nodes(*arrs)
    # every real triangle is one leaf; skip links stay in range
    real = (np.abs(np.asarray(js.tri_e1)).sum(1) + np.abs(np.asarray(js.tri_e2)).sum(1)) > 0
    leaves = np.sort(arrs[3][arrs[3] >= 0])
    np.testing.assert_array_equal(leaves, np.nonzero(real)[0])
    assert (arrs[2] > np.arange(len(arrs[2]))).all() and arrs[2].max() == len(arrs[2])

    o, d, lim, lane = _rays(kind, seed=9, n=1024)
    o, d, lim = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lim)
    bt, btri, bu, bv = _traverse_reference(nodes, ts.tri_v0, ts.tri_e1, ts.tri_e2,
                                           o, d, lim, T_MIN)
    ref = trace_rays_bruteforce(ts.tri_v0, ts.tri_e1, ts.tri_e2, o, d, lim, T_MIN)
    vb, vr = btri.numpy() >= 0, ref.tri.numpy() >= 0
    assert (vb == vr).mean() >= 0.999
    closest = vb & vr & (lane != 1)
    np.testing.assert_allclose(bt.numpy()[closest], ref.t.numpy()[closest], rtol=1e-5)
    same = closest & (btri.numpy() == ref.tri.numpy())
    assert same.sum() >= 0.99 * closest.sum()
    np.testing.assert_allclose(bu.numpy()[same], ref.u.numpy()[same], atol=1e-5, rtol=0)
    miss = ~vb
    np.testing.assert_array_equal(bt.numpy()[miss], lim.abs().numpy()[miss])


@pytest.mark.parametrize("kind", ["box", "soup"])
def test_bruteforce_api_matches_jax_bruteforce(kind):
    """trace_closest_bruteforce / trace_any_bruteforce against their JAX
    twins (ops/trace.py): same block scan, same lowest-id tie-break."""
    from vkrt_tpu.ops.trace import trace_any_bruteforce as j_any
    from vkrt_tpu.ops.trace import trace_closest_bruteforce as j_closest
    from vkrt_tpu_torch.ops.trace import trace_any_bruteforce, trace_closest_bruteforce

    js, ts = _scenes(kind)
    o, d, lim, lane = _rays(kind, seed=11, n=1024)
    lim = np.abs(lim)
    jt = (js.tri_v0, js.tri_e1, js.tri_e2)
    tt = (ts.tri_v0, ts.tri_e1, ts.tri_e2)
    jh = j_closest(*jt, jnp.asarray(o), jnp.asarray(d), T_MIN, jnp.asarray(lim))
    th = trace_closest_bruteforce(*tt, torch.from_numpy(o), torch.from_numpy(d),
                                  T_MIN, torch.from_numpy(lim))
    np.testing.assert_array_equal(th.hit.numpy(), np.asarray(jh.hit))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-5, atol=1e-6)
    # another winner only at an equal-t tie (both packages round differently)
    same = th.tri.numpy() == np.asarray(jh.tri)
    assert same.mean() >= 0.995
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(th, k).numpy()[same],
                                   np.asarray(getattr(jh, k))[same],
                                   rtol=0, atol=1e-5, err_msg=k)
    ja = j_any(*jt, jnp.asarray(o), jnp.asarray(d), T_MIN, T_MAX)
    ta = trace_any_bruteforce(*tt, torch.from_numpy(o), torch.from_numpy(d), T_MIN, T_MAX)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta.numpy().mean() > 0.1


def test_intersect_primitives_match_jax():
    """mt_block, ray_aabb and safe_inv_dir against vkrt_tpu/ops/intersect.py
    (axis-parallel and zero direction components included)."""
    import vkrt_tpu.ops.intersect as ji
    import vkrt_tpu_torch.ops.intersect as ti

    assert (ti.T_MIN, ti.T_MAX) == (ji.T_MIN, ji.T_MAX)
    js, ts = _scenes("soup")
    o, d, lim, _ = _rays("soup", seed=13, n=512)
    d[:40, 0] = 0.0
    d[40:80, 1] = -0.0
    o[80:100] = [0.1, 0.2, 0.3]
    d[80:100] = [0.0, 0.0, 1.0]
    jinv = np.asarray(ji.safe_inv_dir(jnp.asarray(d)))
    tinv = ti.safe_inv_dir(torch.from_numpy(d))
    np.testing.assert_array_equal(tinv.numpy(), jinv)

    blk = slice(0, 64)
    jh, jt, ju, jv = ji.mt_block(jnp.asarray(o), jnp.asarray(d), js.tri_v0[blk],
                                 js.tri_e1[blk], js.tri_e2[blk], T_MIN, jnp.asarray(np.abs(lim)))
    th, tt, tu, tv = ti.mt_block(torch.from_numpy(o), torch.from_numpy(d), ts.tri_v0[blk],
                                 ts.tri_e1[blk], ts.tri_e2[blk], T_MIN,
                                 torch.from_numpy(np.abs(lim)))
    assert (th.numpy() == np.asarray(jh)).mean() >= 0.9999
    both = th.numpy() & np.asarray(jh)
    assert both.sum() > 0
    np.testing.assert_allclose(tt.numpy()[both], np.asarray(jt)[both], rtol=1e-5)
    np.testing.assert_allclose(tu.numpy()[both], np.asarray(ju)[both], atol=1e-5)

    rng = np.random.default_rng(2)
    lo = rng.uniform(-1.5, 0.0, (512, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.5, 2.0, (512, 3))).astype(np.float32)
    jb = np.asarray(ji.ray_aabb(jnp.asarray(o), jnp.asarray(jinv), jnp.asarray(lo),
                                jnp.asarray(hi), T_MIN, T_MAX))
    tb = ti.ray_aabb(torch.from_numpy(o), tinv, torch.from_numpy(lo), torch.from_numpy(hi),
                     T_MIN, T_MAX).numpy()
    np.testing.assert_array_equal(tb, jb)
    assert 0.05 < tb.mean() < 0.95


# --- kernel A's tables and its front-to-back walk in plain torch -----------------


def _np_scene(kind: str):
    import vkrt_tpu_torch.scene as tscene

    if kind == "city":
        return tscene.make_city(grid=4, device="cpu")
    return _scenes(kind)[1]


def _scene_rays(ts, seed: int, n: int = 2048):
    """Rays from inside the scene's bounds with closest, first-hit-kills,
    zero-limit (+0 and -0) and dead lanes."""
    rng = np.random.default_rng(seed)
    v0 = ts.tri_v0.numpy()
    o = rng.uniform(v0.min(0), v0.max(0), (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lim = np.full(n, T_MAX)
    lane = rng.integers(0, 6, n)
    lim[lane == 1] = -rng.uniform(0.05, 6.0, (lane == 1).sum())
    lim[lane == 2] = rng.uniform(0.05, 3.0, (lane == 2).sum())
    lim[lane == 3] = 0.0
    lim[lane == 4] = -0.0
    o[lane == 5], d[lane == 5], lim[lane == 5] = 1e30, 0.0, -1.0
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in (o, d, lim)) + (lane,)


@pytest.mark.parametrize("kind", ["box", "soup", "city"])
def test_pack_bvh2_round_trips(kind):
    """The child-box records hold the threaded tree: the children of inner
    node i are i + 1 and skip[i + 1], with their boxes, and every leaf's
    triangle is reached through its reference."""
    from vkrt_tpu_torch.ops.cuda.trace import node_depths, pack_bvh2_nodes, pack_tris

    ts = _np_scene(kind)
    lo, hi, skip, tri = build_bvh_arrays(ts)
    rec, leaf_tri, depth = pack_bvh2_nodes(lo, hi, skip, tri)
    bits = rec.view(np.int32)
    inner = np.nonzero(tri < 0)[0]
    assert rec.shape == (len(inner), 16) and len(leaf_tri) == (tri >= 0).sum()
    assert len(inner) == len(leaf_tri) - 1  # a full binary tree
    np.testing.assert_array_equal(leaf_tri, tri[tri >= 0])
    node_of_ref = {}  # reference -> threaded node
    for row, i in enumerate(inner):
        node_of_ref[row] = i
    leaf_nodes = np.nonzero(tri >= 0)[0]
    for slot, i in enumerate(leaf_nodes):
        node_of_ref[~slot] = i
    depths = node_depths(skip.astype(np.int64), tri)
    for row, i in enumerate(inner):
        left, right = i + 1, skip[i + 1]
        assert node_of_ref[bits[row, 3]] == left and node_of_ref[bits[row, 7]] == right
        np.testing.assert_array_equal(rec[row, 0:3], lo[left])
        np.testing.assert_array_equal(rec[row, 4:7], hi[left])
        np.testing.assert_array_equal(rec[row, 8:11], lo[right])
        np.testing.assert_array_equal(rec[row, 12:15], hi[right])
        assert bits[row, 11] == depths[i] and bits[row, 15] == 0
    assert depth == depths.max() == depths[leaf_nodes].max()
    v0, e1, e2 = (t.numpy() for t in (ts.tri_v0, ts.tri_e1, ts.tri_e2))
    trec = pack_tris(v0, e1, e2, leaf_tri)
    assert trec.shape == (len(leaf_tri), 12)
    np.testing.assert_array_equal(trec.view(np.int32)[:, 3], leaf_tri)
    np.testing.assert_array_equal(trec[:, 0:3], v0[leaf_tri])
    np.testing.assert_array_equal(trec[:, 4:7], e1[leaf_tri])
    np.testing.assert_array_equal(trec[:, 8:11], e2[leaf_tri])
    assert (trec[:, [7, 11]] == 0).all()


def _hand_bvh(v0, e1, e2, arrays):
    """``Bvh`` tables on the CPU from hand-made triangles and tree arrays."""
    from vkrt_tpu_torch.ops.cuda.trace import pack_bvh2_nodes, pack_bvh_nodes, pack_tris
    from vkrt_tpu_torch.ops.trace import Bvh

    rec, leaf_tri, depth = pack_bvh2_nodes(*arrays)
    return Bvh(torch.from_numpy(rec), torch.from_numpy(pack_tris(v0, e1, e2, leaf_tri)),
               depth, torch.from_numpy(pack_bvh_nodes(*arrays)))


def _caterpillar(n: int):
    """n unit triangles stacked along z and the deepest tree over them: every
    inner node's left child is a leaf, its right child the rest."""
    k = np.arange(n, dtype=np.float32)
    v0 = np.stack([np.zeros(n), np.zeros(n), k], 1).astype(np.float32)
    e1 = np.tile(np.float32([1, 0, 0]), (n, 1))
    e2 = np.tile(np.float32([0, 1, 0]), (n, 1))
    m = 2 * n - 1
    lo, hi = np.zeros((m, 3), np.float32), np.zeros((m, 3), np.float32)
    skip, tri = np.full(m, m, np.int32), np.full(m, -1, np.int32)
    for j in range(n):
        leaf = 2 * j + 1 if j < n - 1 else m - 1
        tri[leaf], skip[leaf] = j, leaf + 1
        lo[leaf], hi[leaf] = (0, 0, j), (1, 1, j)
        if j < n - 1:
            lo[2 * j], hi[2 * j] = (0, 0, j), (1, 1, n - 1)
    return v0, e1, e2, (lo, hi, skip, tri)


def test_one_triangle_tree_and_deepest_tree():
    """A root that is a leaf becomes one record of that leaf twice; a tree of
    exactly WALK_STACK levels is walked, one level more is refused."""
    from vkrt_tpu_torch.ops.cuda.trace import bvh_args, trace_kernel
    from vkrt_tpu_torch.ops.trace import WALK_STACK, trace_rays_bvh_ordered

    rng = np.random.default_rng(3)
    o = torch.from_numpy(np.c_[rng.uniform(-0.2, 1.0, (256, 2)), np.full(256, -1.0)]
                         .astype(np.float32))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(256, 1)
    lim = torch.full((256,), T_MAX)
    lim[::4] = -T_MAX

    v0, e1, e2, arrays = _caterpillar(1)
    one = _hand_bvh(v0, e1, e2, arrays)
    assert one.nodes.shape == (1, 16) and one.tris.shape == (1, 12) and one.depth == 1
    assert one.nodes.view(torch.int32)[0, [3, 7]].tolist() == [~0, ~0]

    deep_ok = _hand_bvh(*_caterpillar(WALK_STACK + 1)[:3], _caterpillar(WALK_STACK + 1)[3])
    assert deep_ok.depth == WALK_STACK
    for bvh, n in ((one, 1), (deep_ok, WALK_STACK + 1)):
        tv0, te1, te2 = (torch.from_numpy(a) for a in _caterpillar(n)[:3])
        h, c = trace_rays_bvh_ordered(bvh, o, d, lim, count=True)
        ref = trace_rays_bruteforce(tv0, te1, te2, o, d, lim, T_MIN)
        for a, b in zip(h, ref):  # the nearest of the stack is triangle 0
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert 0.2 < (h.tri >= 0).float().mean() < 0.8
        assert int(c.nodes.max()) <= 2 * n and int(c.nodes.min()) == 2

    too_deep = _hand_bvh(*_caterpillar(WALK_STACK + 2)[:3], _caterpillar(WALK_STACK + 2)[3])
    assert too_deep.depth == WALK_STACK + 1
    with pytest.raises(ValueError, match="exceeds"):
        bvh_args(too_deep)
    with pytest.raises(ValueError, match="exceeds"):
        trace_rays_bvh_ordered(too_deep, o, d, lim)
    _, ts = _scenes("box")
    with pytest.raises(ValueError, match="exceeds"):  # the wrapper, on the CPU too
        trace_kernel(too_deep, ts, o, d, lim)


@pytest.mark.parametrize("wrapper", ["trace_kernel", "trace_ablate"])
@pytest.mark.parametrize("fault", ["nodes_f64", "nodes_width", "tris_f64", "tris_width"])
def test_cpu_wrappers_refuse_bad_tables(wrapper, fault):
    """Kernels A's and D's wrappers refuse on the CPU the record tables
    the card refuses: a table that is not f32 (``TypeError``) or not 16
    (nodes) or 12 (tris) wide (``ValueError``). A strided table passes,
    as the plain walks read any layout."""
    from types import SimpleNamespace

    from vkrt_tpu_torch.ops.cuda.trace import trace_kernel
    from vkrt_tpu_torch.ops.cuda.trace_variants import trace_ablate

    one = _hand_bvh(*_caterpillar(1)[:3], _caterpillar(1)[3])
    _, ts = _scenes("box")
    o, d = torch.zeros((4, 3)), torch.tensor([[0.0, 0.0, 1.0]]).repeat(4, 1)
    lim = torch.full((4,), T_MAX)

    def call(bvh):
        if wrapper == "trace_kernel":
            return trace_kernel(bvh, ts, o, d, lim)
        return trace_ablate("count", SimpleNamespace(bvh=bvh), ts, o, d, lim)

    table, kind = fault.split("_")
    t = getattr(one, table)
    bad = t.double() if kind == "f64" else torch.cat([t, t[:, :1]], 1)
    with pytest.raises(TypeError if kind == "f64" else ValueError, match=f"bvh.{table}"):
        call(one._replace(**{table: bad}))
    call(one._replace(**{table: t.t().contiguous().t()}))


@pytest.mark.parametrize("kind", ["box", "soup", "city"])
def test_ordered_walk_equals_bruteforce(kind):
    """Kernel A's walk in plain torch against brute force: every closest
    lane bit-equal, the triangle id included (equal-t ties go to the lower
    id in both); every first-hit-kills lane by its verdict; zero-limit
    (+0 and -0) and dead lanes never hit."""
    from vkrt_tpu_torch.ops.cuda.trace import build_bvh
    from vkrt_tpu_torch.ops.trace import trace_rays_bvh_ordered

    ts = _np_scene(kind)
    bvh = build_bvh(ts)
    o, d, lim, lane = _scene_rays(ts, seed=21)
    h = trace_rays_bvh_ordered(bvh, o, d, lim)
    ref = trace_rays_bruteforce(ts.tri_v0, ts.tri_e1, ts.tri_e2, o, d, lim, T_MIN)
    hit = h.tri.numpy() >= 0
    np.testing.assert_array_equal(hit, ref.tri.numpy() >= 0)
    closest = (lane != 1) & (lane != 5)
    for a, b in zip(h, ref):
        np.testing.assert_array_equal(a.numpy()[closest], b.numpy()[closest])
    assert hit[closest].mean() > 0.1 and hit[lane == 1].mean() > 0.05
    assert not hit[(lane == 3) | (lane == 4) | (lane == 5)].any()
    np.testing.assert_array_equal(h.t.numpy()[~hit], np.abs(lim.numpy())[~hit])
    # any_hit makes every lane a first-hit-kills lane: the same verdicts
    h_any = trace_rays_bvh_ordered(bvh, o, d, lim, any_hit=True)
    np.testing.assert_array_equal(h_any.tri.numpy() >= 0, hit)


@pytest.mark.parametrize("kind", ["box", "soup", "city"])
def test_ordered_walk_visits_fewer_than_threaded(kind):
    """Front to back, the closest hit shrinks the search early: over the
    closest rays the walk makes no more slab tests (two a record) and no
    more triangle tests than the stackless walk in fixed preorder."""
    from vkrt_tpu_torch.ops.cuda.trace import build_bvh
    from vkrt_tpu_torch.ops.trace import trace_rays_bvh, trace_rays_bvh_ordered

    ts = _np_scene(kind)
    bvh = build_bvh(ts)
    o, d, lim, lane = _scene_rays(ts, seed=22)
    keep = torch.from_numpy((lane == 0) | (lane == 2))
    o, d, lim = o[keep], d[keep], lim[keep]
    h, c = trace_rays_bvh_ordered(bvh, o, d, lim, count=True)
    ht, ct = trace_rays_bvh(bvh.threaded, ts, o, d, lim, count=True)
    np.testing.assert_array_equal(h.t.numpy(), ht.t.numpy())
    assert int(c.nodes.sum()) <= int(ct.nodes.sum())
    assert int(c.leaves.sum()) <= int(ct.leaves.sum())
    assert (c.nodes % 2 == 0).all() and int(c.nodes.min()) >= 2


def test_coplanar_duplicates_give_the_lower_id():
    """Two identical triangles: whichever the walk meets first, the hit is
    the lower scene triangle id, as brute force's argmin gives it."""
    from vkrt_tpu_torch.ops.trace import trace_rays_bvh_ordered

    v0 = np.float32([[0, 0, 1], [0, 0, 1], [0, 0, 3]])
    e1 = np.tile(np.float32([1, 0, 0]), (3, 1))
    e2 = np.tile(np.float32([0, 1, 0]), (3, 1))
    box = (np.float32([0, 0, 1]), np.float32([1, 1, 1]))
    far = (np.float32([0, 0, 3]), np.float32([1, 1, 3]))
    o = torch.tensor([[0.25, 0.25, 0.0], [0.25, 0.25, 4.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    lim = torch.full((2,), T_MAX)
    for first, second in ((0, 1), (1, 0)):  # the duplicate met first has either id
        lo = np.stack([box[0], box[0], box[0], box[0], far[0]])
        hi = np.stack([far[1], box[1], box[1], box[1], far[1]])
        skip = np.int32([5, 4, 3, 4, 5])
        tri = np.int32([-1, -1, first, second, 2])
        hi[1] = box[1]
        bvh = _hand_bvh(v0, e1, e2, (lo, hi, skip, tri))
        h = trace_rays_bvh_ordered(bvh, o, d, lim)
        ref = trace_rays_bruteforce(*(torch.from_numpy(a) for a in (v0, e1, e2)), o, d, lim, T_MIN)
        assert h.tri.tolist() == ref.tri.tolist() == [0, 2]
        np.testing.assert_array_equal(h.t.numpy(), ref.t.numpy())
