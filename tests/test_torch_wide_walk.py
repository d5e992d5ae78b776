"""The wide tree of kernel E's ``ordered`` (``pack_bvh4_nodes``) and its walk in
plain torch (``trace_rays_bvh_wide``), on the CPU: the table's invariants on
the Cornell box, a random soup, ``make_city(grid=4)`` and one-triangle and
caterpillar trees, and the walk against the port's brute force.

Tolerances: none. The walk takes kernel A's arithmetic and tie rule, so on
closest lanes it is brute force bit for bit, the triangle id included;
first-hit-kills, dead and zero-limit lanes are held to their verdict. (The
same walk against the JAX package's tracers is in ``test_torch_probes.py``.)"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_trace import _caterpillar, _np_scene, _scene_rays
from vkrt_tpu_torch.ops.cuda.trace import (
    build_bvh, build_bvh_arrays, pack_bvh2_nodes, pack_bvh4_nodes, pack_tris,
)
from vkrt_tpu_torch.ops.cuda.trace_variants import probe_tables, trace_variant
from vkrt_tpu_torch.ops.intersect import T_MAX, T_MIN, safe_inv_dir
from vkrt_tpu_torch.ops.trace import (
    WIDE_NETWORK, WIDE_STACK, WideBvh, _child_slabs, _slab, trace_rays_bruteforce,
    trace_rays_bvh_wide,
)

torch.set_num_threads(2)


def _tree(kind: str):
    """(v0, e1, e2, threaded arrays) of a scene or a hand-made tree."""
    if kind == "one":
        return _caterpillar(1)
    ts = _np_scene(kind)
    return (*(t.numpy() for t in (ts.tri_v0, ts.tri_e1, ts.tri_e2)), build_bvh_arrays(ts))


def _wide(v0, e1, e2, arrays) -> WideBvh:
    rec, stack, depth = pack_bvh4_nodes(*arrays)
    leaf_tri = pack_bvh2_nodes(*arrays)[1]
    return WideBvh(torch.from_numpy(rec), torch.from_numpy(pack_tris(v0, e1, e2, leaf_tri)),
                   stack, depth)


@pytest.mark.parametrize("kind", ["box", "soup", "city", "one"])
def test_pack_bvh4_invariants(kind):
    """Every triangle sits in exactly one slot and every record but the root
    in exactly one; rows are breadth first; a child's box encloses the
    triangles under it; a record is short of four children only when all of
    them are leaves; empty slots come last, reference 0; the depth and the
    stack need are those of a recursive count."""
    v0, e1, e2, arrays = _tree(kind)
    rec, stack, depth = pack_bvh4_nodes(*arrays)
    tri = np.asarray(arrays[3])
    leaf_tri = tri[tri >= 0]
    bits = rec.view(np.int32)
    ref, count, level = bits[:, 24:28], bits[:, 28], bits[:, 29]
    assert rec.shape[1] == 32 and (bits[:, 30:32] == 0).all()
    np.testing.assert_array_equal(np.sort(~ref[ref < 0]), np.arange(len(leaf_tri)))
    np.testing.assert_array_equal(np.sort(ref[ref > 0]), np.arange(1, len(rec)))
    np.testing.assert_array_equal(count, (ref != 0).sum(1))
    assert ((ref != 0) == (np.arange(4)[None] < count[:, None])).all()  # empties last
    assert (count >= (1 if kind == "one" else 2)).all()
    short = count < 4
    assert (ref[short] <= 0).all()  # only leaves where a record could not grow
    lo = rec[:, 0:12].reshape(-1, 3, 4)
    hi = rec[:, 12:24].reshape(-1, 3, 4)
    empty = ref == 0
    assert np.isposinf(lo.transpose(0, 2, 1)[empty]).all()
    assert np.isneginf(hi.transpose(0, 2, 1)[empty]).all()
    # bottom up (children have larger rows): the vertices under each record
    corners = np.stack([v0, v0 + e1, v0 + e2], 1)[leaf_tri]  # (L, 3, 3) in leaf order
    sub_lo, sub_hi = np.zeros((len(rec), 3)), np.zeros((len(rec), 3))
    need, deep = np.zeros(len(rec), int), np.ones(len(rec), int)
    for row in range(len(rec) - 1, -1, -1):
        los, his, below, levels = [], [], 0, 1
        for j in range(count[row]):
            c = ref[row, j]
            if c > 0:
                assert c > row and level[c] == level[row] + 1
                c_lo, c_hi = sub_lo[c], sub_hi[c]
                below, levels = max(below, need[c]), max(levels, 1 + deep[c])
            else:
                c_lo, c_hi = corners[~c].min(0), corners[~c].max(0)
            assert (lo[row, :, j] <= c_lo).all() and (hi[row, :, j] >= c_hi).all()
            los.append(c_lo)
            his.append(c_hi)
        sub_lo[row], sub_hi[row] = np.min(los, 0), np.max(his, 0)
        need[row], deep[row] = count[row] - 1 + below, levels
    assert level[0] == 0 and depth == deep[0] == level.max() + 1
    assert stack == need[0] <= WIDE_STACK
    if kind != "one":
        assert (count == 4).any() and depth < pack_bvh2_nodes(*arrays)[2]


def _axis_rays(ts, seed: int):
    """Rays from in and around the scene with axis-parallel directions,
    directions with one and two zero components, and random ones; finite
    and infinite limits."""
    rng = np.random.default_rng(seed)
    v0 = ts.tri_v0.numpy()
    lo, hi = v0.min(0), v0.max(0)
    axis = np.concatenate([np.eye(3), -np.eye(3)])
    planar = rng.normal(size=(60, 3))
    planar[np.arange(60), rng.integers(0, 3, 60)] = 0.0
    d = np.concatenate([np.repeat(axis, 20, 0), planar, rng.normal(size=(120, 3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(d == 0, 0.0, d)  # no negative zeros left by the division
    o = rng.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), (len(d), 3))
    lim = np.where(np.arange(len(d)) % 3 == 0, np.inf, T_MAX)
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in (o, d, lim))


@pytest.mark.parametrize("kind", ["box", "soup", "city"])
def test_empty_slots_are_never_entered(kind):
    """No ray enters an empty slot, axis-parallel and zero-component
    directions and infinite limits included. It is the slot's reference (0)
    that keeps the walk out: the slab test alone takes the inverted box
    (min +inf, max -inf) for all of space."""
    ts = _np_scene(kind)
    wide = probe_tables(build_bvh(ts), ts).wide
    o, d, lim = _axis_rays(ts, seed=5)
    bits = wide.nodes.view(torch.int32)
    short = torch.nonzero(bits[:, 28] < 4)[:, 0][:16]
    assert len(short) > 0
    rec, t_min = wide.nodes.view(-1, 8, 4), torch.tensor(T_MIN)
    inv = safe_inv_dir(d)
    for k in short.tolist():
        rows = torch.full((len(o),), k)
        child, key = _child_slabs(rec[rows, 0:3], rec[rows, 3:6], bits[rows, 24:28].long(),
                                  o, inv, t_min, lim, WIDE_NETWORK)
        kept = (child != 0).sum(1)
        assert (kept <= bits[k, 28]).all()
        assert torch.isin(child, bits[k, 24:28].long()).all()
        assert torch.isinf(key[child == 0]).all() and torch.isfinite(key[child != 0]).all()
        # sorted: nearest first, the misses last
        assert (key[:, :-1] <= key[:, 1:]).all()
        j = int(bits[k, 28])  # the first empty slot
        hit, _ = _slab(rec[rows, 0:3, j], rec[rows, 3:6, j], o, inv, t_min, lim)
        assert hit.all()  # the box itself stops nobody
    h = trace_rays_bvh_wide(wide, o, d, lim)
    for a, b in zip(h, trace_rays_bruteforce(ts.tri_v0, ts.tri_e1, ts.tri_e2, o, d, lim)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert 0.2 < (h.tri >= 0).float().mean()


@pytest.mark.parametrize("kind", ["box", "soup", "city"])
def test_wide_walk_equals_bruteforce(kind):
    """Every closest lane bit-equal to brute force, the triangle id
    included; every first-hit-kills lane by its verdict; zero-limit (+0 and
    -0) and dead lanes never hit. The counts: one slab test a child a
    record holds (between one and four a record, the root's on every ray),
    at least one triangle test a hit, no more records than the binary walk
    enters."""
    from vkrt_tpu_torch.ops.trace import trace_rays_bvh_ordered

    ts = _np_scene(kind)
    bvh = build_bvh(ts)
    wide = probe_tables(bvh, ts).wide
    assert wide.tris is bvh.tris  # kernel A's triangle records, not a copy
    o, d, lim, lane = _scene_rays(ts, seed=23)
    h, c = trace_rays_bvh_wide(wide, o, d, lim, count=True)
    for a, b in zip(h, trace_rays_bvh_wide(wide, o, d, lim)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    ref = trace_rays_bruteforce(ts.tri_v0, ts.tri_e1, ts.tri_e2, o, d, lim, T_MIN)
    hit = h.tri.numpy() >= 0
    np.testing.assert_array_equal(hit, ref.tri.numpy() >= 0)
    closest = (lane != 1) & (lane != 5)
    for a, b in zip(h, ref):
        np.testing.assert_array_equal(a.numpy()[closest], b.numpy()[closest])
    assert hit[closest].mean() > 0.1 and hit[lane == 1].mean() > 0.05
    assert not hit[(lane == 3) | (lane == 4) | (lane == 5)].any()
    np.testing.assert_array_equal(h.t.numpy()[~hit], np.abs(lim.numpy())[~hit])
    nodes, leaves, records = c.nodes.numpy(), c.leaves.numpy(), c.records.numpy()
    root = int(wide.nodes.view(torch.int32)[0, 28])
    assert records.min() >= 1 and nodes.min() == root
    assert (nodes <= 4 * records).all() and (nodes >= 2 * records).all()
    assert (nodes < 4 * records).any()  # a record short of four children was read
    assert (leaves[hit] >= 1).all() and (leaves <= nodes).all()
    _, binary = trace_rays_bvh_ordered(bvh, o, d, lim, count=True)
    assert records.sum() <= binary.nodes.numpy().sum() // 2
    # the wrapper's count on the CPU is this walk
    hk, ck = trace_variant("ordered", probe_tables(bvh, ts), ts, o, d, lim, count=True)
    assert all(torch.equal(a, b) for a, b in zip(ck, c))
    assert all(torch.equal(a, b) for a, b in zip(hk, h))


def test_one_triangle_tree_and_stack_refusal():
    """A root that is a leaf is one record of one child; a tree whose walk
    fits the stack is walked, one that can need more is refused by the
    plain walk and by the wrapper on the CPU."""
    rng = np.random.default_rng(4)
    o = torch.from_numpy(np.c_[rng.uniform(-0.2, 1.0, (256, 2)), np.full(256, -1.0)]
                         .astype(np.float32))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(256, 1)
    lim = torch.full((256,), T_MAX)
    lim[::4] = -T_MAX
    one = _wide(*_caterpillar(1))
    assert one.nodes.shape == (1, 32) and one.stack == 0 and one.depth == 1
    assert one.nodes.view(torch.int32)[0, 24:30].tolist() == [~0, 0, 0, 0, 1, 0]
    for n, wide in ((1, one), (40, _wide(*_caterpillar(40)))):
        assert wide.stack <= WIDE_STACK
        tv0, te1, te2 = (torch.from_numpy(a) for a in _caterpillar(n)[:3])
        h, c = trace_rays_bvh_wide(wide, o, d, lim, count=True)
        for a, b in zip(h, trace_rays_bruteforce(tv0, te1, te2, o, d, lim, T_MIN)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())  # nearest: triangle 0
        assert 0.2 < (h.tri >= 0).float().mean() < 0.8
        # the root's children on every ray: the one triangle, or four of the 40
        assert int(c.nodes.min()) == (1 if n == 1 else 4) and int(c.records.min()) == 1
    deep = _wide(*_caterpillar(80))
    assert deep.stack > WIDE_STACK
    with pytest.raises(ValueError, match="stack entries"):
        trace_rays_bvh_wide(deep, o, d, lim)
    ts = _np_scene("box")
    tables = probe_tables(build_bvh(ts), ts)
    with pytest.raises(ValueError, match="stack entries"):
        trace_variant("ordered", dataclasses.replace(tables, wide=deep), ts, o, d, lim)
    with pytest.raises(ValueError, match="only ordered"):
        trace_variant("binary", tables, ts, o, d, lim, count=True)
