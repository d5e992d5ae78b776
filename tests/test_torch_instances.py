"""The port's instance layer (``vkrt_tpu_torch/scene_instances.py``) and
kernel A's refit (``ops/cuda/trace.py::refit_bvh``) against
``vkrt_tpu/scene_instances.py`` and tests/test_instances.py:

* the six tests of tests/test_instances.py: ``repose`` splices what the JAX
  package's ``repose`` splices, bit for bit, and what a fresh bake gives
  within atol 1e-6 (the JAX test's tolerance: a re-pose forms the edges
  ``v1 - v0`` in f64 from the f32 ``v0``, a build subtracts two f32
  arrays); the brute-force tracer sees the move; the walk over refit
  tables is bit-equal (t, tri, u, v as uint32) to brute force and to the
  walk over a fresh build (the ``bvh`` backend re-posed rebuilds its
  LBVH: ``build_lbvh`` of the re-posed scene bit for bit, hits bit-equal
  to brute force); the rows a refit rewrites are those of the
  moved triangles and their ancestors, the rest stay bit for bit;
  ``Engine.set_node_transform`` changes the image only where the node
  moved; a re-pose runs no native SAH build;
* a refit of unmoved geometry reproduces ``build_bvh``'s three tables bit
  for bit (the leaf boxes are formed as the native builder forms them);
* the alpha tracer re-posed wraps its inner tracer, rebound;
* the port's engine re-posed against the JAX package's frames on its
  re-posed scene (its brute-force tracer, eager), path mode and hybrid with
  GI: the display gate of tests/test_accuracy_oracle.py:83-88 and rays
  within 0.1%."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vkrt_tpu.scene_instances as jsi
from test_torch_hybrid_engine import jax_engine_frames
from test_torch_pathtracer import display_gate
from vkrt_tpu.config import RenderSettings as JSettings
from vkrt_tpu.models.pathtracer import pathtrace_frame as j_pathtrace_frame
from vkrt_tpu.models.post import composite as j_composite
from vkrt_tpu.ops.rng import tea as j_tea
from vkrt_tpu.ops.trace import make_tracer as j_make_tracer
from vkrt_tpu.utils import gltf as jgltf
from vkrt_tpu.utils.camera import Camera as JCamera, pixel_coords as j_pixel_coords, tile_perm
from vkrt_tpu_torch.bvh.lbvh import build_lbvh
from vkrt_tpu_torch.config import RenderSettings
from vkrt_tpu_torch.engine import Engine
from vkrt_tpu_torch.ops.alpha import AlphaTracer
from vkrt_tpu_torch.ops.cuda import trace as ktrace
from vkrt_tpu_torch.ops.cuda.trace_variants import LbvhTracer
from vkrt_tpu_torch.ops.trace import (
    Tracer, make_tracer, trace_rays_bruteforce, trace_rays_bvh_ordered,
)
from vkrt_tpu_torch.scene import make_random_soup
from vkrt_tpu_torch.scene_instances import build_instanced, repose, repose_tracer
from vkrt_tpu_torch.utils import gltf as tgltf
from vkrt_tpu_torch.utils.camera import Camera

torch.set_num_threads(2)
W, H = 48, 32
CLEAR = (1.0, 1.0, 1.0, 1.0)
POSED = ("tri_v0", "tri_e1", "tri_e2", "corner_normal", "corner_tangent", "tri_uv_density")


def _cube(mod, center, half=1.0):
    p = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                  [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32) * half
    quads = [(4, 5, 6, 7), (1, 0, 3, 2), (5, 1, 2, 6), (0, 4, 7, 3), (7, 6, 2, 3), (0, 1, 5, 4)]
    idx = [i for a, b, c, d in quads for i in (a, b, c, a, c, d)]
    return mod.GltfPrimitiveInstance(
        positions=p, indices=np.asarray(idx, np.uint32), normals=None, tangents=None,
        uvs=None, material=0, world_matrix=_translate(*center))


def _doc(mod=tgltf, alpha=None):
    """tests/test_instances.py's document in the gltf module ``mod`` of
    either package: two cubes, one grey material (BLEND at ``alpha`` when
    given), a point light above them."""
    a = 1.0 if alpha is None else alpha
    mats = [mod.GltfMaterial(np.array([0.8, 0.8, 0.8, a], np.float32), metallic_factor=0.0,
                             alpha_mode=0 if alpha is None else 2)]
    lights = [mod.GltfLight(np.array([0, 8, 0.0], np.float32), np.ones(3, np.float32), 60.0, 0)]
    return mod.GltfDocument(primitives=[_cube(mod, (-3, 0, 0)), _cube(mod, (3, 0, 0))],
                            materials=mats, lights=lights, images=[])


def _translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def _probe_rays(n=256):
    rng = np.random.default_rng(7)
    orig = np.zeros((n, 3), np.float32)
    orig[:, 2] = 12.0
    orig[:, 0] = rng.uniform(-7, 7, n)
    orig[:, 1] = rng.uniform(-3, 3, n)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = -1.0
    return torch.from_numpy(orig), torch.from_numpy(d)


def _random_rays(n, seed, lo, hi):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def _bits(h):
    return [x.numpy().view(np.uint32) for x in h]


def _assert_bits(a, b):
    for field, x, y in zip(("t", "tri", "u", "v"), _bits(a), _bits(b)):
        np.testing.assert_array_equal(x, y, err_msg=field)


def test_repose_matches_jax_repose():
    """``repose`` splices what the JAX package's splices, bit for bit, keeps
    the host mirrors equal to the device tensors and marks the moved range;
    against a fresh bake within the JAX test's atol 1e-6."""
    m = _translate(3, 2.5, 0)
    inst = build_instanced(_doc(), device="cpu")
    inst2, moved = repose(inst, 1, m)
    jinst2, jmoved = jsi.repose(jsi.build_instanced(_doc(jgltf)), 1, m)
    for name in POSED:
        got, want = getattr(inst2.scene, name).numpy(), np.asarray(getattr(jinst2.scene, name))
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=name)
    for name, mirror in inst2.host.items():
        np.testing.assert_array_equal(mirror, getattr(inst2.scene, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(moved, jmoved)

    doc_fresh = _doc()
    doc_fresh.primitives[1].world_matrix = m
    fresh = build_instanced(doc_fresh, device="cpu").scene
    for name in POSED:
        np.testing.assert_allclose(getattr(inst2.scene, name).numpy(),
                                   getattr(fresh, name).numpy(), atol=1e-6, err_msg=name)
    s, e = inst.prim_ranges[1]
    assert moved[s:e].all() and not moved[:s].any()
    # copy on write: the earlier pose and its mirrors are untouched
    assert not torch.equal(inst.scene.tri_v0, inst2.scene.tri_v0)
    np.testing.assert_array_equal(inst.host["tri_v0"], inst.scene.tri_v0.numpy())
    # only geometry is replaced: the material and texture tensors are the same objects
    for name in ("mat_base_tex", "mat_normal_tex", "tex_rgba", "tri_mat", "corner_uv"):
        assert getattr(inst2.scene, name) is getattr(inst.scene, name), name


def test_repose_oracle_tracer_sees_move():
    inst = build_instanced(_doc(), device="cpu")
    tr = make_tracer(inst.scene, "bruteforce")
    o, d = _probe_rays()
    before = tr.closest(o, d, 1e-3, 100.0)

    inst2, moved = repose(inst, 1, _translate(3, 0, -6))
    tr2 = repose_tracer(tr, inst2, moved)
    assert type(tr2) is Tracer
    after = tr2.closest(o, d, 1e-3, 100.0)

    # the moved cube's front face goes z=1 -> z=-5; from z=12 the hit
    # distance becomes 17 (was 11)
    x, y = o[:, 0].numpy(), o[:, 1].numpy()
    sel = (np.abs(x - 3) < 0.8) & (np.abs(y) < 0.8)
    assert before.hit.numpy()[sel].all() and after.hit.numpy()[sel].all()
    np.testing.assert_allclose(before.t.numpy()[sel], 11.0, atol=1e-3)
    np.testing.assert_allclose(after.t.numpy()[sel], 17.0, atol=1e-3)
    sel0 = (np.abs(x + 3) < 0.8) & (np.abs(y) < 0.8)
    np.testing.assert_array_equal(after.t.numpy()[sel0], before.t.numpy()[sel0])


@pytest.mark.parametrize("backend", ["pallas", "bvh"])
def test_refit_walk_bit_equal_to_brute_force_and_fresh_build(backend):
    """Kernel A's tracer (its plain version here) re-posed: the
    front-to-back walk over the refit tables is bit-equal to brute force
    and to the walk over a fresh build, on the probe rays and on random
    rays from inside the scene. The ``bvh`` backend re-posed rebuilds its
    LBVH: the tree is ``build_lbvh`` of the re-posed scene bit for bit, its
    tables are ``threaded_tables`` of that tree, and its hits are brute
    force's bit for bit."""
    inst = build_instanced(_doc(), device="cpu")
    tr = make_tracer(inst.scene, backend, tri_arrays=inst.tri_arrays())
    for prim, m in ((0, _translate(-3, -1, -4)), (1, _translate(2, 1.5, 1))):
        inst, moved = repose(inst, prim, m)
        tr = repose_tracer(tr, inst, moved)
    sc = inst.scene
    assert tr.scene is sc
    if backend == "bvh":
        assert isinstance(tr, LbvhTracer)
        want = build_lbvh(sc.tri_v0, sc.tri_e1, sc.tri_e2)
        tables = ktrace.threaded_tables(want, sc.tri_v0, sc.tri_e1, sc.tri_e2)
        for got, ref in zip((*tr.flat, tr.nodes, tr.tris), (*want, *tables)):
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          ref.numpy().view(np.uint32))
    else:
        assert isinstance(tr, ktrace.CudaTracer)
        fresh = ktrace.build_bvh(sc)
    for o, d in (_probe_rays(128), _random_rays(512, 1, -6.0, 6.0)):
        lim = torch.full((o.shape[0],), 100.0)
        brute = trace_rays_bruteforce(sc.tri_v0, sc.tri_e1, sc.tri_e2, o, d, lim)
        if backend == "bvh":
            walk = tr.trace(o, d, lim)
            _assert_bits(walk, brute)
        else:
            walk = trace_rays_bvh_ordered(tr.bvh, o, d, lim)
            _assert_bits(walk, brute)
            _assert_bits(walk, trace_rays_bvh_ordered(fresh, o, d, lim))
            _assert_bits(tr.trace(o, d, lim), walk)
        assert int((walk.tri >= 0).sum()) > 0


def _tables(bvh):
    return {k: getattr(bvh, k).numpy().view(np.uint32) for k in ("nodes", "tris", "threaded")}


def test_refit_rows_scale_with_subset():
    """A refit keeps the topology and rewrites only the moved triangles'
    rows and their ancestors' (a strict subset), counted in
    ``refit_bvh.rows``; every other row stays bit for bit."""
    inst = build_instanced(_doc(), device="cpu")
    bvh = ktrace.build_bvh(inst.scene, inst.tri_arrays())
    inst2, moved = repose(inst, 1, _translate(3, 4, 0))
    rows0 = dict(ktrace.refit_bvh.rows)
    bvh2 = ktrace.refit_bvh(bvh, *inst2.tri_arrays(), moved)
    rows = {k: ktrace.refit_bvh.rows[k] - rows0[k] for k in rows0}

    h = bvh.host
    leaves = h.node_of_tri[np.nonzero(moved)[0]]
    dirty, frontier = set(leaves.tolist()), leaves
    while frontier.size:
        frontier = h.parent[frontier]
        frontier = frontier[frontier >= 0]
        dirty.update(frontier.tolist())
    dirty = np.asarray(sorted(dirty))
    inner = dirty[h.tri[dirty] < 0]
    assert rows == {"records": len(inner), "tris": len(leaves), "threaded": len(dirty)}
    assert 0 < len(dirty) < bvh.threaded.shape[0]

    old, new = _tables(bvh), _tables(bvh2)
    want_changed = {"nodes": h.ref[inner], "tris": ~h.ref[leaves], "threaded": dirty}
    for k in old:
        changed = np.nonzero((old[k] != new[k]).any(1))[0]
        assert set(changed) <= set(want_changed[k].tolist()), k
        assert changed.size > 0, k
    # the topology stays: skip links, leaf triangles, references and depths
    np.testing.assert_array_equal(old["threaded"][:, [3, 7]], new["threaded"][:, [3, 7]])
    np.testing.assert_array_equal(old["nodes"][:, [3, 7, 11]], new["nodes"][:, [3, 7, 11]])
    assert bvh2.depth == bvh.depth
    # the earlier tables are untouched (copy on write) and a no-op refit
    # returns the same object
    assert _tables(bvh)["nodes"].tobytes() == old["nodes"].tobytes()
    assert ktrace.refit_bvh(bvh, *inst.tri_arrays(), np.zeros(len(moved), bool)) is bvh


@pytest.mark.parametrize("scene", ["cubes", "soup"])
def test_identity_refit_equals_build(scene):
    """A refit of every triangle on unmoved geometry reproduces
    ``build_bvh``'s three tables bit for bit."""
    if scene == "cubes":
        sc = build_instanced(_doc(), device="cpu").scene
    else:
        sc = make_random_soup(3000, seed=4, device="cpu")
    bvh = ktrace.build_bvh(sc)
    tri = [t.numpy() for t in (sc.tri_v0, sc.tri_e1, sc.tri_e2)]
    live = (np.abs(tri[1]) + np.abs(tri[2])).any(1)  # padding stays out of the tree
    again = ktrace.refit_bvh(bvh, *tri, live)
    for k, a in _tables(bvh).items():
        np.testing.assert_array_equal(_tables(again)[k], a, err_msg=k)


def test_refit_refuses_a_triangle_outside_the_tree():
    """A padding triangle (degenerate at build time, so not in the tree)
    that a caller gives an area cannot be refit: it raises."""
    sc = build_instanced(_doc(), device="cpu").scene  # 24 triangles padded to 64
    bvh = ktrace.build_bvh(sc)
    tri = [t.numpy().copy() for t in (sc.tri_v0, sc.tri_e1, sc.tri_e2)]
    moved = np.zeros(len(tri[0]), bool)
    moved[30] = True
    assert ktrace.refit_bvh(bvh, *tri, moved) is bvh  # still degenerate: left out
    tri[1][30] = (1.0, 0.0, 0.0)
    tri[2][30] = (0.0, 1.0, 0.0)
    with pytest.raises(ValueError, match="not in the tree"):
        ktrace.refit_bvh(bvh, *tri, moved)


@pytest.mark.parametrize("backend", ["bruteforce", "pallas"])
def test_engine_set_node_transform(backend):
    """Move a node through the Engine: the image changes where (and only
    where) the node moved, and the frame restarts."""
    inst = build_instanced(_doc(), device="cpu")
    cam = Camera(eye=(0, 0, 12.0), center=(0, 0, 0.0))
    e = Engine(inst, W, H, RenderSettings(rt_mode=1, samples=1, depth=1, backend=backend), cam)
    img_before = e.render_frame().numpy().reshape(H, W, 3)
    e.set_node_transform(1, _translate(3, 0, -40))  # the right cube far away
    assert e.frame == -1
    assert e.scene is e.instances.scene and e.tracer.scene is e.scene
    img_after = e.render_frame().numpy().reshape(H, W, 3)
    np.testing.assert_allclose(img_after[:, :20], img_before[:, :20], atol=1e-6)
    assert np.abs(img_after[:, 28:] - img_before[:, 28:]).max() > 1e-3
    plain = Engine(inst.scene, W, H, RenderSettings(rt_mode=1), cam)
    with pytest.raises(ValueError, match="InstancedScene"):
        plain.set_node_transform(1, _translate(3, 0, 0))


def test_repose_runs_no_native_build(monkeypatch):
    """Re-posing under kernel A's tracer refits: the native SAH builder is
    not called (it raises here), in the engine or through repose_tracer."""
    inst = build_instanced(_doc(), device="cpu")
    e = Engine(inst, W, H, RenderSettings(rt_mode=1, depth=1, backend="pallas"),
               Camera(eye=(0, 0, 12.0), center=(0, 0, 0.0)))
    e.render_frame()

    def no_build(*args, **kw):
        raise AssertionError("a native SAH build ran after a repose")

    monkeypatch.setattr(ktrace.native, "build_sah_bvh", no_build)
    for f in range(3):
        e.set_node_transform(f % 2, _translate(3 * (-1) ** (f + 1), 0.2 * f, -f))
        e.render_frame()
    assert isinstance(e.tracer, ktrace.CudaTracer)


def test_alpha_tracer_reposed():
    """An ``AlphaTracer`` re-posed wraps its inner tracer, rebound (refit),
    keeping its rounds and seed; its hits see the move, as brute force
    through the JAX package's alpha rule does on the same hits (opacity
    0.5 BLEND: some lanes punch through the moved cube)."""
    inst = build_instanced(_doc(alpha=0.5), device="cpu")
    tr = make_tracer(inst.scene, "pallas", alpha=True, tri_arrays=inst.tri_arrays())
    assert isinstance(tr, AlphaTracer) and isinstance(tr.inner, ktrace.CudaTracer)
    seeded = tr.with_seed(torch.arange(256, dtype=torch.int64))
    inst2, moved = repose(inst, 1, _translate(3, 0, -6))
    tr2 = repose_tracer(seeded, inst2, moved)
    assert isinstance(tr2, AlphaTracer) and isinstance(tr2.inner, ktrace.CudaTracer)
    assert tr2.scene is inst2.scene and tr2.inner.scene is inst2.scene
    assert tr2.rounds == seeded.rounds and tr2.seed is seeded.seed
    o, d = _probe_rays()
    got = tr2.closest(o, d, 1e-3, 100.0)
    want = AlphaTracer(inst2.scene, Tracer(inst2.scene), seed=seeded.seed).closest(
        o, d, 1e-3, 100.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    x, y = o[:, 0].numpy(), o[:, 1].numpy()
    sel = (np.abs(x - 3) < 0.8) & (np.abs(y) < 0.8) & got.hit.numpy()
    assert sel.any() and (got.t.numpy()[sel] > 15.0).all()  # hits on the moved cube


def _jax_path_frames(js, frames, depth, jcam):
    """The JAX package's path frames, eager, on its brute-force tracer:
    tile-ordered pixels seeded by their pixel ids, the composite, scanline
    order. Returns (image (N,3), rays)."""
    perm, inv = tile_perm(W, H)
    pix = jnp.take(j_pixel_coords(W, H), jnp.asarray(perm), axis=0)
    pid = jnp.asarray(perm.astype(np.uint32))
    jt = j_make_tracer(js, "bruteforce")
    cam = jcam.matrices(W, H)
    accum, rays = jnp.zeros((W * H, 3), jnp.float32), 0.0
    for f in range(frames):
        accum, r = j_pathtrace_frame(js, jt, cam, f, accum, jnp.asarray(CLEAR), width=W,
                                     height=H, samples=1, depth=depth, corr=True, pix=pix,
                                     seeds=j_tea(pid, jnp.uint32(f)))
        rays += float(r)
    out = j_composite(None, jnp.concatenate([accum, jnp.ones_like(accum[:, :1])], 1),
                      rt_mode=1, view_accumulated=False, use_gi=False)
    return np.asarray(out, np.float64)[inv], rays


@pytest.mark.parametrize("mode", ["path", "hybrid-gi"])
def test_engine_matches_jax_after_repose(mode):
    """The port's engine, one frame, ``set_node_transform``, two frames,
    against the JAX package's two frames on its ``repose``d scene."""
    move = _translate(3, 1.5, -4)
    jinst, _ = jsi.repose(jsi.build_instanced(_doc(jgltf)), 1, move)
    jcam = JCamera(eye=(0.0, 0.0, 12.0), center=(0.0, 0.0, 0.0))
    if mode == "path":
        settings = RenderSettings(rt_mode=1, depth=3, corr_sampler=True)
        want, rays_j = _jax_path_frames(jinst.scene, 2, 3, jcam)
    else:
        settings = RenderSettings(rt_mode=0, depth=3, use_gi=True, corr_sampler=True)
        want, rays_j = jax_engine_frames(
            jinst.scene, JSettings(rt_mode=0, depth=3, use_gi=True, corr_sampler=True), 2,
            jcam=jcam, w=W, h=H)
    eng = Engine(build_instanced(_doc(), device="cpu"), W, H, settings,
                 Camera(eye=(0.0, 0.0, 12.0), center=(0.0, 0.0, 0.0)), CLEAR)
    first = eng.render_frame().numpy()
    eng.set_node_transform(1, move)
    r0 = eng.total_rays
    for _ in range(2):
        got = eng.render_frame().numpy().astype(np.float64)
    assert np.isfinite(got).all()
    display_gate(got, want)
    assert abs(eng.total_rays - r0 - rays_j) <= 1e-3 * rays_j, (eng.total_rays - r0, rays_j)
    assert np.abs(got - first).max() > 1e-2  # the move shows
