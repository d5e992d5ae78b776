"""Port vs JAX package for the trace-probe slice: the host modules the port
keeps its own copies of (config, glTF, PNG, the native SAH builder), the
city scene, the plain BVH walks (threaded and front to back) and the plain
versions of the probe kernels C-F, and the probe entry points on the CPU.

Tolerances: the module copies and ``make_city`` are equal (arrays
bit-equal). ``trace_rays_bvh`` against the JAX package's
``trace_closest_bvh`` / ``trace_any_bvh`` on the same node arrays: verdicts
exact, triangle ids equal except at equal-t ties (where t agrees), t within
1e-5 relative and u, v within 1e-5 absolute (XLA's CPU arithmetic
contracts some products, and t, a dot product with cancellation, moves by
more than a few ulp); its visit counts equal a numpy walk written here.
``trace_rays_bvh_ordered`` (kernel A's walk) and ``trace_rays_bvh_wide``
(kernel E's ``ordered``) by the same rule against the same JAX references,
and bit-equal to the port's brute force, triangle ids included. C: the miss record, exact. D and E: their plain
versions against the JAX plain references by the same rule. F: against
``benchmarks/scratch/vpupeak.py``'s kernel run through ``pl.pallas_call(...,
interpret=True)``: the plain version bit-equal to a fused numpy recurrence,
and the JAX kernel within 4 ulp of it (or bit-equal to the unfused one)."""

import base64
import collections
import ctypes
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import vkrt_tpu.config as jconfig
import vkrt_tpu.scene as jscene
import vkrt_tpu.utils.gltf as jgltf
import vkrt_tpu.utils.png as jpng
import vkrt_tpu_torch.config as tconfig
import vkrt_tpu_torch.scene as tscene
import vkrt_tpu_torch.utils.gltf as tgltf
import vkrt_tpu_torch.utils.native as tnative
import vkrt_tpu_torch.utils.png as tpng
from vkrt_tpu.ops.trace import (
    trace_any_bvh, trace_closest_bruteforce, trace_closest_bvh,
)
from vkrt_tpu_torch.ops.cuda.probes import fma_peak_plain, floor_kernel, floor_plain
from vkrt_tpu_torch.ops.cuda.trace import build_bvh, build_bvh_arrays
from vkrt_tpu_torch.ops.cuda.trace_variants import (
    node_depths, probe_tables, trace_ablate, trace_variant,
)
from vkrt_tpu_torch.ops.intersect import T_MAX, T_MIN
from vkrt_tpu_torch.ops.trace import (
    SLAB_SCALE, trace_rays_bruteforce, trace_rays_bvh, trace_rays_bvh_ordered,
    trace_rays_bvh_wide,
)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAYS = 1024
ANY_BOUND = 3.0
JBvh = collections.namedtuple("JBvh", "node_min node_max node_skip node_tri")


def _np(x) -> np.ndarray:
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _tnp(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def assert_equal_scenes(js, ts):
    assert tscene.SceneTensors._fields == jscene.SceneArrays._fields
    for k in jscene.SceneArrays._fields:
        want, got = _np(getattr(js, k)), _tnp(getattr(ts, k))
        assert got.shape == want.shape and got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


# --- module copies ------------------------------------------------------------


def test_config_copy_matches():
    path = os.path.join(REPO, "config.json")
    assert dataclasses.asdict(tconfig.load_config(path)) == \
        dataclasses.asdict(jconfig.load_config(path))
    assert dataclasses.asdict(tconfig.EngineConfig()) == \
        dataclasses.asdict(jconfig.EngineConfig())
    assert dataclasses.asdict(tconfig.RenderSettings()) == \
        dataclasses.asdict(jconfig.RenderSettings())
    assert tconfig.DEFAULT_CLEAR_COLOR == jconfig.DEFAULT_CLEAR_COLOR
    cfg = tconfig.load_config(path)
    for base in ([REPO], ["/nonexistent"]):
        assert tconfig.resolve_scene_path(cfg, base) == \
            jconfig.resolve_scene_path(jconfig.load_config(path), base)


def test_png_round_trip(tmp_path):
    img = np.random.default_rng(5).integers(0, 256, (13, 17, 4)).astype(np.uint8)
    for channels in (3, 4):
        blob = tpng.encode_png(img[..., :channels])
        assert blob == jpng.encode_png(img[..., :channels])
        got = tpng.decode_png(blob)
        np.testing.assert_array_equal(got, jpng.decode_png(blob))
        np.testing.assert_array_equal(got[..., :channels], img[..., :channels])
    tpng.write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(jpng.decode_png((tmp_path / "a.png").read_bytes()), img)


def _write_gltf(path):
    """A textured two-node glTF with an embedded buffer and PNG: normals
    and uvs but no tangents (so both bakes generate them), u32 indices, a
    TRS node and a matrix node, a point light."""
    rng = np.random.default_rng(6)
    pos = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    nrm = rng.normal(size=(6, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = rng.uniform(0, 2, (6, 2)).astype(np.float32)
    idx = np.array([0, 1, 2, 3, 4, 5, 0, 2, 4], np.uint32)
    png = tpng.encode_png(rng.integers(0, 256, (8, 8, 4)).astype(np.uint8))
    blob, views = b"", []
    for part in (pos.tobytes(), nrm.tobytes(), uv.tobytes(), idx.tobytes()):
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(part)})
        blob += part
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0, 1, 2]}],
        "nodes": [
            {"mesh": 0, "translation": [0.5, 0, -1], "rotation": [0, 0.3826834, 0, 0.9238795],
             "scale": [1, 2, 1]},
            {"mesh": 0, "matrix": [1, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0, 3, 0, 0, 1]},
            {"extensions": {"KHR_lights_punctual": {"light": 0}}, "translation": [0, 4, 0]},
        ],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "point", "color": [1, 0.5, 0.25], "intensity": 30.0}]}},
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                                   "TEXCOORD_0": 2},
                                    "indices": 3, "material": 0}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 6, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 6, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 6, "type": "VEC2"},
            {"bufferView": 3, "componentType": 5125, "count": 9, "type": "SCALAR"},
        ],
        "bufferViews": views,
        "buffers": [{"byteLength": len(blob), "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(blob).decode()}],
        "images": [{"uri": "data:image/png;base64," + base64.b64encode(png).decode(),
                    "name": "tex"}],
        "textures": [{"source": 0}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                                "metallicFactor": 0.2,
                                                "roughnessFactor": 0.7},
                       "emissiveFactor": [0.1, 0.0, 0.3]}],
    }
    path.write_text(json.dumps(doc))


def test_gltf_copy_parses_equal(tmp_path):
    path = tmp_path / "scene.gltf"
    _write_gltf(path)
    jd, td = jgltf.parse_gltf(str(path)), tgltf.parse_gltf(str(path))
    assert len(td.primitives) == len(jd.primitives) == 2
    for jp, tp in zip(jd.primitives, td.primitives):
        for f in ("positions", "indices", "normals", "tangents", "uvs", "world_matrix"):
            a, b = getattr(jp, f), getattr(tp, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(b, a, err_msg=f)
        assert tp.material == jp.material
    for group in ("materials", "lights", "images"):
        for ja, ta in zip(getattr(jd, group), getattr(td, group)):
            for f in dataclasses.fields(ja):
                np.testing.assert_array_equal(np.asarray(getattr(ta, f.name)),
                                              np.asarray(getattr(ja, f.name)), err_msg=f.name)
    # the textured bake of both packages, the bf16 mip atlas included
    assert_equal_scenes(jscene.load_scene(str(path)), tscene.load_scene(str(path), device="cpu"))


def _build_sah(lib_path, tris):
    """``build_sah_bvh`` of a library at ``lib_path`` (the same C ABI)."""
    lib = ctypes.CDLL(str(lib_path))
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    n = len(tris[0])
    out = [np.zeros((2 * n - 1, 3), np.float32), np.zeros((2 * n - 1, 3), np.float32),
           np.zeros(2 * n - 1, np.int32), np.zeros(2 * n - 1, np.int32)]
    ptrs = [a.ctypes.data_as(f32p if a.dtype == np.float32 else i32p) for a in [*tris, *out]]
    m = lib.vkrt_build_bvh(*ptrs[:3], n, 1, *ptrs[3:])
    return [a[:m] for a in out]


# native/Makefile's compile and link flags (less -Wall, which only warns)
JAX_NATIVE_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


def _compile(lib, source):
    """``source`` built with ``JAX_NATIVE_FLAGS`` into the library ``lib``."""
    subprocess.run(["c++", *JAX_NATIVE_FLAGS, "-o", str(lib), str(source)], check=True,
                   timeout=120)
    return lib


@pytest.mark.parametrize("kind", ["soup", "city"])
def test_native_builder_copy_matches(tmp_path, kind):
    """The port's builder (its own source and build, portable flags) gives
    the JAX package's arrays on the soup. On the city the JAX library,
    built with -march=native, contracts the SAH cost into FMAs and so flips
    a few near-tie splits: there the port's source built with the JAX
    Makefile's flags gives the JAX arrays exactly (the same builder).

    The JAX package's arrays come from its own source
    (``native/bvh_builder.cpp``) built with its Makefile's flags into this
    test's directory, not through ``vkrt_tpu/utils/native.py``: that loader
    builds one shared library in place for every process that finds it
    missing, and a process that opens it half written keeps ``None``."""
    js = jscene.make_random_soup(2048, 3) if kind == "soup" else jscene.make_city(grid=4)
    tris = [np.ascontiguousarray(np.asarray(getattr(js, k)), np.float32)
            for k in ("tri_v0", "tri_e1", "tri_e2")]
    want = _build_sah(_compile(tmp_path / "libjax_native.so",
                               os.path.join(REPO, "native", "bvh_builder.cpp")), tris)
    got = tnative.build_sah_bvh(*tris)
    assert str(tnative.LIB_PATH).startswith(os.path.join(REPO, "vkrt_tpu_torch", "build"))
    if kind == "city":
        got_tree = got
        got = _build_sah(_compile(tmp_path / "libnative_march.so", tnative.SOURCE), tris)
        # the portable build: a valid threaded tree over the same triangles
        skip, tri = got_tree[2], got_tree[3]
        assert sorted(tri[tri >= 0]) == sorted(want[3][want[3] >= 0])
        assert (skip > np.arange(len(skip))).all() and skip.max() == len(skip)
    assert want is not None and len(got) == 4
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)


def test_make_city_matches():
    js, ts = jscene.make_city(grid=4), tscene.make_city(grid=4, device="cpu")
    assert_equal_scenes(js, ts)
    assert ts.num_tris == js.num_tris and tscene.scene_is_textured(ts)


# --- the plain BVH walk ---------------------------------------------------------


def _scene(kind):
    js = jscene.make_cornell_box() if kind == "box" else jscene.make_city(grid=4)
    ts = tscene.scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                                 device="cpu")
    return js, ts


def _rays(ts, seed=0, n=N_RAYS):
    rng = np.random.default_rng(seed)
    v0 = ts.tri_v0.numpy()
    o = rng.uniform(v0.min(0), v0.max(0), (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.fixture(scope="module", params=["box", "city"])
def case(request):
    """A scene in both packages, its node arrays, rays, and the JAX
    references on them (one compile each)."""
    js, ts = _scene(request.param)
    arrays = build_bvh_arrays(ts)
    bvh = build_bvh(ts)
    o, d = _rays(ts)
    jbvh = JBvh(*(jnp.asarray(a) for a in arrays))
    tris = (js.tri_v0, js.tri_e1, js.tri_e2)
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    ref = {
        "bvh": trace_closest_bvh(jbvh, *tris, jo, jd, T_MIN, T_MAX),
        "any": trace_any_bvh(jbvh, *tris, jo, jd, T_MIN, ANY_BOUND),
        "brute": trace_closest_bruteforce(*tris, jo, jd, T_MIN, T_MAX),
        "mt64": trace_closest_bruteforce(*(t[:64] for t in tris), jo, jd, T_MIN, T_MAX),
    }
    return ts, bvh, o, d, {k: jax.tree_util.tree_map(np.asarray, v) for k, v in ref.items()}


def assert_hits_match(h, ref):
    """Port RayHits (closest, bound T_MAX) against a JAX HitInfo."""
    t, tri, u, v = (x.numpy() for x in h)
    hit = tri >= 0
    np.testing.assert_array_equal(hit, ref.hit)
    assert hit.mean() > 0.2
    np.testing.assert_allclose(t[hit], ref.t[hit], rtol=1e-5, atol=0)
    same = hit & (tri == ref.tri)
    assert same.sum() >= 0.95 * hit.sum()  # other winners only at (near-)equal t
    np.testing.assert_allclose(u[same], ref.u[same], rtol=0, atol=1e-5)
    np.testing.assert_allclose(v[same], ref.v[same], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t[~hit], T_MAX)  # the miss record
    assert (u[~hit] == 0).all() and (v[~hit] == 0).all()


def _numpy_walk(nodes, ts, o, d, lim):
    """Kernel A's walk, one ray at a time in numpy float32: (node visits,
    leaf visits) per ray."""
    f32 = np.float32
    tab = nodes.numpy()
    bits = tab.view(np.int32)
    v0, e1, e2 = (t.numpy() for t in (ts.tri_v0, ts.tri_e1, ts.tri_e2))
    scale, t_min = f32(SLAB_SCALE), f32(T_MIN)
    out = []
    for oo, dd, ll in zip(o.numpy(), d.numpy(), lim.numpy()):
        nudged = np.where(np.abs(dd) < f32(1e-20), np.where(dd < 0, f32(-1e-20), f32(1e-20)), dd)
        inv = (f32(1.0) / nudged).astype(f32)
        best, node, nv, nl = abs(ll), 0, 0, 0
        while node < len(tab):
            nv += 1
            t0 = (tab[node, 0:3] - oo) * inv
            t1 = (tab[node, 4:7] - oo) * inv
            tnear = max(max(max(min(t0[0], t1[0]), min(t0[1], t1[1])), min(t0[2], t1[2])), t_min)
            tfar = min(min(min(max(t0[0], t1[0]), max(t0[1], t1[1])), max(t0[2], t1[2])), best)
            skip, tri = bits[node, 3], bits[node, 7]
            if not tnear <= tfar * scale:
                node = skip
                continue
            if tri < 0:
                node += 1
                continue
            nl += 1
            a, b, c = v0[tri], e1[tri], e2[tri]
            p = np.array([dd[1] * c[2] - dd[2] * c[1], dd[2] * c[0] - dd[0] * c[2],
                          dd[0] * c[1] - dd[1] * c[0]], f32)
            det = b[0] * p[0] + b[1] * p[1] + b[2] * p[2]
            if abs(det) > f32(1e-9):
                inv_det = f32(1.0) / det
                tv = oo - a
                uu = (tv[0] * p[0] + tv[1] * p[1] + tv[2] * p[2]) * inv_det
                q = np.array([tv[1] * b[2] - tv[2] * b[1], tv[2] * b[0] - tv[0] * b[2],
                              tv[0] * b[1] - tv[1] * b[0]], f32)
                vv = (dd[0] * q[0] + dd[1] * q[1] + dd[2] * q[2]) * inv_det
                tt = (c[0] * q[0] + c[1] * q[1] + c[2] * q[2]) * inv_det
                if uu >= 0 and vv >= 0 and uu + vv <= 1 and tt > t_min and tt < best:
                    best = tt
            node = skip
        out.append((nv, nl))
    return np.array(out, np.int32)


def test_trace_rays_bvh_matches_jax(case):
    ts, bvh, o, d, ref = case
    nodes = bvh.threaded
    lim = torch.full((N_RAYS,), T_MAX)
    h, counts = trace_rays_bvh(nodes, ts, o, d, lim, count=True)
    assert_hits_match(h, ref["bvh"])
    assert all(torch.equal(a, b) for a, b in zip(h, trace_rays_bvh(nodes, ts, o, d, lim)))
    # any: first-hit-kills lanes bounded by ANY_BOUND; only the verdict
    kill = torch.full((N_RAYS,), -ANY_BOUND)
    h_any = trace_rays_bvh(nodes, ts, o, d, kill)
    np.testing.assert_array_equal(h_any.tri.numpy() >= 0, ref["any"])
    h_any2 = trace_rays_bvh(nodes, ts, o, d, -kill, any_hit=True)
    np.testing.assert_array_equal(h_any2.tri.numpy() >= 0, ref["any"])
    # the visit counts are the numpy walk's
    want = _numpy_walk(nodes, ts, o[:128], d[:128], lim[:128])
    np.testing.assert_array_equal(counts.nodes.numpy()[:128], want[:, 0])
    np.testing.assert_array_equal(counts.leaves.numpy()[:128], want[:, 1])
    assert (counts.leaves <= counts.nodes).all() and counts.nodes.min() >= 1


def test_trace_rays_bvh_ordered_matches_jax(case):
    """Kernel A's walk in plain torch against the JAX package's BVH and
    brute-force tracers on the same rays, and bit-equal to the port's
    brute force."""
    ts, bvh, o, d, ref = case
    lim = torch.full((N_RAYS,), T_MAX)
    h, counts = trace_rays_bvh_ordered(bvh, o, d, lim, count=True)
    assert_hits_match(h, ref["bvh"])
    assert_hits_match(h, ref["brute"])
    for a, b in zip(h, trace_rays_bruteforce(ts.tri_v0, ts.tri_e1, ts.tri_e2, o, d, lim)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    kill = torch.full((N_RAYS,), -ANY_BOUND)
    for h_any in (trace_rays_bvh_ordered(bvh, o, d, kill),
                  trace_rays_bvh_ordered(bvh, o, d, -kill, any_hit=True)):
        np.testing.assert_array_equal(h_any.tri.numpy() >= 0, ref["any"])
    _, threaded = trace_rays_bvh(bvh.threaded, ts, o, d, lim, count=True)
    assert int(counts.nodes.sum()) <= int(threaded.nodes.sum())


def test_trace_rays_bvh_wide_matches_jax(case):
    """Kernel E's wide walk in plain torch against the JAX package's BVH and
    brute-force tracers on the same rays (as the binary walk above), and
    bit-equal to the port's brute force."""
    ts, bvh, o, d, ref = case
    wide = probe_tables(bvh, ts).wide
    lim = torch.full((N_RAYS,), T_MAX)
    h, counts = trace_rays_bvh_wide(wide, o, d, lim, count=True)
    assert_hits_match(h, ref["bvh"])
    assert_hits_match(h, ref["brute"])
    for a, b in zip(h, trace_rays_bruteforce(ts.tri_v0, ts.tri_e1, ts.tri_e2, o, d, lim)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    h_any = trace_rays_bvh_wide(wide, o, d, torch.full((N_RAYS,), -ANY_BOUND))
    np.testing.assert_array_equal(h_any.tri.numpy() >= 0, ref["any"])
    hit = h.tri.numpy() >= 0
    assert int(counts.records.min()) >= 1
    assert (counts.nodes >= 2 * counts.records).all()
    assert (counts.nodes <= 4 * counts.records).all()
    assert (counts.leaves.numpy()[hit] >= 1).all()
    _, threaded = trace_rays_bvh(bvh.threaded, ts, o, d, lim, count=True)
    assert int(counts.leaves.sum()) <= int(threaded.leaves.sum())


@pytest.mark.parametrize("kind", ["box", "city"])
def test_probe_tables_of_kernel_e(kind):
    """The tables only kernel E reads: the threaded table with leaf slots
    (``bvh.tris[slot]`` is the leaf's triangle), the cut's rows of it with
    ~(first child) at inner nodes, the triangle records in scene order."""
    _, ts = _scene(kind)
    bvh = build_bvh(ts)
    tables = probe_tables(bvh, ts)
    old, new = bvh.threaded.numpy(), tables.threaded.numpy()
    np.testing.assert_array_equal(new[:, :7], old[:, :7])
    tri, slot = old.view(np.int32)[:, 7], new.view(np.int32)[:, 7]
    leaf = tri >= 0
    assert (slot[~leaf] == -1).all()
    np.testing.assert_array_equal(bvh.tris.numpy().view(np.int32)[slot[leaf], 3], tri[leaf])
    cut, boxes = tables.cut.numpy(), tables.cut_boxes.numpy()
    np.testing.assert_array_equal(boxes[:, :7], new[cut, :7])
    np.testing.assert_array_equal(boxes.view(np.int32)[:, 7],
                                  np.where(leaf[cut], slot[cut], ~(cut + 1)))
    rec = tables.scene_tris.numpy()
    n = ts.tri_v0.shape[0]
    np.testing.assert_array_equal(rec.view(np.int32)[:, 3], np.arange(n))
    for col, t in ((0, ts.tri_v0), (4, ts.tri_e1), (8, ts.tri_e2)):
        np.testing.assert_array_equal(rec[:, col:col + 3], t.numpy())
    assert tables.wide.tris is bvh.tris and tables.wide.nodes.shape[1] == 32


def test_node_depths_and_cut():
    _, ts = _scene("city")
    tables = probe_tables(build_bvh(ts), ts)
    bits = tables.bvh.threaded.numpy().view(np.int32)
    skip, tri = bits[:, 3], bits[:, 7]
    depth = tables.depth.numpy()
    # recursive reference: the children of inner node i are i + 1 and skip[i + 1]
    want = np.full(len(skip), -1)
    stack = [(0, 0)]
    while stack:
        i, k = stack.pop()
        want[i] = k
        if tri[i] < 0:
            stack += [(i + 1, k + 1), (int(skip[i + 1]), k + 1)]
    np.testing.assert_array_equal(depth, want)
    np.testing.assert_array_equal(node_depths(skip.astype(np.int64), tri), want)
    assert tables.max_depth == want.max() and tables.cut_depth == 1  # 256 tris
    # the cut's subtrees cover every leaf exactly once
    cut = tables.cut.numpy()
    covered = np.zeros(len(skip), int)
    for c in cut:
        covered[c:skip[c]] += 1
    np.testing.assert_array_equal(covered[tri >= 0], 1)


# --- plain versions of the probe kernels ----------------------------------------


def test_floor_plain_is_the_miss_record():
    o, d = torch.zeros((6, 3)), torch.ones((6, 3))
    lim = torch.tensor([1e4, -2.5, 0.0, -0.0, 3.0, -1.0])
    for h in (floor_plain(o, d, lim), floor_kernel(o, d, lim, 512)):
        np.testing.assert_array_equal(h.t.numpy(), np.abs(lim.numpy()))
        assert (h.tri == -1).all() and (h.u == 0).all() and (h.v == 0).all()
        assert h.tri.dtype == torch.int32


@pytest.mark.parametrize("mode", ["full", "boxes", "top", "count"])
def test_trace_ablate_plain(case, mode):
    ts, bvh, o, d, ref = case
    tables = probe_tables(bvh, ts)
    lim = torch.full((N_RAYS,), T_MAX)
    hits, counts = trace_ablate(mode, tables, ts, o, d, lim)
    if mode in ("boxes", "top"):
        assert counts is None
        np.testing.assert_array_equal(hits.t.numpy(), T_MAX)
        assert (hits.tri == -1).all() and (hits.u == 0).all() and (hits.v == 0).all()
        return
    assert_hits_match(hits, ref["brute" if mode == "full" else "bvh"])
    assert (counts is None) == (mode == "full")
    if counts is not None:
        _, want = trace_rays_bvh_ordered(bvh, o, d, lim, count=True)
        assert torch.equal(counts.nodes, want.nodes) and torch.equal(counts.leaves, want.leaves)


@pytest.mark.parametrize("variant", ["threaded", "binary", "ordered", "flat", "mt64"])
def test_trace_variant_plain(case, variant):
    ts, bvh, o, d, ref = case
    tables = probe_tables(bvh, ts)
    hits = trace_variant(variant, tables, ts, o, d, torch.full((N_RAYS,), T_MAX))
    assert_hits_match(hits, ref["mt64" if variant == "mt64" else "brute"])


def test_probe_names_refused():
    _, ts = _scene("box")
    tables = probe_tables(build_bvh(ts), ts)
    o, d = _rays(ts, n=8)
    lim = torch.full((8,), T_MAX)
    for bad in ("dyn4", "bit4", "mt0", "mt", "plain", "mt999"):
        with pytest.raises(ValueError):
            trace_variant(bad, tables, ts, o, d, lim)
    with pytest.raises(ValueError):
        trace_ablate("votes", tables, ts, o, d, lim)
    with pytest.raises(ValueError):
        fma_peak_plain(torch.ones(4), 100)


def _fma_recurrence(x: np.ndarray, steps: int, fused: bool) -> np.ndarray:
    """vpupeak's recurrence in numpy: 8 chains from x * (0.9 + 0.01 i), each
    ``steps`` times a = a * c + 1e-7, summed in order. ``fused``: each step
    in float64 (exact here) rounded once to float32, as one FMA rounds;
    else a * c and + b each rounded to float32."""
    c, b = np.float32(1.0000001), np.float32(1e-7)
    a = [x * np.float32(0.9 + 0.01 * i) for i in range(8)]
    for _ in range(steps):
        if fused:
            a = [(ai.astype(np.float64) * np.float64(c) + np.float64(b)).astype(np.float32)
                 for ai in a]
        else:
            a = [ai * c + b for ai in a]
    out = a[0]
    for ai in a[1:]:
        out = out + ai
    return out


@pytest.mark.parametrize("k", [64, 512])
def test_fma_peak_plain_matches_vpupeak(monkeypatch, k):
    """The plain version against the JAX probe's kernel in interpret mode
    (TILES = 2); ``vpupeak`` reads K from ``sys.argv`` at import.

    The plain version is bit-equal to the fused numpy recurrence above. The
    JAX kernel is within 4 ulp of it (XLA's CPU code contracts a * c + 1e-7
    into one FMA inside the loop; at K = 64 its one iteration rounds a few
    steps otherwise), or bit-equal to the unfused recurrence. 4 ulp is
    under half of what the K FMAs move every output, which is checked too."""
    monkeypatch.setattr(sys, "argv", ["vpupeak", str(k), "2", "1"])
    vp = importlib.reload(importlib.import_module("benchmarks.scratch.vpupeak"))
    assert vp.K == k
    x = np.random.default_rng(7).uniform(0.1, 2.0, (2 * 8, 128)).astype(np.float32)
    want = np.asarray(pl.pallas_call(
        vp.kernel, grid=(2,),
        in_specs=[pl.BlockSpec((8, 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((16, 128), jnp.float32), interpret=True,
    )(jnp.asarray(x)))
    fused = _fma_recurrence(x, k // 8, fused=True)
    ulp = np.spacing(fused)
    assert (np.abs(fused - _fma_recurrence(x, 0, fused=True)) > 8 * ulp).all()
    np.testing.assert_array_equal(fma_peak_plain(torch.from_numpy(x), k).numpy(), fused)
    assert ((np.abs(want - fused) <= 4 * ulp).all()
            or np.array_equal(want, _fma_recurrence(x, k // 8, fused=False)))


# --- the entry points on the CPU ------------------------------------------------


@pytest.mark.parametrize("entry,argv", [
    ("micro_trace", ["--width", "64", "--height", "16", "--iters", "1"]),
    ("ablate_kernel", ["cornell", "--width", "64", "--height", "16", "--iters", "1"]),
    ("variants", ["cornell", "threaded", "binary", "ordered", "flat", "mt64",
                  "--width", "64", "--height", "16", "--iters", "1", "--incoherent"]),
    ("vpupeak", ["128", "2", "1"]),
])
def test_entry_points_on_the_cpu(capsys, entry, argv):
    mod = importlib.import_module(f"vkrt_tpu_torch.benchmarks.{entry}")
    mod.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "device=cpu" in out
    if not torch.cuda.is_available():  # the default is the card: no fall back
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(argv)
