"""The CUDA kernels against their plain versions on the card (the checks of
chip_smoke.py's phases 2 and 3, at test sizes). Marked ``gpu``; each test
skips without a CUDA device (decided in the fixture, not at import).

Run on the card: ``python -m pytest tests/test_torch_kernels_gpu.py -q``.
Tolerances: kernel A's verdicts equal brute force's on every lane, and its
closest lanes are bit-equal to it, triangle id included (the walk gives an
equal-t tie to the lower id, as brute force does); shade masks equal on >= 99.9% of lanes, seeds bit-equal there, float
columns within 1e-4 relative (1e-6 absolute) on >= 99% of lanes; kernel
B's albedo instantiation on lanes that fetch nothing within 1e-6 relative
of the untextured one on >= 99.9% of lanes."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return torch.device("cuda")


def _rays(n, seed, device, extent):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lim = np.full(n, 1e4)
    lane = rng.integers(0, 6, n)
    lim[lane == 1] = -rng.uniform(0.05, 3.0, (lane == 1).sum())
    lim[lane == 2] = rng.uniform(0.05, 2.0, (lane == 2).sum())
    lim[lane == 3] = 0.0
    lim[lane == 4] = -0.0
    o[lane == 5] = 1e30
    d[lane == 5] = 0.0
    lim[lane == 5] = -1.0
    return tuple(torch.tensor(a.astype(np.float32), device=device) for a in (o, d, lim))


def _scene(kind, device):
    from vkrt_tpu_torch.scene import make_city, make_cornell_box, make_random_soup

    if kind == "box":
        return make_cornell_box(device=device), 4.5
    if kind == "soup":
        return make_random_soup(4096, device=device), 1.5
    return make_city(grid=16, device=device), 20.0


def _launches(entry: str) -> int:
    from vkrt_tpu_torch import device as kdev

    return kdev.counts[entry]["launches"]


@pytest.mark.parametrize("kind", ["box", "soup", "city"])
def test_trace_kernel_matches_bruteforce(cuda, kind):
    from vkrt_tpu_torch.ops.cuda.trace import make_cuda_tracer, trace_kernel
    from vkrt_tpu_torch.ops.trace import trace_rays_bruteforce

    scene, extent = _scene(kind, cuda)
    tracer = make_cuda_tracer(scene)
    o, d, lim = _rays(1 << 15, 1, cuda, extent)
    before = _launches("vkrt_trace")
    k = trace_kernel(tracer.bvh, scene, o, d, lim)
    assert _launches("vkrt_trace") == before + 1
    p = trace_rays_bruteforce(scene.tri_v0, scene.tri_e1, scene.tri_e2, o, d, lim)
    assert torch.equal(k.tri >= 0, p.tri >= 0)
    assert (k.tri >= 0).float().mean() > 0.05
    closest = ~(lim < 0)
    for a, b in zip(k, p):  # t, tri, u, v bit-equal on closest lanes
        assert torch.equal(a[closest], b[closest])
    miss = k.tri < 0
    assert torch.equal(k.t[miss], lim.abs()[miss])
    assert (k.u[miss] == 0).all() and (k.v[miss] == 0).all()


def test_trace_kernel_refuses_a_deep_tree(cuda):
    """A tree deeper than the walk's stack: the wrapper raises, and so does
    the C entry point behind it."""
    from vkrt_tpu_torch import device as dev
    from vkrt_tpu_torch.ops.cuda.trace import make_cuda_tracer, trace_kernel
    from vkrt_tpu_torch.ops.trace import WALK_STACK
    from vkrt_tpu_torch.scene import make_cornell_box

    scene = make_cornell_box(device=cuda)
    bvh = make_cuda_tracer(scene).bvh
    o, d, lim = _rays(256, 2, cuda, 4.5)
    with pytest.raises(ValueError, match="exceeds"):
        trace_kernel(bvh._replace(depth=WALK_STACK + 1), scene, o, d, lim)
    out = [torch.empty(256, device=cuda) for _ in range(4)]
    err = dev.kernels().vkrt_trace(
        bvh.nodes.data_ptr(), bvh.tris.data_ptr(), WALK_STACK + 1,
        o.data_ptr(), 3, 1, d.data_ptr(), 3, 1, lim.data_ptr(), 256, 1e-3, 0,
        *(t.data_ptr() for t in out), dev.stream_ptr(cuda))
    assert err != 0


@pytest.mark.parametrize("corr", [True, False])
def test_shade_kernel_matches_plain(cuda, corr):
    from vkrt_tpu_torch.ops.cuda.shade import (
        C_ACTIVE, C_PSH, ShadeParams, clamp_bounds, scene_tables, shade, shade_plain,
    )
    from vkrt_tpu_torch.ops.cuda.trace import make_cuda_tracer
    from vkrt_tpu_torch.ops.intersect import T_MAX, T_MIN
    from vkrt_tpu_torch.ops.rng import block_uniform_table, rnd, tea
    from vkrt_tpu_torch.scene import make_cornell_box
    from vkrt_tpu_torch.utils.camera import Camera, generate_rays

    w, h = 128, 64
    n = w * h
    scene = make_cornell_box(device=cuda)
    tracer = make_cuda_tracer(scene)
    seed = tea(torch.arange(n, device=cuda), 3)
    seed, r1 = rnd(seed)
    seed, r2 = rnd(seed)
    o, d = generate_rays(Camera().matrices(w, h, cuda), w, h, torch.stack([r1, r2], -1))
    rays = torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                        torch.full((n,), T_MAX, device=cuda)]).contiguous()
    carry = torch.zeros((14, n), device=cuda)
    carry[0:3] = 1.0
    carry[C_ACTIVE] = 1.0
    mat_tab, light_tab = scene_tables(scene)
    lo, hi = clamp_bounds(True)
    sh_tri = None
    for dd in range(3):
        hit = tracer.trace_block(rays)
        tab = block_uniform_table(n // 1024, 77, dd, device=cuda) if corr else None
        p = ShadeParams(d=dd, first=dd == 0, resolve_hd=dd == 2, hitdist_weight=1.0,
                        hitdist_accumulate=True, t_min=T_MIN, t_max=T_MAX,
                        clear=(1.0, 1.0, 1.0), clamp_lo=lo, clamp_hi=hi)
        args = (carry, seed, rays, hit, sh_tri, scene, mat_tab, light_tab, tab, p)
        before = _launches("vkrt_shade")
        k = shade(*args)
        assert _launches("vkrt_shade") == before + 1
        q = shade_plain(*args)
        kc, qc = k.carry.cpu().numpy(), q.carry.cpu().numpy()
        agree = ((kc[C_ACTIVE] > 0) == (qc[C_ACTIVE] > 0)) & ((kc[C_PSH] > 0) == (qc[C_PSH] > 0))
        assert agree.mean() >= 0.999
        np.testing.assert_array_equal(k.seed.cpu().numpy()[agree], q.seed.cpu().numpy()[agree])
        for a, b in ((kc, qc), (k.next_rays.cpu().numpy(), q.next_rays.cpu().numpy()),
                     (k.shadow_rays.cpu().numpy(), q.shadow_rays.cpu().numpy())):
            ok = np.isclose(a, b, rtol=1e-4, atol=1e-6) | (np.isnan(a) & np.isnan(b))
            assert ok.mean(axis=1).min() >= 0.99
        carry, seed, rays = k.carry, k.seed, k.next_rays
        sh_tri = tracer.trace_block(k.shadow_rays).tri


def _city_pool(cuda, w=256, h=128):
    """Bounce 0 of a seeded make_city(grid=16) pool seen from the suite's
    camera, scaled with the grid: (scene, tracer, carry, seed, rays)."""
    from vkrt_tpu_torch.ops.cuda.shade import C_ACTIVE
    from vkrt_tpu_torch.ops.cuda.trace import make_cuda_tracer
    from vkrt_tpu_torch.ops.intersect import T_MAX
    from vkrt_tpu_torch.ops.rng import rnd, tea
    from vkrt_tpu_torch.scene import make_city
    from vkrt_tpu_torch.utils.camera import generate_rays, orbit_camera

    n = w * h
    scene = make_city(grid=16, device=cuda)
    seed = tea(torch.arange(n, device=cuda), 5)
    seed, r1 = rnd(seed)
    seed, r2 = rnd(seed)
    cam = orbit_camera(0.12, radius=50.0, height=8.0).matrices(w, h, cuda)
    o, d = generate_rays(cam, w, h, torch.stack([r1, r2], -1))
    rays = torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                        torch.full((n,), T_MAX, device=cuda)]).contiguous()
    carry = torch.zeros((14, n), device=cuda)
    carry[0:3] = 1.0
    carry[C_ACTIVE] = 1.0
    return scene, make_cuda_tracer(scene), carry, seed, rays


def _close_outputs(k, q, lanes=None, frac=0.99, rtol=1e-4):
    """ShadeOut ``k`` against ``q``: masks equal on >= 99.9% of the lanes,
    seeds bit-equal there, every column within ``rtol`` (1e-6 absolute) on
    >= ``frac`` of them (``lanes``: a bool mask of the lanes compared)."""
    from vkrt_tpu_torch.ops.cuda.shade import C_ACTIVE, C_PSH

    sel = slice(None) if lanes is None else lanes.cpu().numpy()
    kc, qc = k.carry.cpu().numpy()[:, sel], q.carry.cpu().numpy()[:, sel]
    agree = ((kc[C_ACTIVE] > 0) == (qc[C_ACTIVE] > 0)) & ((kc[C_PSH] > 0) == (qc[C_PSH] > 0))
    assert agree.mean() >= 0.999
    np.testing.assert_array_equal(k.seed.cpu().numpy()[sel][agree],
                                  q.seed.cpu().numpy()[sel][agree])
    for a, b in ((kc, qc), (k.next_rays.cpu().numpy()[:, sel], q.next_rays.cpu().numpy()[:, sel]),
                 (k.shadow_rays.cpu().numpy()[:, sel], q.shadow_rays.cpu().numpy()[:, sel])):
        ok = np.isclose(a, b, rtol=rtol, atol=1e-6) | (np.isnan(a) & np.isnan(b))
        assert ok.mean(axis=1).min() >= frac


@pytest.mark.parametrize("corr", [True, False])
def test_shade_albedo_kernel_matches_plain(cuda, corr):
    """Kernel B's albedo instantiation against ``shade_plain`` with the
    albedo branch, three bounces of a city pool; each counts one launch of
    ``vkrt_shade`` and one of its albedo row."""
    from vkrt_tpu_torch.ops.cuda.shade import (
        ShadeParams, clamp_bounds, scene_tables, shade, shade_plain,
    )
    from vkrt_tpu_torch.ops.intersect import T_MAX, T_MIN
    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.ops.rng import block_uniform_table

    scene, tracer, carry, seed, rays = _city_pool(cuda)
    n = seed.shape[0]
    mat_tab, light_tab = scene_tables(scene)
    lo, hi = clamp_bounds(False)
    sh_tri = None
    for dd in range(3):
        hit = tracer.trace_block(rays)
        tab = block_uniform_table(n // 1024, 91, dd, device=cuda) if corr else None
        p = ShadeParams(d=dd, first=dd == 0, resolve_hd=dd == 2, hitdist_weight=1.0,
                        hitdist_accumulate=True, t_min=T_MIN, t_max=T_MAX,
                        clear=(1.0, 1.0, 1.0), clamp_lo=lo, clamp_hi=hi, albedo=True)
        args = (carry, seed, rays, hit, sh_tri, scene, mat_tab, light_tab, tab, p)
        before = (_launches("vkrt_shade"), _launches(kdev.SHADE_ALBEDO))
        k = shade(*args)
        assert (_launches("vkrt_shade"), _launches(kdev.SHADE_ALBEDO)) == (
            before[0] + 1, before[1] + 1)
        _close_outputs(k, shade_plain(*args))
        if dd == 0:  # the fetch is live: the untextured kernel differs
            u = shade(*args[:-1], p._replace(albedo=False))
            assert (u.carry[0:3] != k.carry[0:3]).any(0).float().mean() > 0.05
        carry, seed, rays = k.carry, k.seed, k.next_rays
        sh_tri = tracer.trace_block(k.shadow_rays).tri


def test_shade_albedo_miss_lanes_and_untextured_materials(cuda):
    """Lanes that fetch nothing: a miss lane, a material whose baseColor
    index is -1 (the city's rooftops), and every lane when all indices are
    -1. There the albedo instantiation computes what the untextured one
    does (a multiply by 1.0 is exact)."""
    from vkrt_tpu_torch.ops.cuda.shade import ShadeParams, clamp_bounds, scene_tables, shade
    from vkrt_tpu_torch.ops.intersect import T_MAX, T_MIN

    scene, tracer, carry, seed, rays = _city_pool(cuda)
    hit = tracer.trace_block(rays)
    mat_tab, light_tab = scene_tables(scene)
    lo, hi = clamp_bounds(False)
    p = ShadeParams(d=0, first=True, resolve_hd=False, hitdist_weight=1.0,
                    hitdist_accumulate=True, t_min=T_MIN, t_max=T_MAX,
                    clear=(1.0, 1.0, 1.0), clamp_lo=lo, clamp_hi=hi)
    tri = hit.tri
    white = (tri < 0) | (scene.mat_base_tex[scene.tri_mat[tri.clamp_min(0).long()].long()] < 0)
    assert (tri < 0).any() and (white & (tri >= 0)).any() and (~white).any()
    plain_args = (carry, seed, rays, hit, None)
    u = shade(*plain_args, scene, mat_tab, light_tab, None, p)
    a = shade(*plain_args, scene, mat_tab, light_tab, None, p._replace(albedo=True))
    _close_outputs(a, u, lanes=white, frac=0.999, rtol=1e-6)
    none = scene._replace(mat_base_tex=torch.full_like(scene.mat_base_tex, -1))
    a = shade(*plain_args, none, mat_tab, light_tab, None, p._replace(albedo=True))
    _close_outputs(a, u, frac=0.999, rtol=1e-6)


def test_wrappers_refuse_bad_inputs(cuda):
    from vkrt_tpu_torch.ops.cuda.shade import ShadeParams, scene_tables, shade
    from vkrt_tpu_torch.ops.cuda.trace import make_cuda_tracer, trace_kernel
    from vkrt_tpu_torch.scene import make_cornell_box

    scene = make_cornell_box(device=cuda)
    tracer = make_cuda_tracer(scene)
    o = torch.zeros((8, 3), device=cuda)
    with pytest.raises(TypeError):
        trace_kernel(tracer.bvh, scene, o.double(), o, torch.ones(8, device=cuda))
    with pytest.raises(ValueError):
        trace_kernel(tracer.bvh, scene, o, o, torch.ones(8))

    n = 256
    mat_tab, light_tab = scene_tables(scene)
    carry = torch.zeros((14, n), device=cuda)
    seed = torch.zeros(n, dtype=torch.int32, device=cuda)
    rays = torch.zeros((7, n), device=cuda)
    z = torch.zeros(n, device=cuda)
    hit = (z, torch.full((n,), -1, dtype=torch.int32, device=cuda), z, z)
    p = ShadeParams(d=0, first=True, resolve_hd=False, hitdist_weight=1.0,
                    hitdist_accumulate=True, t_min=1e-3, t_max=1e4,
                    clear=(1.0, 1.0, 1.0), clamp_lo=0.0, clamp_hi=50.0)
    shade(carry, seed, rays, hit, None, scene, mat_tab, light_tab, None, p)
    with pytest.raises(TypeError):  # the seed is int32 bits, not f32
        shade(carry, z, rays, hit, None, scene, mat_tab, light_tab, None, p)
    with pytest.raises(ValueError):  # a carry of the wrong lane count
        shade(carry[:, :128], seed, rays, hit, None, scene, mat_tab, light_tab, None, p)
    with pytest.raises(ValueError):  # a non-first bounce needs shadow verdicts
        shade(carry, seed, rays, hit, None, scene, mat_tab, light_tab, None,
              p._replace(d=1, first=False))
