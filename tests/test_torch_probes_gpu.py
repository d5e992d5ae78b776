"""The trace-probe kernels C-F against their plain versions on the card (the
checks of chip_smoke.py's phase 6, at test sizes). Marked ``gpu``; each test
skips without a CUDA device (decided in the fixture, not at import).

Run on the card: ``python -m pytest --noconftest tests/test_torch_probes_gpu.py -q``.
Tolerances: C, D's ``full``/``boxes``/``top``/``count`` and F at K = 512 are
bit-equal to what they are held to (the miss record, kernel A, the plain
front-to-back walk's visit counts, the f64-per-step recurrence); E's variants agree with
kernel A on every verdict, and on the triangle except at equal-t ties, with
t, u and v within 1e-6 relative where both hit one triangle."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def city(cuda):
    from vkrt_tpu_torch.ops.cuda.trace import build_bvh
    from vkrt_tpu_torch.ops.cuda.trace_variants import probe_tables
    from vkrt_tpu_torch.scene import make_city

    scene = make_city(grid=8, device=cuda)
    return scene, probe_tables(build_bvh(scene), scene.num_tris)


def _rays(n, seed, scene, device, strided=False):
    rng = np.random.default_rng(seed)
    v0 = scene.tri_v0.cpu().numpy()
    o = rng.uniform(v0.min(0), v0.max(0), (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.tensor(o, device=device), torch.tensor(d, device=device)
    if strided:  # rows of a (7, N) ray block, as the bounce loop passes them
        block = torch.cat([o.T, d.T, torch.zeros((1, n), device=device)]).contiguous()
        o, d = block[0:3].T, block[3:6].T
    return o, d, torch.full((n,), 1e4, device=device)


@pytest.mark.parametrize("threads", [128, 256, 512, 1024])
def test_floor_is_the_miss_record(cuda, city, threads):
    from vkrt_tpu_torch.ops.cuda.probes import floor_kernel, floor_plain

    o, d, lim = _rays(5000, 1, city[0], cuda, strided=True)
    lim[::3] = -2.5
    before = floor_kernel.launches
    k = floor_kernel(o, d, lim, threads)
    assert floor_kernel.launches == before + 1
    for a, b in zip(k, floor_plain(o, d, lim)):
        assert torch.equal(a, b)


def test_fma_peak_matches_plain(cuda):
    from vkrt_tpu_torch.ops.cuda.probes import fma_peak, fma_peak_plain

    x = torch.tensor(np.random.default_rng(2).uniform(0.1, 2.0, (16, 128)).astype(np.float32),
                     device=cuda)
    before = fma_peak.launches
    out = fma_peak(x, 512)
    assert fma_peak.launches == before + 1
    assert torch.equal(out, fma_peak_plain(x, 512))


@pytest.mark.parametrize("any_hit", [False, True])
def test_ablate_modes(cuda, city, any_hit):
    from vkrt_tpu_torch.ops.cuda.probes import miss_record
    from vkrt_tpu_torch.ops.cuda.trace import trace_kernel
    from vkrt_tpu_torch.ops.cuda.trace_variants import trace_ablate
    from vkrt_tpu_torch.ops.trace import trace_rays_bvh_ordered

    scene, tables = city
    o, d, lim = _rays(1 << 14, 3, scene, cuda, strided=True)
    a = trace_kernel(tables.bvh, scene, o, d, lim, any_hit=any_hit)
    before = trace_ablate.launches
    full, none = trace_ablate("full", tables, scene, o, d, lim, any_hit=any_hit)
    assert none is None and trace_ablate.launches == before + 1
    assert all(torch.equal(x, y) for x, y in zip(full, a))
    hits, counts = trace_ablate("count", tables, scene, o, d, lim, any_hit=any_hit)
    assert all(torch.equal(x, y) for x, y in zip(hits, a))
    walk, plain = trace_rays_bvh_ordered(tables.bvh, o, d, lim, any_hit=any_hit, count=True)
    assert torch.equal(counts.nodes, plain.nodes) and torch.equal(counts.leaves, plain.leaves)
    assert all(torch.equal(x, y) for x, y in zip(walk, a))
    for mode in ("boxes", "top"):
        hits, _ = trace_ablate(mode, tables, scene, o, d, lim)
        assert all(torch.equal(x, y) for x, y in zip(hits, miss_record(lim)))


@pytest.mark.parametrize("variant", ["threaded", "ordered", "flat", "mt64"])
def test_variants_match_kernel_a(cuda, city, variant):
    from vkrt_tpu_torch.ops.cuda.trace import trace_kernel
    from vkrt_tpu_torch.ops.cuda.trace_variants import trace_variant
    from vkrt_tpu_torch.ops.trace import trace_rays_bruteforce

    scene, tables = city
    o, d, lim = _rays(1 << 14, 4, scene, cuda)
    if variant == "mt64":
        ref = trace_rays_bruteforce(scene.tri_v0[:64], scene.tri_e1[:64], scene.tri_e2[:64],
                                    o, d, lim)
    else:
        ref = trace_kernel(tables.bvh, scene, o, d, lim)
    before = trace_variant.launches
    k = trace_variant(variant, tables, scene, o, d, lim)
    assert trace_variant.launches == before + 1
    kt, ktri, ku, kv = (x.cpu().numpy() for x in k)
    rt, rtri, ru, rv = (x.cpu().numpy() for x in ref)
    np.testing.assert_array_equal(ktri >= 0, rtri >= 0)
    np.testing.assert_allclose(kt, rt, rtol=1e-6)
    same = ktri == rtri
    assert (np.abs(kt - rt)[~same] <= 1e-6 * np.abs(rt)[~same]).all()  # ties only
    np.testing.assert_allclose(ku[same], ru[same], rtol=1e-6, atol=0)
    np.testing.assert_allclose(kv[same], rv[same], rtol=1e-6, atol=0)


def test_probe_wrappers_refuse_bad_inputs(cuda, city):
    import dataclasses

    from vkrt_tpu_torch.ops.cuda.probes import floor_kernel, fma_peak
    from vkrt_tpu_torch.ops.cuda.trace_variants import trace_ablate, trace_variant

    scene, tables = city
    o, d, lim = _rays(256, 5, scene, cuda)
    with pytest.raises(ValueError):
        floor_kernel(o, d, lim, threads=100)
    with pytest.raises(ValueError):
        fma_peak(torch.ones((8, 128), device=cuda), 100)
    with pytest.raises(ValueError):
        trace_ablate("votes", tables, scene, o, d, lim)
    with pytest.raises(ValueError):
        trace_variant("dyn4", tables, scene, o, d, lim)
    with pytest.raises(ValueError):  # deeper than the ordered walk's stack
        trace_variant("ordered", dataclasses.replace(tables, max_depth=65), scene, o, d, lim)
    with pytest.raises(ValueError):
        trace_variant("threaded", tables, scene, o, d, lim.cpu())
    deep = dataclasses.replace(tables, bvh=tables.bvh._replace(depth=33))
    with pytest.raises(ValueError, match="exceeds"):  # deeper than kernel D's stack
        trace_ablate("count", deep, scene, o, d, lim)
