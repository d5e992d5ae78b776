"""The trace-probe kernels C-F against their plain versions on the card (the
checks of chip_smoke.py's phase 6, at test sizes). Marked ``gpu``; each test
skips without a CUDA device (decided in the fixture, not at import).

Run on the card: ``python -m pytest --noconftest tests/test_torch_probes_gpu.py -q``.
Tolerances: C, D's ``full``/``boxes``/``top``/``count`` and F at K = 512 are
bit-equal to what they are held to (the miss record, kernel A, the plain
front-to-back walk's visit counts, the f64-per-step recurrence); E's
variants are bit-equal to kernel A (``mt<K>`` to brute force over its K
triangles) in t, u, v and triangle id on closest lanes and equal in the
verdict on first-hit-kills lanes, and ``ordered``'s counts are the plain
wide walk's."""

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
    return scene, probe_tables(build_bvh(scene), scene)


def _launches(entry: str) -> int:
    from vkrt_tpu_torch import device as kdev

    return kdev.counts[entry]["launches"]


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
    before = _launches("vkrt_floor")
    k = floor_kernel(o, d, lim, threads)
    assert _launches("vkrt_floor") == before + 1
    for a, b in zip(k, floor_plain(o, d, lim)):
        assert torch.equal(a, b)


def test_fma_peak_matches_plain(cuda):
    from vkrt_tpu_torch.ops.cuda.probes import fma_peak, fma_peak_plain

    x = torch.tensor(np.random.default_rng(2).uniform(0.1, 2.0, (16, 128)).astype(np.float32),
                     device=cuda)
    before = _launches("vkrt_fma_peak")
    out = fma_peak(x, 512)
    assert _launches("vkrt_fma_peak") == before + 1
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
    before = _launches("vkrt_trace_ablate")
    full, none = trace_ablate("full", tables, scene, o, d, lim, any_hit=any_hit)
    assert none is None and _launches("vkrt_trace_ablate") == before + 1
    assert all(torch.equal(x, y) for x, y in zip(full, a))
    hits, counts = trace_ablate("count", tables, scene, o, d, lim, any_hit=any_hit)
    assert all(torch.equal(x, y) for x, y in zip(hits, a))
    walk, plain = trace_rays_bvh_ordered(tables.bvh, o, d, lim, any_hit=any_hit, count=True)
    assert torch.equal(counts.nodes, plain.nodes) and torch.equal(counts.leaves, plain.leaves)
    assert all(torch.equal(x, y) for x, y in zip(walk, a))
    for mode in ("boxes", "top"):
        hits, _ = trace_ablate(mode, tables, scene, o, d, lim)
        assert all(torch.equal(x, y) for x, y in zip(hits, miss_record(lim)))


@pytest.fixture(scope="module")
def soup(cuda):
    from vkrt_tpu_torch.ops.cuda.trace import build_bvh
    from vkrt_tpu_torch.ops.cuda.trace_variants import probe_tables
    from vkrt_tpu_torch.scene import make_random_soup

    scene = make_random_soup(4096, device=cuda)
    return scene, probe_tables(build_bvh(scene), scene)


# mt200: K is no multiple of the 128-record tile; 10,007 rays: no multiple of
# the 128-thread block
@pytest.mark.parametrize("variant", ["threaded", "binary", "ordered", "flat", "mt64", "mt200"])
@pytest.mark.parametrize("which", ["city", "soup"])
def test_variants_match_kernel_a(cuda, city, soup, which, variant):
    from vkrt_tpu_torch.ops.cuda.trace import trace_kernel
    from vkrt_tpu_torch.ops.cuda.trace_variants import trace_variant
    from vkrt_tpu_torch.ops.trace import trace_rays_bruteforce

    scene, tables = city if which == "city" else soup
    o, d, lim = _rays(10007, 4, scene, cuda, strided=which == "soup")
    lim[::5] = -3.0   # first-hit-kills lanes: the verdict
    lim[1::5] = 0.75  # short closest lanes
    d[2::50, 0] = 0.0  # zero direction components
    if variant.startswith("mt"):
        k = int(variant[2:])
        ref = trace_rays_bruteforce(scene.tri_v0[:k], scene.tri_e1[:k], scene.tri_e2[:k],
                                    o, d, lim)
    else:
        ref = trace_kernel(tables.bvh, scene, o, d, lim)
    before = _launches("vkrt_trace_variant")
    k = trace_variant(variant, tables, scene, o, d, lim)
    assert _launches("vkrt_trace_variant") == before + 1
    assert torch.equal(k.tri >= 0, ref.tri >= 0)
    assert 0.05 < (k.tri >= 0).float().mean() < 0.999 or variant.startswith("mt")
    closest = lim >= 0
    for x, y in zip(k, ref):
        assert torch.equal(x[closest], y[closest])


@pytest.mark.parametrize("which", ["city", "soup"])
def test_ordered_counts_match_plain_wide_walk(cuda, city, soup, which):
    from vkrt_tpu_torch.ops.cuda.trace import trace_kernel
    from vkrt_tpu_torch.ops.cuda.trace_variants import trace_variant
    from vkrt_tpu_torch.ops.trace import trace_rays_bvh_wide

    scene, tables = city if which == "city" else soup
    o, d, lim = _rays(5001, 6, scene, cuda)
    lim[::4] = -2.0
    hits, counts = trace_variant("ordered", tables, scene, o, d, lim, count=True)
    walk, plain = trace_rays_bvh_wide(tables.wide, o, d, lim, count=True)
    assert all(torch.equal(x, y) for x, y in zip(counts, plain))  # slabs, leaves, records
    assert (counts.nodes < 4 * counts.records).any()  # empty slots are not counted
    assert all(torch.equal(x, y) for x, y in zip(hits, walk))
    assert all(torch.equal(x, y)
               for x, y in zip(hits, trace_variant("ordered", tables, scene, o, d, lim)))
    a = trace_kernel(tables.bvh, scene, o, d, lim)
    assert torch.equal(hits.tri >= 0, a.tri >= 0)


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
    with pytest.raises(ValueError):  # deeper than the binary walk's stack
        trace_variant("binary", dataclasses.replace(tables, max_depth=65), scene, o, d, lim)
    with pytest.raises(ValueError):  # more entries than the wide walk's stack
        trace_variant("ordered", dataclasses.replace(tables, wide=tables.wide._replace(stack=65)),
                      scene, o, d, lim)
    with pytest.raises(ValueError):  # only ordered counts
        trace_variant("binary", tables, scene, o, d, lim, count=True)
    with pytest.raises(ValueError):
        trace_variant("threaded", tables, scene, o, d, lim.cpu())
    deep = dataclasses.replace(tables, bvh=tables.bvh._replace(depth=33))
    with pytest.raises(ValueError, match="exceeds"):  # deeper than kernel D's stack
        trace_ablate("count", deep, scene, o, d, lim)
