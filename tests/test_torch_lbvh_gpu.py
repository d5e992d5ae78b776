"""The LBVH and the ``bvh`` backend on the card. Marked ``gpu``; each test
skips without a CUDA device (decided in the fixture, not at import). The
card's machine has no JAX: run with
``python -m pytest --noconftest tests/test_torch_lbvh_gpu.py -q``.

* ``build_lbvh`` on the card equals the same function on CPU tensors bit
  for bit (all four arrays as uint32), and ``threaded_tables`` on the card
  equal them made on the CPU, on ``make_city(grid=8)``, the padded Cornell
  box and 16 triangles with one centroid;
* kernel E's ``threaded`` body over the LBVH (``trace_threaded``, the
  ``bvh`` backend) equals its plain version (``trace_rays_bvh`` over the
  same tables) bit for bit on rays of every kind (closest, first-hit-kills,
  zero limits, dead lanes: the verdict alone where a lane is first-hit-
  kills), and kernel A over the SAH tree on the closest lanes; the
  launches count under ``vkrt_trace_variant`` in ``device.counts``;
* ``SortingTracer`` over kernel A gives kernel A's hits bit for bit."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return torch.device("cuda")


def _scene(kind, device):
    from vkrt_tpu_torch.scene import make_city, make_cornell_box

    if kind == "city":
        return make_city(grid=8, device=device)
    if kind == "cornell":
        return make_cornell_box(device=device)
    base = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    tris = np.stack([base] * 16)
    return tuple(torch.tensor(a, device=device)
                 for a in (tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]))


def _tris(sc):
    return (sc.tri_v0, sc.tri_e1, sc.tri_e2) if hasattr(sc, "tri_v0") else sc


@pytest.mark.parametrize("kind", ["city", "cornell", "duplicates"])
def test_card_build_equals_cpu_build(cuda, kind):
    from vkrt_tpu_torch.bvh.lbvh import build_lbvh
    from vkrt_tpu_torch.ops.cuda.trace import threaded_tables

    card, cpu = _tris(_scene(kind, cuda)), _tris(_scene(kind, "cpu"))
    got, want = build_lbvh(*card), build_lbvh(*cpu)
    for name, a, b in zip(got._fields, got, want):
        assert a.device.type == "cuda"
        np.testing.assert_array_equal(a.cpu().numpy().view(np.uint32),
                                      b.numpy().view(np.uint32), err_msg=name)
    for a, b in zip(threaded_tables(got, *card), threaded_tables(want, *cpu)):
        np.testing.assert_array_equal(a.cpu().numpy().view(np.uint32),
                                      b.numpy().view(np.uint32))


def _rays(n, seed, lo, hi, device):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lim = np.full(n, 1e4)
    lane = rng.integers(0, 5, n)
    lim[lane == 1] = -rng.uniform(0.5, 20.0, (lane == 1).sum())
    lim[lane == 2] = 0.0
    o[lane == 3], d[lane == 3], lim[lane == 3] = 1e30, 0.0, -1.0
    lim[lane == 4] = rng.uniform(0.5, 20.0, (lane == 4).sum())
    return tuple(torch.tensor(a.astype(np.float32), device=device) for a in (o, d, lim))


def test_threaded_walk_over_lbvh(cuda):
    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.ops.cuda.trace import make_cuda_tracer
    from vkrt_tpu_torch.ops.cuda.trace_variants import LbvhTracer
    from vkrt_tpu_torch.ops.trace import make_tracer, trace_rays_bvh

    sc = _scene("city", cuda)
    tr = make_tracer(sc, "bvh")
    assert isinstance(tr, LbvhTracer) and tr.nodes.device.type == "cuda"
    v0 = sc.tri_v0.cpu().numpy()
    o, d, lim = _rays(65536, 1, v0.min(0), v0.max(0), cuda)
    count = kdev.counts["vkrt_trace_variant"]
    before = count["launches"]
    got = tr.trace(o, d, lim)
    assert count["launches"] == before + 1
    plain = trace_rays_bvh(tr.nodes.cpu(), None, o.cpu(), d.cpu(), lim.cpu(),
                           tris=tr.tris.cpu())
    kill = (lim < 0).cpu()
    for f, a, b in zip(got._fields, got, plain):
        a, b = a.cpu(), b
        assert torch.equal(a[~kill].view(torch.int32), b[~kill].view(torch.int32)), f
    assert torch.equal(got.tri.cpu()[kill] >= 0, plain.tri[kill] >= 0)
    a_hits = make_cuda_tracer(sc).trace(o, d, lim)
    closest = ~kill.to(cuda)
    for f, a, b in zip(got._fields, got, a_hits):
        assert torch.equal(a[closest].view(torch.int32), b[closest].view(torch.int32)), f
    assert int((got.tri[closest] >= 0).sum()) > 1000


def test_sorting_tracer_over_kernel_a(cuda):
    from vkrt_tpu_torch.ops.cuda.trace import make_cuda_tracer
    from vkrt_tpu_torch.ops.intersect import T_MAX, T_MIN
    from vkrt_tpu_torch.ops.sort_rays import make_sorting_tracer

    sc = _scene("city", cuda)
    inner = make_cuda_tracer(sc)
    st = make_sorting_tracer(inner, sc)
    v0 = sc.tri_v0.cpu().numpy()
    o, d, _ = _rays(65536, 2, v0.min(0), v0.max(0), cuda)
    got, want = st.closest(o, d, T_MIN, T_MAX), inner.closest(o, d, T_MIN, T_MAX)
    for f, a, b in zip(got._fields, got, want):
        assert torch.equal(a.view(torch.int32) if a.dtype != torch.bool else a,
                           b.view(torch.int32) if b.dtype != torch.bool else b), f
