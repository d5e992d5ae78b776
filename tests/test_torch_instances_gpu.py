"""Kernel A on refit tables on the card. Marked ``gpu``; each test skips
without a CUDA device (decided in the fixture, not at import). The card's
machine has no JAX: run with
``python -m pytest --noconftest tests/test_torch_instances_gpu.py -q``.

The PNG sponzoid at tess 1 (26,752 triangles) as an ``InstancedScene`` on
the card; its largest primitive (the marble columns) is moved three times
through ``repose`` + ``repose_tracer`` (kernel A's tables refit, no SAH
build). Then kernel A over the refit tables and over a fresh ``build_bvh``
of the last pose: (t, tri, u, v) equal as uint32 on the 320x180 primaries
of the suite's camera and on 65,536 random rays inside the hall, and the
refit tables equal row for row to a refit of the same moves on the CPU."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return torch.device("cuda")


def _moved(inst):
    from vkrt_tpu_torch.ops.trace import make_tracer
    from vkrt_tpu_torch.scene_instances import repose, repose_tracer

    tracer = make_tracer(inst.scene, "pallas", tri_arrays=inst.tri_arrays())
    node = int(np.argmax([e - s for s, e in inst.prim_ranges]))
    for f in range(3):
        m = np.eye(4)
        m[:3, 3] = (0.4 * (f + 1), 0.1 * f, -0.3 * f)
        inst, moved = repose(inst, node, m)
        tracer = repose_tracer(tracer, inst, moved)
    return inst, tracer


def _bits(h):
    return [x.view(torch.int32).cpu() for x in h]


def test_refit_tables_trace_like_a_fresh_build(cuda, tmp_path):
    from vkrt_tpu_torch.ops.cuda import trace as ktrace
    from vkrt_tpu_torch.utils.camera import Camera, generate_rays, pixel_coords
    from vkrt_tpu_torch.utils.sponzoid import load_sponzoid

    inst = load_sponzoid(str(tmp_path), tess=1, texture_format="png", device=cuda,
                         instanced=True)
    inst, tracer = _moved(inst)
    assert isinstance(tracer, ktrace.CudaTracer)
    fresh = ktrace.build_bvh(inst.scene, inst.tri_arrays())

    w, h = 320, 180
    cam = Camera(eye=(0.0, 6.0, 26.0), center=(0.0, 5.0, 0.0)).matrices(w, h, cuda)
    o, d = generate_rays(cam, w, h, torch.tensor([0.5, 0.5], device=cuda),
                         pix=pixel_coords(w, h, cuda))
    rng = np.random.default_rng(3)
    n = 65536
    ro = np.stack([rng.uniform(-9, 9, n), rng.uniform(0.2, 11.8, n),
                   rng.uniform(-29, 29, n)], 1)
    rd = rng.normal(size=(n, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    sets = {"primaries": (o, d), "random": (torch.tensor(ro, dtype=torch.float32, device=cuda),
                                            torch.tensor(rd, dtype=torch.float32, device=cuda))}
    for name, (so, sd) in sets.items():
        lim = torch.full((so.shape[0],), 1e30, device=cuda)
        a = ktrace.trace_kernel(tracer.bvh, inst.scene, so, sd, lim)
        b = ktrace.trace_kernel(fresh, inst.scene, so, sd, lim)
        assert int((a.tri >= 0).sum()) > so.shape[0] // 2, name
        for field, x, y in zip("t tri u v".split(), _bits(a), _bits(b)):
            assert torch.equal(x, y), (name, field, int((x != y).sum()))

    # the same moves refit on the CPU give the same tables
    cpu = load_sponzoid(str(tmp_path), tess=1, texture_format="png", device="cpu",
                        instanced=True)
    _, cpu_tracer = _moved(cpu)
    for field in ("nodes", "tris", "threaded"):
        assert torch.equal(getattr(tracer.bvh, field).cpu().view(torch.int32),
                           getattr(cpu_tracer.bvh, field).view(torch.int32)), field
