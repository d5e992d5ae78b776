"""The port's mesh rendering (``vkrt_tpu_torch/parallel``) on gloo CPU
ranks against ``vkrt_tpu/parallel`` on the 8 virtual CPU devices of
tests/conftest.py, and against the port's own single-process engine: the
tests of tests/test_parallel.py, at 64x32 with the brute-force tracer.

* path mode: (4,1) bit for bit equal to the port's engine (corr off), and
  through the display gate of tests/test_accuracy_oracle.py:83-88 against
  JAX's (4,1) render; (2,2) at spp 2 against JAX's (2,2) (the same seed
  streams: the same gate, pixel by pixel) and in the mean against the
  unsharded spp-2 engine. Ray counts: exact against the same package's
  unsharded render, within 0.1% between the packages (their unsharded
  engines differ by ulps already);
* the band denoiser on 4, 2 and 1 bands of a 32x32 frame, with history
  crossing the band borders, against the full-frame ``denoise_temporal``
  of the port and of JAX (rtol 1e-5, atol 1e-6);
* hybrid mode with GI, and with the temporal denoiser over 2 frames,
  against the engine; the correlated sampler on mesh (1,1) (bit for bit),
  over (2,2) (statistics) and in hybrid mode (smoke); kernel A's tracer
  (its plain version here) under the mesh.

One spawn of ranks per mesh shape runs every case of that shape."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vkrt_tpu.models import denoiser as jdn
from vkrt_tpu.ops import nrd as jnrd
from vkrt_tpu.ops.trace import make_tracer as j_make_tracer
from vkrt_tpu.parallel.mesh import make_render_mesh as j_make_render_mesh
from vkrt_tpu.parallel.render import render_sharded as j_render_sharded
from vkrt_tpu.scene import make_cornell_box as j_make_cornell_box
from vkrt_tpu.utils.camera import Camera as JCamera
from vkrt_tpu_torch.config import RenderSettings
from vkrt_tpu_torch.engine import Engine
from vkrt_tpu_torch.models import denoiser as dn
from vkrt_tpu_torch.parallel.mesh import launch
from vkrt_tpu_torch.parallel.render import run_jobs
from vkrt_tpu_torch.scene import make_cornell_box
from vkrt_tpu_torch.utils.camera import Camera

W, H = 64, 32
CLEAR = (1.0, 1.0, 1.0, 1.0)
TOL = dict(rtol=1e-5, atol=1e-6)
DW, DH = 32, 32  # the denoiser's frame: 4 bands of 8 rows, the 2^3 tap reach


def display_gate(a, b):
    """tests/test_accuracy_oracle.py:83-88 on displayed (gamma, [0,1])
    images."""
    da, db = (np.clip(np.clip(x, 0, None) ** (1.0 / 2.2), 0, 1) for x in (a, b))
    err = np.abs(da - db).max(-1)
    assert np.percentile(err, 99) <= 1e-3, np.percentile(err, 99)
    diverged = err > 1e-2
    assert diverged.mean() < 0.01, diverged.mean()
    rmse = float(np.sqrt(np.mean((da - db)[~diverged] ** 2)))
    assert rmse <= 1e-3, rmse


def path_job(samples=1, depth=3, frames=2, corr=False, backend="bruteforce", w=W, h=H):
    return dict(kind="path", scene=("cornell_box",), backend=backend, cameras=[Camera()],
                width=w, height=h, samples=samples, depth=depth, frames=frames,
                clear_color=CLEAR, corr=corr)


def hybrid_job(frames=1, depth=3, corr=False, denoiser=False):
    return dict(kind="hybrid", scene=("cornell_box",), backend="bruteforce",
                cameras=[Camera()] * frames, width=W, height=H, depth=depth,
                clear_color=CLEAR, use_gi=True, use_denoiser=denoiser, corr=corr)


def denoise_inputs():
    """test_parallel.py's seeded denoiser inputs (numpy): a plane in front
    of two cameras strafing far enough that history crosses the bands."""
    n = DW * DH
    rng = np.random.default_rng(7)
    rad = rng.random((n, 3), np.float32)
    hdn = rng.random((n,), np.float32)
    normal = np.asarray(rng.normal(size=(n, 3)), np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    rough = rng.random((n,), np.float32)
    packed_rad = np.asarray(jnrd.pack_radiance_and_norm_hit_dist(rad, hdn))
    packed_nrm = np.asarray(jnrd.pack_normal_and_roughness(
        normal, rough, np.zeros((n,), np.float32)))
    xs = (np.arange(n) % DW).astype(np.float32) / DW * 4.0 - 2.0
    ys = (np.arange(n) // DW).astype(np.float32) / DH * 4.0 - 2.0
    world_pos = np.stack([xs, ys, np.zeros_like(xs)], axis=-1)
    view_z = np.full((n,), 9.0, np.float32)
    vp0 = np.array(JCamera(eye=(0.0, 0.0, 9.0)).matrices(DW, DH).view_proj)
    vp1 = np.array(JCamera(eye=(0.0, 0.8, 9.0)).matrices(DW, DH).view_proj)
    return packed_rad, packed_nrm, view_z, world_pos, vp0, vp1


@pytest.fixture(scope="module")
def denoise_case():
    """The frame-1 state (from the port's full-frame filter at camera 0),
    the frame-2 inputs as tensors, and the full-frame references of both
    packages at camera 1."""
    packed_rad, packed_nrm, view_z, world_pos, vp0, vp1 = denoise_inputs()
    t = [torch.from_numpy(np.array(x))
         for x in (packed_rad, packed_nrm, view_z, world_pos)]
    _, state1 = dn.denoise_temporal(dn.init_state(DW, DH, "cpu"), *t,
                                    torch.from_numpy(vp0), DW, DH)
    args = (state1, *t, torch.from_numpy(vp1), DW, DH)
    ref = dn.denoise_temporal(*args)
    jstate1 = jdn.DenoiserState(*(jnp.asarray(x.numpy()) for x in state1))
    jref = jdn.denoise_temporal(jstate1, packed_rad, packed_nrm, view_z, world_pos,
                                jnp.asarray(vp1), DW, DH)
    # history must actually cross band borders for this to test the halos
    prev_px, in_prev = jdn.motion_vectors(jnp.asarray(world_pos), jnp.asarray(vp0), DW, DH)
    moved = np.abs(np.asarray(prev_px[:, 1]) - np.arange(DW * DH) // DW)
    assert moved[np.asarray(in_prev)].max() > 1.0
    return args, ref, jref


@pytest.fixture(scope="module")
def mesh41(denoise_case):
    jobs = [path_job(),                                          # 0
            hybrid_job(),                                        # 1
            hybrid_job(frames=2, denoiser=True),                 # 2
            hybrid_job(depth=2), hybrid_job(depth=2, corr=True),  # 3, 4
            path_job(depth=2, frames=1, corr=True),              # 5
            path_job(depth=2, frames=1, backend="pallas", w=32, h=16),  # 6
            dict(kind="denoise", args=denoise_case[0])]          # 7
    return launch(run_jobs, 4, 1, "cpu", jobs)


@pytest.fixture(scope="module")
def mesh22():
    jobs = [path_job(samples=2, depth=2, frames=1),
            path_job(samples=2, depth=2, frames=2, corr=True),
            path_job(samples=2, depth=2, frames=1, backend="pallas", w=32, h=16)]
    return launch(run_jobs, 2, 2, "cpu", jobs)


@pytest.fixture(scope="module")
def box():
    return make_cornell_box(device="cpu")


@pytest.fixture(scope="module")
def jax_renders():
    """JAX's sharded path renders: (4,1) spp 1 depth 3, 2 frames; (2,2) spp 2
    depth 2, 1 frame; corr off."""
    jbox = j_make_cornell_box()
    tracer = j_make_tracer(jbox, "bruteforce")
    cam = JCamera().matrices(W, H)
    out = {}
    for shape, samples, depth, frames in (((4, 1), 1, 3, 2), ((2, 2), 2, 2, 1)):
        mesh = j_make_render_mesh(n_tile=shape[0], n_spp=shape[1])
        accum, rays = j_render_sharded(jbox, tracer, cam, mesh, width=W, height=H,
                                       samples=samples, depth=depth, frames=frames,
                                       clear_color=CLEAR)
        out[shape] = (np.asarray(accum, np.float64), rays)
    return out


def engine(box, frames, **kw):
    """The port's single-process engine after ``frames`` frames."""
    e = Engine(box, W, H, RenderSettings(backend="bruteforce", **kw), Camera(), CLEAR)
    for _ in range(frames):
        e.render_frame()
    return e


def test_tile_sharding_matches_single_device(box, mesh41, jax_renders):
    res = mesh41[0]
    e = engine(box, 2, rt_mode=1, corr_sampler=False)
    assert torch.equal(res["accum"], e.accum[e._inv_perm])  # bit for bit
    assert res["rays"] == e.total_rays > 0
    accum_j, rays_j = jax_renders[(4, 1)]
    display_gate(res["accum"].numpy().astype(np.float64), accum_j)
    assert abs(res["rays"] - rays_j) <= 1e-3 * rays_j, (res["rays"], rays_j)
    # every rank ran its band on the CPU: no kernel launch anywhere
    assert len(res["launches"]) == 4 and not any(any(c.values()) for c in res["launches"])


def test_tile_and_spp_axes(box, mesh22, jax_renders):
    res = mesh22[0]
    a = res["accum"].numpy().astype(np.float64)
    assert np.isfinite(a).all() and a.max() > 0
    accum_j, rays_j = jax_renders[(2, 2)]
    display_gate(a, accum_j)  # the same seed streams, pixel by pixel
    assert abs(res["rays"] - rays_j) <= 1e-3 * rays_j, (res["rays"], rays_j)
    # against the unsharded 2-spp engine: other streams, the same estimator
    e = engine(box, 1, rt_mode=1, samples=2, depth=2, corr_sampler=False)
    b = e.accum[e._inv_perm].numpy()
    finite = np.isfinite(a) & np.isfinite(b) & (np.abs(b) < 50) & (np.abs(a) < 50)
    assert abs(a[finite].mean() - b[finite].mean()) < 0.3


def test_sharded_hybrid_matches_single_device(box, mesh41):
    res = mesh41[1]
    (img,) = res["images"]
    e = engine(box, 1, rt_mode=0, use_gi=True, corr_sampler=False)
    inv = e._inv_perm
    np.testing.assert_allclose(img["accum"].numpy(), e.accum_rt[inv].numpy(), **TOL)
    np.testing.assert_allclose(img["color"].numpy(), e.gbuffer.color[inv].numpy(), **TOL)
    assert res["rays"] == e.total_rays


def test_sharded_hybrid_denoised_matches_single_device(box, mesh41):
    """Suite row 5's stack (hybrid, GI, the temporal denoiser) under a
    mesh, per pixel against the engine over 2 frames."""
    res = mesh41[2]
    (img,) = res["images"]
    e = engine(box, 2, rt_mode=0, use_gi=True, use_denoiser=True, temporal_denoiser=True,
               corr_sampler=False)
    np.testing.assert_allclose(img["accum"].numpy(), e.accum_rt[e._inv_perm].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert res["rays"] == e.total_rays


def test_sharded_corr_hybrid_smoke(mesh41):
    """Hybrid and GI with the correlated sampler under (4,1): finite, in
    the exposure range of the sampler-off render, and a different
    estimate."""
    outs = [mesh41[i]["images"][0]["accum"].numpy() for i in (3, 4)]
    for i, a in zip((3, 4), outs):
        assert np.isfinite(a).all() and mesh41[i]["rays"] > 0
    assert not np.allclose(outs[0], outs[1])
    assert abs(outs[0].mean() - outs[1].mean()) < 0.1


def test_sharded_corr_mesh11_matches_engine(box):
    """Mesh (1,1) salts the correlated sampler's tables to 0: bit for bit
    the engine's correlated render."""
    (res,) = launch(run_jobs, 1, 1, "cpu", [path_job(corr=True)])
    e = engine(box, 2, rt_mode=1, corr_sampler=True)
    assert torch.equal(res["accum"], e.accum[e._inv_perm])
    assert res["rays"] == e.total_rays


def test_sharded_corr_multishard_statistics(box, mesh22, mesh41):
    """The correlated sampler over (2,2): valid, in mean agreement with the
    unsharded correlated render, and the spp groups decorrelated (the
    1-spp (4,1) render of the same frame differs)."""
    res = mesh22[1]
    a = res["accum"].numpy()
    assert np.isfinite(a).all() and a.max() > 0 and res["rays"] > 0
    e = engine(box, 2, rt_mode=1, samples=2, depth=2, corr_sampler=True)
    b = e.accum[e._inv_perm].numpy()
    finite = np.isfinite(a) & np.isfinite(b) & (np.abs(b) < 50) & (np.abs(a) < 50)
    assert abs(a[finite].mean() - b[finite].mean()) < 0.3
    assert not np.allclose(mesh41[5]["accum"].numpy(), a, atol=1e-4)


def test_sharded_pathtrace_with_kernel_a_tracer(mesh41, mesh22):
    """Kernel A's tracer (``make_tracer("pallas")``, its plain version on
    CPU tensors) under the mesh: valid at (2,2), and at (4,1) equal to the
    unsharded frame but at seam pixels."""
    from vkrt_tpu_torch.models.pathtracer import pathtrace_frame
    from vkrt_tpu_torch.ops.trace import make_tracer

    a = mesh22[2]["accum"].numpy()
    assert np.isfinite(a).all() and a.max() > 0 and mesh22[2]["rays"] > 0
    w, h = 32, 16
    scene = make_cornell_box(device="cpu")
    ref, _ = pathtrace_frame(scene, make_tracer(scene, "pallas"),
                             Camera().matrices(w, h, "cpu"), 0,
                             torch.zeros((w * h, 3)), CLEAR, width=w, height=h, samples=1,
                             depth=2)
    got, want = mesh41[6]["accum"].numpy(), ref.numpy()
    mismatched = np.any(np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want), axis=-1)
    assert mismatched.mean() < 0.01, f"{mismatched.sum()}/{mismatched.size} pixels differ"


def check_denoised(got, ref, jref):
    filtered, state = got
    np.testing.assert_allclose(filtered.numpy(), ref[0].numpy(), **TOL)
    np.testing.assert_allclose(filtered.numpy(), np.asarray(jref[0]), **TOL)
    for a, b, c in zip(state, ref[1], jref[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **TOL)


def test_denoise_tile_equals_full(denoise_case, mesh41):
    """4 bands of 8 rows (the tap reach), the history reprojecting across
    band borders: per pixel the full-frame filter of both packages."""
    check_denoised(mesh41[7], *denoise_case[1:])


@pytest.mark.parametrize("n_bands", [1, 2])
def test_denoise_tile_ring_sizes(denoise_case, n_bands):
    """The ring's degenerate sizes: one band (the periodic self-wrap) and
    two (both neighbours are one rank; the two messages must not swap)."""
    args, ref, jref = denoise_case
    (got,) = launch(run_jobs, n_bands, 1, "cpu", [dict(kind="denoise", args=args)])
    check_denoised(got, ref, jref)
