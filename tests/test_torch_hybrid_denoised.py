"""The port's denoised hybrid frame (``hybrid_frame`` with ``use_denoiser``)
against the JAX package's on the Cornell box with GI (depth 2), in the engine's
layout (32x32-tile-ordered pixels seeded by their pixel ids, ``perm`` and
``inv_perm`` given), both given the same hits (``JaxTracer``):

* the temporal denoiser over two frames with the camera moving between
  them (the state carried in each package) and the spatial-only filter, at
  a tile-aligned width (the un-tile and re-tile run as reshape copies) and
  at a width that is not (row gathers): the accumulated RGBA through the
  display gate of tests/test_accuracy_oracle.py:83-88, rays exact, the
  history's length within 1e-5 and its validity exact;
* ``utils/camera.py::retile`` equal to ``img[perm]`` bit for bit for widths
  that are multiples of 32 and heights that are not, and ``untile`` its
  inverse."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vkrt_tpu.scene as jscene
from test_torch_gbuffer import JaxTracer, port_cam, port_scene
from test_torch_pathtracer import display_gate
from vkrt_tpu.models import denoiser as jd
from vkrt_tpu.models.hybrid import hybrid_frame as j_hybrid_frame
from vkrt_tpu.ops.rng import tea as j_tea
from vkrt_tpu.ops.trace import make_tracer as j_make_tracer
from vkrt_tpu.utils.camera import orbit_camera as j_orbit_camera
from vkrt_tpu.utils.camera import pixel_coords as j_pixel_coords
from vkrt_tpu.utils.camera import retile as j_retile, tile_perm
from vkrt_tpu_torch.models import denoiser as dn
from vkrt_tpu_torch.models.hybrid import hybrid_frame
from vkrt_tpu_torch.ops.rng import tea
from vkrt_tpu_torch.utils.camera import pixel_coords, retile, untile

torch.set_num_threads(2)
CLEAR = (1.0, 1.0, 1.0, 1.0)


@pytest.fixture(scope="module")
def box():
    js = jscene.make_cornell_box()
    return js, j_make_tracer(js, "auto"), port_scene(js)


@pytest.mark.parametrize("width,height", [(64, 40), (40, 32)])
@pytest.mark.parametrize("temporal", [True, False])
def test_denoised_hybrid_frame_matches_jax(box, width, height, temporal):
    js, jt, ts = box
    n = width * height
    perm, inv = tile_perm(width, height)
    jperm, jinv = jnp.asarray(perm), jnp.asarray(inv)
    tperm, tinv = (torch.from_numpy(a.astype(np.int64)) for a in (perm, inv))
    jpix = jnp.take(j_pixel_coords(width, height), jperm, axis=0)
    tpix = pixel_coords(width, height)[tperm]
    kw = dict(width=width, height=height, depth=2, use_shadows=True, use_ao=True,
              use_gi=True, use_denoiser=True, corr=True)
    j_state = jd.init_state(width, height) if temporal else None
    t_state = dn.init_state(width, height, "cpu") if temporal else None
    # a fly-through: the camera moves every frame, so each frame is frame 0
    for step in range(2 if temporal else 1):
        jm = j_orbit_camera(0.004 * step, radius=15.0, height=0.5).matrices(width, height)
        _, j_acc, j_rays, j_state = j_hybrid_frame(
            js, jt, jm, 0, jnp.zeros((n, 4)), jnp.asarray(CLEAR), pix=jpix,
            seeds=j_tea(jnp.asarray(perm.astype(np.uint32)), jnp.uint32(0)), perm=jperm,
            inv_perm=jinv, denoise_state=j_state, **kw)
        _, acc, rays, t_state = hybrid_frame(
            ts, JaxTracer(jt), port_cam(jm), 0, torch.zeros((n, 4)), CLEAR, pix=tpix,
            seeds=tea(tperm, 0), perm=tperm, inv_perm=tinv, denoise_state=t_state, **kw)
        assert float(rays) == float(j_rays)
        got, want = acc.numpy().astype(np.float64), np.asarray(j_acc, np.float64)
        assert np.isfinite(got).all()
        display_gate(got[:, :3], want[:, :3])
        np.testing.assert_array_equal(got[:, 3], want[:, 3])  # alpha is not filtered
        if temporal:
            jl = np.asarray(j_state.hist_len)
            np.testing.assert_allclose(t_state.hist_len.numpy(), jl, rtol=0, atol=1e-5)
            np.testing.assert_array_equal(t_state.hist_len.numpy() > 1.0, jl > 1.0)
    if temporal:
        assert (t_state.hist_len.numpy() > 1.0).mean() > 0.5  # the history was reprojected


@pytest.mark.parametrize("width,height", [(32, 8), (64, 40), (96, 70), (128, 32)])
def test_retile_is_img_perm(width, height):
    perm, _ = tile_perm(width, height)
    rng = np.random.default_rng(width + height)
    for feats in ((), (3,)):
        img = rng.normal(size=(width * height, *feats)).astype(np.float32)
        got = retile(torch.from_numpy(img), width, height)
        np.testing.assert_array_equal(got.numpy(), img[perm])
        np.testing.assert_array_equal(np.asarray(j_retile(jnp.asarray(img), width, height)),
                                      got.numpy())
        assert torch.equal(untile(got, width, height), torch.from_numpy(img))
    with pytest.raises(ValueError):
        retile(torch.zeros(40 * 8), 40, 8)
