"""The port's hybrid ``Engine`` and app, with the port's own tracer:

* the hybrid cases of tests/test_golden.py (``hybrid_default_f2``,
  ``hybrid_gi_f2``: the Cornell box at 64x48, 2 frames) against a live
  render of the JAX package (its engine's frame, eager, on its brute-force
  tracer): the display gate of tests/test_accuracy_oracle.py:83-88, rays
  within 0.1%, and the 8-bit image's mean within 0.25 of the golden's;
* the engine's rules: the composite and ``view_accumulated``, a background
  of exactly the clear colour, switching modes, the max-frames early-out,
  the denoiser's history (allocated with temporal denoised GI, kept across
  a camera move, reallocated on a settings change) and the alpha tracer's
  rebuild on ``alpha_test``;
* the CLI: ``--mode hybrid`` is the default and its flags reach the
  settings; a PNG is written;
* the loop choice and the shadow-lane sign: a tracer with ``with_seed`` and
  no ``anyhit_kill_capable`` (an alpha tracer's shape) takes the general loop
  with positive shadow limits and is handed the JAX package's seeds at every
  trace (the visibility pool and the GI chain's three sites), and the frame
  matches the JAX package's given the same kind of tracer."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vkrt_tpu.scene as jscene
import vkrt_tpu_torch.models.pathtracer as tpt
from test_torch_gbuffer import JaxTracer, port_cam, port_scene
from test_torch_pathtracer import display_gate
from vkrt_tpu.config import RenderSettings as JSettings
from vkrt_tpu.models import post as j_post
from vkrt_tpu.models.hybrid import hybrid_frame as j_hybrid_frame
from vkrt_tpu.ops.rng import tea as j_tea
from vkrt_tpu.ops.trace import make_tracer as j_make_tracer
from vkrt_tpu.utils.camera import Camera as JCamera, pixel_coords as j_pixel_coords, tile_perm
from vkrt_tpu_torch.config import RenderSettings
from vkrt_tpu_torch.engine import Engine
from vkrt_tpu_torch.models.hybrid import hybrid_frame
from vkrt_tpu_torch.models.post import to_u8_image
from vkrt_tpu_torch.ops.alpha import AlphaTracer
from vkrt_tpu_torch.ops.trace import make_tracer
from vkrt_tpu_torch.scene import make_city, make_cornell_box
from vkrt_tpu_torch.utils.camera import Camera, orbit_camera, pixel_coords

torch.set_num_threads(2)
GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__), "golden.json")))
W, H = 64, 48  # tests/test_golden.py's size
CLEAR = (1.0, 1.0, 1.0, 1.0)


def jax_engine_frames(js, settings, frames: int, jcam=JCamera(), w: int = W, h: int = H):
    """The JAX engine's hybrid frames, eager: tile-ordered pixels seeded by
    their pixel ids, the composite, then scanline order. Returns (image
    (N,3), rays)."""
    perm, inv = tile_perm(w, h)
    pix = jnp.take(j_pixel_coords(w, h), jnp.asarray(perm), axis=0)
    pid = jnp.asarray(perm.astype(np.uint32))
    jt = j_make_tracer(js, "auto")
    cam = jcam.matrices(w, h)
    accum, rays = jnp.zeros((w * h, 4), jnp.float32), 0.0
    for f in range(frames):
        gbuf, accum, r, _ = j_hybrid_frame(
            js, jt, cam, f, accum, jnp.asarray(CLEAR), width=w, height=h, depth=settings.depth,
            use_shadows=settings.use_shadows, use_ao=settings.use_ao, use_gi=settings.use_gi,
            use_denoiser=False, corr=settings.corr_sampler, pix=pix,
            seeds=j_tea(pid, jnp.uint32(f)))
        rays += float(r)
    out = j_post.composite(gbuf.color[:, :3], accum, rt_mode=0, view_accumulated=False,
                           use_gi=settings.use_gi)
    return np.asarray(out, np.float64)[inv], rays


@pytest.mark.parametrize("case", ["hybrid_default_f2", "hybrid_gi_f2"])
def test_engine_matches_jax_golden_cases(case):
    js_settings = {"hybrid_default_f2": JSettings(rt_mode=0),
                   "hybrid_gi_f2": JSettings(rt_mode=0, use_gi=True)}[case]
    want, rays_j = jax_engine_frames(jscene.make_cornell_box(), js_settings, 2)
    settings = RenderSettings(**{k: getattr(js_settings, k) for k in
                                 ("rt_mode", "use_gi", "depth", "corr_sampler")})
    assert settings == RenderSettings(rt_mode=0, use_gi=settings.use_gi)
    eng = Engine(make_cornell_box(device="cpu"), W, H, settings)
    for _ in range(2):
        out = eng.render_frame()
    got = out.numpy().astype(np.float64)
    assert np.isfinite(got).all()
    display_gate(got, want)
    assert abs(eng.total_rays - rays_j) <= 1e-3 * rays_j, (eng.total_rays, rays_j)
    img = to_u8_image(out, W, H)
    assert abs(float(img.mean()) - GOLDEN[case]["mean"]) <= 0.25, (img.mean(), GOLDEN[case])


def test_engine_composite_view_accumulated_and_background():
    clear = (0.2, 0.3, 0.4, 1.0)
    city = make_city(grid=4, device="cpu")
    cam = orbit_camera(0.12, radius=14.0, height=5.0)
    for width, gi in ((32, False), (40, True)):  # tile-aligned width or not
        eng = Engine(city, width, 24, RenderSettings(use_gi=gi), cam, clear)
        for _ in range(3):
            out = eng.render_frame()
            g, acc = eng._untile(eng.gbuffer.color), eng._untile(eng.accum_rt)
            want = g[:, :3] * acc[:, 3:4] + acc[:, :3]
            assert torch.equal(out, want)
            # a background pixel shows the clear colour exactly
            bg = (eng._untile(eng.gbuffer.position)[:, :3] == 0).all(1)
            assert 0.05 < bg.float().mean() < 0.95
            assert (out[bg] == torch.tensor(clear[:3])).all()
        assert (acc[:, 3] < 0.99).any()  # shadows and AO darken somewhere
        # the debug view, from the same buffers (a settings change resets
        # the frame, so compare the composite of one new frame)
        eng.update_settings(eng.settings.replace(view_accumulated=True))
        out = eng.render_frame()
        acc = eng._untile(eng.accum_rt)
        want = acc[:, :3] * acc[:, 3:4] if gi else acc[:, 3:4].expand(-1, 3)
        assert torch.equal(out, want)


def test_engine_modes_max_frames_and_refusals():
    box = make_cornell_box(device="cpu")
    w, h = 32, 24

    def first_frame(settings):
        return Engine(box, w, h, settings).render_frame()

    eng = Engine(box, w, h)  # the default settings: hybrid
    assert eng.settings.rt_mode == 0
    eng.render_frame()
    eng.render_frame()
    # a mode switch reallocates the buffers and restarts accumulation
    eng.update_settings(eng.settings.replace(rt_mode=1))
    assert eng.gbuffer is None and not eng.accum_rt.any() and eng.frame == -1
    assert torch.equal(eng.render_frame(), first_frame(RenderSettings(rt_mode=1)))
    eng.update_settings(eng.settings.replace(rt_mode=0))
    assert eng.gbuffer is None and not eng.accum.any()
    assert torch.equal(eng.render_frame(), first_frame(RenderSettings()))
    # clamp and view toggles keep the buffers
    gbuf = eng.gbuffer
    eng.update_settings(eng.settings.replace(clamp_weights=True))
    assert eng.gbuffer is gbuf

    # max frames: frames past the limit are not rendered and keep the image
    eng = Engine(box, w, h, RenderSettings(stop_at_max_frames=True, max_frames=2))
    outs, rays = [], []
    for _ in range(4):
        outs.append(eng.render_frame())
        rays.append(eng.total_rays)
    assert rays[0] > 0 and rays[1] > rays[0] and rays[3] == rays[2] == rays[1]
    assert torch.equal(outs[3], outs[1])
    # hybrid renders once first when it has no G-buffer to show; path
    # mode has its (black) image
    eng = Engine(box, w, h, RenderSettings(stop_at_max_frames=True, max_frames=0))
    eng.render_frame()
    r0 = eng.total_rays
    eng.render_frame()
    assert r0 > 0 and eng.total_rays == r0
    eng = Engine(box, w, h, RenderSettings(rt_mode=1, stop_at_max_frames=True, max_frames=0))
    assert not eng.render_frame().any() and eng.total_rays == 0

    # denoised GI: the temporal denoiser's history exists exactly with
    # temporal denoised GI in hybrid mode; a camera move keeps it (the frame
    # counter restarts), a settings change reallocates it. Without GI hybrid
    # ignores use_denoiser, as the JAX engine does
    assert eng.denoise_state is None
    eng = Engine(box, w, h, RenderSettings(use_denoiser=True, use_gi=True))
    assert eng.denoise_state is not None and not eng.denoise_state.hist_len.any()
    eng.render_frame()
    eng.render_frame()
    assert float(eng.denoise_state.hist_len.max()) == 2.0
    eng.camera = Camera(eye=(0.2, 0.0, 15.0))
    eng.render_frame()
    assert eng.frame == 0 and float(eng.denoise_state.hist_len.max()) > 2.0
    eng.update_settings(eng.settings.replace(temporal_denoiser=False))
    assert eng.denoise_state is None and eng.frame == -1
    eng.update_settings(eng.settings.replace(temporal_denoiser=True))
    assert not eng.denoise_state.hist_len.any()
    eng.resize(w, 16)
    assert eng.denoise_state.hist_len.shape == (w * 16,)
    for s in (RenderSettings(use_denoiser=True), RenderSettings(rt_mode=1, use_gi=True,
                                                                use_denoiser=True)):
        assert Engine(box, w, h, s).denoise_state is None
    assert torch.equal(first_frame(RenderSettings(use_denoiser=True)),
                       first_frame(RenderSettings()))
    with pytest.raises(ValueError, match="whole frame"):  # pix without inv_perm
        hybrid_frame(box, make_tracer(box), Camera().matrices(w, h, "cpu"), 0,
                     torch.zeros((w * h, 4)), CLEAR, width=w, height=h, depth=2,
                     use_shadows=False, use_ao=False, use_gi=True, use_denoiser=True,
                     pix=pixel_coords(w, h))
    # alpha_test: the tracer is rebuilt when it changes; an opaque scene
    # keeps its plain tracer, so its frames do not change
    eng = Engine(box, w, h, RenderSettings(alpha_test=True))
    assert not isinstance(eng.tracer, AlphaTracer)
    assert torch.equal(eng.render_frame(), first_frame(RenderSettings()))
    glass = box._replace(mat_alpha_mode=torch.tensor([0, 0, 0, 0, 2], dtype=torch.int32))
    eng = Engine(glass, w, h)
    eng.update_settings(eng.settings.replace(alpha_test=True))
    assert isinstance(eng.tracer, AlphaTracer)
    eng.update_settings(eng.settings.replace(alpha_test=False))
    assert not isinstance(eng.tracer, AlphaTracer)


def test_app_hybrid_cli(tmp_path, monkeypatch):
    import vkrt_tpu_torch.engine as engine_mod
    from vkrt_tpu.utils.png import decode_png
    from vkrt_tpu_torch import app

    args = app.build_argparser().parse_args([])
    assert args.mode == "hybrid" and not (args.no_shadows or args.no_ao or args.gi
                                          or args.view_accumulated)
    seen = []

    class Recording(engine_mod.Engine):
        def __init__(self, scene, width, height, settings, *a):
            seen.append(settings)
            super().__init__(scene, width, height, settings, *a)

    monkeypatch.setattr(engine_mod, "Engine", Recording)
    out = tmp_path / "hy.png"
    rc = app.main(["--procedural", "cornell", "--width", "32", "--height", "24", "--frames",
                   "2", "--device", "cpu", "--gi", "--no-ao", "--out", str(out)])
    assert rc == 0
    png = decode_png(out.read_bytes())
    assert png.shape[:2] == (24, 32) and png[..., :3].mean() > 10
    assert seen[-1] == RenderSettings(use_gi=True, use_ao=False)
    rc = app.main(["--procedural", "cornell", "--mode", "hybrid", "--width", "32", "--height",
                   "24", "--device", "cpu", "--no-shadows", "--view-accumulated", "--out",
                   str(out)])
    assert rc == 0 and seen[-1] == RenderSettings(use_shadows=False, view_accumulated=True)


class SeededTracer:
    """An alpha tracer's shape around another tracer: ``with_seed`` and no
    ``anyhit_kill_capable``. Logs every call's limits."""

    def __init__(self, inner, log):
        self.inner, self.log = inner, log

    def with_seed(self, seed):
        self.log.append(("seed", seed))
        return self

    def closest(self, orig, direction, t_min, t_max, t_lim=None):
        self.log.append(("closest", t_lim))
        return self.inner.closest(orig, direction, t_min, t_max, t_lim=t_lim)

    def any(self, orig, direction, t_min, t_max):
        self.log.append(("any", t_max))
        return self.inner.any(orig, direction, t_min, t_max)


def test_seeded_tracer_takes_the_general_loop_with_positive_limits(monkeypatch):
    js = jscene.make_cornell_box()
    ts = port_scene(js)
    jm = JCamera().matrices(W, H)
    kw = dict(width=W, height=H, depth=3, use_shadows=True, use_ao=True, use_gi=True,
              use_denoiser=False)
    jlog, log = [], []
    jt = j_make_tracer(js, "auto")
    _, j_acc, j_rays, _ = j_hybrid_frame(js, SeededTracer(jt, jlog), jm, 0,
                                         jnp.zeros((W * H, 4)), jnp.asarray(CLEAR), **kw)
    monkeypatch.setattr(tpt, "bounce_chain_packed", None)  # must not be reached
    _, acc, rays, _ = hybrid_frame(ts, SeededTracer(JaxTracer(jt), log), port_cam(jm), 0,
                                   torch.zeros((W * H, 4)), CLEAR, **kw)
    assert float(rays) == float(j_rays)
    display_gate(acc.numpy().astype(np.float64), np.asarray(j_acc, np.float64))
    # the same traces in the same order, each seeded as in the JAX package:
    # the visibility pool, then the GI chain's start, fused pool and last any
    assert [k for k, _ in log] == [k for k, _ in jlog]
    assert [k for k, _ in log].count("seed") == 4
    assert log[1][0] == "seed" and torch.is_tensor(log[1][1])  # the visibility pool's seeds
    for (k, seed), (_, j_seed) in zip(log, jlog):
        if k == "seed":
            np.testing.assert_array_equal(seed.numpy().view(np.uint32), np.asarray(j_seed))
    n = W * H
    fused = [lim for k, lim in log if k == "closest" and lim is not None and lim.shape[0] == 2 * n]
    assert fused and all((lim[n:] >= 0).all() for lim in fused)
    assert any((lim[n:] > 0).any() for lim in fused)
    assert all((torch.as_tensor(lim) >= 0).all() for k, lim in log if k == "any")
