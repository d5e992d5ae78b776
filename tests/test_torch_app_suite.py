"""The port's app flags (``vkrt_tpu_torch/app.py``) and benchmark suite
(``vkrt_tpu_torch/benchmarks/suite.py``) on the CPU:

* every flag the port took from ``vkrt_tpu/app.py``: ``--scene``,
  ``--scene-index``, ``--max-frames``, ``--backend``, ``--orbit`` (one PNG a
  frame with an ``_NNNN`` suffix), ``--save-state`` / ``--load-state`` (the
  frame counter resumes), ``--stats``, ``--trace-dir`` and
  ``--interactive`` (a stdin script);
* ``--backend bvh``, ``pallas`` and ``auto`` render the image
  ``bruteforce`` renders, bit for bit, and their tracers give the same
  hits;
* one ``--scene`` render (the sponzoid at tess 1, path mode, depth 2,
  32x24) against the JAX package's app on the display gate of
  tests/test_accuracy_oracle.py:83-88;
* suite rows 1 and 2 at 32x24 with the JAX suite's row names and JSON keys
  (``benchmarks/suite.py::run_engine_bench``)."""

import io
import json
import os

import numpy as np
import pytest
import torch

import vkrt_tpu.app as japp
from test_torch_pathtracer import display_gate
from vkrt_tpu_torch import app
from vkrt_tpu_torch.benchmarks import suite
from vkrt_tpu_torch.ops.trace import make_tracer
from vkrt_tpu_torch.scene import make_city
from vkrt_tpu_torch.utils.png import decode_png
from vkrt_tpu_torch.utils.sponzoid import sponzoid_path

torch.set_num_threads(2)
SMALL = ["--device", "cpu", "--procedural", "cornell", "--mode", "path", "--width", "32",
         "--height", "24"]
# the keys of a row of the JAX suite (benchmarks/suite.py::run_engine_bench)
JAX_ROW_KEYS = {"config", "ms_per_frame", "fps", "mrays_per_s", "frames", "resolution"}


@pytest.fixture(scope="module")
def sponzoid(tmp_path_factory):
    """The sponzoid at tess 1, JPEG form (as the JAX package writes it)."""
    return sponzoid_path(str(tmp_path_factory.mktemp("sponzoid")), tess=1)


def _img(path):
    return decode_png(open(path, "rb").read())[..., :3]


def test_settings_flags(monkeypatch, tmp_path):
    """--max-frames, --backend and --scene-index reach the engine."""
    from vkrt_tpu_torch import engine as eng_mod

    seen = {}
    init = eng_mod.Engine.__init__

    def spy(self, scene, width, height, settings, *a, **kw):
        seen.update(settings=settings, tris=scene.num_tris)
        init(self, scene, width, height, settings, *a, **kw)

    monkeypatch.setattr(eng_mod.Engine, "__init__", spy)
    out = tmp_path / "o.png"
    assert app.main(SMALL + ["--frames", "3", "--max-frames", "1", "--backend", "bvh",
                             "--out", str(out)]) == 0
    s = seen["settings"]
    assert (s.max_frames, s.stop_at_max_frames, s.backend) == (1, True, "bvh")
    assert out.exists()

    scene_file = sponzoid_path(str(tmp_path / "spz"), tess=1, texture_format="png")
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"scenes": ["absent.gltf", scene_file], "scene": 0,
                               "width": 8, "height": 6}))
    assert app.main(["--device", "cpu", "--config", str(cfg), "--scene-index", "1",
                     "--mode", "path", "--depth", "1", "--out", str(out)]) == 0
    assert seen["tris"] == 26752
    assert _img(out).shape == (6, 8, 3)


def test_max_frames_keeps_the_image(tmp_path, capsys):
    """With the limiter at 1, frames 2 and 3 are not rendered: the image is
    frame 0's."""
    one, three = tmp_path / "one.png", tmp_path / "three.png"
    app.main(SMALL + ["--frames", "1", "--out", str(one)])
    app.main(SMALL + ["--frames", "3", "--max-frames", "1", "--out", str(three)])
    assert "frame counter 2" in capsys.readouterr().out
    np.testing.assert_array_equal(_img(one), _img(three))


def test_backends_render_the_same_image(tmp_path):
    imgs = {}
    for backend in ("bruteforce", "bvh", "pallas", "auto"):
        out = tmp_path / f"{backend}.png"
        assert app.main(SMALL + ["--frames", "2", "--depth", "3", "--backend", backend,
                                 "--out", str(out)]) == 0
        imgs[backend] = _img(out)
    for backend, img in imgs.items():
        np.testing.assert_array_equal(img, imgs["bruteforce"], err_msg=backend)
    # the tracers' hits, bit for bit, on the small city
    city = make_city(grid=4, device="cpu")
    rng = np.random.default_rng(2)
    o = torch.tensor(rng.uniform(-8, 8, (2048, 3)) * [1, 0.5, 1] + [0, 4, 0],
                     dtype=torch.float32)
    d = torch.tensor(rng.normal(size=(2048, 3)), dtype=torch.float32)
    lim = torch.full((2048,), 1e4)
    hits = {b: make_tracer(city, b).trace(o, d, lim) for b in ("bruteforce", "bvh", "pallas")}
    for b, h in hits.items():
        for x, y in zip(h, hits["bruteforce"]):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), b
    with pytest.raises(ValueError, match="unknown trace backend"):
        make_tracer(city, "lbvh")


def test_scene_render_matches_jax_app(tmp_path, sponzoid, monkeypatch):
    """``--scene``: the port's app against the JAX package's on one glTF
    file (both on brute force), the 8-bit images through the display gate."""
    monkeypatch.setenv("VKRT_XLA_CACHE", str(tmp_path / "xla"))  # the JAX app's compile cache
    args = ["--scene", sponzoid, "--mode", "path", "--depth", "2", "--width", "32",
            "--height", "24", "--frames", "1", "--eye", "0", "6", "26", "--lookat", "0", "5",
            "0", "--backend", "bruteforce"]
    assert japp.main(args + ["--cpu", "--out", str(tmp_path / "jax.png")]) == 0
    assert app.main(args + ["--device", "cpu", "--out", str(tmp_path / "port.png")]) == 0
    want = (_img(tmp_path / "jax.png") / 255.0) ** 2.2  # back to linear for the gate
    got = (_img(tmp_path / "port.png") / 255.0) ** 2.2
    assert got.std() > 0.02
    display_gate(got.reshape(-1, 3), want.reshape(-1, 3))


def test_orbit_stats_state_and_trace(tmp_path, capsys, sponzoid):
    """--orbit writes a PNG a frame; --stats prints the frame stats JSON;
    --save-state then --load-state resumes the frame counter; --trace-dir
    writes a Chrome trace."""
    spz = ["--device", "cpu", "--scene", sponzoid, "--mode", "path", "--depth", "1",
           "--width", "16", "--height", "12", "--lookat", "0", "5", "0"]
    fly = tmp_path / "fly.png"
    assert app.main(spz + ["--frames", "3", "--orbit", "--orbit-radius", "20",
                           "--orbit-height", "6", "--stats", "--out", str(fly)]) == 0
    err = capsys.readouterr().err
    assert json.loads(err.strip().splitlines()[-1])["frames"] == 3
    frames = [_img(tmp_path / f"fly_{f:04d}.png") for f in range(3)]
    assert all(f.shape == (12, 16, 3) for f in frames)
    assert np.abs(frames[0].astype(int) - frames[2]).max() > 0  # the camera moved

    state = tmp_path / "state.npz"
    still = spz + ["--eye", "0", "6", "26", "--frames", "2", "--out", str(tmp_path / "s.png")]
    assert app.main(still + ["--save-state", str(state), "--trace-dir",
                             str(tmp_path / "trace")]) == 0
    assert state.exists()
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1 and "pathtrace" in traces[0].read_text()
    capsys.readouterr()
    assert app.main(still + ["--load-state", str(state)]) == 0
    out = capsys.readouterr().out
    assert "resume from" in out and "ok, frame 1" in out and "frame counter 3" in out
    # a checkpoint of another camera is refused
    assert app.main(spz + ["--eye", "1", "6", "26", "--frames", "1", "--load-state",
                           str(state), "--out", str(tmp_path / "r.png")]) == 0
    assert "rejected" in capsys.readouterr().out


def test_interactive_script(tmp_path, monkeypatch, capsys):
    script = ("render 2\nset depth 4\nset view_accumulated 1\nset nonsense 1\n"
              "clear 0 0 0\neye 0 1 14\nfov 50\nrender 1\nstats\n# a comment\n\n"
              f"save {tmp_path / 'saved.png'}\nbogus\nset depth\nquit\nrender 5\n")
    monkeypatch.setattr("sys.stdin", io.StringIO(script))
    out_png = tmp_path / "final.png"
    assert app.main(SMALL + ["--interactive", "--out", str(out_png)]) == 0
    out = capsys.readouterr().out
    for want in ("rendered 2 frame(s)", "frame counter 1", "depth = 4 (buffers reallocated)",
                 "view_accumulated = True (buffers kept)", "unknown setting 'nonsense'",
                 "clear color set", "eye set", "fov set", "rendered 1 frame(s)",
                 "frame 0, last", f"wrote {tmp_path / 'saved.png'}", "unknown command 'bogus'",
                 "bad command 'set depth'", f"wrote {out_png}"):
        assert want in out, want
    assert "rendered 5" not in out  # nothing after quit
    assert os.path.exists(tmp_path / "saved.png") and out_png.exists()


def test_suite_rows_1_2(capsys):
    recs = suite.main(["--device", "cpu", "--width", "32", "--height", "24", "--frames", "2",
                       "--configs", "1,2"])
    assert [r["config"] for r in recs] == ["cornell_1spp_1bounce", "cornell_multibounce_accum"]
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines == recs
    for r in recs:
        assert JAX_ROW_KEYS <= set(r) and r["device"] == "cpu"
        assert r["frames"] == 2 and r["resolution"] == "32x24" and r["mrays_per_s"] > 0
    with pytest.raises(SystemExit):
        suite.main(["--device", "cpu", "--configs", "9"])  # no such row
    with pytest.raises(AssertionError, match="non-finite"):
        suite._assert_finite_image("x", np.array([0.0, np.nan]))
    with pytest.raises(AssertionError, match="all-zero"):
        suite._assert_finite_image("x", np.zeros(4))
