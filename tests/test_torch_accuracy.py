"""The accuracy anchor (``vkrt_tpu_torch/benchmarks/accuracy.py``) and the
port's float64 plain path it rests on, against the JAX package's f64 oracle
(``tests/test_accuracy_oracle.py:43-61``): the Cornell box at 64x48, spp 1,
depth 3, 3 frames, scanline order, the same seeds.

* The port's f64 oracle (brute force, the general loop) against JAX's f64
  oracle run eagerly, op by op as the port computes: ray counts within
  0.1% (exact, measured); a pixel's walk has parted when one of its main
  rays hit another triangle, or one of its shadow rays got another
  verdict (both tracers recorded). Every pixel whose displayed value is
  off by more than 1e-6 is one whose walk parted, and such pixels are at
  most 0.1%. The walks part only at coplanar ties, the floor against the
  boxes' bottom faces at y = -5, decided by the last ulp of t (XLA
  compiles ``jnp.cross`` even eagerly, and contracts it); most of them
  change no displayed value. Elsewhere the renders differ by the
  sampling's f32 transcendentals (sqrt, cos, sin of the draws, 1 ulp
  apart between XLA and torch on some inputs).
* The same against JAX's oracle jitted, as tests/test_accuracy_oracle.py
  runs it: XLA then contracts the f64 products (tests/test_torch_contraction.py
  shows its contraction in f32), which moves a few lanes onto the
  sign-unclamped specular weight's near-singular points (an accumulator of
  about -1e9), so it is held to the display gate and rays within 0.1%.
  Run with ``-s`` for the measured values.
* The port's f32 plain render against its own f64 oracle on the display
  gate: ``accuracy.run(device="cpu")``; the record's keys; exit 5 when the
  f32 image is off; no card, no render on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkrt_tpu.scene as jscene
from vkrt_tpu.models.pathtracer import pathtrace_frame as j_pathtrace_frame
from vkrt_tpu.ops.trace import make_tracer as j_make_tracer
from vkrt_tpu.utils.camera import Camera as JCamera
from vkrt_tpu_torch.benchmarks import accuracy
from vkrt_tpu_torch.models.pathtracer import pathtrace_frame

torch.set_num_threads(2)
W, H, FRAMES, DEPTH = accuracy.W, accuracy.H, accuracy.FRAMES, accuracy.DEPTH
KEYS = ("workload", "device", "rmse_display", "p99_abs_err", "diverged_frac",
        "budget_rmse", "ok", "power_limit")


class Recorder:
    """A tracer that logs what each trace returned: the triangle ids of a
    closest trace, the verdicts of an any-hit trace."""

    def __init__(self, inner, to_numpy):
        self.inner, self.to_numpy, self.log = inner, to_numpy, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def closest(self, *args, **kw):
        hit = self.inner.closest(*args, **kw)
        self.log.append(self.to_numpy(hit.tri))
        return hit

    def any(self, *args, **kw):
        verdict = self.inner.any(*args, **kw)
        self.log.append(self.to_numpy(verdict))
        return verdict


def _render_jax(jit: bool, record: bool = False):
    """JAX's f64 oracle (tests/test_accuracy_oracle.py:43-61). Returns (the
    accumulator, rays a frame, the tracer's log)."""
    js = jscene.make_cornell_box()
    with jax.enable_x64():
        s64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                           if a.dtype == jnp.float32 else jnp.asarray(a), js)
        tracer = j_make_tracer(s64, "bruteforce")
        if record:
            tracer = Recorder(tracer, np.asarray)
        cam = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), JCamera().matrices(W, H))
        clear = jnp.asarray([1.0, 1.0, 1.0, 1.0], jnp.float64)

        def step(c, f, accum):
            return j_pathtrace_frame(s64, tracer, c, f, accum, clear, width=W, height=H,
                                     samples=1, depth=DEPTH)

        step = jax.jit(step, static_argnums=1) if jit else step
        accum, rays = jnp.zeros((W * H, 3), jnp.float64), []
        for f in range(FRAMES):
            accum, r = step(cam, f, accum)
            rays.append(float(r))
        return np.asarray(accum), rays, getattr(tracer, "log", None)


def _render_port():
    """The anchor's oracle frame by frame, its tracer recorded."""
    scene, tracer, cam = accuracy.oracle_inputs()
    rec = Recorder(tracer, lambda x: x.numpy())
    accum, rays = torch.zeros((W * H, 3), dtype=torch.float64), []
    for f in range(FRAMES):
        accum, r = pathtrace_frame(scene, rec, cam, f, accum, accuracy.CLEAR, width=W,
                                   height=H, samples=1, depth=DEPTH, general_loop=True)
        rays.append(float(r))
    assert accum.dtype == torch.float64
    return accum.numpy(), rays, rec.log


@pytest.fixture(scope="module")
def port():
    return _render_port()


def _walks_apart(log_a, log_b) -> np.ndarray:
    """(W*H,) bool: pixels one of whose main rays hit another triangle, or
    one of whose shadow rays got another verdict. A trace of 2N lanes is
    the next bounce's main rays, then this bounce's shadow rays, whose
    triangle is not read (coplanar occluders tie)."""
    n = W * H
    assert len(log_a) == len(log_b) == FRAMES * (DEPTH + 1)
    apart = np.zeros(n, bool)
    for a, b in zip(log_a, log_b):
        assert a.shape == b.shape
        if a.dtype == bool:  # an any-hit trace's verdicts
            apart |= a != b
            continue
        apart |= a[:n] != b[:n]
        if len(a) == 2 * n:
            apart |= (a[n:] >= 0) != (b[n:] >= 0)
    return apart


def test_f64_oracle_matches_jax(port):
    img, rays, log = port
    np.testing.assert_array_equal(img, accuracy.render_oracle())  # the module's oracle
    j_img, j_rays, j_log = _render_jax(jit=False, record=True)
    assert abs(sum(rays) - sum(j_rays)) <= 1e-3 * sum(j_rays), (rays, j_rays)
    apart = _walks_apart(log, j_log)
    err = np.abs(accuracy.display(img) - accuracy.display(j_img)).max(-1)
    diverged = apart & (err > 1e-6)
    print(f"f64 port vs JAX eager: rays {rays} vs {j_rays}; walks parted at {int(apart.sum())} "
          f"of {W * H} pixels, {int(diverged.sum())} of them off by more than 1e-6 (display "
          f"errors of the parted: {np.sort(err[apart])}); largest display error elsewhere "
          f"{err[~apart].max():.3e}; pixels above 1e-9 {int((err > 1e-9).sum())}")
    assert rays == j_rays
    assert err[~apart].max() <= 1e-6
    assert diverged.mean() <= 1e-3
    assert np.isfinite(img).all() and accuracy.display(img).mean() > 0.05


def test_f64_oracle_against_jitted_jax(port):
    img, rays, _ = port
    j_img, j_rays, _ = _render_jax(jit=True)
    assert abs(sum(rays) - sum(j_rays)) <= 1e-3 * sum(j_rays), (rays, j_rays)
    rec = accuracy.gate(img, j_img)
    err = np.abs(accuracy.display(img) - accuracy.display(j_img)).max(-1)
    print(f"f64 port vs JAX jitted: rays {rays} vs {j_rays}; {rec}; pixels above 1e-2 "
          f"{int((err > 1e-2).sum())}, above 1e-6 {int((err > 1e-6).sum())}; the jitted "
          f"accumulator's least value {j_img.min():.4g}, the port's {img.min():.4g}")
    assert rec["ok"], rec


def test_f32_plain_passes_gate_against_oracle(tmp_path):
    out = tmp_path / "acc.json"
    rec = accuracy.run(device="cpu", out_path=out)
    print(f"f32 plain vs f64 oracle: {rec}")
    assert rec["ok"], rec
    assert tuple(rec) == KEYS
    assert json.loads(out.read_text()) == rec
    assert rec["workload"] == "cornell_64x48_spp1_depth3_frames3"
    assert rec["device"] == "cpu" and rec["power_limit"] is None


def test_exit_5_when_the_image_is_off(tmp_path, monkeypatch):
    render_f32 = accuracy.render_f32
    monkeypatch.setattr(accuracy, "OUT", tmp_path / "acc.json")
    monkeypatch.setattr(accuracy, "render_f32", lambda dev: render_f32(dev) * 1.1)
    assert accuracy.main(["--device", "cpu"]) == 5
    rec = json.loads((tmp_path / "acc.json").read_text())
    assert not rec["ok"] and tuple(rec) == KEYS


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_no_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accuracy.run(out_path=tmp_path / "acc.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accuracy.main([])
