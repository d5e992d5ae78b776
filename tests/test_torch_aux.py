"""The port's checkpoint and profiling utilities
(``vkrt_tpu_torch/utils/checkpoint.py``, ``utils/profiling.py``) against
tests/test_aux.py:

* its three checkpoint tests (a resumed render continues identically, the
  denoiser's history round-trips, a mismatched fingerprint is refused) and
  ``test_frame_stats``, on the port;
* the geometry hash of an ``InstancedScene``'s engine is read from the host
  mirror (no device read) and follows a re-pose;
* ``device_trace`` writes a Chrome trace holding the engine's pass labels
  (``pathtrace``, ``hybrid``) and is a no-op for None; ``timed_frame``
  records one frame; ``nan_debug`` makes a non-finite frame raise, only
  inside its scope."""

import json

import numpy as np
import pytest
import torch

from vkrt_tpu_torch.config import RenderSettings
from vkrt_tpu_torch.engine import Engine
from vkrt_tpu_torch.scene import make_cornell_box
from vkrt_tpu_torch.utils import checkpoint
from vkrt_tpu_torch.utils.profiling import (
    FrameStats, device_trace, nan_debug, nan_debug_enabled, timed_frame,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cornell():
    return make_cornell_box(device="cpu")


def test_checkpoint_roundtrip(tmp_path, cornell):
    path = str(tmp_path / "state.npz")
    e = Engine(cornell, 32, 24, RenderSettings(rt_mode=1))
    e.render_frame()
    e.render_frame()
    checkpoint.save(e, path)

    e2 = Engine(cornell, 32, 24, RenderSettings(rt_mode=1))
    assert checkpoint.restore(e2, path)
    assert e2.frame == e.frame and e2.total_rays == e.total_rays
    assert torch.equal(e2.accum, e.accum)
    # a resumed render continues identically to an uninterrupted one
    e.render_frame()
    e2.render_frame()
    assert torch.equal(e2.accum, e.accum)


def test_checkpoint_roundtrips_denoiser_state(tmp_path, cornell):
    """A resumed denoised fly-through keeps its temporal history and
    continues bit for bit."""
    settings = RenderSettings(rt_mode=0, use_shadows=True, use_ao=True, use_gi=True,
                              use_denoiser=True)
    path = str(tmp_path / "state.npz")
    e = Engine(cornell, 32, 24, settings)
    assert e.denoise_state is not None
    e.render_frame()
    e.render_frame()
    checkpoint.save(e, path)

    e2 = Engine(cornell, 32, 24, settings)
    assert checkpoint.restore(e2, path)
    for a, b in zip(e2.denoise_state, e.denoise_state):
        assert torch.equal(a, b)
    assert torch.equal(e2.render_frame(), e.render_frame())


def test_checkpoint_rejects_mismatched_fingerprint(tmp_path, cornell):
    path = str(tmp_path / "state.npz")
    e = Engine(cornell, 32, 24, RenderSettings(rt_mode=1))
    e.render_frame()
    checkpoint.save(e, path)
    assert not checkpoint.restore(Engine(cornell, 32, 24, RenderSettings(rt_mode=1, depth=5)),
                                  path)
    assert not checkpoint.restore(e, str(tmp_path / "absent.npz"))


def test_checkpoint_geometry_from_the_host_mirror(tmp_path, monkeypatch):
    """An ``InstancedScene``'s engine hashes its host mirror (the device
    tensor is not read), and a re-pose changes the fingerprint."""
    from test_torch_instances import _doc, _translate
    from vkrt_tpu_torch.scene_instances import build_instanced

    e = Engine(build_instanced(_doc(), device="cpu"), 32, 24, RenderSettings(rt_mode=1))
    e.render_frame()
    assert checkpoint._geometry(e) is e.instances.host["tri_v0"]
    fp = checkpoint._fingerprint(e)
    e.set_node_transform(1, _translate(3, 1, 0))
    assert checkpoint._fingerprint(e) != fp
    path = str(tmp_path / "state.npz")
    e.render_frame()
    checkpoint.save(e, path)
    e2 = Engine(e.instances, 32, 24, RenderSettings(rt_mode=1))
    assert checkpoint.restore(e2, path) and e2.frame == 0


def test_frame_stats():
    s = FrameStats()
    s.record(0.01, 1e6)
    s.record(0.03, 3e6)
    assert abs(s.ms_per_frame - 20.0) < 1e-9
    assert abs(s.fps - 50.0) < 1e-9
    assert abs(s.mrays_per_s - 100.0) < 1e-6
    assert s.summary()["frames"] == 2


def test_timed_frame_and_device_trace(tmp_path, cornell):
    stats = FrameStats()
    path_eng = Engine(cornell, 32, 24, RenderSettings(rt_mode=1))
    hybrid_eng = Engine(cornell, 32, 24, RenderSettings(rt_mode=0))
    with device_trace(str(tmp_path / "trace")):
        with timed_frame(stats, device=path_eng.device):
            path_eng.render_frame()
        hybrid_eng.render_frame()
    assert len(stats.times_s) == 1 and stats.times_s[0] > 0
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    names = {ev.get("name") for ev in json.loads(files[0].read_text())["traceEvents"]}
    assert {"pathtrace", "hybrid"} <= names
    with device_trace(None):  # a no-op
        pass


def test_nan_debug_raises_on_a_non_finite_frame(cornell):
    e = Engine(cornell, 32, 24, RenderSettings(rt_mode=1), clear_color=(np.nan, 1.0, 1.0, 1.0))
    out = e.render_frame()  # outside the scope the NaN background passes
    assert not torch.isfinite(out).all()
    assert not nan_debug_enabled()
    with nan_debug():
        assert nan_debug_enabled()
        with pytest.raises(FloatingPointError, match="non-finite"):
            e.render_frame()
        with nan_debug(False):
            e.render_frame()
    assert not nan_debug_enabled()
    ok = Engine(cornell, 32, 24, RenderSettings(rt_mode=1))
    with nan_debug():
        assert torch.isfinite(ok.render_frame()).all()
