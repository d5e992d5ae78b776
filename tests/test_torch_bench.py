"""``vkrt_tpu_torch/bench.py`` (the port's ``bench.py``) on the CPU at 64x48:
one parseable JSON line last with the keys the port reports; exit 4 on a
non-finite or a black accumulator (the frame step patched), before the
anchor runs; exit 5 when the anchor is out of budget (its f32 image made
off); an anchor that raises fails the run; the frame bit for bit
``Engine.render_frame``'s at the same settings, ray counts included; the
workload's size from ``config.json``; no card, no render on the CPU."""

import json

import numpy as np
import pytest
import torch

from vkrt_tpu_torch import bench
from vkrt_tpu_torch.benchmarks import accuracy
from vkrt_tpu_torch.config import RenderSettings
from vkrt_tpu_torch.engine import Engine
from vkrt_tpu_torch.ops.trace import make_tracer
from vkrt_tpu_torch.scene import load_cornell

torch.set_num_threads(2)
SMALL = ["--device", "cpu", "--width", "64", "--height", "48", "--batches", "1",
         "--frames", "2"]
KEYS = ("metric", "value", "unit", "ms_per_frame", "device", "power_limit")


@pytest.fixture(autouse=True)
def record_in_tmp(tmp_path, monkeypatch):
    """The anchor's record goes to a temporary file, not the repository."""
    monkeypatch.setattr(accuracy, "OUT", tmp_path / "acc.json")


def test_main_prints_one_json_line(capsys):
    assert bench.main(SMALL) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert tuple(rec) == KEYS
    assert rec["metric"] == "pathtrace_cornell_64x48_spp1_depth3"
    assert rec["unit"] == "Mrays/s" and rec["value"] > 0 and rec["ms_per_frame"] > 0
    assert rec["device"] == "cpu" and rec["power_limit"] is None
    assert "vs_baseline" not in rec


@pytest.mark.parametrize("fault", ["nan", "black"])
def test_exit_4_on_a_broken_image(fault, monkeypatch, capsys):
    make_step = bench.make_step

    def broken(*args):
        step = make_step(*args)

        def frame(f, accum):
            accum, rays = step(f, accum)
            return (accum * float("nan") if fault == "nan" else torch.zeros_like(accum)), rays

        return frame

    def anchor(*args, **kw):
        raise AssertionError("the anchor ran after a broken image")

    monkeypatch.setattr(bench, "make_step", broken)
    monkeypatch.setattr(accuracy, "run", anchor)
    assert bench.main(SMALL) == 4
    assert capsys.readouterr().out == ""  # no JSON line


def test_exit_5_when_the_anchor_is_out_of_budget(monkeypatch, capsys):
    render_f32 = accuracy.render_f32
    monkeypatch.setattr(accuracy, "render_f32", lambda dev: render_f32(dev) + 0.05)
    assert bench.main(SMALL) == 5
    assert capsys.readouterr().out == ""


def test_a_crashing_anchor_fails_the_run(monkeypatch):
    def crash(*args, **kw):
        raise RuntimeError("anchor crashed")

    monkeypatch.setattr(accuracy, "run", crash)
    with pytest.raises(RuntimeError, match="anchor crashed"):
        bench.main(SMALL)


def test_frame_bit_equal_to_engine():
    dev = torch.device("cpu")
    w, h, frames = 64, 48, 3
    scene = load_cornell(device=dev)
    step = bench.make_step(scene, make_tracer(scene, "auto"), w, h, dev)
    eng = Engine(scene, w, h, RenderSettings(rt_mode=1, samples=1, depth=bench.DEPTH),
                 clear_color=bench.CLEAR)
    assert eng.settings.corr_sampler == RenderSettings().corr_sampler
    accum = torch.zeros((w * h, 3))
    for f in range(frames):
        accum, rays = step(f, accum)
        before = eng.total_rays
        eng.render_frame()
        assert float(rays) == eng.total_rays - before > 0
        np.testing.assert_array_equal(accum.numpy().view(np.uint32),
                                      eng.accum.numpy().view(np.uint32))


def test_workload_size(tmp_path, monkeypatch):
    assert bench.workload_size() == (1280, 720)  # the repository's config.json
    (tmp_path / "config.json").write_text(json.dumps({"width": 320, "height": 240}))
    monkeypatch.chdir(tmp_path)
    assert bench.workload_size() == (320, 240)
    (tmp_path / "config.json").write_text("{")
    assert bench.workload_size() == (1280, 720)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_no_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
