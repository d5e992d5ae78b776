"""The port's measurement entry points on the card: ``vkrt_tpu_torch.bench``
at 320x240 and the accuracy anchor (``benchmarks/accuracy.py``) at its own
size, and ``entry()``. Marked ``gpu``; each test skips without a CUDA
device (decided in a fixture, not at import). The card's machine has no
JAX: run with ``python -m pytest --noconftest tests/test_torch_bench_gpu.py -q``.

* ``bench.main`` exits 0 with one JSON line last (``metric``, ``value``,
  ``unit``, ``ms_per_frame``, ``device``, ``power_limit``), kernels A and B
  launched 6 and 3 times in each of its 25 frames and of the anchor's 3,
  and the anchor's record within budget;
* ``entry()``'s frame step on the card: finite, non-black, 6 A and 3 B
  launches."""

import json

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

KEYS = ("metric", "value", "unit", "ms_per_frame", "device", "power_limit")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return torch.device("cuda")


def _launches() -> dict:
    """Kernels A's and B's launches, and B's albedo launches, since the
    last ``device.reset_counts()``."""
    from vkrt_tpu_torch import device as kdev

    return {e: kdev.counts[e]["launches"]
            for e in ("vkrt_trace", "vkrt_shade", kdev.SHADE_ALBEDO)}


def test_bench_and_anchor_on_the_card(cuda, tmp_path, monkeypatch, capsys):
    from vkrt_tpu_torch import bench
    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.benchmarks import accuracy

    seen = {}

    def counted(name, fn):
        def call(*args, **kw):
            kdev.reset_counts()
            out = fn(*args, **kw)
            seen[name] = (out, _launches())
            return out
        return call

    monkeypatch.setattr(accuracy, "OUT", tmp_path / "acc.json")
    monkeypatch.setattr(bench, "measure", counted("bench", bench.measure))
    monkeypatch.setattr(accuracy, "run", counted("accuracy", accuracy.run))
    assert bench.main(["--width", "320", "--height", "240"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tuple(rec) == KEYS
    assert rec["metric"] == "pathtrace_cornell_320x240_spp1_depth3"
    assert rec["value"] > 0 and rec["ms_per_frame"] > 0
    assert rec["device"] == torch.cuda.get_device_name(0) and rec["power_limit"]
    res, launches = seen["bench"]
    assert launches == {"vkrt_trace": 6 * 25, "vkrt_shade": 3 * 25,
                        "vkrt_shade.albedo": 0}
    anchor, anchor_launches = seen["accuracy"]
    assert anchor_launches == {"vkrt_trace": 6 * 3, "vkrt_shade": 3 * 3,
                              "vkrt_shade.albedo": 0}
    assert anchor["ok"] and json.loads((tmp_path / "acc.json").read_text()) == anchor
    assert res["accum"].device.type == "cuda"


def test_entry_on_the_card(cuda):
    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.entry import entry

    fn, args = entry()
    assert all(t.device.type == "cuda" for t in (args[0].view_inverse, args[2], args[3]))
    kdev.reset_counts()
    accum, rays = fn(*args)
    assert _launches() == {"vkrt_trace": 6, "vkrt_shade": 3, "vkrt_shade.albedo": 0}
    a = accum.cpu().numpy()
    assert np.isfinite(a).all() and a.max() > 0 and float(rays) > 0
