"""BENCHMARK.json and the files it names: every cell resolves, every metric
has its reader, names and units keep to the contract's characters, and a
cell, a traffic mix and a metric are added by files alone."""

import json
import os
import re

import pytest

from framebench import cells
from framebench.run import _load_reader

ROOT = cells.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(workload):
    cell = cells.resolve(workload)
    assert cell.width > 0 and cell.height > 0
    assert cell.traffic["settings"] and cell.limits
    assert {m["name"] for m in cell.end_to_end} >= {"frame_ms", "setup_s"}
    assert cell.per_layer
    cfg = next(c for c in BENCH["configs"] if c["name"] == workload.split(".")[0])
    assert os.path.exists(os.path.join(ROOT, cfg["file"]))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_has_reader(metric):
    assert callable(_load_reader(os.path.join(ROOT, "framebench"), metric))


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert all(m["moves"] == "frame_ms" for m in BENCH["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51


def test_cell_added_by_files_alone(tiny_root, tmp_path):
    """A new config, traffic mix, limits file and metric reader in another
    checkout resolve and load without an edit to any existing file."""
    bench = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    fb = os.path.join(tiny_root, "framebench")
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "framebench"))
    for sub in ("configs", "traffic", "limits", "metrics"):
        os.symlink(os.path.join(fb, sub), os.path.join(root, "framebench", sub))
    extra = os.path.join(root, "extra")
    for sub in ("configs", "traffic", "limits", "metrics"):
        os.makedirs(os.path.join(extra, sub))
    json.dump(json.load(open(os.path.join(fb, "configs", "citytiny.json"))),
              open(os.path.join(extra, "configs", "citysmall.json"), "w"))
    json.dump({"settings": {"rt_mode": 1, "depth": 2}, "warmup_frames": 1},
              open(os.path.join(extra, "traffic", "path-d2.json"), "w"))
    json.dump({"diverged": {"limit": 0.05}},
              open(os.path.join(extra, "limits", "citysmall.path-d2.json"), "w"))
    with open(os.path.join(extra, "metrics", "frames.count.py"), "w") as f:
        f.write("def read(s):\n    return float(s.frames)\n")
    bench["workloads"].append({"name": "citysmall.path-d2", "config": "citysmall",
                               "traffic": "path-d2", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "frames.count", "unit": "frames", "better": "higher",
                               "source": "device_trace", "layer": "host loop",
                               "moves": "frame_ms", "workloads": ["citysmall.path-d2"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    cell = cells.resolve("citysmall.path-d2", root=root, bench_dir=extra)
    assert cell.traffic["settings"]["depth"] == 2 and cell.width == 64
    assert [m["name"] for m in cell.per_layer][-1] == "frames.count"

    class S:
        frames = 3

    assert _load_reader(extra, "frames.count")(S()) == 3.0
