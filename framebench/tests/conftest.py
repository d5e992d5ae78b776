"""Shared fixtures of the benchmark's CPU tests: a small checkout of the
benchmark written to a temporary directory (``tiny_root``), whose cells the
harness resolves from files alone. Tests marked ``gpu`` need a CUDA device
and skip without one."""

import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "framebench")


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def write_tiny_root(path: str) -> str:
    """BENCHMARK.json and the files of four small cells (the city at grid 6,
    64x48, in path and hybrid mode and, from an orbiting camera, denoised;
    the sponzoid at tess 1, 32x24) under ``path``."""
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"] = [
        {"name": "citytiny", "source": "test", "file": "framebench/configs/citytiny.json",
         "reduced": ["grid", "width", "height"], "why": "test"},
        {"name": "sponztiny", "source": "test", "file": "framebench/configs/sponztiny.json",
         "reduced": ["tess", "width", "height"], "why": "test"},
        {"name": "cityorbit", "source": "test", "file": "framebench/configs/cityorbit.json",
         "reduced": ["grid", "width", "height", "camera"], "why": "test"}]
    bench["workloads"] = [
        {"name": "citytiny.path-d4", "config": "citytiny", "traffic": "path-d4", "chips": 1,
         "why": "test"},
        {"name": "sponztiny.path-d3", "config": "sponztiny", "traffic": "path-d3", "chips": 1,
         "why": "test"},
        {"name": "citytiny.hybrid-gi", "config": "citytiny", "traffic": "hybrid-gi", "chips": 1,
         "why": "test"},
        {"name": "cityorbit.hybrid-denoised-orbit", "config": "cityorbit",
         "traffic": "hybrid-denoised-orbit", "chips": 1, "why": "test"},
        # mixes of the tiny root alone: the orbit in path mode and undenoised
        {"name": "cityorbit.path-orbit", "config": "cityorbit", "traffic": "path-orbit",
         "chips": 1, "why": "test"},
        {"name": "cityorbit.hybrid-orbit", "config": "cityorbit", "traffic": "hybrid-orbit",
         "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["citytiny.path-d4"]
    fb = os.path.join(path, "framebench")
    for sub in ("configs", "limits"):
        os.makedirs(os.path.join(fb, sub), exist_ok=True)
    for sub in ("traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(fb, sub))
    for name, src, scene, w, h, cam in (
            ("citytiny", "city-2160p", {"grid": 6}, 64, 48,
             {"eye": [0.0, 8.0, 20.0], "center": [0.0, 2.0, 0.0], "fov_deg": 60.0}),
            ("sponztiny", "sponzoid-1440p", {"tess": 1}, 32, 24, None),
            ("cityorbit", "city-2160p", {"grid": 6}, 64, 48,  # citytiny's eye at orbit 0
             {"orbit": 0.0, "radius": 20.0, "height": 6.0, "center": [0.0, 2.0, 0.0],
              "fov_deg": 60.0})):
        c = json.load(open(os.path.join(BENCH, "configs", f"{src}.json")))
        c["scene"].update(scene)
        c["width"], c["height"] = w, h
        if cam:
            c["camera"] = cam
        json.dump(c, open(os.path.join(fb, "configs", f"{name}.json"), "w"))
    for w, real in (("citytiny.path-d4", "city-2160p.path-d4"),
                    ("sponztiny.path-d3", "sponzoid-1440p.path-d3"),
                    ("citytiny.hybrid-gi", "city-2160p.hybrid-gi"),
                    ("cityorbit.hybrid-denoised-orbit",
                     "city-2160p.hybrid-denoised-orbit")):  # the cells' own limits
        shutil.copy(os.path.join(BENCH, "limits", f"{real}.json"),
                    os.path.join(fb, "limits", f"{w}.json"))
    for t, src in (("path-orbit", "path-d4"), ("hybrid-orbit", "hybrid-gi")):
        d = json.load(open(os.path.join(BENCH, "traffic", f"{src}.json")))
        d["camera"] = {"orbit_turns_per_frame": 1.0 / 1440.0}
        json.dump(d, open(os.path.join(fb, "traffic", f"{t}.json"), "w"))
        shutil.copy(os.path.join(BENCH, "limits", f"city-2160p.{src}.json"),
                    os.path.join(fb, "limits", f"cityorbit.{t}.json"))
    for t in ("path-d4", "path-d3", "hybrid-gi", "hybrid-denoised-orbit", "path-orbit",
              "hybrid-orbit"):
        p = os.path.join(fb, "traffic", f"{t}.json")
        d = json.load(open(p))
        d["warmup_frames"] = 1  # one warm-up frame keeps the CPU runs short
        if d["camera"] != "static":
            # 4 degrees a frame moves the 64x48 frame by as many pixels as
            # the cell's quarter degree moves 3840x2160
            d["camera"] = {"orbit_turns_per_frame": 1.0 / 90.0}
        json.dump(d, open(p, "w"))
    json.dump(bench, open(os.path.join(path, "BENCHMARK.json"), "w"))
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return write_tiny_root(str(tmp_path_factory.mktemp("framebench_tiny")))
