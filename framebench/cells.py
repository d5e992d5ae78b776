"""Cells resolved from data: ``BENCHMARK.json``'s workload ``<config>.<traffic>``
names ``framebench/configs/<config>.json`` (the scene generator and its
parameters, the resolution, the camera), ``framebench/traffic/<traffic>.json``
(render settings, camera motion, the warm-up frames and the traced stretch)
and ``framebench/limits/<workload>.json`` (each number the check compares,
with its limit). Per-layer metrics are
``framebench/metrics/<metric>.py``. A new cell, mix or metric is new files
and new ``BENCHMARK.json`` entries.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]   # this cell's end-to-end metric entries
    per_layer: List[dict]    # this cell's per-layer metric entries
    bench_dir: str           # the folder holding configs/, traffic/, limits/, metrics/

    @property
    def width(self) -> int:
        return int(self.config["width"])

    @property
    def height(self) -> int:
        return int(self.config["height"])


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: str = ROOT, bench_dir: str = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files from
    ``bench_dir`` (default ``<root>/framebench``)."""
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    bench_dir = bench_dir or os.path.join(root, "framebench")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_load(os.path.join(bench_dir, "configs", f"{w['config']}.json")),
        traffic=_load(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")),
        limits=_load(os.path.join(bench_dir, "limits", f"{name}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        bench_dir=bench_dir)


def camera_pose(cam: dict):
    """(eye, center, fov_deg) of a config's camera: an ``orbit`` parameter
    (``utils/camera.py::orbit_camera``'s formula) or an explicit eye."""
    fov = float(cam.get("fov_deg", 60.0))
    center = tuple(float(c) for c in cam.get("center", (0.0, 0.0, 0.0)))
    if "orbit" in cam:
        ang = 2.0 * math.pi * float(cam["orbit"])
        r, h = float(cam["radius"]), float(cam["height"])
        eye = (center[0] + r * math.sin(ang), center[1] + h, center[2] + r * math.cos(ang))
        return eye, center, fov
    return tuple(float(c) for c in cam["eye"]), center, fov


def program_scene(inp, device):
    """The program's scene from the benchmark's input: its soup constructor
    or its glTF loader."""
    import numpy as np

    from vkrt_tpu_torch import scene as scene_mod
    from vkrt_tpu_torch.utils import gltf

    if inp.kind == "gltf":
        return scene_mod.load_scene(inp.path, device=device)
    mats = [gltf.GltfMaterial(
        np.asarray(m.base_color, np.float32), base_color_texture=m.base_tex,
        metallic_factor=m.metallic, roughness_factor=m.roughness,
        metallic_roughness_texture=m.mr_tex, normal_texture=m.normal_tex,
        emissive_factor=np.asarray(m.emissive, np.float32), emissive_texture=m.emissive_tex,
        alpha_mode=m.alpha_mode, alpha_cutoff=m.alpha_cutoff)
        for m in inp.materials]
    lights = [gltf.GltfLight(np.asarray(lt.position, np.float32),
                             np.asarray(lt.color, np.float32), lt.intensity, lt.type)
              for lt in inp.lights]
    images = [gltf.GltfImage(im, f"image{k}") for k, im in enumerate(inp.images)]
    tris = np.stack([inp.v0, inp.v1, inp.v2], axis=1)
    return scene_mod.scene_from_soup(list(tris), inp.tri_mat.tolist(), mats, lights,
                                     images=images, uvs=inp.uv, device=device)


def make_engine(cell: Cell, inp, device):
    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.utils.camera import Camera

    eye, center, fov = camera_pose(cell.config["camera"])
    settings = RenderSettings(**cell.traffic["settings"])
    return Engine(program_scene(inp, device), cell.width, cell.height, settings,
                  Camera(eye=eye, center=center, fov_deg=fov),
                  tuple(cell.config.get("clear_color", (1.0, 1.0, 1.0, 1.0))))
