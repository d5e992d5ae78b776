"""Scene inputs the benchmark makes itself, found by the ``generator`` name of
a configuration file: ``framebench/scenes/<generator>.py`` defines
``make(params, asset_dir) -> SceneInput``.

A ``SceneInput`` is what both sides get: the raw triangles, per-corner
attributes as the program reads them, materials, lights and 8-bit texture
images. ``kind`` says how the program receives it: ``"soup"`` (its
``scene_from_soup`` constructor, flat normals and derived tangents) or
``"gltf"`` (its glTF loader, reading the asset that ``make`` wrote to
``path``). The plain reference (``framebench/reference``) derives its own
tables from the same arrays. A material's ``alpha_mode`` and
``alpha_cutoff`` are glTF's: where a traffic file sets ``alpha_test``, the
engine punches through MASK and BLEND hits (``reference/alpha.py``).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Material:
    base_color: tuple = (1.0, 1.0, 1.0, 1.0)
    base_tex: int = -1
    metallic: float = 1.0
    roughness: float = 1.0
    mr_tex: int = -1
    normal_tex: int = -1
    emissive: tuple = (0.0, 0.0, 0.0)
    emissive_tex: int = -1
    alpha_mode: int = 0        # glTF alphaMode: 0 OPAQUE, 1 MASK, 2 BLEND
    alpha_cutoff: float = 0.5  # MASK: opaque where alpha >= cutoff


@dataclasses.dataclass
class Light:
    position: tuple
    color: tuple
    intensity: float
    type: int = 0  # 0 point


@dataclasses.dataclass
class SceneInput:
    kind: str                         # "soup" or "gltf"
    v0: np.ndarray                    # (T, 3) f32 corner positions
    v1: np.ndarray
    v2: np.ndarray
    uv: np.ndarray                    # (T, 3, 2) f32 per-corner texcoords
    tri_mat: np.ndarray               # (T,) int32
    materials: List[Material]
    lights: List[Light]
    images: List[np.ndarray]          # (H, W, 4) uint8 each
    srgb: List[bool]                  # per image: baseColor / emissive source
    normal: Optional[np.ndarray] = None   # (T, 3, 3) f32, None: flat normals
    tangent: Optional[np.ndarray] = None  # (T, 3, 4) f32, None: derived from uvs
    path: Optional[str] = None        # the glTF file the program loads

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]


def make(generator: str, params: dict, asset_dir: str) -> SceneInput:
    mod = importlib.import_module(f"framebench.scenes.{generator}")
    return mod.make(dict(params), asset_dir)
