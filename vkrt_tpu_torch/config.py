"""Config system: the reference's ``config.json`` schema + runtime settings
(the port's copy of ``vkrt_tpu/config.py``).

``config.json`` (reference config.json:1-13, parsed at main.cpp:136-145) has
exactly: ``scenes`` (list of paths), ``scene`` (index), ``vsync`` (ignored
headless), ``width``, ``height``. The reference parses with no defaults and
no error handling; we keep the schema but default sanely.

Runtime settings mirror the ImGui panel + push constants:
``PushConstantRay`` {clearColor, frame, lightsCount, samples, depth,
useShadows, useAO, useGI} (host_device.h:88-98) with defaults from
``initRayTracing`` (hello_vulkan.cpp:911-918: spp=1, depth=3, shadows on,
AO on, GI off, rtMode=0 hybrid) and ``PushConstantPost`` {rtMode,
viewAccumulated, useGI} (hello_vulkan.h:170-178).

Recompile surface (the reference changes everything per frame via push
constants; here each knob is one of):

* **traced — zero-recompile, like a push constant**: ``clear_color``,
  ``frame``, camera matrices, ``view_accumulated`` (display-step
  argument), ``clamp_weights`` (traced [lo, hi] bounds — see
  models.shading.clamp_bounds), and ``max_frames``/
  ``stop_at_max_frames`` (host-side early-out, never enters jit).
* **static — changing recompiles**: ``samples``/``depth`` (the bounce
  loop and the 2N-lane pools are unrolled and shape-specialized on
  them), the ``use_*`` toggles (each removes whole pipeline stages —
  dead-code elimination the reference's GPU pays branches for),
  ``corr_sampler`` (static Pallas shade-kernel branch),
  ``backend``/``alpha_test`` (different tracer object). This
  is the right XLA trade: the program specializes and fuses per setting,
  and the compiled step is cached per combination (persistent cache
  across processes, utils/jaxcache.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static render knobs (recompile on change)."""

    samples: int = 1                  # spp slider 1-100 (main.cpp:78)
    depth: int = 3                    # bounce slider 1-30 (main.cpp:75)
    use_shadows: bool = True          # hybrid toggle (main.cpp:82)
    use_ao: bool = True               # hybrid toggle (main.cpp:83)
    use_gi: bool = False              # hybrid toggle (main.cpp:84)
    rt_mode: int = 0                  # 0 = hybrid, 1 = path tracer (main.cpp:457)
    view_accumulated: bool = False    # debug view (main.cpp:85)
    max_frames: int = 1               # accumulation limit (hello_vulkan.h:157)
    stop_at_max_frames: bool = False  # "Limit Max Frames" (hello_vulkan.h:156)
    use_denoiser: bool = False        # finishes the reference's disabled NRD path
    temporal_denoiser: bool = True    # reprojecting REBLUR-style history (vs
                                      # spatial-only à-trous) when denoising
    backend: str = "auto"             # trace backend: auto|bruteforce|bvh (LBVH)|pallas
    # Extension (default off = reference-faithful): clamp path throughput
    # weights to [0, 50]. The reference's GGX importance weight
    # (gltf.glsl:98-109; BRDF*cos/pdf with pdf -> 0 as N.H -> 0 and
    # cosTheta allowed negative) has unbounded two-sided tails that its
    # one-sided firefly clamp (rgen:101) does not contain; this bounds them.
    clamp_weights: bool = False
    # Alpha-tested transparency (stochastic punch-through, ops/alpha.py).
    # Default off = reference-faithful: the reference SHIPS any-hit shaders
    # for this (raytrace_rahit_todo.glsl) but never wires them into the
    # pipeline (commented hookup, hello_vulkan.cpp:1185-1191), so e.g. the
    # BLEND sphere in cornell.gltf renders opaque there. Enabling finishes
    # the feature.
    alpha_test: bool = False
    # Correlated per-block sampler (ops/rng.py block_uniform_table): one
    # shared lobe/light/hemisphere/GGX draw per 1024-ray kernel block per
    # (frame, sample, bounce). Unbiased with unchanged per-pixel variance
    # (draws stay marginally uniform and frame-independent); trades
    # per-frame intra-block noise independence for trace coherence — the
    # incoherent bounce-pool trace is the measured Sponza-class bound.
    # DEFAULT ON since round 4: measured 3.5x on Cornell d3 / 2.15x on the
    # city d4 (benchmarks/scratch/corr_ab.py, interleaved on-device), with
    # equal-budget convergence at or BETTER than independent draws (RMSE
    # ratio 0.78 @8 frames, 0.98 @128; long-run bias below independent
    # self-noise — benchmarks/scratch/corr_quality.py). The single-frame
    # noise is block-structured (32x32-tile-shaped) instead of white;
    # temporal accumulation averages it at the same 1/N rate. VKRT_CORR=0
    # restores the reference's independent per-lane draws (raytrace.rgen's
    # per-pixel LCG streams). Interaction: the SVGF-style spatial denoiser
    # assumes white per-pixel noise — block-shaped noise is invisible to a
    # spatial kernel smaller than the block, so under use_denoiser the
    # temporal history does the averaging and the spatial pass adds less;
    # quality-critical denoised runs can prefer --no-corr-sampler.
    corr_sampler: bool = os.environ.get("VKRT_CORR", "1") == "1"

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)


# ImGui default clear color (main.cpp:247).
DEFAULT_CLEAR_COLOR: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """config.json schema (reference config.json:1-13)."""

    scenes: List[str] = dataclasses.field(
        default_factory=lambda: [
            "media/scenes/Sponza.gltf",
            "media/scenes/fireplace/fireplace.gltf",
            "media/scenes/cornell.gltf",
            "media/scenes/suntemple/suntemple.gltf",
        ]
    )
    scene: int = 2
    vsync: bool = False
    width: int = 1280
    height: int = 720

    @property
    def scene_path(self) -> str:
        return self.scenes[self.scene]


def load_config(path: str = "config.json") -> EngineConfig:
    with open(path, "r") as f:
        raw = json.load(f)
    return EngineConfig(
        scenes=list(raw.get("scenes", EngineConfig().scenes)),
        scene=int(raw.get("scene", 2)),
        vsync=bool(raw.get("vsync", False)),
        width=int(raw.get("width", 1280)),
        height=int(raw.get("height", 720)),
    )


def resolve_scene_path(cfg: EngineConfig, base_dirs=None) -> str:
    """Find the configured scene file, searching the working directory,
    then the repository (assets are not copied into the repo)."""
    rel = cfg.scene_path
    if base_dirs is None:
        base_dirs = [
            os.getcwd(),
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ]
    for base in base_dirs:
        cand = os.path.join(base, rel)
        if os.path.exists(cand):
            return cand
    return rel
