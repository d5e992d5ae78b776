#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``vkrt_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure (non-zero exit, no ``ok`` line):

0. device: a CUDA device is required; versions and the card's name and
   power limit are printed;
1. build: the CUDA kernels (``vkrt_tpu_torch/csrc``) with nvcc, and the
   native SAH BVH builder;
2. kernel A (trace) against its plain version (brute force) on the card:
   Cornell 1280x720 tile-ordered primaries, a real bounce pool and its
   first-hit-kills shadow pool, and a 16,384-triangle random soup with
   65,536 random rays including dead and zero-limit lanes;
3. kernel B (shade) against ``shade_plain`` on the card, bounces 0 and 1
   of the 1280x720 main-path pool with the correlated sampler on;
4. the main path: ``Engine`` in path mode at 1280x720, spp 1, depth 3,
   correlated sampler on, clear (1,1,1,1) -- 2 warm-up frames, then 3
   batches of 8 frames timed with CUDA events; the launch counters must
   grow by exactly 6 trace and 3 shade launches a frame; then 4 more frames
   under torch.profiler give the device time a frame by kernel and the
   device's idle share (so does phase 4b);
5. kernel path against plain path end to end: 160x120, depth 3, 4 frames on
   the card and on the CPU (plain versions), display-domain gate;
3b. kernel B's albedo instantiation (baseColor-only scenes) against
   ``shade_plain`` on the card: bounces 0 and 1 of ``make_city(grid=96)``'s
   1280x720 tile-ordered pool, correlated sampler on, the suite's city
   camera ``orbit_camera(0.12, radius=300, height=48)``;
3c. the RNG prologue's kernels (``csrc/rng.cu``) against the int64 plain
   path on the card, at the cells' sizes: the seeds of 3840x2160 tile-ordered
   pixel ids (16 rounds), the city's 8,100-row table and the hybrid's
   8,294,400-lane ``corr_draws`` view, bit for bit; each kernel's time, its
   bound and the plain path's device and host ms a call (the plain
   functions called by name: on the card the dispatch takes the kernels);
3d. row T, the texel fetch's kernel (``csrc/texture.cu``) against the plain
   PyTorch path on the card, bit for bit on every lane (non-finite ones
   too), at the cells' shapes: the sponzoid's level-0 call (2560x1440
   lanes, six 256x256 f32 images) and the city's trilinear and 4-tap
   anisotropic calls (3840x2160 lanes, a bf16 atlas of three 64x64
   images); each one launch, its time, its bound and the plain path's
   device and host ms a call. Every main path (``drive_engine``) checks
   that each texture call is one launch, and the counts a frame where
   ``texture_launches`` gives them;
4b. the city's main path (``benchmarks/suite.py`` row 3): ``Engine`` on
   ``make_city(grid=96)`` at 1280x720, spp 1, depth 4, correlated sampler
   on, that camera, clear (1,1,1,1) -- 2 warm-up frames, then 3 batches of
   8 frames timed with CUDA events; the counters must grow by exactly 8
   trace and 4 shade launches a frame, all 4 of them albedo launches;
5b. the city end to end, kernels against plain versions: ``make_city(grid=8)``
   at 160x120, depth 4, 4 frames on the card and on the CPU, display gate,
   ray counts within 0.1%;
4c. hybrid mode (``benchmarks/suite.py`` row 4, ``hybrid_shadows_ao_gi``):
   ``Engine`` on ``make_city(grid=96)`` at 1280x720, depth 3, spp 1,
   shadows, AO and GI on, correlated sampler on, the city's camera, clear
   (1,1,1,1) -- timed and profiled as 4b; the counters must grow by
   exactly 6 trace and 2 shade launches a frame (the G-buffer's closest
   trace, the visibility pool, then the GI chain's closest and shadow
   traces of bounces 1 and 2), the shade launches all albedo launches.
   Then one more frame's visibility pool (a shadow and four AO lanes a
   pixel: 4,608,000 first-hit-kills lanes, t_min 0.1) through kernel A and
   through the plain front-to-back walk: verdicts equal as uint32 on every
   lane, and no hit on a lane that skips its query (d = 0, limit -0.0);
   and the frame's stages profiled alone (the G-buffer pass, the shadow
   and AO pool with its set-up, the effects with GI);
4d. the denoised fly-through (``benchmarks/suite.py`` row 5,
   ``city_flythrough_denoised``): ``Engine`` on ``make_city(grid=96)`` at
   1280x720, hybrid, shadows, AO and GI, depth 3, spp 1, the temporal
   denoiser, correlated sampler on, clear (1,1,1,1), the camera at
   ``orbit_camera(k / 8, radius=300, height=48)`` before the k-th frame of
   the warm-up and of each batch -- timed as 4b, with the counters growing
   by 6 trace and 2 (albedo) shade launches and 1 + 3 of the denoiser's
   kernels a frame. Then the frame and the denoiser alone under
   torch.profiler; one frame's denoiser inputs filtered on the card and on
   the CPU by the same torch code (every float within atol 1e-5 + rtol
   1e-4); at the cells' 3840x2160, one frame's denoiser inputs through the
   kernels and through the plain torch code on the card (every output bit
   for bit), each kernel's time beside its bound and the plain code's time;
   the history's mean length growing over 4 static frames; and the
   suite's ``rmse_vs_converged`` (the last fly-through frame against 64
   static frames with the denoiser off at its pose) and
   ``rmse_noisy_1frame``, by ``utils/metrics.rmse``;
4e. suite row 8 (``sponzoid_disk_pathtrace``) as a scene that moves: the
   PNG sponzoid (``utils/sponzoid.py``, tess 4, 161,920 triangles, every
   texture decoded at full size) loaded as an ``InstancedScene`` into
   ``Engine`` at 1280x720, path mode, spp 1, depth 3, correlated sampler
   on, eye (0, 6, 26) looking at (0, 5, 0): static, then animated (the
   largest primitive moved before every frame by ``set_node_transform``,
   x += 0.02 (f + 1)), each 2 warm-up frames and 3 timed batches of 8;
   kernel A 4 launches a frame and kernel B none (the general loop); the
   repose's host ms (steady state without the first) and the rows it
   rewrites; no native SAH build after a repose; torch.profiler lines of
   both; then, after the last pose, kernel A over the refit tables against
   a fresh ``build_bvh`` of that pose: (t, tri, u, v) equal as uint32 on
   the frame's 921,600 primaries and the first bounce's 921,600 rays, the
   shadow verdicts equal, and kernel A's time on the primaries over both
   tables beside their bounds;
5c. the general shading loop on the card: a scene built in memory with
   baseColor, metallic-roughness, emissive and normal-map textures (numpy
   images, no file) at 160x120, depth 4, 4 frames on the card and on the
   CPU with the same gate; on the card kernel A is launched depth + 1 times
   a frame and kernel B not at all;
5d. hybrid frames end to end, kernels against plain versions, 160x120,
   depth 3, 4 frames: the Cornell box with GI, ``make_city(grid=8)`` with
   GI off and on; the display gate, rays within 0.1%, the G-buffers'
   hit/miss masks equal and every field within 1e-4 on >= 99.9% of the
   pixels, and the card's launches a frame (2 trace without GI; 6 trace
   and 2 shade with it);
5e. denoised hybrid frames end to end, kernels against plain versions: the
   Cornell box and the small city at 160x120, depth 3, 4 frames with the
   camera moving every frame, with the temporal and with the spatial-only
   denoiser; frame by frame the noisy GI through the display gate, the
   card's denoiser against the plain torch code on the card's inputs, and
   the filtered GI through the display gate until the first pixel whose
   variance boost sits on its ulp tie (history length 4 +- an ulp); the
   final composite through the display gate when no such tie flipped
   (reported otherwise); rays within 0.1%, launches as in 5d;
5f. alpha-tested transparency: the small city with material 3 BLEND at
   alpha 0.5 and material 2 MASK at 0.3 under cutoff 0.5, path mode at
   depth 4 and hybrid (shadows, AO, GI), 160x120, 4 frames, card against
   CPU: the display gate, rays within 0.1%, kernel A 25 launches a frame
   (5 traces of 1 + 4 punch rounds each; every round runs) and kernel B
   none (the general loop); then the full city with the same switch in
   hybrid mode at 1280x720, 2 warm-up frames and one timed batch of 8;
5g. scenes that move end to end: the two cubes of tests/test_instances.py
   as an ``InstancedScene`` on the card and on the CPU, 160x120, 4 frames,
   ``set_node_transform`` of the right cube, 4 more frames: the display
   gate before and after the repose in path mode at depth 3 (kernels A and
   B: 6 and 3 launches a frame) and in hybrid mode with GI (6 and 2), then
   the cubes BLEND at 0.5 through the alpha tracer, reposed (kernel A 20
   launches a frame, B none);
5h. the app on the card (``app.main`` in this process): ``--scene`` the
   sponzoid at 320x180 with ``--orbit --stats --save-state`` (a PNG a
   frame, the stats JSON), ``--save-state`` then ``--load-state`` resuming
   the frame counter, ``--trace-dir`` (a Chrome trace holding the
   ``pathtrace`` label and kernel A), every ``--backend`` on Cornell (equal
   images) and ``--interactive`` on a script;
6. the trace probes (``vkrt_tpu_torch.benchmarks``) on Cornell and on
   ``make_city(grid=96)`` (143,568 triangles, the scene of 3b and 4b, built
   once) at 1280x720: micro_trace
   (kernel C's launch floor at four block sizes, kernel A closest and any
   on primary and incoherent rays), ablate_kernel (kernel D's four modes),
   variants (kernel E's variants on tile-ordered and incoherent rays) and
   vpupeak (kernel F, K = 65,536); the launch counters must show every
   probe kernel. Then each kernel against its plain version: C the miss
   record at every block size; F bit-equal to its plain recurrence at
   K = 512 and at the timed K = 65,536, on seeded inputs that differ
   element by element; kernel A against brute force on 65,536 subsampled
   rays (no other winner at an equal t is left to excuse: the count is
   printed and must be 0); D ``full`` and ``count`` bit-equal to kernel A,
   ``boxes`` and ``top`` the miss record, ``count``'s visit columns equal
   to the plain front-to-back walk (``trace_rays_bvh_ordered``) on every
   city primary and on 4,096-ray subsamples of the other sets; E's
   variants ``threaded``, ``binary``, ``ordered`` and ``flat`` bit-equal to
   kernel A in t, u, v and triangle id on every ray (``mt128`` to brute
   force over its 128 triangles); ``ordered``'s counts (slab tests, one a
   child a record holds; triangle tests; records) equal to the plain wide
   walk (``trace_rays_bvh_wide``) on every tiled ray of both scenes and on
   4,096-ray subsamples of the incoherent sets; phase 2's first-hit-kills shadow
   pool through ``ordered`` and ``threaded``, verdicts against kernel A.
   Every variant gets its bound on every ray set: ``ordered`` from its own
   counts, ``binary`` from kernel D's, ``threaded`` and ``flat`` from the
   plain stackless walk (``flat``'s from a 4,096-ray subsample of each
   set, scaled to the set), ``mt128`` in closed form. For kernel A on both
   scenes and all four ray sets (closest / any x primary / incoherent) a
   line gives its time beside E ``threaded``'s (the stackless walk that was
   kernel A's first design) on the same rays, the visits a ray and the SIMT
   efficiency of both walks, and both bounds.

4f. suite row 6 (``cornell_sharded_mesh``) through the port's mesh of ranks
   (``vkrt_tpu_torch/parallel``): the glTF Cornell box at 1280x720, spp 1,
   depth 3, correlated sampler on, over ``factor_mesh(cards)`` (one card:
   mesh (1,1) over NCCL, in this process) -- one warm-up frame, then 3
   batches of 8 frames, each from a fresh accumulator, timed on the host
   clock between device synchronisations; each rank's counters grow by 6
   trace and 3 shade launches a frame; on mesh (1,1) the last batch's
   image equals ``Engine``'s 8 frames bit for bit; then the engine's and
   the mesh's batches of the same frames in turns (engine, mesh, mesh,
   engine), each the best of 3 batches on the host clock;
5i. suite row 5's stack under a (4,1) mesh: 4 ranks (spawned processes)
   sharing the card over gloo, each building ``make_city(grid=96)``, 3
   frames of the row-5 fly-through at 1280x720 with the temporal denoiser
   in its band form (ring halos, gathered history), correlated sampler
   off; every frame's gathered composite against the single-process
   ``Engine`` on the same poses by the display gate (max abs difference
   printed), rays within 0.1%, each rank 6 trace and 2 albedo shade
   launches a frame;
5j. ``python -m vkrt_tpu_torch.app --mesh 2,2 --spp 2`` on the Cornell box
   at 1280x720, 2 frames (4 ranks sharing the card, gloo): finite,
   non-black, and its displayed mean within 0.02 of the unsharded app's
   spp-2 image; then ``dryrun_multichip(4)`` on gloo CPU ranks;

5k. the ``bvh`` backend (run after phase 6): ``build_lbvh`` on the card
   for ``make_city(grid=96)`` and the tess-4 sponzoid, each bit-equal (as
   uint32) to the same function on CPU tensors, ``threaded_tables`` equal
   to the host packing; printed: the build's ms (CUDA events, median of
   5 after a warm-up) and of a replay of it captured as one CUDA graph
   (bit-equal), its device kernels and their device ms, its host
   syncs (``torch.cuda.set_sync_debug_mode("warn")``, must be 0) and the
   tree's depth. Then on the city's tiled primaries and incoherent rays
   (phase 6's sets) kernel E ``threaded`` over the LBVH bit-equal to its
   plain walk (``trace_rays_bvh`` over the same tables) on 4,096 rays and
   to kernel A over the SAH tree on every ray; ms of E ``threaded`` over
   the LBVH, over the SAH tree and of A, the walks' tests a ray and SIMT
   efficiency. Then the animated sponzoid (phase 4e's poses, 3 frames)
   through ``Engine`` with ``backend="bvh"`` and ``"pallas"``: the frames
   equal bit for bit, kernel E 12 launches and A none under ``bvh`` (and
   the reverse), the repose's re-bake + upload and LBVH rebuild (or
   refit) ms between device synchronisations. Then ray sorting
   (``SortingTracer``) in front of kernel A on the city's incoherent rays:
   hits after unsorting bit-equal to kernel A's; ms of the key, the sort
   and two gathers, kernel A on the sorted and the unsorted rays, and
   both SIMT efficiencies (kernel D's counts);
7. the port's suite (``vkrt_tpu_torch.benchmarks.suite``), rows 1, 2 and 7
   at 1280x720 and 8 frames, one JSON line each (rows 3-5 are phases
   4b-4d, row 8 is 4e);
8. the port's measurement entry points: ``vkrt_tpu_torch.bench.main()``
   in-process at its real workload (the Cornell box at 1280x720, spp 1,
   depth 3, correlated sampler on: frame 0, then 3 batches of 8 frames
   timed with CUDA events; ``[bench]`` lines: ms/frame, Mrays/s and the
   batches' spread), kernels A and B launched 6 and 3 times a frame, then
   the accuracy anchor it runs (``benchmarks/accuracy.py``: 64x48, 3
   frames on A and B, 6 and 3 launches a frame, against the float64
   oracle on the host CPU; RMSE, p99 and diverged share printed); the
   phase fails on any exit but 0 (4: a broken image, 5: the anchor out of
   budget). Then ``entry()``'s frame step once on the card: finite,
   non-black, 6 A and 3 B launches.

The last lines are a JSON object of the kernels (each with its time, its
plain version's time, its bound, the one PyTorch call's time where one
computes the same function and its launches on its path; ``trace`` and
``shade`` count Cornell's main path in ``launches``, the city's in
``city_launches``, the hybrid path's in ``hybrid_launches`` and the
denoised fly-through's in ``denoised_launches``, as does ``shade_albedo``;
``rng_tea`` and ``rng_table`` count the RNG kernels' launches on the
main paths of phases 4, 4b and 4c in ``launches``, ``city_launches`` and
``hybrid_launches``, and on phase 4e's static sponzoid in
``sponzoid_launches``, each checked against ``rng_launches`` as the
kernels' counts are against theirs; ``tex_level0``, ``tex_trilinear`` and
``tex_aniso`` count the texture launches of phases 4, 4c and 4e in
``launches``, ``hybrid_launches`` and ``sponzoid_launches`` (``tex_aniso``
also phase 4d's in ``denoised_launches``), each checked against
``texture_launches``; ``denoise_temporal`` and ``denoise_atrous`` count
phase 4d's denoiser launches in ``launches``, checked against
``denoise_launches``, their times those of the 3840x2160 frame;
``trace``'s ``alpha_launches`` counts
phase 5f's full-size alpha run, its ``sponzoid_launches`` and
``sponzoid_animated_launches`` phase 4e's static and animated runs, ``cubes_launches`` / ``cubes_hybrid_launches`` of
``trace`` and ``shade`` phase 5g's path and hybrid cubes on the card, and
``mesh_launches`` / ``mesh_hybrid_launches`` of ``trace``, ``shade`` and
``shade_albedo`` the launches of each rank of phases 4f and 5i;
``trace_variant``'s ``lbvh_launches`` the ``bvh`` backend's launches of
kernel E ``threaded`` in phase 5k, with ``lbvh_ms``, ``lbvh_bound_ms`` and
``lbvh_plain_ms`` of the city's tiled primaries over the LBVH;
``trace``'s and ``shade``'s ``bench_launches`` and ``accuracy_launches``
phase 8's bench and anchor), the card's nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

W, H = 1280, 720
DEPTH = 3
CLEAR = (1.0, 1.0, 1.0, 1.0)
# the city's main path: benchmarks/suite.py row 3 (its grid: benchmarks.CITY_GRID)
CITY_DEPTH = 4
CITY_CAM = dict(t=0.12, radius=300.0, height=48.0)
# the hybrid path: benchmarks/suite.py row 4, the city and camera of row 3
HYBRID_DEPTH = 3
# the small city of the end-to-end checks: the camera scaled with the grid
SMALL_CITY_GRID, SMALL_CITY_CAM = 8, dict(t=0.12, radius=25.0, height=4.0)
# the denoised fly-through: benchmarks/suite.py row 5, 8 poses of an orbit
FLY_FRAMES, FLY_CAM = 8, dict(radius=300.0, height=48.0)
CSRC = "vkrt_tpu_torch/csrc/"


class Kernel(NamedTuple):
    source: str
    entry: str     # its row of vkrt_tpu_torch.device.counts
    replaces: str  # the TPU kernel it replaces


KERNELS = {
    "trace": Kernel(CSRC + "trace.cu", "vkrt_trace", "vkrt_tpu/ops/pallas/trace.py:1084"),
    "shade": Kernel(CSRC + "shade.cu", "vkrt_shade", "vkrt_tpu/ops/pallas/shade.py:179"),
    "shade_albedo": Kernel(CSRC + "shade.cu", "vkrt_shade.albedo",
                           "vkrt_tpu/ops/pallas/shade.py:179 (albedo)"),
    "floor": Kernel(CSRC + "probes.cu", "vkrt_floor", "benchmarks/micro_trace.py:51"),
    "trace_ablate": Kernel(CSRC + "trace_variants.cu", "vkrt_trace_ablate",
                           "benchmarks/scratch/ablate_kernel.py:95"),
    "trace_variant": Kernel(CSRC + "trace_variants.cu", "vkrt_trace_variant",
                            "benchmarks/scratch/variants.py:220"),
    "fma_peak": Kernel(CSRC + "probes.cu", "vkrt_fma_peak", "benchmarks/scratch/vpupeak.py:65"),
    "rng_tea": Kernel(CSRC + "rng.cu", "vkrt_rng_tea", "none (vkrt_tpu/ops/rng.py::tea, in XLA)"),
    "rng_table": Kernel(CSRC + "rng.cu", "vkrt_rng_table",
                        "none (vkrt_tpu/ops/rng.py::corr_draws, in XLA)"),
    "tex_level0": Kernel(CSRC + "texture.cu", "vkrt_tex_level0",
                         "none (vkrt_tpu/ops/texture.py::sample_texture, in XLA)"),
    "tex_trilinear": Kernel(CSRC + "texture.cu", "vkrt_tex_lod",
                            "none (vkrt_tpu/ops/texture.py::sample_texture_lod, in XLA)"),
    "tex_aniso": Kernel(CSRC + "texture.cu", "vkrt_tex_aniso",
                        "none (vkrt_tpu/ops/texture.py::sample_texture_aniso, in XLA)"),
    "denoise_temporal": Kernel(CSRC + "denoise.cu", "vkrt_denoise_temporal",
                               "none (vkrt_tpu/models/denoiser.py reproject, clamp, moments, "
                               "in XLA)"),
    "denoise_atrous": Kernel(CSRC + "denoise.cu", "vkrt_denoise_atrous",
                             "none (vkrt_tpu/models/denoiser.py::atrous_filter, in XLA)"),
}
# the card's published peaks (H100 SXM data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# FP32 instructions a second: the 67 TFLOP/s count an FMA as 2 FLOPs, and
# every other FP32 instruction (add, mul, min, max, compare) issues at the
# FMA's rate and does one
FP32_INSTR_PER_S = FP32_FLOPS / 2
# FP32 instructions of one slab test and one Moller-Trumbore test of the
# traversal kernels (csrc/trace.cu), counted from the source: none of them
# is a fused multiply-add
SLAB_OPS, MT_OPS = 26, 52
# integer instructions of one TEA round a lane at the least (csrc/rng.cu):
# per half a shift-add, an add, a shift-add, a three-way xor, an accumulate;
# the bound takes 128 a clock an SM, the combined issue limit of the INT32
# pipe (64 lanes) and the IMAD work the compiler can move onto the FMA
# pipe: an optimistic bound (the INT32 pipe alone would give twice the time)
TEA_ROUND_OPS = 10
# the cells' frame (framebench/configs/city-2160p.json)
RNG_W, RNG_H = 3840, 2160
# the sponzoid cell's frame (framebench/configs/sponzoid-1440p.json)
SPONZOID_W, SPONZOID_H = 2560, 1440
# FP32 instructions of the texel fetch a lane (csrc/texture.cuh, texture.cu),
# counted from the source, each IEEE sqrt, division and log2 as one (an
# optimistic bound): a bilinear fetch 62 (the wrap 4, the scale 4, the
# half-texel shift 2, two floors, the weights 4, two casts, the mix 44);
# a trilinear one two of those and 20 (the clamp, the level, the blend);
# an anisotropic tap one trilinear and 11 (its offset, uv and the sum), and
# 25 a lane around the taps (the footprint, the minor lod, the division)
BILINEAR_OPS = 62
TRILINEAR_OPS = 2 * BILINEAR_OPS + 20
ANISO_TAP_OPS, ANISO_LANE_OPS = TRILINEAR_OPS + 11, 25
# FP32 instructions of an a-trous pixel with the variance and the hit
# distance (csrc/denoise.cu), counted from the source, each pow, exp, sqrt
# and division as one (an optimistic bound): a tap 38 (the normal's dot 5,
# its clamp 1, pow 1; the depth's difference, scale and exp 3; the kernel
# weight 2; the luminance 5, its difference, division, exp and product 4;
# the hit distance's 6; the sums 7; the variance's 4), the centre tap 6
# fewer, and 37 around the taps (the centre's luminance 5, the pre-blur 22,
# the hit distance 3, the divides 7)
ATROUS_TAP_OPS, ATROUS_PIXEL_OPS = 38, 37 - 6
# bytes a pixel: a-trous reads the image, normal, depth, variance and hit
# distance and writes the image and variance; the temporal pass reads the
# packed radiance and normal, depth, position and the six history fields
# (each once) and writes the eight fields of ``models.denoiser.Temporal``
ATROUS_BYTES = 12 + 12 + 4 + 4 + 4 + 12 + 4
TEMPORAL_BYTES = 16 + 16 + 4 + 12 + (12 + 4 + 4 + 4 + 4 + 12) + (12 + 4 * 6 + 12)
PROBE_VARIANTS = ("threaded", "binary", "ordered", "flat", "mt128")


def log(msg: str) -> None:
    print(msg, flush=True)


def by_kernel(by_entry: dict, names=tuple(KERNELS)) -> dict:
    """Launches by ``device.counts`` row (a rank's gathered copy) under the
    kernels' ``names`` of ``KERNELS``."""
    return {k: by_entry[KERNELS[k].entry] for k in names}


def launches_now(names=tuple(KERNELS)) -> dict:
    """``by_kernel`` of the launches since the last
    ``device.reset_counts()``."""
    from vkrt_tpu_torch import device as kdev

    return by_kernel({e: c["launches"] for e, c in kdev.counts.items()}, names)


def cuda_ms(fn, reps: int = 10) -> float:
    """Device ms per call of ``fn``: ``reps`` calls queued behind a spin
    kernel and timed back to back with CUDA events (``time_calls``)."""
    import torch

    from vkrt_tpu_torch.benchmarks import time_calls

    return time_calls(fn, reps, torch.device("cuda"))[0]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes: float, instrs: float):
    """(bound_ms, bound_by): the larger of the bytes over the card's memory
    rate and the FP32 instructions over its FP32 instruction rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, instrs / FP32_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def trace_bound(tables, n_rays: int, counts, out_bytes_per_ray: int = 16):
    """Bound of a traversal over ``n_rays`` rays: each input read once (the
    node and triangle ``tables`` the walk reads, 7 floats a ray), each
    output written once, and the FP32 instructions of the slab and
    Moller-Trumbore tests this run's walk made (``counts``, a BvhCounts)."""
    n_bytes = nbytes(*tables) + n_rays * (28 + out_bytes_per_ray)
    instrs = (int(counts.nodes.sum()) * SLAB_OPS + int(counts.leaves.sum()) * MT_OPS)
    return bound(n_bytes, instrs)


def walk_tables(bvh):
    """What kernels A and D read of a scene: its record tables."""
    return (bvh.nodes, bvh.tris)


def variant_tables(tables, variant: str):
    """What a variant of kernel E reads: its node table(s) and the triangle
    records (``mt<K>``: its K records alone)."""
    if variant.startswith("mt"):
        return (tables.scene_tris[:int(variant[2:])],)
    if variant == "ordered":
        return (tables.wide.nodes, tables.bvh.tris)
    if variant == "flat":
        return (tables.cut_boxes, tables.threaded, tables.bvh.tris)
    return (tables.threaded, tables.bvh.tris)


def flat_counts(b, o, d, t_lim):
    """The slab and triangle tests of variant ``flat`` on rays whose limit
    exceeds t_min: every box of the cut, then the stackless walk below each
    cut node that is hit. That is the plain stackless walk over a table
    whose inner nodes above the cut hold all of space, less those nodes."""
    import torch

    from vkrt_tpu_torch.ops.trace import BvhCounts, trace_rays_bvh

    tables = b.tables
    above = (tables.depth < tables.cut_depth) & (tables.bvh.threaded.view(torch.int32)[:, 7] < 0)
    nodes = tables.bvh.threaded.clone()
    nodes[above, 0:3] = -float("inf")
    nodes[above, 4:7] = float("inf")
    _, cnt = trace_rays_bvh(nodes, b.scene, o, d, t_lim, count=True)
    return BvhCounts(cnt.nodes - int(above.sum()), cnt.leaves)


def compare_trace(name, k, p, t_lim, ties: bool = True) -> float:
    """Kernel hits ``k`` against plain hits ``p`` (RayHits). Verdicts equal
    on >= 99.99% of lanes; on closest lanes where both hit, triangle ids
    equal except at equal-t ties (``ties`` False: equal on every lane, for a
    kernel that decides its ties as the plain version does), t within 1e-5
    relative, u and v within 1e-5 absolute. First-hit-kills lanes
    (t_lim < 0) promise only their verdict. Returns the max abs t error on
    compared lanes."""
    kt, ktri, ku, kv = (x.cpu().numpy() for x in k)
    pt, ptri, pu, pv = (x.cpu().numpy() for x in p)
    lim = t_lim.cpu().numpy()
    kh, ph = ktri >= 0, ptri >= 0
    agree = (kh == ph).mean()
    closest = kh & ph & ~(lim < 0)
    same = closest & (ktri == ptri)
    rel = np.abs(kt - pt) / np.maximum(np.abs(pt), 1e-30)
    tie_ok = rel[closest & ~same] <= 1e-5
    miss = ~kh
    err_t = float(np.abs(kt - pt)[closest].max(initial=0.0))
    log(f"[trace] {name}: {len(lim)} lanes, hit {kh.mean():.4f}, verdict agree "
        f"{agree:.6f}, closest both-hit {closest.sum()}, same tri "
        f"{same.sum()} (other winners {int((closest & ~same).sum())}), max rel t {rel[closest].max(initial=0.0):.3g}, max |du| "
        f"{np.abs(ku - pu)[same].max(initial=0.0):.3g}, max |dv| "
        f"{np.abs(kv - pv)[same].max(initial=0.0):.3g}")
    if agree < 0.9999:
        raise AssertionError(f"{name}: verdicts agree on {agree:.6f} < 0.9999")
    if not tie_ok.all():
        raise AssertionError(f"{name}: {int((~tie_ok).sum())} other winners at unequal t")
    if not ties and (closest & ~same).any():
        raise AssertionError(f"{name}: {int((closest & ~same).sum())} other winners at equal t")
    if (rel[closest] > 1e-5).any():
        raise AssertionError(f"{name}: t beyond 1e-5 relative on {int((rel[closest] > 1e-5).sum())} lanes")
    if (np.abs(ku - pu)[same] > 1e-5).any() or (np.abs(kv - pv)[same] > 1e-5).any():
        raise AssertionError(f"{name}: u/v beyond 1e-5")
    if not (np.array_equal(kt[miss], np.abs(lim[miss]))
            and (ku[miss] == 0).all() and (kv[miss] == 0).all()):
        raise AssertionError(f"{name}: miss contract (t = |t_lim|, u = v = 0) broken")
    return err_t


def compare_shade(name, k, p) -> float:
    """Kernel ShadeOut ``k`` against plain ``p``: active and do_shadow masks
    equal on >= 99.9% of lanes, seeds bit-equal there, every float column
    within 1e-4 relative (1e-6 absolute near zero) on >= 99% of lanes.
    Returns the max abs error over float columns on mask-agreeing lanes."""
    from vkrt_tpu_torch.ops.cuda.shade import C_ACTIVE, C_PSH

    kc, pc = k.carry.cpu().numpy(), p.carry.cpu().numpy()
    agree = ((kc[C_ACTIVE] > 0) == (pc[C_ACTIVE] > 0)) & ((kc[C_PSH] > 0) == (pc[C_PSH] > 0))
    if agree.mean() < 0.999:
        raise AssertionError(f"{name}: masks agree on {agree.mean():.6f} < 0.999")
    ks, ps = k.seed.cpu().numpy(), p.seed.cpu().numpy()
    if not np.array_equal(ks[agree], ps[agree]):
        raise AssertionError(f"{name}: seeds differ on {int((ks != ps)[agree].sum())} lanes")
    worst, max_err = 1.0, 0.0
    for what, a, b in (("carry", kc, pc), ("next", k.next_rays.cpu().numpy(), p.next_rays.cpu().numpy()),
                       ("shadow", k.shadow_rays.cpu().numpy(), p.shadow_rays.cpu().numpy())):
        for c in range(a.shape[0]):
            x, y = a[c].astype(np.float64), b[c].astype(np.float64)
            both_nan = np.isnan(x) & np.isnan(y)
            ok = np.isclose(x, y, rtol=1e-4, atol=1e-6) | both_nan
            frac = ok.mean()
            worst = min(worst, frac)
            d = np.where(both_nan, 0.0, np.abs(x - y))[agree]
            max_err = max(max_err, float(np.nanmax(d, initial=0.0)))
            if frac < 0.99:
                raise AssertionError(f"{name}: {what}[{c}] close on {frac:.4f} < 0.99")
    log(f"[shade] {name}: {kc.shape[1]} lanes, masks agree {agree.mean():.6f}, "
        f"active {(kc[C_ACTIVE] > 0).mean():.4f}, worst column close {worst:.6f}, "
        f"max abs err {max_err:.3g}")
    return max_err


def random_rays(n, seed, device):
    """Rays in [-1.5, 1.5]^3 with closest, first-hit-kills, zero-limit (+0
    and -0) and dead (origin 1e30, d = 0, limit -1) lanes."""
    import torch

    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lim = np.full(n, 1e4)
    lane = rng.integers(0, 6, n)
    lim[lane == 1] = -rng.uniform(0.05, 3.0, (lane == 1).sum())
    lim[lane == 2] = rng.uniform(0.05, 2.0, (lane == 2).sum())
    lim[lane == 3] = 0.0
    lim[lane == 4] = -0.0
    o[lane == 5] = 1e30
    d[lane == 5] = 0.0
    lim[lane == 5] = -1.0

    def t(a):
        return torch.tensor(a.astype(np.float32), device=device)

    return t(o), t(d), t(lim)


def phase_kernels(dev, results):
    """Phases 2 and 3; returns bounce 0's first-hit-kills shadow pool (o, d,
    t_lim) for phase 6."""
    import torch

    from vkrt_tpu_torch.models.pathtracer import corr_seed_for
    from vkrt_tpu_torch.ops.cuda.shade import (
        ShadeParams, clamp_bounds, scene_tables, shade, shade_plain,
    )
    from vkrt_tpu_torch.ops.cuda.trace import make_cuda_tracer, trace_kernel
    from vkrt_tpu_torch.ops.intersect import T_MAX, T_MIN
    from vkrt_tpu_torch.ops.rng import block_uniform_table, rnd, tea
    from vkrt_tpu_torch.ops.trace import trace_rays_bruteforce, trace_rays_bvh_ordered
    from vkrt_tpu_torch.scene import load_cornell, make_random_soup
    from vkrt_tpu_torch.utils.camera import Camera, generate_rays, pixel_coords, tile_perm

    scene = load_cornell(device=dev)
    tracer = make_cuda_tracer(scene)
    log(f"[scene] {scene.num_tris} triangles, {scene.num_lights} lights, "
        f"{tracer.bvh.nodes.shape[0]} child-box records, {tracer.bvh.tris.shape[0]} "
        f"triangle records, depth {tracer.bvh.depth}")

    def plain(o, d, lim, sc=scene):
        return trace_rays_bruteforce(sc.tri_v0, sc.tri_e1, sc.tri_e2, o, d, lim, T_MIN)

    # (a) tile-ordered primaries, closest mode (frame 0: centre jitter)
    perm, _ = tile_perm(W, H)
    pid = torch.as_tensor(perm.astype(np.int64), device=dev)
    cam = Camera().matrices(W, H, dev)
    o, d = generate_rays(cam, W, H, torch.tensor([0.5, 0.5], device=dev),
                         pix=pixel_coords(W, H, dev)[pid])
    lim = torch.full((W * H,), T_MAX, device=dev)
    k = tracer.trace(o, d, lim)
    errs = [compare_trace("primaries 1280x720", k, plain(o, d, lim), lim, ties=False)]
    ms = cuda_ms(lambda: tracer.trace(o, d, lim))
    plain_ms = cuda_ms(lambda: plain(o, d, lim), reps=3)
    walk, counts = trace_rays_bvh_ordered(tracer.bvh, o, d, lim, count=True)
    check_equal("trace_rays_bvh_ordered vs kernel A on the primaries", walk, k)
    bound_ms, bound_by = trace_bound(walk_tables(tracer.bvh), W * H, counts)
    log(f"[trace] primaries 1280x720: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}; {counts.nodes.float().mean():.2f} slab "
        f"and {counts.leaves.float().mean():.2f} triangle tests a ray)")
    results["trace"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None}

    # (b) frame 1's bounce pool and its shadow pool
    frame = 1
    seed = tea(pid, frame)
    seed, r1 = rnd(seed)
    seed, r2 = rnd(seed)
    o, d = generate_rays(cam, W, H, torch.stack([r1, r2], -1), pix=pixel_coords(W, H, dev)[pid])
    n = W * H
    rays = torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                        torch.full((n,), T_MAX, device=dev)]).contiguous()
    carry = torch.zeros((14, n), device=dev)
    carry[0:3] = 1.0
    carry[6] = 1.0
    mat_tab, light_tab = scene_tables(scene)
    lo, hi = clamp_bounds(False)
    corr_seed = corr_seed_for(frame, 0)

    def params(dd):
        return ShadeParams(d=dd, first=dd == 0, resolve_hd=dd == 2, hitdist_weight=1.0,
                           hitdist_accumulate=True, t_min=T_MIN, t_max=T_MAX,
                           clear=CLEAR[:3], clamp_lo=lo, clamp_hi=hi)

    # phase 3 runs here too: bounces 0 and 1 of the main-path pool, corr on
    shade_errs = []
    sh_tri = None
    for dd in range(2):
        hit = tracer.trace_block(rays)
        tab = block_uniform_table(n // 1024, corr_seed, dd, device=dev)
        args = (carry, seed, rays, hit, sh_tri, scene, mat_tab, light_tab, tab, params(dd))
        out = shade(*args)
        shade_errs.append(compare_shade(f"bounce {dd} 1280x720 corr", out, shade_plain(*args)))
        if dd == 0:
            s_ms = cuda_ms(lambda: shade(*args))
            s_plain = cuda_ms(lambda: shade_plain(*args), reps=3)
            # every input read once, every output written once
            io = nbytes(carry, seed, rays, *hit, sh_tri, scene.corner_normal,
                        scene.corner_tangent, scene.tri_mat, mat_tab, light_tab, tab,
                        out.carry, out.seed, out.next_rays, out.shadow_rays)
            b_ms, b_by = bound(io, 0)
            log(f"[shade] bounce 0 1280x720: kernel {s_ms:.4f} ms, plain {s_plain:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}, {io / n:.1f} B/lane)")
            results["shade"] = {"ms": s_ms, "plain_ms": s_plain, "bound_ms": b_ms,
                                "bound_by": b_by, "library_ms": None}
        sh = out.shadow_rays
        sh_o, sh_d, sh_l = sh[0:3].T, sh[3:6].T, sh[6]
        k = tracer.trace(sh_o, sh_d, sh_l)
        if dd == 0:
            shadow_pool = (sh_o, sh_d, sh_l)
        errs.append(compare_trace(f"shadow pool d={dd}", k, plain(sh_o, sh_d, sh_l), sh_l,
                                  ties=False))
        if dd == 0:
            nx = out.next_rays
            nx_o, nx_d, nx_l = nx[0:3].T, nx[3:6].T, nx[6]
            errs.append(compare_trace("bounce pool d=1", tracer.trace(nx_o, nx_d, nx_l),
                                      plain(nx_o, nx_d, nx_l), nx_l, ties=False))
        carry, seed, rays, sh_tri = out.carry, out.seed, out.next_rays, k.tri
    results["shade"]["max_abs_err"] = max(shade_errs)

    # (c) the size of the real asset: a 16,384-triangle soup
    soup = make_random_soup(16384, device=dev)
    soup_tracer = make_cuda_tracer(soup)
    o, d, lim = random_rays(65536, 3, dev)
    k = trace_kernel(soup_tracer.bvh, soup, o, d, lim)
    errs.append(compare_trace("soup 16384 tris, 65536 rays", k, plain(o, d, lim, soup), lim,
                              ties=False))
    ms = cuda_ms(lambda: trace_kernel(soup_tracer.bvh, soup, o, d, lim))
    plain_ms = cuda_ms(lambda: plain(o, d, lim, soup), reps=2)
    log(f"[trace] soup 16384 tris, 65536 rays: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results["trace"]["max_abs_err"] = max(errs)
    return shadow_pool


def phase_albedo(dev, results, cb):
    """Phase 3b: kernel B's albedo instantiation against ``shade_plain`` on
    bounces 0 and 1 of the city's 1280x720 tile-ordered pool, corr on
    (``cb``: the city's BuiltScene; its tracer is kernel A)."""
    import torch

    from vkrt_tpu_torch.models.pathtracer import corr_seed_for
    from vkrt_tpu_torch.ops.cuda.shade import (
        ShadeParams, clamp_bounds, scene_tables, shade, shade_plain,
    )
    from vkrt_tpu_torch.ops.intersect import T_MAX, T_MIN
    from vkrt_tpu_torch.ops.rng import block_uniform_table, rnd, tea
    from vkrt_tpu_torch.scene import scene_base_only_textured
    from vkrt_tpu_torch.utils.camera import generate_rays, orbit_camera, pixel_coords, tile_perm

    scene, tracer = cb.scene, cb.tracer
    if not scene_base_only_textured(scene):
        raise AssertionError("the city is not a baseColor-only scene")
    perm, _ = tile_perm(W, H)
    pid = torch.as_tensor(perm.astype(np.int64), device=dev)
    cam = orbit_camera(**CITY_CAM).matrices(W, H, dev)
    frame, n = 1, W * H
    seed = tea(pid, frame)
    seed, r1 = rnd(seed)
    seed, r2 = rnd(seed)
    o, d = generate_rays(cam, W, H, torch.stack([r1, r2], -1), pix=pixel_coords(W, H, dev)[pid])
    rays = torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                        torch.full((n,), T_MAX, device=dev)]).contiguous()
    carry = torch.zeros((14, n), device=dev)
    carry[0:3] = 1.0
    carry[6] = 1.0
    mat_tab, light_tab = scene_tables(scene)
    lo, hi = clamp_bounds(False)
    errs, sh_tri = [], None
    for dd in range(2):
        hit = tracer.trace_block(rays)
        tab = block_uniform_table(n // 1024, corr_seed_for(frame, 0), dd, device=dev)
        p = ShadeParams(d=dd, first=dd == 0, resolve_hd=dd == 2, hitdist_weight=1.0,
                        hitdist_accumulate=True, t_min=T_MIN, t_max=T_MAX, clear=CLEAR[:3],
                        clamp_lo=lo, clamp_hi=hi, albedo=True)
        args = (carry, seed, rays, hit, sh_tri, scene, mat_tab, light_tab, tab, p)
        out = shade(*args)
        errs.append(compare_shade(f"city bounce {dd} 1280x720 corr, albedo", out,
                                  shade_plain(*args)))
        if dd == 0:
            s_ms = cuda_ms(lambda: shade(*args))
            s_plain = cuda_ms(lambda: shade_plain(*args), reps=3)
            # every input read once, every output written once: the lane
            # columns, the corner rows of the triangles this pool hits (the
            # kernel reads no others), the material, light, corr and texture
            # tables whole
            tris = hit.tri[hit.tri >= 0].unique()
            rows = tris.numel() * (nbytes(scene.corner_normal[:1], scene.corner_tangent[:1],
                                          scene.corner_uv[:1], scene.tri_mat[:1]))
            io = rows + nbytes(carry, seed, rays, *hit, mat_tab, light_tab, tab,
                               scene.mat_base_tex, scene.tex_rgba, scene.tex_size,
                               out.carry, out.seed, out.next_rays, out.shadow_rays)
            b_ms, b_by = bound(io, 0)
            hit_share = float((hit.tri >= 0).float().mean())
            log(f"[shade] city bounce 0 1280x720, albedo: kernel {s_ms:.4f} ms, plain "
                f"{s_plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {io / n:.1f} B/lane; "
                f"{hit_share:.4f} of the lanes hit, {tris.numel()} distinct triangles)")
            results["shade_albedo"] = {"ms": s_ms, "plain_ms": s_plain, "bound_ms": b_ms,
                                       "bound_by": b_by, "library_ms": None}
        sh_tri = tracer.trace_block(out.shadow_rays).tri
        carry, seed, rays = out.carry, out.seed, out.next_rays
    results["shade_albedo"]["max_abs_err"] = max(errs)


def phase_rng(dev, results):
    """Phase 3c: the RNG prologue's kernels against the int64 plain path on
    the card (``tea_plain``, ``block_uniform_table_plain``,
    ``corr_draws_plain`` called by name), at the cells' sizes."""
    import torch

    from vkrt_tpu_torch.benchmarks import time_calls
    from vkrt_tpu_torch.ops import rng
    from vkrt_tpu_torch.utils.camera import tile_perm

    n = RNG_W * RNG_H
    perm, _ = tile_perm(RNG_W, RNG_H)
    pid = torch.as_tensor(perm.astype(np.int64), device=dev)
    frame, corr_seed, g = 0x9E3779B9, 0xDEADBEEF, n // 1024

    def run(name, kernel, plain, n_bytes, instrs, what):
        check_equal(f"{name} {what}", (kernel().view(torch.int32),), (plain().view(torch.int32),))
        ms = cuda_ms(kernel)
        plain_ms, plain_host_ms = time_calls(plain, 3, dev)
        b_ms, b_by = bound(n_bytes, instrs)
        log(f"[rng] {name} {what}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"plain {plain_ms:.4f} device ms, {plain_host_ms:.4f} host ms a call")
        return {"ms": ms, "plain_ms": plain_ms, "plain_host_ms": plain_host_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "max_abs_err": 0.0}

    results["rng_tea"] = run(
        "tea", lambda: rng.tea(pid, frame), lambda: rng.tea_plain(pid, frame),
        n * (8 + 4), n * 16 * TEA_ROUND_OPS, f"16 rounds, {RNG_W}x{RNG_H} pixel ids")
    # a table row: 8 rounds, then 6 draws of a multiply-add, a mask, a
    # conversion and a multiply
    row_ops = 8 * TEA_ROUND_OPS + 6 * 4
    results["rng_table"] = run(
        "table", lambda: rng.block_uniform_table(g, corr_seed, 3, device=dev),
        lambda: rng.block_uniform_table_plain(g, corr_seed, 3, device=dev),
        g * 8 * 4, g * row_ops, f"{g} rows (G, 8)")
    results["rng_table"]["lanes"] = run(
        "corr_draws", lambda: rng.corr_draws(n, corr_seed, 66, device=dev),
        lambda: rng.corr_draws_plain(n, corr_seed, 66, device=dev),
        n * 6 * 4, g * row_ops, f"{n} lanes (N, 6)")


def texture_lanes(dev, w: int, h: int, k: int, seed: int):
    """A frame's coherent texture lanes, w x h pixels over ``k`` images:
    uv a ramp across the frame (7.3 x 4.1 repeats, starting below 0), the
    index one of ``k`` images or -1 (white) in 256-pixel tiles, the UV
    derivatives a footprint whose size runs over 2^-4 .. 2^4 texels of a
    64-texel image down the frame and whose direction turns across it; the
    first 64 lanes non-finite or huge (a miss lane's derivatives, a uv at
    infinity). Returns (idx int32, uv, lod, ddx, ddy) on ``dev``."""
    import torch

    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                          torch.arange(w, dtype=torch.float32), indexing="ij")
    x, y = x.reshape(-1), y.reshape(-1)
    uv = torch.stack([(x + 0.5) / w * 7.3 - 1.2, (y + 0.5) / h * 4.1 - 0.3], dim=-1)
    tile = (x // 256).long() + 3 * (y // 256).long() + seed
    idx = (tile % (k + 1) - 1).to(torch.int32)
    size = torch.exp2((y + 0.5) / h * 8.0 - 4.0) / 64.0
    ang = (x + 0.5) / w * 3.1416
    ddx = torch.stack([size * torch.cos(ang), size * torch.sin(ang) * 0.3], dim=-1)
    ddy = torch.stack([-size * torch.sin(ang) * 0.5, size * torch.cos(ang) * 0.2], dim=-1)
    lod = (x + 0.5) / w * 10.0 - 2.0
    odd = torch.tensor([float("nan"), float("inf"), -float("inf"), 3e38, -3e38, 0.0, -0.0,
                        1e-30], dtype=torch.float32)
    bad = odd[torch.arange(64) % odd.numel()]
    uv[:64, 0], uv[:64, 1] = bad, bad.flip(0)
    ddx[:64, 0], ddy[:64, 1], lod[:64] = bad, bad.roll(3), bad.roll(5)
    return tuple(t.contiguous().to(dev) for t in (idx, uv, lod, ddx, ddy))


def phase_texture(dev, results):
    """Phase 3d (row T): the texel fetch's kernel (``csrc/texture.cu``) at
    the cells' shapes against the plain PyTorch path on the card
    (``sample_texture_plain`` and the rest called by name), bit for bit on
    every lane: the sponzoid's level-0 call over six 256x256 f32 images at
    2560x1440 lanes, and the city's trilinear and 4x anisotropic calls over
    three 64x64 images' bf16 mip atlas at 3840x2160 lanes."""
    import torch

    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.benchmarks import time_calls
    from vkrt_tpu_torch.ops import texture as tex

    gen = np.random.default_rng(20)
    imgs = [gen.integers(0, 256, (256, 256, 4), dtype=np.uint8) for _ in range(6)]
    tex_rgba = torch.as_tensor(np.stack(imgs).astype(np.float32) / 255.0, device=dev)
    tex_size = torch.full((6, 2), 256, dtype=torch.int32, device=dev)
    atlas, lsize, loff, nlev = tex.pack_mip_atlas(
        [gen.integers(0, 256, (64, 64, 4), dtype=np.uint8) for _ in range(3)], [True, False, True])
    mip = (torch.as_tensor(atlas, device=dev).to(torch.bfloat16),
           *(torch.as_tensor(a, device=dev) for a in (lsize, loff, nlev)))

    def run(name, kernel, plain, n, lane_bytes, tables, instrs, what):
        count = kdev.counts[KERNELS[f"tex_{name}"].entry]
        before = count["launches"]
        got = kernel()
        if count["launches"] != before + 1:
            raise AssertionError(f"{name}: {count['launches'] - before} launches for one call")
        check_equal(f"texture {name} {what}", (got.view(torch.int32),),
                    (plain().view(torch.int32),))
        ms = cuda_ms(kernel)
        plain_ms, plain_host_ms = time_calls(plain, 3, dev)
        b_ms, b_by = bound(n * lane_bytes + nbytes(*tables), instrs)
        log(f"[texture] {name} {what}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{lane_bytes} B a lane), {ms / b_ms * 100:.1f}% of it; plain {plain_ms:.4f} device "
            f"ms, {plain_host_ms:.4f} host ms a call; {int(torch.isnan(got).any(1).sum())} "
            f"NaN lanes, equal bit for bit")
        return {"ms": ms, "plain_ms": plain_ms, "plain_host_ms": plain_host_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "max_abs_err": 0.0,
                "lanes": n}

    n = SPONZOID_W * SPONZOID_H
    idx, uv, _, _, _ = texture_lanes(dev, SPONZOID_W, SPONZOID_H, 6, 1)
    results["tex_level0"] = run(
        "level0", lambda: tex.sample_texture(tex_rgba, tex_size, idx, uv),
        lambda: tex.sample_texture_plain(tex_rgba, tex_size, idx, uv), n, 8 + 4 + 16,
        (tex_rgba, tex_size), n * BILINEAR_OPS,
        f"{SPONZOID_W}x{SPONZOID_H} lanes, six 256x256 f32 images")
    n = RNG_W * RNG_H
    idx, uv, lod, ddx, ddy = texture_lanes(dev, RNG_W, RNG_H, 3, 2)
    results["tex_trilinear"] = run(
        "trilinear", lambda: tex.sample_texture_lod(*mip, idx, uv, lod),
        lambda: tex.sample_texture_lod_plain(*mip, idx, uv, lod), n, 8 + 4 + 4 + 16, mip,
        n * TRILINEAR_OPS, f"{RNG_W}x{RNG_H} lanes, a bf16 atlas of three 64x64 images")
    results["tex_aniso"] = run(
        "aniso",
        lambda: tex.sample_texture_aniso(*mip, idx, uv, ddx, ddy, taps=4),
        lambda: tex.sample_texture_aniso_plain(*mip, idx, uv, ddx, ddy, taps=4), n,
        8 + 4 + 8 + 8 + 16, mip, n * (4 * ANISO_TAP_OPS + ANISO_LANE_OPS),
        f"{RNG_W}x{RNG_H} lanes, 4 taps, the same atlas")


def texture_launches(level0: int = 0, trilinear: int = 0, aniso: int = 0) -> dict:
    """The texel fetch's launches a frame, one a ``sample_*`` call: on the
    card kernel B fetches its own albedo, so the city path makes none, a
    hybrid frame on the city one anisotropic G-buffer fetch, and the
    sponzoid's general loop one level-0 fetch a used slot (baseColor and
    the normal map) a bounce."""
    return {"tex_level0": level0, "tex_trilinear": trilinear, "tex_aniso": aniso}


def rng_launches(settings, alpha_traces: int = 0) -> dict:
    """The RNG kernels' launches a frame (``csrc/rng.cu``): one ``tea`` of
    the pixel seeds, and ``DEFAULT_ROUNDS`` more for each of
    ``alpha_traces`` alpha-tested traces (a punch draw a round); with the
    correlated sampler on, one table a draw set: each sample's bounces in
    path mode, and in hybrid mode the shadow's light pick, each AO sample,
    GI's lobe and each of GI's depth - 1 bounces."""
    from vkrt_tpu_torch.models.hybrid import AO_SAMPLES
    from vkrt_tpu_torch.ops.alpha import DEFAULT_ROUNDS

    s = settings
    if s.rt_mode == 1:
        tables = s.samples * s.depth
    else:
        tables = int(s.use_shadows) + AO_SAMPLES * int(s.use_ao) + s.depth * int(s.use_gi)
    return {"rng_tea": 1 + alpha_traces * DEFAULT_ROUNDS,
            "rng_table": tables if s.corr_sampler else 0}


def path_launches(depth: int, albedo: bool) -> dict:
    """Launches a path-mode frame makes: kernel A 2 * depth times (a closest
    and a shadow trace a bounce), kernel B depth times (all of them albedo
    launches on a baseColor-only scene)."""
    return {"trace": 2 * depth, "shade": depth, "shade_albedo": depth if albedo else 0}


def denoise_launches(temporal: bool = True) -> dict:
    """The denoiser's launches a frame (``csrc/denoise.cu``): the temporal
    pass once, the à-trous filter once an iteration (3)."""
    return {"denoise_temporal": int(temporal), "denoise_atrous": 3}


def hybrid_launches(depth: int, albedo: bool) -> dict:
    """Launches a hybrid frame with shadows, AO and GI makes on a scene
    kernel B shades: kernel A for the G-buffer, once for the visibility
    pool, then a closest and a shadow trace for each of the GI chain's
    depth - 1 bounces; kernel B once a bounce."""
    return {"trace": 2 + 2 * (depth - 1), "shade": depth - 1,
            "shade_albedo": depth - 1 if albedo else 0}


def drive_engine(eng, per_frame: dict, label: str, pose=None, batches_n: int = 3,
                 step=None):
    """A main path: 2 warm-up frames, then ``batches_n`` batches of 8 frames
    timed with CUDA events, with ``device.counts`` set to 0 just before
    and read just after. Each count must grow by ``per_frame`` a frame
    (keys trace, shade, shade_albedo, rng_tea and rng_table of
    ``rng_launches``, and where given those of ``texture_launches``), and
    the texel fetch's launches must equal its calls (the "texture" ranges
    entered, counted through ``utils.profiling.pass_label``) on every path.
    ``pose``: camera of the k-th frame
    of the warm-up or of a batch (a fly-through: ``eng.camera`` is set
    before each frame), None for a fixed camera. ``step``: called with the
    run's frame index before each frame (an animated scene's re-pose), its
    time inside the timed batches. Returns (best batch (ms/frame, Mrays/s,
    rays/frame), launches, the last frame's image)."""
    import torch

    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.utils import profiling

    count = [0]
    tex_calls = {"open": 0, "calls": 0}
    real_label = profiling.pass_label

    @contextlib.contextmanager
    def texture_range(name):
        tex_calls["calls"] += tex_calls["open"] == 0
        tex_calls["open"] += 1
        try:
            with real_label(name):
                yield
        finally:
            tex_calls["open"] -= 1

    def frame(k):
        if pose is not None:
            eng.camera = pose(k)
        if step is not None:
            step(count[0])
        count[0] += 1
        return eng.render_frame()

    kdev.reset_counts()
    profiling.pass_label = lambda name: (texture_range(name) if name == "texture"
                                         else real_label(name))
    try:
        frames = 0
        for k in range(2):  # warm-up
            frame(k)
            frames += 1
        torch.cuda.synchronize()
        batches = []
        for _ in range(batches_n):
            rays0 = eng.total_rays
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for k in range(8):
                out = frame(k)
                frames += 1
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            rays = eng.total_rays - rays0
            batches.append((ms / 8, rays / (ms * 1e-3) / 1e6, rays / 8))
    finally:
        profiling.pass_label = real_label
    launches = launches_now()
    for ms, mrays, rpf in batches:
        log(f"[{label}] batch: {ms:.4f} ms/frame, {mrays:.4f} Mrays/s, {rpf:.0f} rays/frame")
    best = min(batches)
    s = eng.settings
    mode = ("path" if s.rt_mode == 1 else
            f"hybrid (shadows {s.use_shadows}, AO {s.use_ao}, GI {s.use_gi})")
    log(f"[{label}] {eng.width}x{eng.height} {mode} spp {s.samples} depth {s.depth} corr "
        f"{'on' if s.corr_sampler else 'off'}: best batch {best[0]:.4f} ms/frame, "
        f"{best[1]:.4f} Mrays/s, {best[2]:.0f} rays/frame; launches {launches} over "
        f"{frames} frames ({', '.join(f'{k} {v / frames:g}' for k, v in launches.items())} "
        f"a frame)")
    want = {k: v * frames for k, v in per_frame.items()}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    tex_launches = sum(launches[k] for k in texture_launches())
    if tex_launches != tex_calls["calls"]:
        raise AssertionError(f"{tex_calls['calls']} texture calls made {tex_launches} texture "
                             f"launches")
    accum = (eng.accum if s.rt_mode == 1 else eng.accum_rt).cpu().numpy()
    if not np.isfinite(accum).all():
        raise AssertionError(f"non-finite accum ({int((~np.isfinite(accum)).sum())} elements)")
    if float(accum.max()) <= 0.0:
        raise AssertionError("all-zero/black accum")
    return best, launches, out


def profile_frames(eng, label: str, frames: int = 4) -> dict:
    """Where a frame's device time goes (``profile_calls`` of
    ``eng.render_frame``). The profiled frames are extra: they are not in
    the timed batches or the launch counts."""
    return profile_calls(eng.render_frame, label, frames, "frame")


def profile_calls(fn, label: str, calls: int = 4, unit: str = "call") -> dict:
    """``calls`` calls of ``fn`` under torch.profiler: the device kernels'
    time a call by kernel A, kernel B and the rest (PyTorch's own kernels;
    the three of those that take the most time by name), the device's idle
    share between the first kernel's start and the last one's end, and
    kernel launches a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vkrt_tpu_torch.utils.profiling import RANGES

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    # device kernels only: the program's named ranges (record_function)
    # also appear on the device timeline, as user annotations spanning their work
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.name not in RANGES)
    if not spans:
        raise AssertionError(f"{label}: the profiler saw no device kernel")
    by, other = {"kernel A": 0.0, "kernel B": 0.0, "other": 0.0}, {}
    for start, end, name in spans:
        key = ("kernel A" if "trace_kernel" in name else
               "kernel B" if "shade_kernel" in name else "other")
        by[key] += (end - start) * 1e-3 / calls
        if key == "other":
            other[name] = other.get(name, 0.0) + (end - start) * 1e-3 / calls
    busy, (lo, hi, _) = 0.0, spans[0]
    for start, end, _ in spans[1:]:
        if start > hi:
            busy, lo, hi = busy + hi - lo, start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    window = max(end for _, end, _ in spans) - spans[0][0]
    launches = sum(e.name == "cudaLaunchKernel" for e in events) / calls
    top = sorted(other.items(), key=lambda kv: -kv[1])[:3]
    out = {"device_ms": sum(by.values()), "by_kernel_ms": by,
           "idle_share": 1.0 - busy / window, "kernels_per_frame": len(spans) / calls,
           "launch_calls_per_frame": launches, "top_other_ms": dict(top)}
    log(f"[{label}] profile of {calls} {unit}s: device kernel time {out['device_ms']:.4f} "
        f"ms/{unit} (" + ", ".join(f"{k} {v:.4f}" for k, v in by.items()) + f"), idle share "
        f"{out['idle_share']:.4f} of the {window * 1e-3 / calls:.4f} ms/{unit} device span, "
        f"{out['kernels_per_frame']:.0f} kernels and {launches:.0f} cudaLaunchKernel calls a "
        f"{unit}; most device time among the rest: "
        + "; ".join(f"{v:.4f} ms {k[:90]}" for k, v in top))
    return out


def phase_main_path(dev, results):
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.scene import load_cornell
    from vkrt_tpu_torch.utils.camera import Camera

    eng = Engine(load_cornell(device=dev), W, H, path_settings(DEPTH), Camera(), CLEAR)
    best, launches, _ = drive_engine(
        eng, {**path_launches(DEPTH, False), **rng_launches(eng.settings),
              **texture_launches()}, "main")
    for name in ("trace", "shade", "rng_tea", "rng_table", *texture_launches()):
        results[name]["launches"] = launches[name]
    results["main"] = {"ms_per_frame": best[0], "mrays_per_s": best[1],
                       "profile": profile_frames(eng, "main")}


def phase_city_main_path(dev, results, city):
    """Phase 4b: suite row 3 through ``Engine`` (which builds its own BVH,
    as a user's call does)."""
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.utils.camera import orbit_camera

    t0 = time.perf_counter()
    eng = Engine(city, W, H, path_settings(CITY_DEPTH), orbit_camera(**CITY_CAM), CLEAR)
    log(f"[city] Engine on {city.num_tris} triangles (padded): set-up with its BVH "
        f"{time.perf_counter() - t0:.2f} s")
    best, launches, _ = drive_engine(
        eng, {**path_launches(CITY_DEPTH, True), **rng_launches(eng.settings),
              **texture_launches()}, "city")
    results["shade_albedo"]["launches"] = launches["shade_albedo"]
    # the city path's own counts of kernels A and B (B's: all of them albedo
    # launches, so they equal shade_albedo's) and of the RNG kernels;
    # "launches" is Cornell's
    for name in ("trace", "shade", "rng_tea", "rng_table"):
        results[name]["city_launches"] = launches[name]
    results["city"] = {"ms_per_frame": best[0], "mrays_per_s": best[1],
                       "rays_per_frame": best[2], "profile": profile_frames(eng, "city")}


class PoolRecorder:
    """A tracer that keeps what is traced through it and passes every call
    on to kernel A's tracer: ``pool``, the last first-hit-kills pool of
    ``any`` (in a hybrid frame on a scene kernel B shades, the visibility
    pool alone), and ``pools``, every (o, d, t_lim, t_min) of ``closest``
    (in a general-loop frame: the primaries, then the fused bounce and
    shadow pools)."""

    anyhit_kill_capable = True

    def __init__(self, inner):
        self.inner, self.pool, self.pools = inner, None, []

    def closest(self, orig, direction, t_min, t_max, t_lim=None):
        self.pools.append((orig, direction, t_lim, t_min))
        return self.inner.closest(orig, direction, t_min, t_max, t_lim=t_lim)

    def trace_block(self, *args, **kw):
        return self.inner.trace_block(*args, **kw)

    def any(self, orig, direction, t_min, t_max):
        self.pool = (orig, direction, t_min, t_max)
        return self.inner.any(orig, direction, t_min, t_max)


def phase_hybrid_main_path(dev, results, city):
    """Phase 4c: suite row 4 (``hybrid_shadows_ao_gi``) through ``Engine``:
    the timed batches and the profile as phase 4b, then one more frame
    whose visibility pool (one shadow and four AO lanes a pixel) goes
    through kernel A and through the plain front-to-back walk: equal
    verdicts on every lane, and no hit on a lane that skips its query."""
    import torch

    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.models.gbuffer import gbuffer_pass
    from vkrt_tpu_torch.models.hybrid import hybrid_effects
    from vkrt_tpu_torch.ops.cuda.trace import trace_kernel
    from vkrt_tpu_torch.ops.rng import tea
    from vkrt_tpu_torch.ops.trace import trace_rays_bvh_ordered
    from vkrt_tpu_torch.utils.camera import orbit_camera

    t_phase = time.perf_counter()
    settings = RenderSettings(samples=1, depth=HYBRID_DEPTH, rt_mode=0, use_shadows=True,
                              use_ao=True, use_gi=True, corr_sampler=True)
    eng = Engine(city, W, H, settings, orbit_camera(**CITY_CAM), CLEAR)
    per_frame = {**hybrid_launches(HYBRID_DEPTH, True), **rng_launches(settings),
                 **texture_launches(aniso=1)}
    best, launches, _ = drive_engine(eng, per_frame, "hybrid")
    if not (launches["trace"] > 0 and launches["shade"] > 0):
        raise AssertionError(f"hybrid path launches {launches}")
    for name in ("trace", "shade", "shade_albedo", "rng_tea", "rng_table",
                 *texture_launches()):
        results[name]["hybrid_launches"] = launches[name]
    profile = profile_frames(eng, "hybrid")

    rec = PoolRecorder(eng.tracer)
    eng.tracer = rec
    eng.render_frame()
    eng.tracer = rec.inner
    o, d, t_min, t_max = rec.pool
    n = W * H
    if o.shape[0] != 5 * n:
        raise AssertionError(f"visibility pool of {o.shape[0]} lanes, want {5 * n}")
    lim = -t_max.abs()  # Tracer.any: first-hit-kills lanes; a skipped query keeps -0.0
    bvh = rec.inner.bvh
    k = trace_kernel(bvh, city, o, d, lim, t_min, any_hit=True)
    t0 = time.perf_counter()
    p, counts = trace_rays_bvh_ordered(bvh, o, d, lim, t_min, any_hit=True, count=True)
    sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    # verdicts as uint32 (a miss's triangle id of -1 read as a float would be a NaN pattern)
    kv, pv = ((h.tri >= 0).to(torch.int32).cpu().numpy().view(np.uint32) for h in (k, p))
    skip = (t_max == 0.0).cpu().numpy()
    log(f"[hybrid] visibility pool: {o.shape[0]} lanes ({int(skip.sum())} skip their query), "
        f"t_min {t_min}, occluded {int(kv.sum())} (kernel A) / {int(pv.sum())} (plain walk), "
        f"shadow lanes occluded {int(kv[:n].sum())}, AO lanes {int(kv[n:].sum())}")
    if not np.array_equal(kv, pv):
        raise AssertionError(f"visibility verdicts differ on {int((kv != pv).sum())} lanes")
    if kv[skip].any() or pv[skip].any():
        raise AssertionError("a lane that skips its query hit something")
    ms = cuda_ms(lambda: trace_kernel(bvh, city, o, d, lim, t_min, any_hit=True), reps=8)
    pool_bound = trace_bound(walk_tables(bvh), o.shape[0], counts)
    log(f"[hybrid] visibility pool through kernel A: {ms:.4f} ms, bound {pool_bound[0]:.4f} ms "
        f"({pool_bound[1]}; {counts.nodes.float().mean():.2f} slab and "
        f"{counts.leaves.float().mean():.2f} triangle tests a lane), plain walk "
        f"{plain_ms:.1f} ms (host clock)")
    # the frame's stages alone, on frame 1's seeds: the G-buffer pass, the
    # shadow and AO pool with its set-up, and the effects with GI
    cam = eng.camera.matrices(W, H, dev)
    seeds = tea(eng._perm, 1)
    tracer = eng.tracer
    gbuf = gbuffer_pass(city, tracer, cam, W, H, CLEAR, pix=eng._pix)

    def effects(gi):
        return lambda: hybrid_effects(city, tracer, gbuf, cam, seeds, 1, eng.accum_rt,
                                      depth=HYBRID_DEPTH, use_shadows=True, use_ao=True,
                                      use_gi=gi, corr=True)

    stages = {"gbuffer": profile_calls(lambda: gbuffer_pass(city, tracer, cam, W, H, CLEAR,
                                                            pix=eng._pix),
                                       "hybrid G-buffer pass"),
              "shadows_ao": profile_calls(effects(False), "hybrid shadows + AO"),
              "shadows_ao_gi": profile_calls(effects(True), "hybrid shadows + AO + GI")}
    results["hybrid"] = {"ms_per_frame": best[0], "mrays_per_s": best[1],
                         "rays_per_frame": best[2], "launches_per_frame": per_frame,
                         "profile": profile, "stages": stages, "pool_lanes": o.shape[0],
                         "pool_ms": ms, "pool_plain_ms": plain_ms, "pool_bound_ms": pool_bound[0],
                         "pool_bound_by": pool_bound[1]}
    log(f"[hybrid] phase wall time {time.perf_counter() - t_phase:.1f} s")


SPONZOID_DEPTH = 3
# the app's renders of the sponzoid (phase 5h)
APP_W, APP_H = 320, 180


def general_launches(depth: int) -> dict:
    """Launches a path-mode frame of the general loop makes (a scene with
    normal maps: kernel A and PyTorch shading): kernel A depth + 1 times
    (the primaries, depth - 1 fused bounce and shadow pools, the last
    shadow rays), kernel B none."""
    return {"trace": depth + 1, "shade": 0, "shade_albedo": 0}


def sponzoid_instanced(dev):
    """The PNG sponzoid (suite row 8's asset, tess 4) as an InstancedScene
    on ``dev``; every texture must decode at full size."""
    from vkrt_tpu_torch.benchmarks.suite import ASSET_DIR, MIN_TEXTURE_PX, SPONZOID_TESS
    from vkrt_tpu_torch.scene_instances import build_instanced
    from vkrt_tpu_torch.utils.gltf import parse_gltf
    from vkrt_tpu_torch.utils.sponzoid import sponzoid_path

    t0 = time.perf_counter()
    path = sponzoid_path(str(ASSET_DIR), tess=SPONZOID_TESS, texture_format="png")
    doc = parse_gltf(path)
    sizes = [tuple(im.data.shape[:2]) for im in doc.images]
    if min(min(s) for s in sizes) < MIN_TEXTURE_PX:
        raise AssertionError(f"sponzoid textures decoded at {sizes}")
    inst = build_instanced(doc, device=dev)
    log(f"[sponzoid] {path}: {inst.scene.num_tris} triangles in {inst.num_nodes} primitives "
        f"{[e - s for s, e in inst.prim_ranges]}, {inst.scene.num_lights} lights, textures "
        f"{sizes}; written, parsed and uploaded in {time.perf_counter() - t0:.2f} s")
    return path, inst


def phase_sponzoid(dev, results, card):
    """Phase 4e: suite row 8 (``sponzoid_disk_pathtrace``) as an
    InstancedScene through ``Engine``: static, then animated (the largest
    primitive moved every frame by ``set_node_transform``, x += 0.02 (f +
    1)), each 2 warm-up frames and 3 timed batches of 8; kernel A's
    launches; the repose's host ms and rows; no SAH build after a repose;
    profiles; then kernel A on the refit tables against a fresh build of
    the last pose on the frame's primaries and one bounce's rays."""
    import torch

    from vkrt_tpu_torch import scene_instances as si
    from vkrt_tpu_torch.benchmarks.suite import SPONZOID_CAMERA
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.ops.cuda import trace as ktrace
    from vkrt_tpu_torch.ops.cuda.shade import kernel_shading_available
    from vkrt_tpu_torch.ops.trace import trace_rays_bvh_ordered
    from vkrt_tpu_torch.utils.camera import Camera

    t_phase = time.perf_counter()
    path, inst = sponzoid_instanced(dev)
    t0 = time.perf_counter()
    eng = Engine(inst, W, H, path_settings(SPONZOID_DEPTH), Camera(**SPONZOID_CAMERA), CLEAR)
    bvh0 = eng.tracer.bvh
    log(f"[sponzoid] Engine set-up with its BVH {time.perf_counter() - t0:.2f} s: "
        f"{bvh0.nodes.shape[0]} child-box records, depth {bvh0.depth}")
    if kernel_shading_available(eng.scene):
        raise AssertionError("the sponzoid would take the packed loop, not the general loop")
    per = {**general_launches(SPONZOID_DEPTH), **rng_launches(eng.settings),
           **texture_launches(level0=2 * SPONZOID_DEPTH)}
    static, launches, _ = drive_engine(eng, per, "sponzoid")
    for name in ("trace", "rng_tea", "rng_table", *texture_launches()):
        results[name]["sponzoid_launches"] = launches[name]
    static_prof = profile_frames(eng, "sponzoid")

    node = int(np.argmax([e - s for s, e in inst.prim_ranges]))
    reposes, builds = [], [0]
    rows0 = dict(ktrace.refit_bvh.rows)
    real_build = ktrace.native.build_sah_bvh

    def counting_build(*args, **kw):
        builds[0] += 1
        return real_build(*args, **kw)

    def repose(f):
        t0 = time.perf_counter()
        eng.set_node_transform(node, translation(0.02 * (f + 1), 0.0, 0.0))
        reposes.append((time.perf_counter() - t0) * 1e3)

    # the repose's two parts, timed where set_node_transform calls them:
    # re-bake + splice (repose) and the refit (repose_tracer)
    parts = {"repose": [], "repose_tracer": []}
    real_parts = {k: getattr(si, k) for k in parts}

    def timed_part(name):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = real_parts[name](*args, **kw)
            parts[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    ktrace.native.build_sah_bvh = counting_build
    for k in parts:
        setattr(si, k, timed_part(k))
    try:
        anim, launches, _ = drive_engine(eng, per, "sponzoid animated", step=repose)
        anim_prof = profile_calls(lambda: (repose(len(reposes)), eng.render_frame()),
                                  "sponzoid animated", unit="frame")
    finally:
        ktrace.native.build_sah_bvh = real_build
        for k, fn in real_parts.items():
            setattr(si, k, fn)
    if builds[0]:
        raise AssertionError(f"{builds[0]} native SAH builds ran after a repose")
    results["trace"]["sponzoid_animated_launches"] = launches["trace"]
    rows = {k: (ktrace.refit_bvh.rows[k] - rows0[k]) / len(reposes) for k in rows0}
    steady = np.asarray(reposes[1:])
    lo, hi = inst.prim_ranges[node]
    log(f"[sponzoid] repose of primitive {node} ({hi - lo} of {inst.scene.num_tris} "
        f"triangles), {len(reposes)} reposes: first {reposes[0]:.3f} ms, steady state "
        f"mean {steady.mean():.3f} ms, min {steady.min():.3f}, max {steady.max():.3f} "
        f"(host clock: re-bake, refit, splice); rows rewritten a repose {rows} of "
        f"{bvh0.nodes.shape[0]} records, {bvh0.tris.shape[0]} triangle records, "
        f"{bvh0.threaded.shape[0]} threaded rows; no SAH build ({card})")
    split = {k: float(np.mean(v[1:])) for k, v in parts.items()}
    log(f"[sponzoid] the repose's parts, steady state mean: re-bake + splice "
        f"{split['repose']:.3f} ms, refit {split['repose_tracer']:.3f} ms (host clock)")

    # after the last pose: kernel A on the refit tables against a fresh build
    rec = PoolRecorder(eng.tracer)
    eng.tracer = rec
    eng.render_frame()
    eng.tracer = rec.inner
    refit = rec.inner.bvh
    t0 = time.perf_counter()
    fresh = ktrace.build_bvh(eng.scene, eng.instances.tri_arrays())
    build_s = time.perf_counter() - t0
    n = W * H
    po, pd, plim, pt = rec.pools[0]
    bo, bd, blim, bt = rec.pools[1]
    if po.shape[0] != n or bo.shape[0] != 2 * n:
        raise AssertionError(f"pools of {po.shape[0]} and {bo.shape[0]} lanes")
    for name, (o, d, lim, tm) in (("primaries", (po, pd, plim, pt)),
                                  ("bounce 1", (bo[:n], bd[:n], blim[:n], bt))):
        a = ktrace.trace_kernel(refit, eng.scene, o, d, lim, tm)
        b = ktrace.trace_kernel(fresh, eng.scene, o, d, lim, tm)
        check_equal(f"sponzoid {name}, refit vs fresh build (as uint32)",
                    *([x.view(torch.int32) for x in h] for h in (a, b)))
        log(f"[sponzoid] {name}: {o.shape[0]} lanes, {int((a.tri >= 0).sum())} hits, "
            f"(t, tri, u, v) equal as uint32, refit tables vs a fresh build_bvh")
    sh = slice(n, 2 * n)
    a = ktrace.trace_kernel(refit, eng.scene, bo[sh], bd[sh], blim[sh], bt)
    b = ktrace.trace_kernel(fresh, eng.scene, bo[sh], bd[sh], blim[sh], bt)
    if not torch.equal(a.tri >= 0, b.tri >= 0):
        raise AssertionError("sponzoid shadow verdicts differ between refit and fresh tables")
    # kernel A on the primaries, both tables, against their bounds
    times = {}
    for name, tables in (("refit", refit), ("fresh", fresh)):
        ms = cuda_ms(lambda: ktrace.trace_kernel(tables, eng.scene, po, pd, plim, pt))
        _, counts = trace_rays_bvh_ordered(tables, po, pd, plim, pt, count=True)
        b_ms, b_by = trace_bound(walk_tables(tables), n, counts)
        times[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                       "slab_tests": float(counts.nodes.float().mean()),
                       "triangle_tests": float(counts.leaves.float().mean())}
        log(f"[sponzoid] kernel A on the primaries, {name} tables: {ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; {times[name]['slab_tests']:.2f} slab and "
            f"{times[name]['triangle_tests']:.2f} triangle tests a ray)")
    log(f"[sponzoid] fresh build_bvh of the last pose: {build_s:.2f} s (host)")
    log(f"[sponzoid] {W}x{H} path spp 1 depth {SPONZOID_DEPTH} ({card}): static "
        f"{static[0]:.4f} ms/frame {static[1]:.4f} Mrays/s; animated {anim[0]:.4f} ms/frame "
        f"{anim[1]:.4f} Mrays/s; {static[2]:.0f} rays/frame")
    results["sponzoid"] = {
        "ms_per_frame": static[0], "mrays_per_s": static[1], "rays_per_frame": static[2],
        "animated_ms_per_frame": anim[0], "animated_mrays_per_s": anim[1],
        "repose_first_ms": reposes[0], "repose_steady_ms": float(steady.mean()),
        "repose_parts_ms": split,
        "rows_per_repose": rows, "launches_per_frame": per, "profile": static_prof,
        "animated_profile": anim_prof, "primaries": times}
    log(f"[sponzoid] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return inst


def gate_numbers(a, b):
    """The display-domain gate's numbers (tests/test_accuracy_oracle.py:83-88)
    between two linear images: (p99 of the per-pixel error, the share of
    pixels beyond 1e-2, the RMSE of the rest, whether the gate holds)."""
    da, db = (np.clip(np.clip(x, 0, None) ** (1.0 / 2.2), 0, 1) for x in (a, b))
    err = np.abs(da - db).max(-1)
    p99 = float(np.percentile(err, 99))
    diverged = err > 1e-2
    rmse = float(np.sqrt(np.mean((da - db)[~diverged] ** 2)))
    return p99, float(diverged.mean()), rmse, p99 <= 1e-3 and diverged.mean() < 0.01 and \
        rmse <= 1e-3


def display_gate(name, imgs, rays, gated: bool = True) -> bool:
    """The display-domain gate between the card's and the CPU's images, and
    their ray counts within 0.1%. ``gated`` False reports the gate and
    returns whether it held, without failing on it."""
    p99, diverged, rmse, ok = gate_numbers(imgs["cuda"], imgs["cpu"])
    log(f"[e2e] {name}, kernels vs plain: p99 {p99:.3g}, diverged {diverged:.4f}, "
        f"rmse {rmse:.3g}, rays {rays}, mean {float(imgs['cuda'].mean()):.4f}"
        + ("" if gated else f" (reported, not gated: {'holds' if ok else 'fails'})"))
    for k, v in imgs.items():
        if not np.isfinite(v).all() or float(v.max()) <= 0.0:
            raise AssertionError(f"{name}: the {k} image is not finite and non-black")
    if gated and not ok:
        raise AssertionError(f"{name}: end-to-end display gate failed")
    if abs(rays["cuda"] - rays["cpu"]) > 1e-3 * rays["cpu"]:
        raise AssertionError(f"{name}: ray counts differ: {rays}")
    return ok


def path_settings(depth: int):
    from vkrt_tpu_torch.config import RenderSettings

    return RenderSettings(samples=1, depth=depth, rt_mode=1, corr_sampler=True)


def render_both(dev, make_scene, camera, settings, w: int = 160, h: int = 120,
                frames: int = 4):
    """``frames`` frames of ``Engine`` on the card and on the CPU (plain
    versions): ({device: image}, {device: rays}, the card's launches,
    {device: the hybrid G-buffer as numpy arrays, or None}). ``camera``: a
    Camera, or a function of the frame index giving the camera of each
    frame (a fly-through)."""
    import torch

    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.engine import Engine

    pose = camera if callable(camera) else (lambda f: camera)
    imgs, rays, launches, gbufs = {}, {}, None, {}
    for where in (dev, torch.device("cpu")):
        eng = Engine(make_scene(where), w, h, settings, pose(0), CLEAR)
        kdev.reset_counts()
        for f in range(frames):
            eng.camera = pose(f)
            out = eng.render_frame()
        imgs[where.type] = out.cpu().numpy().astype(np.float64)
        rays[where.type] = eng.total_rays
        gbufs[where.type] = (None if eng.gbuffer is None else
                             type(eng.gbuffer)(*(x.cpu().numpy() for x in eng.gbuffer)))
        if where.type == "cuda":
            launches = launches_now(("trace", "shade"))
    return imgs, rays, launches, gbufs


def phase_end_to_end(dev):
    from vkrt_tpu_torch.scene import load_cornell
    from vkrt_tpu_torch.utils.camera import Camera

    imgs, rays, _, _ = render_both(dev, lambda where: load_cornell(device=where), Camera(),
                                   path_settings(DEPTH))
    display_gate(f"Cornell 160x120 depth {DEPTH} 4 frames", imgs, rays)


def phase_city_end_to_end(dev):
    from vkrt_tpu_torch.scene import make_city
    from vkrt_tpu_torch.utils.camera import orbit_camera

    imgs, rays, launches, _ = render_both(
        dev, lambda where: make_city(grid=SMALL_CITY_GRID, device=where),
        orbit_camera(**SMALL_CITY_CAM), path_settings(CITY_DEPTH))
    display_gate(f"make_city(grid={SMALL_CITY_GRID}) 160x120 depth {CITY_DEPTH} 4 frames",
                 imgs, rays)
    want = {"trace": 2 * CITY_DEPTH * 4, "shade": CITY_DEPTH * 4}
    if launches != want:
        raise AssertionError(f"small city launches {launches} != {want}")


def general_scene(device):
    """A scene that takes the general shading loop, built in memory: a slab
    and three boxes whose materials use every texture slot (numpy images:
    a checker, a tangent-space normal ramp, a metallic-roughness noise and
    an emissive window grid), lit by two point lights."""
    from vkrt_tpu_torch.scene import _boxes, _boxes_uvs, scene_from_soup
    from vkrt_tpu_torch.utils import gltf as gltf_mod

    n = 32
    rng = np.random.default_rng(5)
    ij = np.arange(n)
    checker = np.zeros((n, n, 4), np.uint8)
    cell = (ij[:, None] // 4 + ij[None, :] // 4) % 2 == 1
    checker[..., 0] = np.where(cell, 220, 40)
    checker[..., 1] = np.where(cell, 60, 180)
    checker[..., 2], checker[..., 3] = 40, 255
    ramp = np.linspace(-0.4, 0.4, n, dtype=np.float32)
    nx, ny = np.meshgrid(ramp, ramp)
    normal = np.zeros((n, n, 4), np.uint8)
    for c, x in enumerate((nx, ny, np.sqrt(1.0 - nx ** 2 - ny ** 2))):
        normal[..., c] = ((x * 0.5 + 0.5) * 255).astype(np.uint8)
    normal[..., 3] = 255
    mr = rng.integers(0, 256, (n, n, 4), dtype=np.uint8)
    mr[..., 3] = 255
    glow = np.full((n, n, 4), 20, np.uint8)
    glow[4::8, 4::8, :3] = 255
    glow[..., 3] = 255
    images = [gltf_mod.GltfImage(im, name) for im, name in
              ((checker, "checker"), (normal, "normal"), (mr, "mr"), (glow, "glow"))]
    f32 = np.float32
    mats = [
        gltf_mod.GltfMaterial(np.ones(4, f32), base_color_texture=0, normal_texture=1,
                              metallic_factor=0.0, roughness_factor=0.9),
        gltf_mod.GltfMaterial(np.array([0.9, 0.8, 0.7, 1], f32), base_color_texture=0,
                              metallic_roughness_texture=2, metallic_factor=0.8,
                              roughness_factor=0.6),
        gltf_mod.GltfMaterial(np.array([0.5, 0.5, 0.6, 1], f32), emissive_texture=3,
                              emissive_factor=np.array([2.0, 1.5, 1.0], f32),
                              metallic_factor=0.2, roughness_factor=0.4),
        gltf_mod.GltfMaterial(np.array([0.7, 0.7, 0.7, 1], f32), metallic_factor=0.0),
    ]
    centers = [(0.0, -0.25, 0.0), (-2.0, 1.0, -1.0), (1.5, 0.75, 0.5), (0.0, 2.5, -3.0)]
    halves = [(6.0, 0.25, 6.0), (1.0, 1.0, 1.0), (0.75, 0.75, 0.75), (2.0, 0.5, 0.5)]
    tris = _boxes(centers, halves, [0.0, 0.4, -0.3, 0.1])
    uvs = _boxes_uvs(halves, [0.25, 0.5, 0.5, 1.0])
    lights = [gltf_mod.GltfLight(np.array(p, f32), np.ones(3, f32), 60.0, 0)
              for p in ((2.0, 6.0, 3.0), (-3.0, 5.0, -1.0))]
    return scene_from_soup(tris, np.repeat(np.arange(4), 12).tolist(), mats, lights,
                           images=images, uvs=uvs.astype(f32), device=device)


def phase_general_loop(dev):
    """Phase 5c: a scene of every texture slot through the general loop:
    kernel A on the card, shading in PyTorch."""
    from vkrt_tpu_torch.ops.cuda.shade import kernel_shading_available
    from vkrt_tpu_torch.utils.camera import Camera

    if kernel_shading_available(general_scene("cpu")):
        raise AssertionError("the general scene would take the packed loop")
    cam = Camera(eye=(5.0, 4.0, 9.0), center=(0.0, 0.5, 0.0))
    imgs, rays, launches, _ = render_both(dev, general_scene, cam, path_settings(CITY_DEPTH))
    display_gate(f"general loop, every texture slot, 160x120 depth {CITY_DEPTH} 4 frames",
                 imgs, rays)
    want = {"trace": (CITY_DEPTH + 1) * 4, "shade": 0}
    log(f"[general] launches on the card over 4 frames: {launches}")
    if launches != want:
        raise AssertionError(f"general loop launches {launches} != {want}")


def compare_gbuffers(name, gbufs) -> None:
    """The card's G-buffer against the CPU's: the hit/miss mask (position
    and normal exactly 0) equal on every pixel, and every field within 1e-4
    (absolute, or relative above 1) on >= 99.9% of the pixels."""
    g, c = gbufs["cuda"], gbufs["cpu"]

    def miss(x):
        return (x.position[:, :3] == 0).all(1) & (x.normal[:, :3] == 0).all(1)

    if not np.array_equal(miss(g), miss(c)):
        raise AssertionError(f"{name}: G-buffer masks differ on "
                             f"{int((miss(g) != miss(c)).sum())} pixels")
    worst = 1.0
    for field, a, b in zip(g._fields, g, c):
        close = np.isclose(a, b, rtol=1e-4, atol=1e-4).reshape(a.shape[0], -1).all(1).mean()
        worst = min(worst, close)
        if close < 0.999:
            raise AssertionError(f"{name}: G-buffer {field} close on {close:.5f} < 0.999")
    log(f"[e2e] {name}: G-buffer masks equal ({miss(c).mean():.4f} background), every field "
        f"close on >= {worst:.5f} of the pixels")


def phase_hybrid_end_to_end(dev):
    """Phase 5d: hybrid frames, kernels against plain versions: the Cornell
    box with GI, the small city with GI off and on (160x120, depth 3, 4
    frames); the display gate, rays within 0.1%, the G-buffers, and the
    card's launches a frame."""
    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.scene import load_cornell, make_city
    from vkrt_tpu_torch.utils.camera import Camera, orbit_camera

    def small_city(where):
        return make_city(grid=SMALL_CITY_GRID, device=where)

    for label, make_scene, camera, gi in (
            ("Cornell", lambda where: load_cornell(device=where), Camera(), True),
            (f"make_city(grid={SMALL_CITY_GRID})", small_city, orbit_camera(**SMALL_CITY_CAM),
             False),
            (f"make_city(grid={SMALL_CITY_GRID})", small_city, orbit_camera(**SMALL_CITY_CAM),
             True)):
        settings = RenderSettings(samples=1, depth=HYBRID_DEPTH, rt_mode=0, use_gi=gi,
                                  corr_sampler=True)
        imgs, rays, launches, gbufs = render_both(dev, make_scene, camera, settings)
        name = f"hybrid {label} GI {'on' if gi else 'off'} 160x120 depth {HYBRID_DEPTH} 4 frames"
        display_gate(name, imgs, rays)
        compare_gbuffers(name, gbufs)
        per = hybrid_launches(HYBRID_DEPTH, False) if gi else {"trace": 2, "shade": 0}
        want = {"trace": per["trace"] * 4, "shade": per["shade"] * 4}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches} != {want}")


def flythrough_pose(k: int):
    """The camera of suite row 5's k-th frame: ``orbit_camera(k / 8,
    radius=300, height=48)`` (``benchmarks/suite.py:62``, 8 frames)."""
    from vkrt_tpu_torch.utils.camera import orbit_camera

    return orbit_camera(k / FLY_FRAMES, **FLY_CAM)


def denoised_settings(temporal: bool = True, use_denoiser: bool = True):
    from vkrt_tpu_torch.config import RenderSettings

    return RenderSettings(samples=1, depth=HYBRID_DEPTH, rt_mode=0, use_shadows=True,
                          use_ao=True, use_gi=True, use_denoiser=use_denoiser,
                          temporal_denoiser=temporal, corr_sampler=True)


class DenoiserCalls:
    """Records every call of ``models.denoiser.denoise_temporal`` and
    ``denoise_gi`` (which ``hybrid_frame`` looks up at every call) while it
    is installed: ``calls`` holds (the function, its arguments, its
    result)."""

    NAMES = ("denoise_temporal", "denoise_gi")

    def __init__(self):
        from vkrt_tpu_torch.models import denoiser as dn

        self.module, self.calls = dn, []
        self.real = {k: getattr(dn, k) for k in self.NAMES}

    def __enter__(self):
        def recorder(fn):
            def record(*args):
                out = fn(*args)
                self.calls.append((fn, args, out))
                return out
            return record

        for k, fn in self.real.items():
            setattr(self.module, k, recorder(fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self.real.items():
            setattr(self.module, k, fn)


def to_cpu(x):
    """A tensor, or a tuple of tensors (a DenoiserState), on the CPU."""
    import torch

    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, tuple):
        return type(x)(*(to_cpu(y) for y in x))
    return x


def compare_denoised(name, card, cpu, quiet: bool = False) -> float:
    """The card's denoiser output (filtered radiance and, from the temporal
    denoiser, the new state) against the CPU's on the same inputs: every
    float within atol 1e-5 + rtol 1e-4, the history's validity (length > 1)
    equal. Returns the max abs error."""
    import torch

    if torch.is_tensor(card):  # denoise_gi: the filtered radiance alone
        card, cpu = (card, None), (cpu, None)
    fields = ("filtered",) + (type(card[1])._fields if card[1] is not None else ())
    worst = 0.0
    for field, a, b in zip(fields, (card[0],) + tuple(card[1] or ()),
                           (cpu[0],) + tuple(cpu[1] or ())):
        a, b = a.cpu().numpy(), b.numpy()
        err = np.abs(a.astype(np.float64) - b)
        worst = max(worst, float(err.max()))
        bad = err > 1e-5 + 1e-4 * np.abs(b)
        if bad.any():
            raise AssertionError(f"{name}: {field} beyond atol 1e-5 + rtol 1e-4 on "
                                 f"{int(bad.sum())} of {bad.size} elements (max {err.max():.3g})")
    if card[1] is not None and not np.array_equal(card[1].hist_len.cpu().numpy() > 1.0,
                                                  cpu[1].hist_len.numpy() > 1.0):
        raise AssertionError(f"{name}: history validity differs")
    if not quiet:
        log(f"[denoised] {name}: card and CPU agree, max abs err {worst:.3g}")
    return worst


def phase_denoised_main_path(dev, results, city, card):
    """Phase 4d: suite row 5 (``city_flythrough_denoised``) through
    ``Engine``: the fly-through timed (2 warm-up frames, 3 batches of 8,
    the camera at ``orbit_camera(k / 8, radius=300, height=48)`` before the
    k-th frame of each), the launch counts (the denoiser's 1 + 3), the
    profile of a frame and of the denoiser alone, one frame's denoiser
    inputs filtered on the card and on the CPU, row N at 3840x2160
    (``denoiser_kernels``), the history over static
    frames, then the suite's ``rmse_vs_converged`` and
    ``rmse_noisy_1frame`` (``benchmarks/suite.py:203-229``)."""
    import torch

    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.utils.metrics import rmse

    t_phase = time.perf_counter()
    eng = Engine(city, W, H, denoised_settings(), flythrough_pose(0), CLEAR)
    per_frame = {**hybrid_launches(HYBRID_DEPTH, True), **rng_launches(eng.settings),
                 **texture_launches(aniso=1), **denoise_launches()}
    best, launches, final = drive_engine(eng, per_frame, "denoised", pose=flythrough_pose)
    for name in ("trace", "shade", "shade_albedo", "tex_aniso"):
        results[name]["denoised_launches"] = launches[name]
    denoiser_kernels(dev, results, city, card)
    for name in denoise_launches():
        results[name]["launches"] = launches[name]
    final = final.cpu().numpy().astype(np.float64)
    last = flythrough_pose(FLY_FRAMES - 1)
    poses = iter(range(FLY_FRAMES))

    def fly_frame():
        eng.camera = flythrough_pose(next(poses))
        return eng.render_frame()

    profile = profile_calls(fly_frame, "denoised", 4, "frame")

    # one frame's denoiser inputs (the next pose's), the denoiser alone on
    # the card, then on the CPU with the same torch code
    eng.camera = flythrough_pose(1)
    with DenoiserCalls() as rec:
        eng.render_frame()
    fn, args, card_out = rec.calls[-1]
    stage = profile_calls(lambda: fn(*args), "denoiser stage (denoise_temporal)")
    t0 = time.perf_counter()
    cpu_out = fn(*(to_cpu(a) for a in args))
    cpu_s = time.perf_counter() - t0
    err = compare_denoised(f"one frame's inputs, {W}x{H}", card_out, cpu_out)

    # static frames at the last pose: the history grows frame by frame (the
    # mean over the frame; background pixels never keep one)
    eng.camera = last
    lens = []
    for _ in range(4):
        eng.render_frame()
        lens.append(float(eng.denoise_state.hist_len.mean()))
    covered = float((eng.denoise_state.hist_len >= 4.0).float().mean())
    log(f"[denoised] history over 4 static frames: mean length {lens}; {covered:.4f} of the "
        f"pixels hold 4 frames")
    if not all(b > a for a, b in zip(lens, lens[1:])):
        raise AssertionError(f"the history does not grow over static frames: {lens}")

    # the suite's accuracy columns at the last pose: 64 static frames with
    # the denoiser off as the reference, one frame of it as the noisy input
    ref_eng = Engine(city, W, H, denoised_settings(use_denoiser=False), last, CLEAR)
    for _ in range(64):
        ref = ref_eng.render_frame()
    ref = ref.cpu().numpy().astype(np.float64)
    noisy = Engine(city, W, H, denoised_settings(use_denoiser=False), last,
                   CLEAR).render_frame().cpu().numpy().astype(np.float64)
    acc = {"rmse_vs_converged": rmse(final, ref), "rmse_noisy_1frame": rmse(noisy, ref)}
    log(f"[denoised] suite row 5 at {W}x{H} ({card}): best batch {best[0]:.4f} ms/frame, "
        f"{best[1]:.4f} Mrays/s, {best[2]:.0f} rays/frame; launches a frame {per_frame}; "
        f"device {profile['device_ms']:.4f} ms/frame, idle share {profile['idle_share']:.4f}; "
        f"denoiser stage {stage['device_ms']:.4f} ms device, {stage['kernels_per_frame']:.0f} "
        f"kernels; rmse_vs_converged {acc['rmse_vs_converged']:.6f}, rmse_noisy_1frame "
        f"{acc['rmse_noisy_1frame']:.6f}; the CPU's denoiser on the same inputs {cpu_s:.1f} s")
    results["denoised"] = {"ms_per_frame": best[0], "mrays_per_s": best[1],
                           "rays_per_frame": best[2], "launches_per_frame": per_frame,
                           "profile": profile, "denoiser_stage": stage,
                           "card_vs_cpu_max_abs_err": err, **acc}
    log(f"[denoised] phase wall time {time.perf_counter() - t_phase:.1f} s")


def same_bits(name, got, want) -> None:
    """Bit-equal up to NaN payloads: NaN where ``want`` has one, every other
    value equal."""
    import torch

    nan = torch.isnan(want)
    bad = ((got != want) & ~nan) | (torch.isnan(got) != nan)
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} of {got.numel()} values differ")


def denoiser_kernels(dev, results, city, card):
    """Row N at the cells' 3840x2160: one frame's denoiser inputs (the
    second frame of the fly-through's orbit) through ``denoise_temporal``
    (the kernels) and ``denoise_temporal_plain`` (the torch code) on the
    card, every output bit for bit; then the temporal kernel's and an
    à-trous launch's time (the 3 iterations' mean) beside their bounds, and
    the plain code's time."""
    import torch

    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.models import denoiser as dn

    w, h = RNG_W, RNG_H
    eng = Engine(city, w, h, denoised_settings(), flythrough_pose(0), CLEAR)
    eng.render_frame()
    eng.camera = flythrough_pose(1)
    with DenoiserCalls() as rec:
        eng.render_frame()
    _, args, _ = rec.calls[-1]
    state, packed, norm_rough, view_z, pos, view_proj = args[:6]
    got, want = dn.denoise_temporal(*args), dn.denoise_temporal_plain(*args)
    for field, a, b in zip(("filtered",) + dn.DenoiserState._fields, (got[0], *got[1]),
                           (want[0], *want[1])):
        same_bits(f"denoiser {w}x{h} {field}", a, b)
    n = w * h
    t = dn.temporal_pass(state, packed, norm_rough, view_z, pos, w, h, h)
    temporal_ms = cuda_ms(lambda: dn.temporal_pass(state, packed, norm_rough, view_z, pos,
                                                   w, h, h))
    atrous_ms = cuda_ms(lambda: dn.atrous_filter(t.rad_acc, t.prev_normal, view_z, w, h, 3,
                                                 t.variance, t.hit_dist)) / 3
    plain_ms = cuda_ms(lambda: dn.denoise_temporal_plain(*args), reps=3)
    out = {}
    for name, ms, b in (("denoise_temporal", temporal_ms, bound(n * TEMPORAL_BYTES, 0)),
                        ("denoise_atrous", atrous_ms,
                         bound(n * ATROUS_BYTES, n * (25 * ATROUS_TAP_OPS + ATROUS_PIXEL_OPS)))):
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                     "library_ms": None, "max_abs_err": 0.0, "lanes": n}
        log(f"[denoised] {name} at {w}x{h}: kernel {ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), "
            f"{b[0] / ms * 100:.1f}% of it")
    valid = float((got[1].hist_len > 1.0).float().mean())
    log(f"[denoised] the denoiser at {w}x{h} ({card}): 1 temporal + 3 a-trous launches "
        f"{temporal_ms + 3 * atrous_ms:.4f} ms, the plain torch code {plain_ms:.4f} ms device; "
        f"kernels and plain equal bit for bit in every output ({valid:.4f} of the pixels "
        f"reprojected)")
    results.update(out)


def phase_denoised_end_to_end(dev):
    """Phase 5e: denoised hybrid frames, kernels against plain versions: the
    Cornell box and the small city at 160x120, depth 3, 4 frames with the
    camera moving every frame, the temporal and the spatial-only denoiser.
    Gates, frame by frame: the denoiser's noisy inputs (the GI radiance the
    kernels produce) card against CPU through the display gate; the
    denoiser on the card against the plain torch code on the CPU given the
    card's own inputs and history, every float within atol 1e-5 + rtol
    1e-4; and the filtered GI of the two pipelines through the display gate.
    One ulp tie is exempt: the temporal denoiser boosts the variance while
    the history length is below 4, and a length that is 4 in exact
    arithmetic comes out of the bilinear reprojection as 4 +- an ulp, so
    the card and the CPU may decide such a pixel either way. Each side's flipped
    pixels must lie within 1e-4 of 4; from the first frame with a flip on,
    the filtered GI and the final composite are reported, not gated. Rays
    within 0.1%, the card's launches as in 5d."""
    from vkrt_tpu_torch.ops import nrd
    from vkrt_tpu_torch.scene import load_cornell, make_city
    from vkrt_tpu_torch.utils.camera import orbit_camera

    def small_city(where):
        return make_city(grid=SMALL_CITY_GRID, device=where)

    def city_pose(f):
        return orbit_camera(SMALL_CITY_CAM["t"] + 0.004 * f, radius=SMALL_CITY_CAM["radius"],
                            height=SMALL_CITY_CAM["height"])

    def box_pose(f):
        return orbit_camera(0.002 * f, radius=15.0, height=0.5)

    def gi(call):  # the GI radiance a denoiser call was given, (N,3) numpy
        temporal = isinstance(call[1][0], tuple)  # denoise_temporal(state, packed, ...)
        packed = call[1][1 if temporal else 0]
        return nrd.unpack_radiance_and_norm_hit_dist(packed)[:, :3].cpu().numpy()

    def filtered(call):
        out = call[2][0] if isinstance(call[2], tuple) else call[2]
        return out.cpu().numpy()

    def boost_ties(card, cpu):
        """Pixels whose variance boost (length < 4) the two sides decide
        differently; raises unless each lies within 1e-4 of 4 on both."""
        if not isinstance(card[2], tuple):
            return 0
        a, b = card[2][1].hist_len.cpu().numpy(), cpu[2][1].hist_len.numpy()
        flip = (a < 4.0) != (b < 4.0)
        if (np.abs(a[flip] - 4.0) >= 1e-4).any() or (np.abs(b[flip] - 4.0) >= 1e-4).any():
            raise AssertionError("a variance boost differs away from the length-4 tie")
        return int(flip.sum())

    for label, make_scene, pose in (
            ("Cornell", lambda where: load_cornell(device=where), box_pose),
            (f"make_city(grid={SMALL_CITY_GRID})", small_city, city_pose)):
        for temporal in (True, False):
            name = (f"denoised ({'temporal' if temporal else 'spatial'}) hybrid {label} "
                    f"160x120 depth {HYBRID_DEPTH} 4 moving frames")
            with DenoiserCalls() as rec:
                imgs, rays, launches, _ = render_both(dev, make_scene, pose,
                                                      denoised_settings(temporal))
            # render_both renders on the card first, then on the CPU
            card, cpu = rec.calls[:4], rec.calls[4:]
            if len(rec.calls) != 8 or card[0][1][1].device.type != dev.type:
                raise AssertionError(f"{name}: {len(rec.calls)} denoiser calls, want 4 a device")
            worst, ties, lines = 0.0, 0, []
            for f, (c, p) in enumerate(zip(card, cpu)):
                p99, div, rmse_, ok = gate_numbers(gi(c), gi(p))
                if not ok:
                    raise AssertionError(f"{name}: frame {f}'s noisy GI fails the display gate "
                                         f"(p99 {p99:.3g}, diverged {div:.4f}, rmse {rmse_:.3g})")
                plain = c[0](*(to_cpu(a) for a in c[1]))
                worst = max(worst, compare_denoised(f"{name}, frame {f}", c[2], plain, True))
                ties += boost_ties(c, p)
                p99, div, rmse_, ok = gate_numbers(filtered(c), filtered(p))
                lines.append(f"frame {f}: noisy GI p99 {gate_numbers(gi(c), gi(p))[0]:.3g}, "
                             f"filtered p99 {p99:.3g} diverged {div:.4f}, boost ties {ties}")
                if not ok and not ties:
                    raise AssertionError(f"{name}: frame {f}'s filtered GI fails the display "
                                         f"gate (p99 {p99:.3g}, diverged {div:.4f}, rmse "
                                         f"{rmse_:.3g}) with no boost tie")
            log(f"[e2e] {name}: " + "; ".join(lines) + f"; the card's denoiser on its own "
                f"inputs equals the plain torch code's to {worst:.3g}")
            display_gate(name, imgs, rays, gated=ties == 0)
            per = hybrid_launches(HYBRID_DEPTH, False)
            want = {"trace": per["trace"] * 4, "shade": per["shade"] * 4}
            if launches != want:
                raise AssertionError(f"{name}: launches {launches} != {want}")


def with_alpha(scene):
    """``scene`` (a city) with material 3 (the window grid) BLEND at alpha
    0.5 and material 2 (plain grey) MASK at alpha 0.3 under cutoff 0.5,
    which always punches through."""
    mode = scene.mat_alpha_mode.clone()
    base = scene.mat_base_color.clone()
    cutoff = scene.mat_alpha_cutoff.clone()
    mode[3], base[3, 3] = 2, 0.5
    mode[2], base[2, 3], cutoff[2] = 1, 0.3, 0.5
    return scene._replace(mat_alpha_mode=mode, mat_base_color=base, mat_alpha_cutoff=cutoff)


def alpha_launches() -> dict:
    """Kernel A's launches a frame with the alpha tracer: every trace is
    1 + ``DEFAULT_ROUNDS`` launches (all rounds run, none is skipped), and
    a frame of path mode at depth 4 traces 5 times (the start, 3 fused
    pools, the last shadow rays), a hybrid frame at depth 3 too (the
    G-buffer, the visibility pool, GI's start, fused pool and shadow rays);
    kernel B is not launched (the general loop)."""
    from vkrt_tpu_torch.ops.alpha import DEFAULT_ROUNDS

    return {"trace": 5 * (1 + DEFAULT_ROUNDS), "shade": 0, "shade_albedo": 0}


def phase_alpha(dev, results, city, card):
    """Phase 5f: alpha-tested transparency on the card: the small city with
    a BLEND and a MASK material, path mode at depth 4 and hybrid with
    shadows, AO and GI, 160x120, 4 frames, card against CPU (display gate,
    rays within 0.1%, kernel A's launches by the round design, kernel B's
    0); then the full city with the same switch in hybrid mode at
    1280x720, 2 warm-up frames and one timed batch of 8."""
    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.ops.alpha import AlphaTracer
    from vkrt_tpu_torch.scene import make_city
    from vkrt_tpu_torch.utils.camera import orbit_camera

    t_phase = time.perf_counter()
    per = alpha_launches()
    hybrid = RenderSettings(samples=1, depth=HYBRID_DEPTH, rt_mode=0, use_gi=True,
                            alpha_test=True, corr_sampler=True)
    for label, settings in (
            (f"path depth {CITY_DEPTH}", path_settings(CITY_DEPTH).replace(alpha_test=True)),
            (f"hybrid shadows + AO + GI depth {HYBRID_DEPTH}", hybrid)):
        imgs, rays, launches, _ = render_both(
            dev, lambda where: with_alpha(make_city(grid=SMALL_CITY_GRID, device=where)),
            orbit_camera(**SMALL_CITY_CAM), settings)
        name = f"alpha {label}, make_city(grid={SMALL_CITY_GRID}) 160x120 4 frames"
        display_gate(name, imgs, rays)
        want = {"trace": per["trace"] * 4, "shade": 0}
        log(f"[alpha] {name}: card launches {launches}")
        if launches != want:
            raise AssertionError(f"{name}: launches {launches} != {want}")

    eng = Engine(with_alpha(city), W, H, hybrid, orbit_camera(**CITY_CAM), CLEAR)
    if not isinstance(eng.tracer, AlphaTracer):
        raise AssertionError("the alpha city did not get the alpha tracer")
    # the 5 alpha-tested traces a frame of alpha_launches
    best, launches, _ = drive_engine(eng, {**per, **rng_launches(hybrid, alpha_traces=5)},
                                     "alpha", batches_n=1)
    results["trace"]["alpha_launches"] = launches["trace"]
    profile = profile_frames(eng, "alpha")
    log(f"[alpha] hybrid alpha city {W}x{H} ({card}): {best[0]:.4f} ms/frame, "
        f"{best[1]:.4f} Mrays/s, {best[2]:.0f} rays/frame, launches a frame {per}")
    results["alpha"] = {"ms_per_frame": best[0], "mrays_per_s": best[1],
                        "rays_per_frame": best[2], "launches_per_frame": per,
                        "profile": profile}
    log(f"[alpha] phase wall time {time.perf_counter() - t_phase:.1f} s")


def cubes_doc(alpha: bool = False):
    """Two unit cubes at x = -3 and x = 3 (tests/test_instances.py's
    document), one grey material (BLEND at alpha 0.5 with ``alpha``) and a
    point light above them."""
    from vkrt_tpu_torch.utils import gltf as gltf_mod

    p = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                  [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32)
    quads = [(4, 5, 6, 7), (1, 0, 3, 2), (5, 1, 2, 6), (0, 4, 7, 3), (7, 6, 2, 3), (0, 1, 5, 4)]
    idx = np.asarray([i for a, b, c, d in quads for i in (a, b, c, a, c, d)], np.uint32)
    prims = []
    for x in (-3.0, 3.0):
        prims.append(gltf_mod.GltfPrimitiveInstance(
            positions=p, indices=idx, normals=None, tangents=None, uvs=None, material=0,
            world_matrix=translation(x, 0.0, 0.0)))
    mat = gltf_mod.GltfMaterial(np.array([0.8, 0.8, 0.8, 0.5 if alpha else 1.0], np.float32),
                                metallic_factor=0.0, alpha_mode=2 if alpha else 0)
    light = gltf_mod.GltfLight(np.array([0, 8, 0.0], np.float32), np.ones(3, np.float32),
                               60.0, 0)
    return gltf_mod.GltfDocument(primitives=prims, materials=[mat], lights=[light], images=[])


def translation(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def phase_instances_end_to_end(dev, results):
    """Phase 5g: the instanced cubes on the card against the CPU, 4 frames,
    then ``set_node_transform`` of the right cube and 4 more frames: the
    display gate before and after the repose, in path mode through kernels
    A and B and in hybrid mode with GI; then the alpha tracer (the cubes
    BLEND at 0.5, path mode, the general loop) reposed the same way."""
    import torch

    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.ops.alpha import DEFAULT_ROUNDS, AlphaTracer
    from vkrt_tpu_torch.ops.cuda.trace import CudaTracer
    from vkrt_tpu_torch.scene_instances import build_instanced
    from vkrt_tpu_torch.utils.camera import Camera

    cam = Camera(eye=(0.0, 0.0, 12.0), center=(0.0, 0.0, 0.0))
    move = translation(3.0, 1.5, -4.0)
    hybrid = RenderSettings(samples=1, depth=HYBRID_DEPTH, rt_mode=0, use_gi=True,
                            corr_sampler=True)
    # the general loop's DEPTH + 1 traces a frame, each 1 + DEFAULT_ROUNDS launches
    per_alpha = {"trace": (DEPTH + 1) * (1 + DEFAULT_ROUNDS), "shade": 0}
    for label, settings, alpha, per in (
            (f"path depth {DEPTH}", path_settings(DEPTH), False, path_launches(DEPTH, False)),
            (f"hybrid GI depth {HYBRID_DEPTH}", hybrid, False,
             hybrid_launches(HYBRID_DEPTH, False)),
            (f"alpha path depth {DEPTH}", path_settings(DEPTH).replace(alpha_test=True), True,
             per_alpha)):
        imgs = {"before": {}, "after": {}}
        rays = {"before": {}, "after": {}}
        launches = None
        for leg, where in (("cuda", dev), ("cpu", torch.device("cpu"))):
            eng = Engine(build_instanced(cubes_doc(alpha), device=where), 160, 120, settings,
                         cam, CLEAR)
            kdev.reset_counts()
            for stage in ("before", "after"):
                if stage == "after":
                    eng.set_node_transform(1, move)
                    if eng.frame != -1:
                        raise AssertionError("set_node_transform did not reset the frame")
                r0 = eng.total_rays
                for _ in range(4):
                    out = eng.render_frame()
                imgs[stage][leg] = out.cpu().numpy().astype(np.float64)
                rays[stage][leg] = eng.total_rays - r0
            inner = eng.tracer.inner if alpha else eng.tracer
            if alpha and not isinstance(eng.tracer, AlphaTracer):
                raise AssertionError("the BLEND cubes did not get the alpha tracer")
            if leg == "cuda":
                launches = launches_now(("trace", "shade"))
                if not isinstance(inner, CudaTracer):
                    raise AssertionError(f"the card's tracer is {type(inner).__name__}")
        for stage in ("before", "after"):
            display_gate(f"cubes {label} 160x120, 4 frames {stage} the repose", imgs[stage],
                         rays[stage])
        moved = np.abs(imgs["after"]["cuda"] - imgs["before"]["cuda"]).max()
        if moved < 1e-3:
            raise AssertionError(f"cubes {label}: the repose changed nothing ({moved})")
        want = {k: per[k] * 8 for k in ("trace", "shade")}
        log(f"[instances] cubes {label}: card launches over 8 frames {launches}")
        if launches != want:
            raise AssertionError(f"cubes {label}: launches {launches} != {want}")
        if not alpha:
            key = "cubes_launches" if settings.rt_mode == 1 else "cubes_hybrid_launches"
            results["trace"][key] = launches["trace"]
            results["shade"][key] = launches["shade"]


def phase_app(dev):
    """Phase 5h: the app on the card, in this process (``app.main``): the
    sponzoid by ``--scene`` with ``--orbit --stats --save-state`` (a PNG a
    frame); ``--save-state`` then ``--load-state`` resuming the frame
    counter; ``--trace-dir``; every ``--backend`` (equal images); and
    ``--interactive`` on a script."""
    import contextlib
    import io
    import json as _json
    import os
    from pathlib import Path

    from vkrt_tpu_torch import app
    from vkrt_tpu_torch.benchmarks.suite import ASSET_DIR, SPONZOID_TESS
    from vkrt_tpu_torch.utils.png import decode_png
    from vkrt_tpu_torch.utils.sponzoid import sponzoid_path

    work = Path("vkrt_tpu_torch/build/app_smoke")
    work.mkdir(parents=True, exist_ok=True)
    gltf = sponzoid_path(str(ASSET_DIR), tess=SPONZOID_TESS, texture_format="png")

    def run(args, stdin=""):
        out, err = io.StringIO(), io.StringIO()
        old_stdin = sys.stdin
        sys.stdin = io.StringIO(stdin)
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = app.main(["--device", dev.type] + [str(a) for a in args])
        finally:
            sys.stdin = old_stdin
        if rc != 0:
            raise AssertionError(f"app {args} exited {rc}: {out.getvalue()}{err.getvalue()}")
        return out.getvalue(), err.getvalue()

    spz = ["--scene", gltf, "--mode", "path", "--width", APP_W, "--height", APP_H,
           "--lookat", 0, 5, 0]
    t0 = time.perf_counter()
    out, err = run(spz + ["--frames", 3, "--orbit", "--orbit-radius", 20, "--orbit-height", 6,
                          "--stats", "--save-state", work / "orbit.npz",
                          "--out", work / "fly.png"])
    stats = _json.loads(err.strip().splitlines()[-1])
    for f in range(3):
        img = decode_png((work / f"fly_{f:04d}.png").read_bytes())
        if img.shape[:2] != (APP_H, APP_W) or img[..., :3].std() < 5.0:
            raise AssertionError(f"orbit frame {f}: {img.shape}, std {img[..., :3].std()}")
    if stats["frames"] != 3 or not (work / "orbit.npz").exists():
        raise AssertionError(f"--stats/--save-state: {stats}")
    log(f"[app] --scene sponzoid --orbit --stats --save-state: 3 PNGs, stats {stats}")
    still = spz + ["--eye", 0, 6, 26, "--frames", 2]
    run(still + ["--save-state", work / "still.npz", "--out", work / "still.png"])
    out, _ = run(still + ["--load-state", work / "still.npz", "--out", work / "still2.png"])
    if "ok, frame 1" not in out or "frame counter 3" not in out:
        raise AssertionError(f"--load-state did not resume the frame counter:\n{out}")
    log("[app] --save-state after 2 frames, --load-state + 2 frames: resumed at frame 1, "
        "ended at frame counter 3")
    trace_dir = work / "trace"
    run(["--procedural", "cornell", "--mode", "path", "--width", 64, "--height", 48,
         "--frames", 2, "--trace-dir", trace_dir, "--out", work / "traced.png"])
    traces = sorted(trace_dir.glob("*.json"))
    # the engine's pass label, and on the card kernel A's launches
    want = ("pathtrace",) + (("trace_kernel",) if dev.type == "cuda" else ())
    if not traces or not all(w in traces[-1].read_text() for w in want):
        raise AssertionError(f"--trace-dir wrote no trace holding {want}: {traces}")
    log(f"[app] --trace-dir: {traces[-1].name}, {os.path.getsize(traces[-1])} bytes")
    imgs = {}
    for backend in ("auto", "bruteforce", "bvh", "pallas"):
        png = work / f"backend_{backend}.png"
        run(["--procedural", "cornell", "--mode", "path", "--width", 64, "--height", 48,
             "--frames", 2, "--backend", backend, "--out", png])
        imgs[backend] = decode_png(png.read_bytes())
    for backend, img in imgs.items():
        if not np.array_equal(img, imgs["auto"]):
            raise AssertionError(f"--backend {backend}'s image differs from auto's")
    log("[app] --backend auto, bruteforce, bvh, pallas: equal images")
    out, _ = run(["--procedural", "cornell", "--width", 64, "--height", 48, "--interactive",
                  "--out", work / "interactive.png"],
                 stdin="render 2\nset depth 4\nset view_accumulated 1\nclear 0 0 0\n"
                       "eye 0 1 14\nrender 1\nstats\nsave " + str(work / "saved.png") +
                       "\nquit\n")
    for want in ("rendered 2 frame(s)", "depth = 4 (buffers reallocated)",
                 "view_accumulated = True (buffers kept)", "wrote " + str(work / "saved.png")):
        if want not in out:
            raise AssertionError(f"--interactive: {want!r} missing from\n{out}")
    log(f"[app] --interactive script: ok; app phase {time.perf_counter() - t0:.1f} s")


def phase_suite(dev, results):
    """Phase 7: the port's suite, rows 1, 2 and 7 at 1280x720 and 8 frames,
    one JSON line each (rows 3-5 are phases 4b-4d, row 8 is 4e)."""
    from vkrt_tpu_torch.benchmarks import suite

    results["suite"] = suite.main(["--configs", "1,2,7", "--frames", "8", "--width", str(W),
                                   "--height", str(H), "--device", dev.type])


BENCH_FRAMES = 1 + 3 * 8  # bench.py's frame 0, then 3 batches of 8


def phase_bench(dev, results, card):
    """Phase 8: ``vkrt_tpu_torch.bench.main()`` at its real workload, the
    accuracy anchor it runs, and ``entry()``'s frame step. ``device.counts``
    is set to 0 just before the bench's frames (``bench.measure``) and the
    anchor's renders (``accuracy.run``) and read just after each."""
    import contextlib
    import io

    import torch

    from vkrt_tpu_torch import bench
    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.benchmarks import accuracy
    from vkrt_tpu_torch.entry import entry

    t_phase = time.perf_counter()
    seen = {}

    def counted(name, fn):
        def call(*args, **kw):
            kdev.reset_counts()
            out = fn(*args, **kw)
            seen[name] = (out, launches_now(("trace", "shade", "shade_albedo")))
            return out
        return call

    measure, run = bench.measure, accuracy.run
    bench.measure, accuracy.run = counted("bench", measure), counted("accuracy", run)
    stdout = io.StringIO()
    try:
        with contextlib.redirect_stdout(stdout):
            rc = bench.main([])
    finally:
        bench.measure, accuracy.run = measure, run
    printed = stdout.getvalue().strip().splitlines()
    for line in printed:
        log(f"[bench] stdout: {line}")
    if rc != 0:
        raise AssertionError(f"vkrt_tpu_torch.bench exited {rc} (4: broken image, 5: the "
                             "accuracy anchor out of budget)")
    line = json.loads(printed[-1])
    res, launches = seen["bench"]
    rec, anchor_launches = seen["accuracy"]
    per_frame = path_launches(DEPTH, False)
    for name, got, frames in (("bench", launches, BENCH_FRAMES),
                              ("accuracy", anchor_launches, accuracy.FRAMES)):
        want = {k: v * frames for k, v in per_frame.items()}
        if got != want:
            raise AssertionError(f"{name}: launch counts {got} != {want}")
    batch_ms = [b["ms"] / 8 for b in res["batches"]]
    host_ms = ", ".join(f"{b['host_ms'] / 8:.4f}" for b in res["batches"])
    log(f"[bench] {line['metric']}: best batch {line['ms_per_frame']:.4f} ms/frame, "
        f"{line['value']:.4f} Mrays/s, {res['rays_per_frame']:.0f} rays/frame; batches "
        f"{', '.join(f'{ms:.4f}' for ms in batch_ms)} ms/frame (spread {min(batch_ms):.4f}-"
        f"{max(batch_ms):.4f}), host clock {host_ms}; launches {launches} "
        f"over {BENCH_FRAMES} frames (6 A + 3 B a frame); {line['device']}, "
        f"{line['power_limit']} ({card})")
    log(f"[bench] accuracy anchor {rec['workload']}: RMSE {rec['rmse_display']:.6g}, p99 "
        f"{rec['p99_abs_err']:.6g}, diverged {rec['diverged_frac']:.6g} (budgets 1e-3, 1e-3, "
        f"0.01), ok {rec['ok']}; launches {anchor_launches} over {accuracy.FRAMES} frames")

    fn, args = entry()
    kdev.reset_counts()
    accum, rays = fn(*args)
    got = launches_now(("trace", "shade", "shade_albedo"))
    a = accum.cpu().numpy()
    if not (np.isfinite(a).all() and float(a.max()) > 0.0 and float(rays) > 0.0):
        raise AssertionError("entry()'s frame step: non-finite, black or no rays")
    if got != per_frame:
        raise AssertionError(f"entry(): launch counts {got} != {per_frame}")
    log(f"[bench] entry(): {tuple(a.shape)} accum on {accum.device}, finite, max "
        f"{float(a.max()):.4f}, {float(rays):.0f} rays, launches {got}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    for k in ("trace", "shade"):
        results[k]["bench_launches"] = launches[k]
        results[k]["accuracy_launches"] = anchor_launches[k]
    results["bench"] = {"line": line, "accuracy": rec}
    torch.cuda.synchronize()


def phase_mesh_main_path(dev, results, card):
    """Phase 4f: suite row 6 (``cornell_sharded_mesh``) at 1280x720 through
    ``benchmarks.suite.run_sharded_bench``: the glTF Cornell box, spp 1 a
    rank, depth 3, correlated sampler on, over ``factor_mesh(cards)`` (one
    card: mesh (1,1) over NCCL, in this process); one warm-up frame, then
    3 batches of 8 frames from a fresh accumulator. Each rank's counters
    grow by 6 trace and 3 shade launches a frame; on mesh (1,1) the last
    batch's image is bit-equal to ``Engine``'s 8 frames (the salt is 0).
    Then the engine's and the mesh's batches of the same frames in turns
    (engine, mesh, mesh, engine) on one clock."""
    import torch

    from vkrt_tpu_torch.benchmarks import suite
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.parallel.mesh import factor_mesh, launch
    from vkrt_tpu_torch.scene import load_cornell
    from vkrt_tpu_torch.utils.camera import Camera

    t_phase = time.perf_counter()
    out = suite.run_sharded_bench("cornell_sharded_mesh", W, H, 8, DEPTH, dev, batches=3)
    rec = out["rec"]
    for ms, mrays, rpf in out["batches"]:
        log(f"[mesh] batch: {ms:.4f} ms/frame, {mrays:.4f} Mrays/s, {rpf:.0f} rays/frame")
    best = min(out["batches"])
    frames = 1 + 3 * 8
    want = {k: v * frames for k, v in path_launches(DEPTH, False).items()}
    by_rank = [by_kernel(c, tuple(want)) for c in out["launches"]]
    for rank, launches in enumerate(by_rank):
        if launches != want:
            raise AssertionError(f"rank {rank}: launch counts {launches} != {want}")
    eng = Engine(load_cornell(device=dev), W, H, path_settings(DEPTH), Camera(), CLEAR)
    for _ in range(8):
        eng.render_frame()
    ref = eng.accum[eng._inv_perm].cpu()
    if rec["mesh"] == "tile=1,spp=1":
        if not torch.equal(out["accum"].view(torch.int32), ref.view(torch.int32)):
            diff = (out["accum"] - ref).abs().max().item()
            raise AssertionError(f"mesh (1,1) differs from the engine (max abs {diff:.3g})")
        verdict = "bit-equal to the engine's 8 frames"
    else:
        verdict = "not compared bit for bit (more than one rank)"
    log(f"[mesh] suite row 6 at {W}x{H} ({card}), mesh {rec['mesh']} over {rec['backend']}: "
        f"best batch {best[0]:.4f} ms/frame, {best[1]:.4f} Mrays/s, {best[2]:.0f} rays/frame; "
        f"launches {by_rank} over {frames} frames; {verdict}")

    # the same frames in turns with the engine (engine, mesh, mesh, engine),
    # each the best of 3 batches of 8 from frame 0 on the host clock between
    # device synchronisations: phase 4's best batch is another moment of a
    # host whose cores are shared
    def engine_turn():
        times = []
        for _ in range(3):
            eng.reset_frame()
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(8):
                eng.render_frame()
            sync(dev)
            times.append((time.perf_counter() - t0) / 8 * 1e3)
        return min(times)

    turns = {"engine": [], "mesh": []}
    for who in ("engine", "mesh", "mesh", "engine"):
        turns[who].append(engine_turn() if who == "engine" else min(
            b[0] for b in launch(suite.sharded_bench_rank, *factor_mesh(torch.cuda.device_count()),
                                 dev, "turn", W, H, 8, DEPTH, 3)["batches"]))
    log(f"[mesh] in turns with the engine (the same frames, best of 3 batches of 8 each): "
        f"engine {turns['engine'][0]:.4f} / {turns['engine'][1]:.4f}, mesh "
        f"{turns['mesh'][0]:.4f} / {turns['mesh'][1]:.4f} ms/frame; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    for name in ("trace", "shade", "shade_albedo"):
        results[name]["mesh_launches"] = [c[name] for c in by_rank]
    results["mesh"] = {"ms_per_frame": best[0], "mrays_per_s": best[1],
                       "rays_per_frame": best[2], "mesh": rec["mesh"],
                       "backend": rec["backend"], "turns_ms": turns}


def phase_mesh_hybrid(dev, results, city, card):
    """Phase 5i: suite row 5's stack under a (4,1) mesh: 4 ranks sharing the
    card (gloo), each with its own ``make_city(grid=96)``, 3 frames of the
    row-5 fly-through at 1280x720 (hybrid, shadows, AO, GI, depth 3, the
    temporal denoiser in its band form: ring halos and the gathered
    history), correlated sampler off; every frame's composite gathered and
    held against the single-process ``Engine`` on the same poses by the
    display gate, with the max abs difference printed. Each rank's
    counters grow by 6 trace and 2 albedo shade launches a frame."""
    from vkrt_tpu_torch.benchmarks import CITY_GRID
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.models.post import composite
    from vkrt_tpu_torch.parallel.mesh import launch
    from vkrt_tpu_torch.parallel.render import run_jobs

    t_phase = time.perf_counter()
    frames = 3
    poses = [flythrough_pose(k) for k in range(frames)]
    settings = denoised_settings().replace(corr_sampler=False)
    job = dict(kind="hybrid", scene=("city", CITY_GRID), backend="auto", cameras=poses,
               width=W, height=H, depth=HYBRID_DEPTH, clear_color=CLEAR, use_shadows=True,
               use_ao=True, use_gi=True, use_denoiser=True, corr=False,
               gather_each_frame=True)
    (res,) = launch(run_jobs, 4, 1, dev, [job])
    wall = time.perf_counter() - t_phase
    per_frame = hybrid_launches(HYBRID_DEPTH, True)
    want = {k: v * frames for k, v in per_frame.items()}
    by_rank = [by_kernel(c, tuple(want)) for c in res["launches"]]
    for rank, launches in enumerate(by_rank):
        if launches != want:
            raise AssertionError(f"rank {rank}: launch counts {launches} != {want}")
    eng = Engine(city, W, H, settings, poses[0], CLEAR)
    worst = []
    for k, img in enumerate(res["images"]):
        eng.camera = poses[k]
        ref = eng.render_frame().cpu().numpy().astype(np.float64)
        got = composite(img["color"][:, :3], img["accum"], rt_mode=0, view_accumulated=False,
                        use_gi=True).numpy().astype(np.float64)
        if not np.isfinite(got).all() or float(got.max()) <= 0.0:
            raise AssertionError(f"mesh hybrid frame {k}: not finite and non-black")
        p99, diverged, rmse, ok = gate_numbers(got, ref)
        worst.append(float(np.abs(got - ref).max()))
        log(f"[mesh-hybrid] frame {k}: (4,1) ranks vs the engine: p99 {p99:.3g}, diverged "
            f"{diverged:.4f}, rmse {rmse:.3g}, max abs diff {worst[-1]:.3g}")
        if not ok:
            raise AssertionError(f"mesh hybrid frame {k}: display gate failed")
    if abs(res["rays"] - eng.total_rays) > 1e-3 * eng.total_rays:
        raise AssertionError(f"rays {res['rays']} against the engine's {eng.total_rays}")
    log(f"[mesh-hybrid] row 5's stack at {W}x{H} over a (4,1) mesh over {res['backend']}, "
        f"4 ranks sharing one card ({card}): {frames} frames in {res['seconds']:.3f} s on "
        f"rank 0 ({res['seconds'] / frames * 1e3:.1f} ms/frame, each frame's image gathered; "
        f"a parity run, not a speed number for a mesh); launches per rank "
        f"{by_rank}; rays {res['rays']:.0f} (engine {eng.total_rays:.0f}); phase "
        f"{time.perf_counter() - t_phase:.1f} s, {wall:.1f} s of it the ranks' spawn, "
        f"scenes and frames")
    for name in ("trace", "shade", "shade_albedo"):
        results[name]["mesh_hybrid_launches"] = [c[name] for c in by_rank]
    results["mesh_hybrid"] = {"seconds": res["seconds"], "max_abs_diff": worst,
                              "backend": res["backend"]}


def phase_mesh_app(dev):
    """Phase 5j: ``python -m vkrt_tpu_torch.app --mesh 2,2 --spp 2`` on the
    Cornell box at 1280x720, 2 frames (4 ranks sharing the card, gloo):
    finite and non-black, and in mean agreement with the unsharded app's
    spp-2 render (|mean difference| of the displayed images < 0.02);
    then ``dryrun_multichip(4)`` on CPU ranks."""
    from pathlib import Path

    from vkrt_tpu_torch import app
    from vkrt_tpu_torch.parallel.dryrun import dryrun_multichip
    from vkrt_tpu_torch.utils.png import decode_png

    t_phase = time.perf_counter()
    work = Path("vkrt_tpu_torch/build/mesh_smoke")
    work.mkdir(parents=True, exist_ok=True)
    args = ["--device", dev.type, "--procedural", "cornell", "--mode", "path", "--spp", "2",
            "--frames", "2", "--width", str(W), "--height", str(H)]
    res = subprocess.run([sys.executable, "-m", "vkrt_tpu_torch.app", *args, "--mesh", "2,2",
                          "--out", str(work / "mesh.png")],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"app --mesh 2,2 exited {res.returncode}:\n{res.stdout}\n"
                             f"{res.stderr[-4000:]}")
    log("[mesh-app] " + " | ".join(res.stdout.strip().splitlines()))
    if app.main(args + ["--out", str(work / "ref.png")]) != 0:
        raise AssertionError("the unsharded app failed")
    img, ref = (decode_png((work / f).read_bytes())[..., :3].astype(np.float64) / 255.0
                for f in ("mesh.png", "ref.png"))
    if img.shape != (H, W, 3) or img.std() < 5.0 / 255.0 or img.max() <= 0.0:
        raise AssertionError(f"app --mesh 2,2: {img.shape}, std {img.std()}")
    delta = abs(img.mean() - ref.mean())
    log(f"[mesh-app] --mesh 2,2 --spp 2 against the unsharded spp-2 app: displayed means "
        f"{img.mean():.5f} / {ref.mean():.5f} (|difference| {delta:.5f}, limit 0.02)")
    if delta >= 0.02:
        raise AssertionError(f"the mesh image's mean is off by {delta:.5f}")
    out = dryrun_multichip(4)
    log(f"[mesh-app] dryrun_multichip(4): {out}; phase {time.perf_counter() - t_phase:.1f} s")


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def subsample(n: int, m: int):
    """``m`` evenly strided lane ids of ``n``."""
    import torch

    return torch.arange(0, n, max(n // m, 1))[:m]


def pick(hits, idx):
    return type(hits)(*(x[idx.to(x.device)] for x in hits))


def check_equal(name, a, b) -> None:
    """Bit-equal tensors (tuples of tensors)."""
    import torch

    for i, (x, y) in enumerate(zip(a, b)):
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: output {i} differs on "
                                 f"{int((x != y).sum())} of {x.numel()} elements")


def phase_probes(dev, results, shadow_pool, city):
    """Phase 6: the trace-probe entry points at full size, their launch
    counts, then every probe kernel against its plain version."""
    t_phase = time.perf_counter()
    run = drive_probes(dev, city)
    log(f"[probes] launches on the probe path: {run['launches']}; the entry points took "
        f"{time.perf_counter() - t_phase:.1f} s")
    if not all(run["launches"].values()):
        raise AssertionError(f"a probe kernel was never launched: {run['launches']}")
    check_probes(dev, run, results, shadow_pool)
    log(f"[probes] phase wall time {time.perf_counter() - t_phase:.1f} s")


def drive_probes(dev, city) -> dict:
    """Build Cornell (``city``: the city's BuiltScene, built already), then
    run every probe entry point as a user runs it, with ``device.counts``
    set to 0 just before and read just after."""
    import torch

    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.benchmarks import ablate_kernel, build, micro_trace, variants, vpupeak

    built = {"cornell": build("cornell", dev), "city": city}
    log(f"[probes] city: {city.scene.num_tris} triangles (padded), host build "
        f"{city.seconds['scene']:.4f} s scene + {city.seconds['bvh']:.4f} s BVH + "
        f"{city.seconds['tables']:.4f} s tables; {city.tables.bvh.threaded.shape[0]} BVH nodes, "
        f"{city.tables.bvh.nodes.shape[0]} child-box records, depth {city.tables.max_depth}")
    kdev.reset_counts()
    run = {
        "built": built,
        "mt": {k: micro_trace.run(k, W, H, iters=8, device=dev, built=b)
               for k, b in built.items()},
        "ab": {k: ablate_kernel.run(k, W, H, iters=4, device=dev, built=b)
               for k, b in built.items()},
        "va": {k: variants.run(k, PROBE_VARIANTS, W, H, iters=4, incoherent=True,
                               device=dev, built=b) for k, b in built.items()},
        "fp": vpupeak.run(65536, 64, 20, dev),
    }
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run["launches"] = launches_now(("floor", "fma_peak", "trace_ablate", "trace_variant",
                                     "trace"))
    return run


def check_probes(dev, run, results, shadow_pool) -> None:
    """Every probe kernel against its plain version; fills ``results``."""
    import torch

    from vkrt_tpu_torch.benchmarks import ablate_kernel, micro_trace
    from vkrt_tpu_torch.ops.cuda.probes import (
        FLOOR_THREADS, fma_flops, fma_peak, fma_peak_plain, floor_kernel, floor_plain,
        miss_record,
    )
    from vkrt_tpu_torch.benchmarks.ablate_kernel import visit_stats
    from vkrt_tpu_torch.ops.cuda.trace_variants import trace_variant
    from vkrt_tpu_torch.ops.trace import (
        BvhCounts, RayHits, trace_rays_bruteforce, trace_rays_bvh_ordered,
        trace_rays_bvh_wide,
    )

    built, mt, ab, va, fp = (run[k] for k in ("built", "mt", "ab", "va", "fp"))
    launches = run["launches"]
    laps, t_lap = {}, [time.perf_counter()]

    def lap(what):  # the host seconds since the last lap, under ``what``
        sync(dev)
        laps[what] = time.perf_counter() - t_lap[0]
        t_lap[0] = time.perf_counter()

    # C: the miss record at every block size
    n = mt["cornell"]["rays"]
    o, d = mt["cornell"]["primary"]["o"], mt["cornell"]["primary"]["d"]
    lim = torch.full((n,), 1e4, device=dev)
    for threads in FLOOR_THREADS:
        check_equal(f"floor {threads} threads", floor_kernel(o, d, lim, threads),
                    floor_plain(o, d, lim))
    floor = min(mt["cornell"]["floor"], key=lambda r: r["device_us"])
    buf = torch.empty((4, n), device=dev)
    c_bound = bound(n * 44, 0)
    # no PyTorch call computes the floor's function (28 B a ray read, t =
    # |t_lim|, tri = -1, u = v = 0 written): zero_ of the record writes 16 of
    # its 44 B a ray and is only a write-only yardstick
    results["floor"] = {
        "launches": launches["floor"], "max_abs_err": 0.0,
        "ms": floor["device_us"] * 1e-3,
        "plain_ms": cuda_ms(lambda: floor_plain(o, d, lim)),
        "bound_ms": c_bound[0], "bound_by": c_bound[1], "library_ms": None,
    }
    log(f"[probes] floor: best {floor['threads']} threads {floor['device_us']:.3f} us/launch, "
        f"plain {results['floor']['plain_ms'] * 1e3:.3f} us, bound {c_bound[0] * 1e3:.3f} us; "
        f"write-only yardstick (not the floor's function): zero_ of the (4, N) record "
        f"{cuda_ms(lambda: buf.zero_()) * 1e3:.3f} us")

    # F: bit-equal to the plain recurrence, at a small K and at the timed
    # full K, on seeded inputs that differ element by element. One fused
    # multiply-add rounds as the plain step does: a * c + b is exact in
    # float64 for these magnitudes, then rounded once to float32.
    x = fp["x"]
    if x.unique().numel() < x.numel() // 2:
        raise AssertionError("fma_peak's inputs are not distinct enough to show indexing faults")
    check_equal("fma_peak K=512", (fma_peak(x, 512),), (fma_peak_plain(x, 512),))
    t0 = time.perf_counter()
    big_plain = fma_peak_plain(x, fp["k"])
    sync(dev)
    f_plain_ms = (time.perf_counter() - t0) * 1e3
    check_equal(f"fma_peak K={fp['k']}", (fp["out"],), (big_plain,))
    moved = float(((big_plain - fma_peak_plain(x, 64)).abs() / big_plain.abs()).min())
    log(f"[probes] fma_peak: bit-equal to its plain recurrence at K=512 and K={fp['k']} "
        f"(the K-64 FMAs moved every output by >= {moved:.3g} relative); "
        f"{fp['tflops']:.3f} TFLOP/s, plain {f_plain_ms:.1f} ms")
    f_bound = bound(2 * nbytes(x), fma_flops(x, fp["k"]) // 2)  # one instruction an FMA
    results["fma_peak"] = {"launches": launches["fma_peak"], "max_abs_err": 0.0,
                           "ms": fp["ms"], "plain_ms": f_plain_ms, "bound_ms": f_bound[0],
                           "bound_by": f_bound[1], "library_ms": None, "tflops": fp["tflops"]}

    lap("C and F")
    # A: against brute force on 65,536 subsampled rays (any: the verdict
    # of a closest hit nearer than the any bound); then, per ray set, its
    # time beside the stackless walk's (E threaded, same rays), the visits
    # and SIMT efficiency of both walks and both bounds
    errs = []
    a_sets = {}
    for name, b in built.items():
        sc, bvh = b.scene, b.tables.bvh
        for kind in ("primary", "incoherent"):
            r = mt[name][kind]
            idx = subsample(r["o"].shape[0], 65536).to(dev)
            so, sd = r["o"][idx], r["d"][idx]
            lim = r["closest"]["t_lim"][idx]
            p = trace_rays_bruteforce(sc.tri_v0, sc.tri_e1, sc.tri_e2, so, sd, lim)
            errs.append(compare_trace(f"{name} {kind} closest (65,536 of {r['o'].shape[0]})",
                                      pick(r["closest"]["hits"], idx), p, lim, ties=False))
            near = (p.tri >= 0) & (p.t < micro_trace.ANY_BOUND)
            p_any = RayHits(p.t, torch.where(near, p.tri, -1), p.u, p.v)
            errs.append(compare_trace(f"{name} {kind} any", pick(r["any"]["hits"], idx),
                                      p_any, r["any"]["t_lim"][idx]))
            for mode in ("closest", "any"):
                a_sets[(name, kind, mode)] = ray_set_report(
                    f"{name} {mode} {kind}", b, r["o"], r["d"], r[mode], mode == "any")
    results["trace"]["max_abs_err"] = max(results["trace"]["max_abs_err"], *errs)
    results["trace"]["ray_sets"] = {" ".join(k): v for k, v in a_sets.items()}

    lap("A")
    # D: full and count bit-equal to kernel A, boxes/top the miss record,
    # count's columns equal to the plain front-to-back walk
    for name, b in built.items():
        for kind in ("primary", "incoherent"):
            r, a_hits = ab[name][kind], mt[name][kind]["closest"]["hits"]
            check_equal(f"{name} {kind} full vs kernel A", r["full"]["hits"], a_hits)
            check_equal(f"{name} {kind} count vs kernel A", r["count"]["hits"], a_hits)
            for mode in ("boxes", "top"):
                check_equal(f"{name} {kind} {mode}", r[mode]["hits"], miss_record(r[mode]["t_lim"]))
            full_set = name == "city" and kind == "primary"
            idx = torch.arange(r["o"].shape[0], device=dev) if full_set else \
                subsample(r["o"].shape[0], 4096).to(dev)
            t0 = time.perf_counter()
            walk, cnt = trace_rays_bvh_ordered(b.tables.bvh, r["o"][idx], r["d"][idx],
                                               r["full"]["t_lim"][idx], count=True)
            sync(dev)
            walk_ms = (time.perf_counter() - t0) * 1e3
            k_cnt = r["count"]["counts"]
            check_equal(f"{name} {kind} count columns vs trace_rays_bvh_ordered",
                        (k_cnt.nodes[idx], k_cnt.leaves[idx]), (cnt.nodes, cnt.leaves))
            check_equal(f"{name} {kind} trace_rays_bvh_ordered hits vs kernel A", walk,
                        pick(a_hits, idx))
            st = r["count"]["stats"]
            log(f"[probes] {name} {kind}: slab tests/ray mean {st['nodes']['mean']:.2f} "
                f"p50 {st['nodes']['p50']:.0f} p95 {st['nodes']['p95']:.0f} max "
                f"{st['nodes']['max']:.0f}; triangle tests/ray mean {st['leaves']['mean']:.2f}; "
                f"slab tests/1024-ray block mean {st['block_nodes']['mean']:.0f} max "
                f"{st['block_nodes']['max']:.0f}; SIMT efficiency {st['simt_efficiency']:.4f}; "
                + ", ".join(f"{m} {r[m]['ms']:.4f} ms" for m in ablate_kernel.MODES))
            # kernel A on these rays beside the traffic of every visit (64 B a
            # record, 48 B a triangle, 44 B of ray I/O) and its instructions
            # at kernel F's measured rate (2 FLOPs an FMA instruction)
            n_k = r["o"].shape[0]
            visits = (int(k_cnt.nodes.sum()), int(k_cnt.leaves.sum()))
            traffic = visits[0] * 32 + visits[1] * 48 + n_k * 44
            ops = visits[0] * SLAB_OPS + visits[1] * MT_OPS
            log(f"[probes] {name} {kind} kernel A closest "
                f"{mt[name][kind]['closest']['ms']:.4f} ms: per-visit traffic "
                f"{traffic / 1e9:.4f} GB = {traffic / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 "
                f"TB/s; {ops / 1e9:.4f} G FP32 instructions = "
                f"{ops / (fp['tflops'] / 2 * 1e12) * 1e3:.4f} ms at kernel F's "
                f"{fp['tflops'] / 2:.2f} T instructions/s")
            if full_set:
                a_set = a_sets[(name, kind, "closest")]
                d_b = trace_bound(walk_tables(b.tables.bvh), n_k, k_cnt, out_bytes_per_ray=24)
                results["trace"].update({"city_ms": a_set["ms"],
                                         "city_bound_ms": a_set["bound_ms"],
                                         "city_bound_by": a_set["bound_by"]})
                results["trace_ablate"] = {
                    "launches": launches["trace_ablate"], "max_abs_err": 0.0,
                    "ms": r["count"]["ms"], "plain_ms": walk_ms, "bound_ms": d_b[0],
                    "bound_by": d_b[1], "library_ms": None,
                    "modes_ms": {m: r[m]["ms"] for m in ablate_kernel.MODES}}

    lap("D")
    # E: threaded, binary, ordered and flat bit-equal to kernel A on every
    # ray of both sets (mt128 to brute force over its 128 triangles);
    # ordered's counts equal to the plain wide walk's; then every variant's
    # bound from this run's visits. The tiled rays are the primary rays in
    # another order, so kernel D's and the stackless walk's sums are theirs.
    e_err, e_sets, plain_s = [], {}, {"wide": 0.0, "flat": 0.0}
    for name, b in built.items():
        sc, tables = b.scene, b.tables
        # flat has no count instantiation: its tests are its plain walk's on a
        # 4,096-ray subsample of each set, scaled to the set. The walk's time is
        # its longest ray's steps, so both sets go through it in one call.
        sets = [va[name][kind] for kind in ("tiled", "incoherent")]
        sub = subsample(sets[0]["o"].shape[0], 4096).to(dev)
        t0 = time.perf_counter()
        f_both = flat_counts(b, *(torch.cat([r[x][sub] for r in sets]) for x in ("o", "d")),
                             torch.cat([r["threaded"]["t_lim"][sub] for r in sets]))
        sync(dev)
        plain_s["flat"] += time.perf_counter() - t0
        f_sub = dict(zip(("tiled", "incoherent"),
                         (BvhCounts(*(c[k:k + sub.shape[0]] for c in f_both))
                          for k in (0, sub.shape[0]))))
        for kind, a_kind in (("tiled", "primary"), ("incoherent", "incoherent")):
            r = va[name][kind]
            o, d, lim = r["o"], r["d"], r["threaded"]["t_lim"]
            n_k = o.shape[0]
            a_hits = b.tracer.trace(o, d, lim)
            e_sets[f"{name} {kind}"] = row = {
                "kernel_a_ms": cuda_ms(lambda: b.tracer.trace(o, d, lim), reps=8)}
            for v in PROBE_VARIANTS:
                p = a_hits
                if v.startswith("mt"):
                    k = int(v[2:])
                    p = trace_rays_bruteforce(sc.tri_v0[:k], sc.tri_e1[:k], sc.tri_e2[:k],
                                              o, d, lim)
                e_err.append(compare_trace(f"E {name} {kind} {v}", r[v]["hits"], p, lim,
                                           ties=False))
                check_equal(f"E {name} {kind} {v} bit for bit", r[v]["hits"], p)
            hits, cnt = trace_variant("ordered", tables, sc, o, d, lim, count=True)
            check_equal(f"E {name} {kind} ordered with counts", hits, a_hits)
            # the plain wide walk: on every tiled ray, on 4,096 of the incoherent
            idx = torch.arange(n_k, device=dev) if kind == "tiled" else sub
            t0 = time.perf_counter()
            walk, want = trace_rays_bvh_wide(tables.wide, o[idx], d[idx], lim[idx], count=True)
            sync(dev)
            row["ordered_plain_ms"] = (time.perf_counter() - t0) * 1e3
            check_equal(f"E {name} {kind} ordered's counts vs trace_rays_bvh_wide",
                        tuple(c[idx] for c in cnt), tuple(want))
            check_equal(f"E {name} {kind} trace_rays_bvh_wide hits vs kernel A", walk,
                        pick(a_hits, idx))
            plain_s["wide"] += row["ordered_plain_ms"] * 1e-3
            row["flat_bound_from"] = f"{sub.shape[0]} of {n_k} rays"
            f_cnt = BvhCounts(*(c.double() * (n_k / sub.shape[0]) for c in f_sub[kind]))
            d_cnt = ab[name][a_kind]["count"]["counts"]
            visits = {"ordered": cnt,
                      "binary": BvhCounts(d_cnt.nodes + 1, d_cnt.leaves),  # and the root's box
                      "flat": f_cnt,
                      "mt128": BvhCounts(torch.zeros(1), torch.tensor(128 * n_k))}
            a_set = a_sets[(name, a_kind, "closest")]
            for v in PROBE_VARIANTS:
                row[f"{v}_ms"] = r[v]["ms"]
                if v == "threaded":
                    row["threaded_bound_ms"], row["threaded_bound_by"] = (
                        a_set["threaded_bound_ms"], a_set["threaded_bound_by"])
                else:
                    row[f"{v}_bound_ms"], row[f"{v}_bound_by"] = trace_bound(
                        variant_tables(tables, v), n_k, visits[v])
            # a record is one step of the wide walk; its slab tests are the
            # children it holds, so an empty slot's test is no part of the bound
            st = visit_stats(BvhCounts(cnt.records, cnt.leaves))
            row.update({"ordered_slab_tests": float(cnt.nodes.double().mean()),
                        "ordered_records": st["nodes"]["mean"],
                        "ordered_triangle_tests": st["leaves"]["mean"],
                        "ordered_simt_efficiency": st["simt_efficiency"],
                        "flat_slab_tests": float(f_cnt.nodes.sum()) / n_k,
                        "flat_triangle_tests": float(f_cnt.leaves.sum()) / n_k})
            log(f"[probes] E {name} {kind} (kernel A {row['kernel_a_ms']:.4f} ms): "
                + ", ".join(f"{v} {row[f'{v}_ms']:.4f} ms (bound {row[f'{v}_bound_ms']:.4f} "
                            f"{row[f'{v}_bound_by']})" for v in PROBE_VARIANTS)
                + f"; ordered {row['ordered_slab_tests']:.2f} slab + "
                f"{row['ordered_triangle_tests']:.2f} triangle tests a ray in "
                f"{row['ordered_records']:.2f} records, SIMT efficiency "
                f"{row['ordered_simt_efficiency']:.4f}; flat {row['flat_slab_tests']:.2f} + "
                f"{row['flat_triangle_tests']:.2f} (counted on {row['flat_bound_from']})")
    lap("E")
    log("[probes] checks, host seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in laps.items())
        + f" (of E's: trace_rays_bvh_wide {plain_s['wide']:.1f}, flat's stackless walk "
        f"{plain_s['flat']:.1f})")
    # phase 2's first-hit-kills shadow pool through the two variants that
    # end such a lane at its first hit: the verdicts are kernel A's
    cb = built["cornell"]
    so, sd, sl = shadow_pool
    a_any = cb.tracer.trace(so, sd, sl).tri >= 0
    for v in ("ordered", "threaded"):
        check_equal(f"E {v} verdicts on the shadow pool",
                    (trace_variant(v, cb.tables, cb.scene, so, sd, sl).tri >= 0,), (a_any,))
    log(f"[probes] E shadow pool ({sl.shape[0]} first-hit-kills lanes, {int(a_any.sum())} "
        f"occluded): ordered's and threaded's verdicts are kernel A's")
    top = e_sets["cornell tiled"]
    results["trace_variant"] = {
        "launches": launches["trace_variant"], "max_abs_err": max(e_err),
        "ms": top["ordered_ms"], "plain_ms": top["ordered_plain_ms"],
        "bound_ms": top["ordered_bound_ms"], "bound_by": top["ordered_bound_by"],
        "library_ms": None, "city_ms": e_sets["city tiled"]["ordered_ms"],
        "ray_sets": e_sets}


LBVH_BUILDS = 5  # timed builds a scene, after one warm-up


def device_kernels(fn):
    """(device kernels, their summed device ms) of one call of ``fn`` under
    torch.profiler, memory copies and sets included."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [e.time_range for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(spans), sum(r.end - r.start for r in spans) * 1e-3


def graph_replay(fn, reps: int = LBVH_BUILDS):
    """``fn`` (which must not synchronise the host) captured once as a CUDA
    graph: (its output, the median ms of ``reps`` replays by CUDA events).
    The replay takes the host's launches out of the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm the allocator outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return out, float(np.median(times))


def host_syncs(fn) -> int:
    """The host synchronisations one call of ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's own notice ("a prototype feature ... does not yet detect
    # all synchronizing operations") is not a synchronisation
    return sum("called a synchronizing" in str(w.message) for w in seen)


def phase_lbvh(dev, results, city, sponzoid, card):
    """Phase 5k: the ``bvh`` backend, the JAX package's LBVH built on the
    card (``bvh/lbvh.py``) walked by kernel E's ``threaded`` body; then ray
    sorting (``ops/sort_rays.py``) in front of kernel A."""
    import dataclasses

    import torch

    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch import scene_instances as si
    from vkrt_tpu_torch.benchmarks.ablate_kernel import visit_stats
    from vkrt_tpu_torch.benchmarks.micro_trace import make_rays
    from vkrt_tpu_torch.benchmarks.suite import SPONZOID_CAMERA
    from vkrt_tpu_torch.bvh.lbvh import build_lbvh
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.ops.cuda.trace import (
        node_depths, pack_bvh_nodes, pack_tris, threaded_tables,
    )
    from vkrt_tpu_torch.ops.cuda.trace_variants import (
        LbvhTracer, trace_ablate, trace_threaded, trace_variant,
    )
    from vkrt_tpu_torch.ops.intersect import T_MAX, T_MIN
    from vkrt_tpu_torch.ops.sort_rays import make_sorting_tracer, ray_sort_keys
    from vkrt_tpu_torch.ops.trace import BvhCounts, trace_rays_bvh
    from vkrt_tpu_torch.utils.camera import Camera

    t_phase = time.perf_counter()
    out = {}
    # 1. the build on the card against the CPU build, the device tables
    # against the host packing
    tables = {}
    for name, sc in (("city", city.scene), ("sponzoid", sponzoid.scene)):
        tris = (sc.tri_v0, sc.tri_e1, sc.tri_e2)
        flat = build_lbvh(*tris)  # warm-up
        syncs = host_syncs(lambda: threaded_tables(build_lbvh(*tris), *tris))
        if syncs:
            raise AssertionError(f"{name}: the LBVH build synchronised the host {syncs} times")
        if not host_syncs(lambda: tris[0].sum().item()):
            raise AssertionError("host_syncs does not see a read-back")
        kernels, device_ms = device_kernels(lambda: build_lbvh(*tris))
        times = []
        for _ in range(LBVH_BUILDS):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            build_lbvh(*tris)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        t_ms = cuda_ms(lambda: threaded_tables(flat, *tris), reps=5)
        replayed, graph_ms = graph_replay(lambda: build_lbvh(*tris))
        check_equal(f"{name} LBVH, CUDA graph replay vs the build (as uint32)",
                    [x.view(torch.int32) for x in replayed], [x.view(torch.int32) for x in flat])
        t0 = time.perf_counter()
        cpu = build_lbvh(*(t.cpu() for t in tris))
        cpu_s = time.perf_counter() - t0
        check_equal(f"{name} LBVH, card vs CPU (as uint32)",
                    [x.view(torch.int32).cpu() for x in flat],
                    [x.view(torch.int32) for x in cpu])
        nodes, tri_rec = threaded_tables(flat, *tris)
        host = [x.numpy() for x in cpu]
        want = pack_bvh_nodes(*host)
        want.view(np.int32)[:, 7] = np.where(host[3] >= 0, np.cumsum(host[3] >= 0) - 1, -1)
        want_tris = pack_tris(*(t.cpu().numpy() for t in tris), host[3][host[3] >= 0])
        check_equal(f"{name} threaded_tables vs the host packing",
                    (nodes.cpu().view(torch.int32), tri_rec.cpu().view(torch.int32)),
                    (torch.from_numpy(want).view(torch.int32),
                     torch.from_numpy(want_tris).view(torch.int32)))
        depth = int(node_depths(host[2].astype(np.int64), host[3]).max())
        tables[name] = (nodes, tri_rec)
        out[f"{name}_build"] = {"triangles": int(tris[0].shape[0]),
                                "build_ms": float(np.median(times)), "build_ms_all": times,
                                "tables_ms": t_ms, "kernels": kernels,
                                "kernels_device_ms": device_ms, "graph_replay_ms": graph_ms,
                                "host_syncs": syncs,
                                "depth": depth, "cpu_build_s": cpu_s}
        log(f"[lbvh] {name}: {tris[0].shape[0]} triangles, build {np.median(times):.4f} ms "
            f"(median of {LBVH_BUILDS} after a warm-up, CUDA events; all "
            f"{', '.join(f'{x:.4f}' for x in times)}), the build captured as one CUDA graph "
            f"{graph_ms:.4f} ms a replay (bit-equal), threaded_tables {t_ms:.4f} ms; "
            f"{kernels} device kernels ({device_ms:.4f} ms of device time) and {syncs} host "
            f"syncs a build; depth {depth} (the SAH "
            f"tree's {city.tables.max_depth if name == 'city' else 'not built here'}); "
            f"bit-equal to the CPU build ({cpu_s:.2f} s) and to the host packing ({card})")

    # 2. the walk: E threaded over the LBVH against its plain walk and
    # against kernel A over the SAH tree
    nodes, tri_rec = tables["city"]
    sc, bvh = city.scene, city.tables.bvh
    for kind in ("tiled", "incoherent"):
        o, d = make_rays(sc, W, H, kind, dev)
        n = o.shape[0]
        lim = torch.full((n,), T_MAX, device=dev)
        kdev.reset_counts()
        hits = trace_threaded(nodes, tri_rec, o, d, lim)
        if kdev.counts["vkrt_trace_variant"]["launches"] != 1:
            raise AssertionError("trace_threaded did not launch kernel E")
        idx = subsample(n, 4096).to(dev)
        t0 = time.perf_counter()
        walk, cnt = trace_rays_bvh(nodes, None, o[idx], d[idx], lim[idx], tris=tri_rec,
                                   count=True)
        sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        check_equal(f"city {kind}: E threaded over the LBVH vs trace_rays_bvh (as uint32)",
                    [x.view(torch.int32) for x in pick(hits, idx)],
                    [x.view(torch.int32) for x in walk])
        _, sah_cnt = trace_rays_bvh(bvh.threaded, sc, o[idx], d[idx], lim[idx], count=True)
        a_hits = city.tracer.trace(o, d, lim)
        check_equal(f"city {kind}: E threaded over the LBVH vs kernel A over the SAH tree "
                    "(as uint32)", [x.view(torch.int32) for x in hits],
                    [x.view(torch.int32) for x in a_hits])
        row = {"lbvh_ms": cuda_ms(lambda: trace_threaded(nodes, tri_rec, o, d, lim), reps=4),
               "sah_threaded_ms": cuda_ms(lambda: trace_variant("threaded", city.tables, sc, o,
                                                                d, lim), reps=4),
               "kernel_a_ms": cuda_ms(lambda: city.tracer.trace(o, d, lim), reps=8),
               "plain_ms": plain_ms, "plain_rays": int(idx.shape[0])}
        scaled = BvhCounts(*(c.double() * (n / idx.shape[0]) for c in cnt))
        row["bound_ms"], row["bound_by"] = trace_bound((nodes, tri_rec), n, scaled)
        for what, c in (("lbvh", cnt), ("sah", sah_cnt)):
            st = visit_stats(c)
            row.update({f"{what}_slab_tests": st["nodes"]["mean"],
                        f"{what}_triangle_tests": st["leaves"]["mean"],
                        f"{what}_simt_efficiency": st["simt_efficiency"]})
        out[f"walk_{kind}"] = row
        log(f"[lbvh] city {kind} ({n} rays, {int((hits.tri >= 0).sum())} hits): E threaded over "
            f"the LBVH {row['lbvh_ms']:.4f} ms (bound {row['bound_ms']:.4f} ms "
            f"{row['bound_by']}; {row['lbvh_slab_tests']:.2f} slab + "
            f"{row['lbvh_triangle_tests']:.2f} triangle tests a ray, SIMT efficiency "
            f"{row['lbvh_simt_efficiency']:.4f}, on {idx.shape[0]} rays), E threaded over the "
            f"SAH tree {row['sah_threaded_ms']:.4f} ms ({row['sah_slab_tests']:.2f} + "
            f"{row['sah_triangle_tests']:.2f}, {row['sah_simt_efficiency']:.4f}), kernel A "
            f"over the SAH tree {row['kernel_a_ms']:.4f} ms; bit-equal to the plain walk on "
            f"{idx.shape[0]} rays ({plain_ms:.1f} ms) and to kernel A on every ray ({card})")

    # 3. the scene that moves: the animated sponzoid through Engine with
    # bvh and with pallas, 3 frames of phase 4e's poses, bit-equal images
    node = int(np.argmax([e - s for s, e in sponzoid.prim_ranges]))
    parts = {"repose": [], "repose_tracer": []}
    real_parts = {k: getattr(si, k) for k in parts}

    def timed_part(name):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = real_parts[name](*args, **kw)
            torch.cuda.synchronize()
            parts[name].append((time.perf_counter() - t0) * 1e3)
            return res
        return call

    images, split, launches = {}, {}, {}
    settings = path_settings(SPONZOID_DEPTH)
    for backend in ("bvh", "pallas"):
        eng = Engine(sponzoid, W, H, dataclasses.replace(settings, backend=backend),
                     Camera(**SPONZOID_CAMERA), CLEAR)
        if (backend == "bvh") != isinstance(eng.tracer, LbvhTracer):
            raise AssertionError(f"backend {backend}: tracer {type(eng.tracer).__name__}")
        for k in parts:
            parts[k] = []
            setattr(si, k, timed_part(k))
        kdev.reset_counts()
        try:
            frames = []
            for f in range(3):
                eng.set_node_transform(node, translation(0.02 * (f + 1), 0.0, 0.0))
                frames.append(eng.render_frame().clone())
            torch.cuda.synchronize()
        finally:
            for k, fn in real_parts.items():
                setattr(si, k, fn)
        launches[backend] = launches_now(("trace_variant", "trace"))
        images[backend] = frames
        split[backend] = {k: float(np.mean(v)) for k, v in parts.items()}
    per = general_launches(SPONZOID_DEPTH)["trace"] * 3
    if launches["bvh"] != {"trace_variant": per, "trace": 0} or \
            launches["pallas"] != {"trace_variant": 0, "trace": per}:
        raise AssertionError(f"launches over 3 frames {launches}, want {per} of E (bvh) and "
                             f"of A (pallas)")
    results["trace_variant"]["lbvh_launches"] = launches["bvh"]["trace_variant"]
    for f, (a, b) in enumerate(zip(images["bvh"], images["pallas"])):
        check_equal(f"sponzoid animated frame {f}, bvh vs pallas", (a,), (b,))
    refit = results.get("sponzoid", {}).get("repose_parts_ms", {})
    log(f"[lbvh] sponzoid animated, 3 frames, {W}x{H} path depth {SPONZOID_DEPTH}: bvh's "
        f"images equal pallas' bit for bit; launches {launches}; the repose a frame (host clock "
        f"between device synchronisations, mean of 3): bvh re-bake + upload "
        f"{split['bvh']['repose']:.3f} ms, LBVH rebuild {split['bvh']['repose_tracer']:.3f} ms; "
        f"pallas re-bake + upload {split['pallas']['repose']:.3f} ms, refit "
        f"{split['pallas']['repose_tracer']:.3f} ms; phase 4e's (no synchronisation): re-bake "
        f"+ splice {refit.get('repose', float('nan')):.3f} ms, refit "
        f"{refit.get('repose_tracer', float('nan')):.3f} ms ({card})")
    out["sponzoid_repose_ms"] = split
    out["sponzoid_launches"] = launches

    # 4. ray sorting in front of kernel A on the city's incoherent rays
    o, d = make_rays(sc, W, H, "incoherent", dev)
    n = o.shape[0]
    lim = torch.full((n,), T_MAX, device=dev)
    st = make_sorting_tracer(city.tracer, sc)
    check_equal("city incoherent: sorted kernel A, unsorted, vs kernel A (as uint32)",
                [x.view(torch.int32) if x.dtype != torch.bool else x
                 for x in st.closest(o, d, T_MIN, T_MAX)],
                [x.view(torch.int32) if x.dtype != torch.bool else x
                 for x in city.tracer.closest(o, d, T_MIN, T_MAX)])
    keys = ray_sort_keys(o, d, st.lo, st.hi)
    perm = torch.sort(keys, stable=True).indices
    so, sd = o[perm], d[perm]

    def sort_and_gather():
        p = torch.sort(keys, stable=True).indices
        return o[p], d[p]

    srt = {"key_ms": cuda_ms(lambda: ray_sort_keys(o, d, st.lo, st.hi), reps=8),
           "sort_gather_ms": cuda_ms(sort_and_gather, reps=8),
           "kernel_a_sorted_ms": cuda_ms(lambda: city.tracer.trace(so, sd, lim), reps=8),
           "kernel_a_ms": cuda_ms(lambda: city.tracer.trace(o, d, lim), reps=8)}
    for what, (ro, rd) in (("unsorted", (o, d)), ("sorted", (so, sd))):
        _, cnt = trace_ablate("count", city.tables, sc, ro, rd, lim)
        stt = visit_stats(cnt)
        srt[f"{what}_simt_efficiency"] = stt["simt_efficiency"]
        srt[f"{what}_slab_tests"] = stt["nodes"]["mean"]
    out["sort"] = srt
    log(f"[lbvh] city incoherent, {n} rays: sorted kernel A's hits, unsorted, bit-equal to "
        f"kernel A's; key {srt['key_ms']:.4f} ms, sort + two gathers "
        f"{srt['sort_gather_ms']:.4f} ms, kernel A on the sorted rays "
        f"{srt['kernel_a_sorted_ms']:.4f} ms against {srt['kernel_a_ms']:.4f} ms unsorted; "
        f"SIMT efficiency {srt['sorted_simt_efficiency']:.4f} sorted, "
        f"{srt['unsorted_simt_efficiency']:.4f} unsorted ({srt['sorted_slab_tests']:.2f} / "
        f"{srt['unsorted_slab_tests']:.2f} slab tests a ray; kernel D's counts) ({card})")
    tiled = out["walk_tiled"]
    results["trace_variant"].update({
        "lbvh_ms": tiled["lbvh_ms"], "lbvh_bound_ms": tiled["bound_ms"],
        "lbvh_bound_by": tiled["bound_by"], "lbvh_plain_ms": tiled["plain_ms"]})
    results["lbvh"] = out
    log(f"[lbvh] phase wall time {time.perf_counter() - t_phase:.1f} s")


def ray_set_report(name, b, o, d, a_run, any_hit: bool) -> dict:
    """Kernel A on one ray set (``a_run``: micro_trace's time, hits and
    limits) beside kernel E's ``threaded`` on the same rays: both times,
    the slab and triangle tests a ray and the SIMT efficiency of both walks
    (kernel D's ``count``; the plain stackless walk), and both bounds."""
    import torch

    from vkrt_tpu_torch.benchmarks.ablate_kernel import visit_stats
    from vkrt_tpu_torch.ops.cuda.trace_variants import trace_ablate, trace_variant
    from vkrt_tpu_torch.ops.trace import trace_rays_bvh

    sc, bvh, t_lim = b.scene, b.tables.bvh, a_run["t_lim"]
    old = trace_variant("threaded", b.tables, sc, o, d, t_lim)
    if not torch.equal(old.tri >= 0, a_run["hits"].tri >= 0):
        raise AssertionError(f"{name}: E threaded's verdicts differ from kernel A's")
    old_ms = cuda_ms(lambda: trace_variant("threaded", b.tables, sc, o, d, t_lim), reps=4)
    hits, cnt = trace_ablate("count", b.tables, sc, o, d, t_lim, any_hit=any_hit)
    check_equal(f"{name} count vs kernel A", (hits.tri >= 0,) if any_hit else hits,
                (a_run["hits"].tri >= 0,) if any_hit else a_run["hits"])
    _, old_cnt = trace_rays_bvh(bvh.threaded, sc, o, d, t_lim, any_hit=any_hit, count=True)
    new, was = visit_stats(cnt), visit_stats(old_cnt)
    n = o.shape[0]
    a_b = trace_bound(walk_tables(bvh), n, cnt)
    e_b = trace_bound(variant_tables(b.tables, "threaded"), n, old_cnt)
    log(f"[walk] {name}: kernel A {a_run['ms']:.4f} ms ({new['nodes']['mean']:.2f} slab + "
        f"{new['leaves']['mean']:.2f} triangle tests a ray, SIMT efficiency "
        f"{new['simt_efficiency']:.4f}, bound {a_b[0]:.4f} ms {a_b[1]}); E threaded "
        f"{old_ms:.4f} ms ({was['nodes']['mean']:.2f} + {was['leaves']['mean']:.2f}, SIMT "
        f"efficiency {was['simt_efficiency']:.4f}, bound {e_b[0]:.4f} ms {e_b[1]}); "
        f"{old_ms / a_run['ms']:.2f}x")
    return {"ms": a_run["ms"], "bound_ms": a_b[0], "bound_by": a_b[1],
            "slab_tests": new["nodes"]["mean"], "triangle_tests": new["leaves"]["mean"],
            "simt_efficiency": new["simt_efficiency"], "threaded_ms": old_ms,
            "threaded_bound_ms": e_b[0], "threaded_bound_by": e_b[1],
            "threaded_slab_tests": was["nodes"]["mean"],
            "threaded_triangle_tests": was["leaves"]["mean"],
            "threaded_simt_efficiency": was["simt_efficiency"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.benchmarks import CITY_GRID, build
    from vkrt_tpu_torch.ops.cuda.trace_variants import INSTANTIATIONS
    from vkrt_tpu_torch.utils import native

    dev = torch.device("cuda")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(f"[device] {card}")

    t0 = time.perf_counter()
    info = kdev.build()
    kdev.kernels()
    log(f"[build] kernels: {time.perf_counter() - t0:.2f} s "
        f"({'cached' if info['cached'] else 'nvcc'})")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build]   {line.strip()}")
    info = kdev.trace_info()
    log(f"[build] kernel A as compiled: {info['registers']} registers a thread, "
        f"{info['shared_bytes']} B shared memory a block, {info['local_bytes']} B local "
        f"memory (stack frame) a thread, {info['blocks_per_sm']} blocks of 128 threads an SM")
    for v, vid in INSTANTIATIONS.items():
        info = kdev.variant_info(vid)
        log(f"[build] kernel E {v} as compiled: {info['registers']} registers a thread, "
            f"{info['shared_bytes']} B shared memory a block, {info['local_bytes']} B local "
            f"memory a thread, {info['blocks_per_sm']} blocks of 128 threads an SM")
    for albedo in (False, True):
        info = kdev.shade_info(albedo)
        log(f"[build] kernel B {'albedo' if albedo else 'untextured'} as compiled: "
            f"{info['registers']} registers a thread, {info['shared_bytes']} B shared memory "
            f"a block, {info['local_bytes']} B local memory a thread, "
            f"{info['blocks_per_sm']} blocks of 128 threads an SM")
    t0 = time.perf_counter()
    native.library()
    log(f"[build] native SAH builder: {time.perf_counter() - t0:.2f} s")

    # the city of phases 3b, 4b and 6, built once
    t0 = time.perf_counter()
    city = build("city", dev)
    log(f"[city] make_city(grid={CITY_GRID}): {city.scene.num_tris} triangles (padded), "
        f"host build {time.perf_counter() - t0:.2f} s with its BVH and probe tables")

    results, pools = {}, {}
    for name, phase in (("2-3 kernels",
                         lambda: pools.update(shadow=phase_kernels(dev, results))),
                        ("3b albedo kernel", lambda: phase_albedo(dev, results, city)),
                        ("3c rng kernels", lambda: phase_rng(dev, results)),
                        ("3d texture kernels", lambda: phase_texture(dev, results)),
                        ("4 main path", lambda: phase_main_path(dev, results)),
                        ("4b city main path", lambda: phase_city_main_path(dev, results,
                                                                           city.scene)),
                        ("4c hybrid main path", lambda: phase_hybrid_main_path(dev, results,
                                                                               city.scene)),
                        ("4d denoised main path",
                         lambda: phase_denoised_main_path(dev, results, city.scene, card)),
                        ("4e sponzoid main path",
                         lambda: pools.update(sponzoid=phase_sponzoid(dev, results, card))),
                        ("4f mesh main path", lambda: phase_mesh_main_path(dev, results, card)),
                        ("5 end to end", lambda: phase_end_to_end(dev)),
                        ("5b city end to end", lambda: phase_city_end_to_end(dev)),
                        ("5c general loop", lambda: phase_general_loop(dev)),
                        ("5d hybrid end to end", lambda: phase_hybrid_end_to_end(dev)),
                        ("5e denoised end to end", lambda: phase_denoised_end_to_end(dev)),
                        ("5f alpha", lambda: phase_alpha(dev, results, city.scene, card)),
                        ("5g instances end to end",
                         lambda: phase_instances_end_to_end(dev, results)),
                        ("5h app", lambda: phase_app(dev)),
                        ("5i mesh hybrid", lambda: phase_mesh_hybrid(dev, results, city.scene,
                                                                     card)),
                        ("5j mesh app", lambda: phase_mesh_app(dev)),
                        ("6 probes", lambda: phase_probes(dev, results, pools["shadow"],
                                                          city)),
                        ("5k lbvh", lambda: phase_lbvh(dev, results, city, pools["sponzoid"],
                                                       card)),
                        ("7 suite", lambda: phase_suite(dev, results)),
                        ("8 bench", lambda: phase_bench(dev, results, card))):
        t0 = time.perf_counter()
        phase()
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")

    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                **results[name]} for name, (src, _, rep) in KERNELS.items()]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    for kk in kernels:
        missing = [k for k in keys if k not in kk]
        if missing:
            raise AssertionError(f"kernel {kk['name']} lacks {missing}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
