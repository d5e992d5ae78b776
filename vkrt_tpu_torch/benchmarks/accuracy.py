"""The accuracy anchor (the port's twin of ``benchmarks/tpu_accuracy.py``).

    python -m vkrt_tpu_torch.benchmarks.accuracy

Renders the Cornell box (``make_cornell_box``) at 64x48, spp 1, depth 3,
over 3 frames, with ``pathtrace_frame``'s defaults (scanline order, the
correlated sampler off), through the production route on the card: kernel
A (``make_tracer(scene, "auto")``) and kernel B (the packed loop), in f32.
The oracle is the same estimator in float64 on the host CPU: the port's
plain path (brute force, the general loop) on the scene and camera widened
to float64 (``scene_to_dtype``, ``Camera.matrices(dtype=)``). The RNG gives
both renders the same f32 draws, so they follow one random walk, and what
separates them is float drift plus the few walks a rounding sent another
way (a lobe, a light, a coplanar tie).

The gate is ``tests/test_accuracy_oracle.py:83-88``'s on the displayed
images, ``clip(tonemap(x), 0, 1)`` with both images cast to f32 before the
tonemap: p99 of the per-pixel error <= 1e-3, pixels off by more than 1e-2
(diverged) under 1%, and RMSE <= 1e-3 over the rest.

The record goes to ``CUDA_ACCURACY.json`` at the repository's root (the
JAX package's is ``TPU_ACCURACY.json``): the JAX record's keys, with
``device`` the card's name, plus ``power_limit``. The module exits 5 when
the gate fails. ``device=None`` (the default) means the card and raises
without one; ``device="cpu"`` renders the f32 leg through the plain
versions, for the tests.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

W, H = 64, 48
FRAMES = 3
DEPTH = 3
CLEAR = (1.0, 1.0, 1.0, 1.0)
BUDGET_RMSE = 1e-3
BUDGET_P99 = 1e-3
DIVERGED_ERR = 1e-2  # a pixel off by more than this has diverged
BUDGET_DIVERGED = 0.01
WORKLOAD = f"cornell_{W}x{H}_spp1_depth{DEPTH}_frames{FRAMES}"
OUT = Path(__file__).resolve().parents[2] / "CUDA_ACCURACY.json"


def render(scene, tracer, cam, general_loop: bool = False) -> np.ndarray:
    """``FRAMES`` progressive frames in the scene's dtype; the accumulator
    (W*H, 3) as float64 numpy."""
    from vkrt_tpu_torch.models.pathtracer import pathtrace_frame

    accum = torch.zeros((W * H, 3), dtype=scene.tri_v0.dtype, device=scene.device)
    for f in range(FRAMES):
        accum, _ = pathtrace_frame(scene, tracer, cam, f, accum, CLEAR, width=W, height=H,
                                   samples=1, depth=DEPTH, general_loop=general_loop)
    return accum.cpu().numpy().astype(np.float64)


def render_f32(device: torch.device) -> np.ndarray:
    """The production route's render on ``device`` (kernels A and B on the
    card, their plain versions on the CPU)."""
    from vkrt_tpu_torch.ops.trace import make_tracer
    from vkrt_tpu_torch.scene import make_cornell_box
    from vkrt_tpu_torch.utils.camera import Camera

    scene = make_cornell_box(device=device)
    return render(scene, make_tracer(scene, "auto"), Camera().matrices(W, H, device))


def oracle_inputs():
    """(scene, brute-force tracer, camera), all float64 on the CPU."""
    from vkrt_tpu_torch.ops.trace import make_tracer
    from vkrt_tpu_torch.scene import make_cornell_box, scene_to_dtype
    from vkrt_tpu_torch.utils.camera import Camera

    scene = scene_to_dtype(make_cornell_box(device="cpu"), torch.float64)
    cam = Camera().matrices(W, H, "cpu", torch.float64)
    return scene, make_tracer(scene, "bruteforce"), cam


def render_oracle() -> np.ndarray:
    """The float64 oracle: the general loop over brute force, on the CPU."""
    scene, tracer, cam = oracle_inputs()
    return render(scene, tracer, cam, general_loop=True)


def display(img: np.ndarray) -> np.ndarray:
    """The displayed image: ``clip(tonemap(img as f32), 0, 1)``, as float64."""
    from vkrt_tpu_torch.models.post import tonemap

    shown = tonemap(torch.tensor(np.asarray(img, np.float32))).numpy()
    return np.clip(shown.astype(np.float64), 0.0, 1.0)


def gate(img: np.ndarray, ref: np.ndarray) -> dict:
    """The display gate of ``img`` against ``ref``: RMSE over the pixels
    that did not diverge, p99 of the per-pixel error, the diverged share,
    and whether all three are within budget."""
    diff = display(img) - display(ref)
    err = np.abs(diff).max(-1)
    diverged = err > DIVERGED_ERR
    rmse = float(np.sqrt(np.mean(diff[~diverged] ** 2)))
    p99 = float(np.percentile(err, 99))
    frac = float(diverged.mean())
    return {"rmse_display": rmse, "p99_abs_err": p99, "diverged_frac": frac,
            "budget_rmse": BUDGET_RMSE,
            "ok": bool(rmse <= BUDGET_RMSE and p99 <= BUDGET_P99 and frac < BUDGET_DIVERGED)}


def run(device=None, out_path=None) -> dict:
    """Render f32 on ``device`` and the float64 oracle on the CPU; write
    the record to ``out_path`` (``OUT`` when None) and return it."""
    from vkrt_tpu_torch.device import card, select

    dev = device if isinstance(device, torch.device) else select(device or "cuda")
    img = render_f32(dev)
    info = card(dev)
    rec = {"workload": WORKLOAD, "device": info["name"], **gate(img, render_oracle()),
           "power_limit": info["power_limit"]}
    Path(out_path or OUT).write_text(json.dumps(rec, indent=1) + "\n")
    print(f"[accuracy] {rec}", file=sys.stderr, flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the f32 render runs (cpu: the plain versions)")
    args = ap.parse_args(argv)
    return 0 if run(device=args.device)["ok"] else 5


if __name__ == "__main__":
    sys.exit(main())
