"""FP32 FMA peak (port of ``benchmarks/scratch/vpupeak.py``): the measured
rate of kernel F, K FMAs per element in 8 independent chains over
(TILES*8, 128) f32 elements, for the trace kernels' roofline. Printed
beside the H100 SXM's published FP32 peak (67 TFLOP/s at 700 W). The
elements are uniform in [0.1, 2) from ``--seed``, so every output differs
and a check against the plain version sees each one.

Usage: python -m vkrt_tpu_torch.benchmarks.vpupeak [K=65536] [TILES=64] [REPS=20]
           [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vkrt_tpu_torch.benchmarks import time_calls, where
from vkrt_tpu_torch.device import select
from vkrt_tpu_torch.ops.cuda.probes import fma_flops, fma_peak

ROWS, LANES = 8, 128
H100_FP32_TFLOPS = 67.0  # H100 SXM data sheet, FP32 outside the tensor cores


def run(k: int = 65536, tiles: int = 64, reps: int = 20, device="cuda",
        seed: int = 0) -> dict:
    """Time kernel F: {ms, tflops, x, out, k}."""
    device = select(device) if isinstance(device, str) else device
    x = np.random.default_rng(seed).uniform(0.1, 2.0, (tiles * ROWS, LANES))
    x = torch.tensor(x.astype(np.float32), device=device)
    ms, _ = time_calls(lambda: fma_peak(x, k), reps, device)
    out = fma_peak(x, k)
    tflops = fma_flops(x, k) / (ms * 1e-3) / 1e12
    print(f"device={where(device)}")
    print(f"K={k} TILES={tiles}: {ms:.4f} ms/rep")
    print(f"achieved: {tflops:.3f} TFLOP/s f32 FMA "
          f"({tflops / H100_FP32_TFLOPS:.3f} of the H100 SXM's {H100_FP32_TFLOPS} TFLOP/s)")
    return {"ms": ms, "tflops": tflops, "x": x, "out": out, "k": k}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("k", nargs="?", type=int, default=65536, metavar="K")
    p.add_argument("tiles", nargs="?", type=int, default=64, metavar="TILES")
    p.add_argument("reps", nargs="?", type=int, default=20, metavar="REPS")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if args.k <= 0 or args.k % 64:
        p.error("K must be a positive multiple of 64")
    run(args.k, args.tiles, args.reps, args.device, args.seed)


if __name__ == "__main__":
    main()
