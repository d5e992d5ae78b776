"""Kernels C and F: the launch-floor and FP32 FMA-peak probes
(``csrc/probes.cu``).

* ``floor_kernel`` replaces ``benchmarks/micro_trace.py::bench_floor``'s
  empty Pallas kernel: kernel A's ray I/O (the 7-float ray record in, the
  4-word miss record out) with no traversal. ``threads`` is the block size,
  swept over ``FLOOR_THREADS``. Plain version: ``floor_plain``.
* ``fma_peak`` replaces ``benchmarks/scratch/vpupeak.py::kernel``: per
  element, 8 independent chains of ``a = fma(a, 1.0000001, 1e-7)``, ``k``
  FMAs in all, and the chains' sum. Plain version: ``fma_peak_plain``, each
  step in float64 rounded to float32, which is what one fused multiply-add
  rounds to (the product of two f32 is exact in f64, and so is its sum
  with 1e-7 at these magnitudes).

Each wrapper launches its kernel on CUDA tensors (or raises) and runs the
plain version on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from vkrt_tpu_torch import device as dev
from vkrt_tpu_torch.ops.cuda.trace import ray_args
from vkrt_tpu_torch.ops.trace import RayHits

FLOOR_THREADS = (128, 256, 512, 1024)
FMA_UNROLL = 64  # FMAs per element per loop iteration (8 chains x 8 steps)
FMA_C = float(np.float32(1.0000001))
FMA_B = float(np.float32(1e-7))
# the chains' start multipliers, (0.9 + 0.01 i) rounded to f32
FMA_START = [float(np.float32(0.9 + 0.01 * i)) for i in range(8)]


def miss_record(t_lim: torch.Tensor) -> RayHits:
    """Kernel A's miss record: t = |t_lim|, tri = -1, u = v = 0."""
    n = t_lim.shape[0]
    z = torch.zeros(n, dtype=torch.float32, device=t_lim.device)
    return RayHits(t_lim.abs(), torch.full((n,), -1, dtype=torch.int32,
                                           device=t_lim.device), z, z.clone())


def floor_plain(o, d, t_lim) -> RayHits:
    """The plain version of the floor kernel: the miss record."""
    return miss_record(t_lim)


def floor_kernel(o, d, t_lim, threads: int = 256) -> RayHits:
    """Read kernel A's ray record, write its miss record (kernel C)."""
    if o.device.type == "cpu":
        return floor_plain(o, d, t_lim)
    if threads not in FLOOR_THREADS:
        raise ValueError(f"threads must be one of {FLOOR_THREADS}, got {threads}")
    n = o.shape[0]
    dev.check_args("floor_kernel", ray_args(o, d, t_lim), strided=("o", "d"))
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty(n, dtype=torch.float32, device=o.device)
    v = torch.empty(n, dtype=torch.float32, device=o.device)
    dev.launch(
        "vkrt_floor", o.device,
        o.data_ptr(), o.stride(0), o.stride(1),
        d.data_ptr(), d.stride(0), d.stride(1),
        t_lim.data_ptr(), n, threads,
        t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(), lanes=n,
    )
    return RayHits(t, tri, u, v)


def fma_flops(x: torch.Tensor, k: int) -> int:
    """FLOPs of one ``fma_peak`` call (2 per FMA)."""
    return 2 * x.numel() * (k // FMA_UNROLL) * FMA_UNROLL


def _check_k(k: int) -> None:
    if k <= 0 or k % FMA_UNROLL:
        raise ValueError(f"k must be a positive multiple of {FMA_UNROLL}, got {k}")


def fma_peak_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """The plain version of the FMA-peak kernel."""
    _check_k(k)
    a = torch.stack([x * s for s in FMA_START])  # f32 products
    for _ in range(k // 8):  # 8 chains: k / 8 steps each
        a = (a.double() * FMA_C + FMA_B).float()
    out = a[0]
    for j in range(1, 8):
        out = out + a[j]
    return out


def fma_peak(x: torch.Tensor, k: int) -> torch.Tensor:
    """k FMAs per element of f32 ``x`` in 8 chains, summed (kernel F)."""
    if x.device.type == "cpu":
        return fma_peak_plain(x, k)
    _check_k(k)
    dev.check_args("fma_peak", [("x", x, torch.float32, None)])
    out = torch.empty_like(x)
    dev.launch("vkrt_fma_peak", x.device, x.data_ptr(), out.data_ptr(), x.numel(),
               k // FMA_UNROLL, lanes=x.numel())
    return out
