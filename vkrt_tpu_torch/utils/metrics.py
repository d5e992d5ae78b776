"""Image quality metrics: RMSE / PSNR / relative MSE (port of
``vkrt_tpu/utils/metrics.py``, numpy only).

The accuracy measures of the convergence tests and of the denoised
fly-through's ``rmse_vs_converged``: the reference validates visually; the
port measures. Inputs are anything ``np.asarray`` takes (a CPU tensor
included); the arithmetic is float64.
"""

from __future__ import annotations

import numpy as np


def rmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def psnr(a, b, peak: float = 1.0) -> float:
    m = rmse(a, b)
    if m == 0:
        return float("inf")
    return float(20.0 * np.log10(peak / m))


def rel_mse(a, ref, eps: float = 1e-2) -> float:
    """Relative MSE (a common path-tracing metric; tolerant of bright pixels)."""
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.mean((a - ref) ** 2 / (ref**2 + eps)))


def flip_summary(a, b) -> dict:
    """Compact difference summary for logs."""
    return {
        "rmse": round(rmse(a, b), 6),
        "psnr": round(psnr(a, b), 2),
        "rel_mse": round(rel_mse(a, b), 6),
    }
