"""The RNG prologue's CUDA kernels (``csrc/rng.cu``): the TEA seeds and the
correlated draw tables, one launch each.

``ops/rng.py`` dispatches here for every call on the card; its int64
PyTorch rounds are the plain version these are held to bit for bit
(``tests/test_torch_rng_gpu.py``). The host integers (the second TEA word,
the table's seed and depth) are launch scalars: nothing is uploaded, so
the call does not synchronise.
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch import device as dev

MASK32 = 0xFFFFFFFF
TABLE_COLS = 8  # the (G, 8) table kernel B reads: CORR_DRAWS draws, then zeros
LANE_COLS = 6   # ops/rng.py CORR_DRAWS


def tea(val0: torch.Tensor, val1: int, rounds: int) -> torch.Tensor:
    """TEA of (the low 32 bits of each ``val0``, ``val1``) over ``rounds``
    rounds: the int32 bits of the uint32 hash, shaped like ``val0`` (int64
    or int32 on the card)."""
    device = dev.check_args("rng tea", [("val0", val0, (torch.int64, torch.int32), None)],
                            strided=("val0",))
    val0 = val0.contiguous()
    out = torch.empty(val0.shape, dtype=torch.int32, device=device)
    n = val0.numel()
    if n:
        dev.launch("vkrt_rng_tea", device, val0.data_ptr(), int(val0.dtype == torch.int64),
                   int(val1) & MASK32, int(rounds), n, out.data_ptr(), lanes=n)
    return out


def table(n_rows: int, corr_seed: int, depth: int, device, n_lanes: int | None = None,
          block: int = 0) -> torch.Tensor:
    """One bounce's correlated draws: the (n_rows, 8) f32 table, or with
    ``n_lanes`` its per-lane (n_lanes, 6) view, each ``block`` consecutive
    lanes sharing one row (``n_rows`` = ceil(n_lanes / block))."""
    device = dev.check_args("rng table", [], device=device)
    if n_lanes is None:
        out = torch.empty((n_rows, TABLE_COLS), dtype=torch.float32, device=device)
        ptrs = (out.data_ptr(), None)
    else:
        if n_rows != -(-n_lanes // block):
            raise ValueError(f"rng table: {n_rows} rows for {n_lanes} lanes in blocks of {block}")
        out = torch.empty((n_lanes, LANE_COLS), dtype=torch.float32, device=device)
        ptrs = (None, out.data_ptr())
    if n_rows:
        dev.launch("vkrt_rng_table", device, int(corr_seed) & MASK32, int(depth) & MASK32,
                   n_rows, *ptrs, n_lanes or 0, block, lanes=n_lanes or n_rows)
    return out
