"""TEA + LCG generators, bit-exact with ``vkrt_tpu/ops/rng.py``.

The renderer's randomness is a deterministic uint32 state carried per lane
(TEA-hashed seed, then an LCG), so the port reproduces the JAX package draw
for draw; no ``torch.Generator`` is involved.

Torch on the CPU has no uint32 shifts (``>>`` on a ``torch.uint32`` tensor
raises "rshift_cpu not implemented"), and TEA needs a logical ``>> 5``. So
the arithmetic runs in int64 holding values in [0, 2^32), masked after every
add and shift, and state is stored as int32 bits (``u32_bits``): the same 32
bits a uint32 array holds, viewable as one with ``.numpy().view(np.uint32)``.

The RNG prologue (``tea``, the correlated-draw tables) runs under the
"rng" range of ``utils.profiling``. On the card each call is one launch of
a kernel of ``csrc/rng.cu`` (``ops/cuda/rng.py``), its seed a launch
scalar, so a seed there has to be a host integer: a tensor seed raises.
The int64 rounds are the plain version (``tea_plain``,
``block_uniform_table_plain``, ``corr_draws_plain``): every CPU call
takes them, and the card's tests and ``chip_smoke.py`` call them by name
to hold the kernels to them bit for bit.
"""

from __future__ import annotations

import numbers

import torch

from vkrt_tpu_torch.ops.cuda import rng as rng_cuda
from vkrt_tpu_torch.utils.profiling import labelled

MASK32 = 0xFFFFFFFF
TEA_DELTA = 0x9E3779B9
TEA_KEYS = (0xA341316C, 0xC8013EA4, 0xAD90777D, 0x7E95761E)
DEPTH_KEY = 0x85EBCA6B  # a correlated table's depth salt
_LCG_A = 1664525
_LCG_C = 1013904223
_INV_2_24 = 1.0 / float(0x01000000)  # exact in f32

CORR_DRAWS = 6  # lobe, light, hemi r1/r2, ggx r1/r2
CORR_BLOCK = 1024  # lanes sharing one draw row: the JAX PROG_ROWS * 128


def as_u32(x, device=None) -> torch.Tensor:
    """Any integer tensor or Python int -> int64 tensor in [0, 2^32)."""
    if not torch.is_tensor(x):
        x = torch.tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & MASK32


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same bits."""
    return x.to(torch.int32)


def _on_card(device, seed) -> bool:
    """Whether a call takes the kernels: every call on a CUDA device, whose
    seed the kernel takes as a launch scalar (a tensor seed raises)."""
    if device is None or torch.device(device).type != "cuda":
        return False
    if not isinstance(seed, numbers.Integral):
        raise TypeError(f"rng: a seed on {device} is a host integer (a launch scalar), "
                        f"not {type(seed).__name__}")
    return True


@labelled("rng")
def tea(val0, val1, rounds: int = 16) -> torch.Tensor:
    """TEA hash (shaders/random.glsl:6-20). Inputs broadcast; returns the
    uint32 result as int32 bits."""
    if torch.is_tensor(val0) and _on_card(val0.device, val1):
        return rng_cuda.tea(val0, val1, rounds)
    return tea_plain(val0, val1, rounds)


def tea_plain(val0, val1, rounds: int = 16) -> torch.Tensor:
    """``tea`` in int64 rounds on any device: the plain version."""
    v0 = as_u32(val0)
    v1 = as_u32(val1, device=v0.device)
    v0, v1 = torch.broadcast_tensors(v0, v1)
    s0 = 0
    k0, k1, k2, k3 = TEA_KEYS
    for _ in range(rounds):
        s0 = (s0 + TEA_DELTA) & MASK32
        v0 = (v0 + (
            (((v1 << 4) + k0) & MASK32)
            ^ ((v1 + s0) & MASK32)
            ^ ((v1 >> 5) + k1)
        )) & MASK32
        v1 = (v1 + (
            (((v0 << 4) + k2) & MASK32)
            ^ ((v0 + s0) & MASK32)
            ^ ((v0 >> 5) + k3)
        )) & MASK32
    return u32_bits(v0)


def lcg(state):
    """One LCG step (shaders/random.glsl:22-28). Returns (new_state,
    bits24), both int32 bits."""
    s = (as_u32(state) * _LCG_A + _LCG_C) & MASK32
    return u32_bits(s), u32_bits(s & 0x00FFFFFF)


def rnd(state):
    """Uniform float in [0, 1) (shaders/random.glsl:30-33). Returns
    ``(new_state, u)``."""
    state, bits = lcg(state)
    return state, bits.to(torch.float32) * _INV_2_24


def seed_pixels(width: int, height: int, frame, device=None) -> torch.Tensor:
    """Per-pixel seeds, flat row-major (N = height*width,) int32 bits."""
    idx = torch.arange(width * height, dtype=torch.int64, device=device)
    return tea(idx, frame)


# --- correlated per-block sampling (see vkrt_tpu/ops/rng.py) ---------------


@labelled("rng")
def block_uniform_table(n_blocks: int, corr_seed, depth: int,
                        device=None) -> torch.Tensor:
    """(G, 8) f32 of per-block shared uniforms in [0,1) for one bounce.
    Columns 0-5 = CORR_DRAWS, 6-7 zero."""
    if _on_card(device, corr_seed):
        return rng_cuda.table(n_blocks, corr_seed, depth, device)
    return block_uniform_table_plain(n_blocks, corr_seed, depth, device)


def block_uniform_table_plain(n_blocks: int, corr_seed, depth: int,
                              device=None) -> torch.Tensor:
    """``block_uniform_table`` in int64 rounds on any device: the plain
    version."""
    i = torch.arange(n_blocks, dtype=torch.int64, device=device)
    dkey = (int(depth) * DEPTH_KEY) & MASK32
    st = tea_plain(i, as_u32(corr_seed, device=device) ^ dkey, rounds=8)
    us = []
    for _ in range(CORR_DRAWS):
        st, u = rnd(st)
        us.append(u)
    us.append(torch.zeros_like(us[0]))
    us.append(torch.zeros_like(us[0]))
    return torch.stack(us, dim=1)


@labelled("rng")
def corr_draws(n: int, corr_seed, depth: int, block: int = CORR_BLOCK,
               device=None) -> torch.Tensor:
    """Per-lane view of the block table: (N, CORR_DRAWS) f32, each
    ``block`` consecutive lanes (in pool = tile order) sharing one row."""
    if _on_card(device, corr_seed):
        return rng_cuda.table(-(-n // block), corr_seed, depth, device, n_lanes=n,
                              block=block)
    return corr_draws_plain(n, corr_seed, depth, block, device)


def corr_draws_plain(n: int, corr_seed, depth: int, block: int = CORR_BLOCK,
                     device=None) -> torch.Tensor:
    """``corr_draws`` in int64 rounds on any device: the plain version."""
    tab = block_uniform_table_plain(-(-n // block), corr_seed, depth, device)
    return torch.repeat_interleave(tab[:, :CORR_DRAWS], block, dim=0)[:n]
