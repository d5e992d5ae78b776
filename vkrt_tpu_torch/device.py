"""Device choice and the CUDA kernels' build and load.

``csrc/*.cu`` (with the headers ``csrc/*.cuh``) compile with ``nvcc`` into
``build/libvkrt_kernels.so`` at the first CUDA launch, keyed by a hash of
the sources and flags, and load with ``ctypes``. Each source compiles in
its own ``nvcc`` process, all started together, and one ``nvcc`` links the
objects. Each C entry point takes plain pointers and the CUDA stream and
returns ``cudaGetLastError()``; ``check`` turns a non-zero code into an
exception.

Every kernel wrapper takes the same path to its kernel: ``check_args``
refuses the tensors the kernel cannot read, then ``launch`` calls the entry
point with the tensor's card made current (the runtime launches on the
current card, so a tensor on another card than the current one would
otherwise get its kernel, and its stream, on the wrong card) and counts
the launch and its lanes in ``counts``, by entry point, and kernel B's
albedo instantiation also in a row of its own. A wrapper whose plain CPU
version takes only what the kernel takes refuses there with
``check_tensors``, the device-independent part of ``check_args``. Nothing here runs at import: the
CPU tests import every module of the package on a machine with no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
LIB_PATH = BUILD / "libvkrt_kernels.so"
# no --use_fast_math: it changes sqrt, division, sin and cos
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_U = ctypes.c_uint32

# argtypes of every C entry point, in the order of its parameters
_SIGNATURES = {
    "vkrt_trace": [
        _P, _P, _I,          # node records (I, 16), tri records (L, 12), tree depth
        _P, _L, _L,          # o, stride lane, stride component
        _P, _L, _L,          # d, stride lane, stride component
        _P, _I, _F, _I,      # t_lim, n, t_min, any_hit
        _P, _P, _P, _P,      # out t, tri, u, v
        _P,                  # stream
    ],
    "vkrt_trace_info": [     # out: registers, shared bytes, local bytes, blocks per SM
        ctypes.POINTER(_I), ctypes.POINTER(_I), ctypes.POINTER(_I), ctypes.POINTER(_I),
    ],
    "vkrt_shade": [
        _P, _P, _P,          # carry (14, N), seed (N,), rays (7, N)
        _P, _P, _P, _P,      # hit t, tri, u, v
        _P,                  # previous shadow tri (N,) or null
        _P, _P, _P,          # corner_normal, corner_tangent, tri_mat
        _P, _P, _I,          # material table, light table, n_lights
        _P,                  # corr table (G, 8) or null
        _P, _P, _P, _P,      # albedo: corner_uv, mat_base_tex, tex_rgba, tex_size (null: off)
        _I, _I,              # texture height, width (padded)
        _I, _I, _I, _I,      # n, d, first, resolve_hd
        _F, _I, _F, _F,      # hitdist weight, accumulate, t_min, t_max
        _F, _F, _F, _F, _F,  # clear rgb, clamp lo, clamp hi
        _P, _P, _P, _P,      # out carry, seed, next rays, shadow rays
        _P,                  # stream
    ],
    "vkrt_shade_info": [     # albedo 0/1; out: registers, shared, local, blocks per SM
        _I, ctypes.POINTER(_I),
    ],
    "vkrt_floor": [
        _P, _L, _L,          # o, stride lane, stride component
        _P, _L, _L,          # d, stride lane, stride component
        _P, _I, _I,          # t_lim, n, threads per block
        _P, _P, _P, _P,      # out t, tri, u, v
        _P,                  # stream
    ],
    "vkrt_fma_peak": [
        _P, _P, _I, _I,      # x, out, n, iterations (64 FMAs each)
        _P,                  # stream
    ],
    "vkrt_trace_ablate": [
        _I,                  # mode
        _P, _P, _I, _I,      # node records, tri records, tree depth, cut depth
        _P, _L, _L,          # o, stride lane, stride component
        _P, _L, _L,          # d, stride lane, stride component
        _P, _I, _F, _I,      # t_lim, n, t_min, any_hit
        _P, _P, _P, _P,      # out t, tri, u, v
        _P,                  # counts (2, N) or null
        _P,                  # stream
    ],
    "vkrt_trace_variant": [
        _I, _I, _I,          # variant, threaded tree depth, wide walk's stack need
        _P, _I,              # threaded nodes with leaf slots (M, 8), n_nodes
        _P, _I,              # wide records (W, 32), n_wide
        _P, _I,              # cut boxes (C, 8), n_cut
        _P, _P, _I,          # tri records in leaf order, in scene order, k_tris
        _P, _L, _L,          # o, stride lane, stride component
        _P, _L, _L,          # d, stride lane, stride component
        _P, _I, _F,          # t_lim, n, t_min
        _P, _P, _P, _P,      # out t, tri, u, v
        _P,                  # counts (2, N) or null (ordered only)
        _P,                  # stream
    ],
    "vkrt_trace_variant_info": [  # variant; out: registers, shared, local, blocks per SM
        _I, ctypes.POINTER(_I),
    ],
    "vkrt_rng_tea": [
        _P, _I, _U,          # val0, val0 is int64 (else int32), val1
        _I, _I, _P,          # rounds, n, out (n,) int32 bits
        _P,                  # stream
    ],
    "vkrt_rng_table": [
        _U, _U, _I,          # corr_seed, depth, rows
        _P, _P, _I, _I,      # out table (rows, 8) or null, out lanes (n, 6) or null, n, block
        _P,                  # stream
    ],
    "vkrt_tex_level0": [
        _P, _P, _I, _I,      # tex_rgba (K, TH, TW, 4) f32, tex_size (K, 2), TH, TW
        _P, _I,              # index (N,), is int64 (else int32)
        _P, _I, _P,          # uv (N, 2), n, out (N, 4) f32
        _P,                  # stream
    ],
    "vkrt_tex_lod": [
        _P, _I,              # atlas (K, TH, 2TW, 4), is bf16 (else f32)
        _P, _P, _P, _I,      # level_size (K, L, 2), level_off (K, L), n_levels (K,), L
        _I, _I,              # TH, 2TW
        _P, _I,              # index (N,), is int64 (else int32)
        _P, _P,              # uv (N, 2), lod (N,)
        _I, _P,              # n, out (N, 4) f32
        _P,                  # stream
    ],
    "vkrt_tex_aniso": [
        _P, _I,              # atlas (K, TH, 2TW, 4), is bf16 (else f32)
        _P, _P, _P, _I,      # level_size (K, L, 2), level_off (K, L), n_levels (K,), L
        _I, _I,              # TH, 2TW
        _P, _I,              # index (N,), is int64 (else int32)
        _P, _P, _P,          # uv, ddx_uv, ddy_uv (N, 2) each
        _I, _I, _P,          # taps, n, out (N, 4) f32
        _P,                  # stream
    ],
    "vkrt_denoise_atrous": [
        _P, _P, _P,          # radiance (H, W, 3), its top and bottom halo rows (k, W, 3)
        _P, _P, _P,          # normal, the same
        _P, _P, _P,          # view_z (H, W), halos (k, W)
        _P, _P, _P,          # variance, halos, or null
        _P, _P,              # raw hit distance (H * W,) or null, tap table (host, 78 f32)
        _I, _I, _I,          # width, height, step
        _P, _P,              # out radiance, out variance (null without)
        _P,                  # stream
    ],
    "vkrt_denoise_temporal": [
        _P, _P, _P,          # packed radiance (rows, W, 4), the rows above and below (1, W, 4)
        _P, _P,              # norm_rough (rows * W, 4), view_z
        _P, _L, _L,          # world_pos, stride lane, stride component
        _P,                  # the history's view_proj (4, 4)
        _P, _P, _P, _P, _P, _P,  # hist rad, m1, m2, len, prev view_z, prev normal (frame)
        _I, _I, _I,          # width, height, rows
        _F, _F, _F,          # max history, depth reject, normal reject
        _P, _P, _P, _P,      # out rad_acc, variance, hit distance, m1
        _P, _P, _P, _P,      # out m2, length, |view_z|, normal
        _P,                  # stream
    ],
}


# the row kernel B's albedo instantiation counts in, besides vkrt_shade's
SHADE_ALBEDO = "vkrt_shade.albedo"

# launches and lanes handed to each launching entry point (and to the
# instantiation rows) since the last reset_counts(), successful launches only
counts = {name: {"launches": 0, "lanes": 0} for name in (
    *(n for n in _SIGNATURES if not n.endswith("_info")), SHADE_ALBEDO)}


def reset_counts() -> None:
    """Set every entry point's counts to 0."""
    for c in counts.values():
        c["launches"] = c["lanes"] = 0


def select(name: str = "cuda") -> torch.device:
    """The device to render on: ``"cuda"`` (raises when there is no card;
    nothing falls back to the CPU) or ``"cpu"`` (the kernels' plain
    versions)."""
    if name not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {name!r} (cuda or cpu)")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (the cpu device runs the plain versions)")
    return torch.device(name)


def card(dev: torch.device) -> dict:
    """{"name", "power_limit"} of the card ``dev``: the name as
    ``torch.cuda.get_device_name`` gives it, the power limit as
    ``nvidia-smi --query-gpu=power.limit --format=csv,noheader`` prints it
    (None when nvidia-smi gives nothing). On the CPU: {"name": "cpu",
    "power_limit": None}."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", str(index)], capture_output=True, text=True, timeout=60)
        limit = res.stdout.strip() if res.returncode == 0 and res.stdout.strip() else None
    except OSError:
        limit = None
    return {"name": torch.cuda.get_device_name(index), "power_limit": limit}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home is None:
        from torch.utils.cpp_extension import CUDA_HOME as cuda_home
    for cand in (os.path.join(cuda_home or "", "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _run_all(cmds):
    """Run the commands in parallel; (returncode, output) of each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def build() -> dict:
    """Compile the kernels unless the library for these sources exists:
    one ``nvcc -c`` per source, all at once, then one link. Returns
    {"seconds", "cached", "log"} (the log holds ptxas's register and spill
    report)."""
    key = source_key()
    stamp = LIB_PATH.with_suffix(".so.sha256")
    log_path = BUILD / "nvcc.log"
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == key:
        log = log_path.read_text() if log_path.exists() else ""
        return {"seconds": 0.0, "cached": True, "log": log}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    pid = os.getpid()
    objs = [BUILD / f"{p.stem}.{pid}.o" for p in _sources()]
    t0 = time.perf_counter()
    results = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(p), "-o", str(obj)]
                        for p, obj in zip(_sources(), objs)])
    tmp = BUILD / f"libvkrt_kernels.{pid}.so"
    if all(rc == 0 for rc, _ in results):
        results += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    log = "".join(out for _, out in results)
    log_path.write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    bad = [rc for rc, _ in results if rc != 0]
    if bad:
        raise RuntimeError(f"nvcc failed ({bad[0]}):\n{log}")
    os.replace(tmp, LIB_PATH)
    stamp.write_text(key)
    return {"seconds": seconds, "cached": False, "log": log}


@functools.cache
def kernels() -> ctypes.CDLL:
    """The built kernel library, with argtypes set (built at first use)."""
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def trace_info() -> dict:
    """What the compiler made of kernel A (``vkrt_trace_info``): registers
    a thread, static shared bytes a block, local-memory bytes a thread and
    the blocks an SM holds at once."""
    out = [ctypes.c_int() for _ in range(4)]
    check("vkrt_trace_info", kernels().vkrt_trace_info(*map(ctypes.byref, out)))
    return dict(zip(("registers", "shared_bytes", "local_bytes", "blocks_per_sm"),
                    (v.value for v in out)))


def variant_info(variant: int) -> dict:
    """``trace_info`` of one instantiation of kernel E
    (``vkrt_trace_variant_info``; the ids are
    ``ops/cuda/trace_variants.py::INSTANTIATIONS``)."""
    out = (_I * 4)()
    check("vkrt_trace_variant_info", kernels().vkrt_trace_variant_info(variant, out))
    return dict(zip(("registers", "shared_bytes", "local_bytes", "blocks_per_sm"), out))


def shade_info(albedo: bool) -> dict:
    """``trace_info`` of one instantiation of kernel B
    (``vkrt_shade_info``): untextured or albedo."""
    out = (_I * 4)()
    check("vkrt_shade_info", kernels().vkrt_shade_info(int(albedo), out))
    return dict(zip(("registers", "shared_bytes", "local_bytes", "blocks_per_sm"), out))


def check(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_tensors(what: str, want, strided=()) -> None:
    """Refuse tensors unless each is what a kernel reads, on any device.
    ``want``: (name, tensor, dtype or tuple of dtypes, shape) entries, the
    shape a tuple whose None entries take any length, or None for any
    shape. Every dtype is checked first (``TypeError``), then every shape
    and that each tensor is contiguous (the names in ``strided`` may be
    views; ``ValueError``). Reads no tensor's data."""
    for name, t, dtypes, _ in want:
        dtypes = dtypes if isinstance(dtypes, tuple) else (dtypes,)
        if t.dtype not in dtypes:
            names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise TypeError(f"{what}: {name} is {t.dtype}, want {names}")
    for name, t, _, shape in want:
        if shape is not None and (t.ndim != len(shape) or any(
                w is not None and s != w for s, w in zip(t.shape, shape))):
            want_shape = str(tuple(shape)).replace("None", "*")
            raise ValueError(f"{what}: {name} is {tuple(t.shape)}, want {want_shape}")
        if name not in strided and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def check_args(what: str, want, device=None, strided=()) -> torch.device:
    """``check_tensors``, then that every tensor is on ``device`` (by
    default the first tensor's), a CUDA device (``ValueError``): the
    refusals of a launch. Returns the device."""
    check_tensors(what, want, strided)
    device = torch.device(device) if device is not None else want[0][1].device
    if device.type != "cuda":
        raise ValueError(f"{what}: {device} is not a CUDA device")
    for name, t, _, _ in want:
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, the launch on {device}")
    return device


def launch(fn: str, device: torch.device, *args, lanes: int, also: str | None = None) -> None:
    """Call the C entry point ``fn`` with ``args`` and the current stream
    of ``device``, with ``device`` made the current card for the call; raise
    on a non-zero ``cudaGetLastError()``, else count the launch and its
    ``lanes`` in ``counts[fn]``, and in ``counts[also]`` where the caller
    names the instantiation it launched (``SHADE_ALBEDO``)."""
    with torch.cuda.device(device):
        check(fn, getattr(kernels(), fn)(*args, stream_ptr(device)))
    for row in (fn, also) if also else (fn,):
        counts[row]["launches"] += 1
        counts[row]["lanes"] += lanes
