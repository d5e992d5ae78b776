"""ctypes binding to the port's native SAH BVH builder
(``vkrt_tpu_torch/native/bvh_builder.cpp``; the port's copy of
``vkrt_tpu/utils/native.py``, builder only).

The library is compiled at first use with the host's C++ compiler into
``vkrt_tpu_torch/build/``, keyed by a hash of the source and flags. The
flags are the same on every machine: no ``-march=native``, and no
contracted multiply-adds, so the SAH costs (and so the tree) do not depend
on the host's instruction set. (The JAX package's build uses
``-march=native``; where the host has FMA, its contracted SAH costs can
flip a split between near-equal candidates.) A failed build raises; there
is no fallback builder.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "bvh_builder.cpp"
BUILD = _PKG / "build"
LIB_PATH = BUILD / "libvkrt_native.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-ffp-contract=off")


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("no C++ compiler found for the native BVH builder (set CXX)")


def build() -> Path:
    """Compile the builder unless the library for this source exists."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    key = h.hexdigest()
    stamp = LIB_PATH.with_suffix(".so.sha256")
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == key:
        return LIB_PATH
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f"libvkrt_native.{os.getpid()}.so"
    res = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"native BVH builder failed to compile:\n{res.stdout}{res.stderr}")
    os.replace(tmp, LIB_PATH)
    stamp.write_text(key)
    return LIB_PATH


@functools.cache
def library() -> ctypes.CDLL:
    """The built builder library, with argtypes set (built at first use)."""
    lib = ctypes.CDLL(str(build()))
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.vkrt_build_bvh.restype = ctypes.c_int
    lib.vkrt_build_bvh.argtypes = [
        f32p, f32p, f32p, ctypes.c_int, ctypes.c_int, f32p, f32p, i32p, i32p,
    ]
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_sah_bvh(v0, e1, e2, leaf_size: int = 1):
    """Binned SAH flat threaded BVH. Returns (node_min, node_max, node_skip,
    node_tri) numpy arrays, or None when no triangle is non-degenerate."""
    lib = library()
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    n = len(v0)
    cap = max(2 * n - 1, 1)
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    node_skip = np.zeros(cap, np.int32)
    node_tri = np.zeros(cap, np.int32)
    m = lib.vkrt_build_bvh(
        _fp(v0), _fp(e1), _fp(e2), n, leaf_size,
        _fp(node_min), _fp(node_max), _ip(node_skip), _ip(node_tri),
    )
    if m < 0:
        raise ValueError(f"vkrt_build_bvh refused {n} triangles")
    if m == 0:
        return None
    return node_min[:m], node_max[:m], node_skip[:m], node_tri[:m]
