"""Checkpoint and resume for progressive renders (port of
``vkrt_tpu/utils/checkpoint.py``).

The reference's only persistent state is the in-memory accumulation image
and frame counter, reset on any camera or setting change
(hello_vulkan.cpp:1501-1521) and lost on exit. Here that state is saved and
restored, keyed by a validity fingerprint (scene, camera, settings,
resolution), so a long converging render survives a process restart. Plain
.npz: the state is a handful of arrays, and the fingerprint check stands
in for versioning.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch


def _geometry(engine) -> np.ndarray:
    """The scene's ``tri_v0`` on the host: an ``InstancedScene``'s mirror
    when the engine has one, else one read of the device."""
    inst = getattr(engine, "instances", None)
    if inst is not None and inst.host is not None:
        return inst.host["tri_v0"]
    return engine.scene.tri_v0.cpu().numpy()


def _fingerprint(engine) -> str:
    """Hash everything that invalidates accumulation when changed."""
    parts = {
        # the buffers live in tile order (engine._alloc_buffers); the tag
        # rejects checkpoints from layouts that ordered pixels differently
        "layout": "tile32",
        "settings": dataclasses.asdict(engine.settings),
        "camera": {k: np.asarray(v).tolist()
                   for k, v in dataclasses.asdict(engine.camera).items()},
        "clear": [float(c) for c in engine.clear_color],
        "size": [engine.width, engine.height],
        "scene": [
            int(engine.scene.num_tris),
            int(engine.scene.num_lights),
            # the geometry's bytes (a float sum collides trivially: any
            # permutation or compensating move of vertices preserves it)
            hashlib.sha256(np.ascontiguousarray(_geometry(engine)).tobytes()).hexdigest(),
        ],
    }
    return hashlib.sha256(json.dumps(parts, sort_keys=True).encode()).hexdigest()


def save(engine, path: str) -> None:
    """Persist the accumulation state, the frame counter and the temporal
    denoiser's history (its reprojection buffers and moments are
    convergence state: without them a resumed fly-through restarts the
    filter from history length 0)."""
    dn = {}
    if engine.denoise_state is not None:
        dn = {f"dn_{k}": v.cpu().numpy() for k, v in engine.denoise_state._asdict().items()}
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp,
        fingerprint=np.frombuffer(_fingerprint(engine).encode(), np.uint8),
        frame=np.int64(engine.frame),
        total_rays=np.float64(engine.total_rays),
        accum=engine.accum.cpu().numpy(),
        accum_rt=engine.accum_rt.cpu().numpy(),
        **dn,
    )
    os.replace(tmp, path)


def restore(engine, path: str, strict: bool = True) -> bool:
    """Load the state into the engine. Returns True on success.

    ``strict``: refuse state whose fingerprint (scene, camera, settings,
    size) does not match the engine: resuming mismatched state would blend
    incompatible images."""
    if not os.path.exists(path):
        return False
    data = np.load(path)
    if strict and bytes(data["fingerprint"]).decode() != _fingerprint(engine):
        return False

    def put(a):
        return torch.as_tensor(a, device=engine.device)

    engine.frame = int(data["frame"])
    engine.total_rays = float(data["total_rays"])
    engine.accum = put(data["accum"])
    engine.accum_rt = put(data["accum_rt"])
    if engine.denoise_state is not None and "dn_hist_rad" in data.files:
        engine.denoise_state = type(engine.denoise_state)(
            **{k: put(data[f"dn_{k}"]) for k in engine.denoise_state._fields})
    # pin the camera reference so the next update_frame does not reset
    engine._ref_cam = engine.camera
    return True
