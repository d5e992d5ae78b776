"""Engine: frame orchestration, progressive accumulation, invalidation
(port of ``vkrt_tpu/engine.py``): hybrid mode (the default, ``rt_mode`` 0:
G-buffer, ray-traced shadows, AO and one-path GI, optionally denoised) and
path mode (``rt_mode`` 1). Untextured and baseColor-only scenes bounce
through kernels A and B, other textured scenes and alpha-tested ones
(``alpha_test`` on a scene with a MASK or BLEND material) through kernel A
and the general shading loop.

Owns the scene, tracer, camera state, accumulation buffers, the hybrid
G-buffer, the denoiser's history and the frame counter, and exposes
``render_frame()``. The reset rules:

* ``update_frame``: bump the counter, reset when the camera changed
  (hello_vulkan.cpp:1506-1521); the denoiser's history stays, since
  reprojection is what carries it across a camera move;
* ``reset_frame``: frame = -1 (hello_vulkan.cpp:1501-1504), so the next
  update makes it 0;
* any settings change resets accumulation (main.cpp:103-104, 463-464); a
  change of a field in ``_BUFFER_FIELDS`` or a resize also reallocates the
  buffers and the denoiser's history;
* max-frames early-out: when limiting is on and frame >= maxFrames the
  frame is not re-rendered (hello_vulkan.cpp:1426-1430); hybrid mode
  renders once first when it has no G-buffer to show;
* ``set_node_transform`` (an engine built from an ``InstancedScene``)
  re-poses one node, rebinds the tracer (kernel A's refits its tables,
  the ``bvh`` backend rebuilds its LBVH on the device) and resets the
  frame; the
  denoiser's history stays, as a camera move keeps it.

A frame runs under a ``pass_label`` ("pathtrace" or "hybrid"), a named
range in torch.profiler traces around all of it (the seeds, the pass, the
composite), and a re-pose under "repose"; inside
``utils.profiling.nan_debug`` a non-finite composite raises.

Pixels run in 32x32-tile order (``utils.camera.tile_perm``) with seeds of
the original pixel id, ``tea(pid, frame)``, so a pixel's radiance does not
depend on the layout; ``render_frame`` un-tiles for display.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vkrt_tpu_torch.config import DEFAULT_CLEAR_COLOR, RenderSettings
from vkrt_tpu_torch.models import post as post_mod
from vkrt_tpu_torch.models import denoiser as dn
from vkrt_tpu_torch.models.hybrid import hybrid_frame
from vkrt_tpu_torch.models.pathtracer import pathtrace_frame
from vkrt_tpu_torch.ops.rng import tea
from vkrt_tpu_torch.ops.trace import make_tracer
from vkrt_tpu_torch.scene import SceneTensors
from vkrt_tpu_torch.utils import profiling
from vkrt_tpu_torch.utils.camera import Camera, pixel_coords, tile_perm, untile

# a change of any of these reallocates the buffers (the JAX engine's
# re-jit list); the display and clamp knobs and the frame limit do not
_BUFFER_FIELDS = ("samples", "depth", "rt_mode", "use_shadows", "use_ao", "use_gi",
                  "use_denoiser", "temporal_denoiser", "backend", "alpha_test",
                  "corr_sampler")


class Engine:
    def __init__(
        self,
        scene,
        width: int,
        height: int,
        settings: RenderSettings = RenderSettings(),
        camera: Camera = Camera(),
        clear_color=DEFAULT_CLEAR_COLOR,
    ):
        """``scene``: a ``SceneTensors``, or an ``InstancedScene``
        (``scene_instances``), whose nodes ``set_node_transform`` moves."""
        self.instances = None
        if not isinstance(scene, SceneTensors):  # an InstancedScene
            self.instances = scene
            scene = scene.scene
        self.scene = scene
        self.device = scene.device
        self.width = width
        self.height = height
        self.settings = settings
        self.camera = camera
        self.clear_color = tuple(float(c) for c in clear_color)
        self.tracer = self._make_tracer()
        self.frame = -1
        self._ref_cam: Optional[Camera] = None
        self._total_rays = torch.zeros((), dtype=torch.float32, device=self.device)
        self._alloc_buffers()

    @property
    def total_rays(self) -> float:
        """Total rays traced. Reading syncs with the device: fetch once per
        run, not per frame."""
        return float(self._total_rays)

    @total_rays.setter
    def total_rays(self, value: float):
        self._total_rays = torch.tensor(float(value), dtype=torch.float32,
                                        device=self.device)

    def _make_tracer(self):
        s = self.settings
        tri = self.instances.tri_arrays() if self.instances is not None else None
        return make_tracer(self.scene, s.backend, alpha=s.alpha_test, tri_arrays=tri)

    def _alloc_buffers(self):
        n = self.width * self.height
        perm, inv = tile_perm(self.width, self.height)
        self._perm = torch.as_tensor(perm.astype(np.int64), device=self.device)
        self._inv_perm = torch.as_tensor(inv.astype(np.int64), device=self.device)
        self._pix = pixel_coords(self.width, self.height, self.device)[self._perm]
        self.accum = torch.zeros((n, 3), dtype=torch.float32, device=self.device)  # path
        self.accum_rt = torch.zeros((n, 4), dtype=torch.float32, device=self.device)  # hybrid
        self.gbuffer = None  # hybrid G-buffer of the last rendered frame
        s = self.settings
        self.denoise_state = (
            dn.init_state(self.width, self.height, self.device)
            if s.rt_mode == 0 and s.use_denoiser and s.use_gi and s.temporal_denoiser
            else None)

    def _untile(self, out):
        if self.width % 32 == 0:
            return untile(out, self.width, self.height)
        return out[self._inv_perm]

    def reset_frame(self):
        """hello_vulkan.cpp:1501-1504."""
        self.frame = -1

    def update_frame(self):
        """Reset accumulation on camera change (hello_vulkan.cpp:1506-1521)."""
        if self._ref_cam != self.camera:
            self.reset_frame()
            self._ref_cam = self.camera
        self.frame += 1

    def update_settings(self, settings: RenderSettings):
        """Apply new settings: any change resets the frame; a change of a
        ``_BUFFER_FIELDS`` field reallocates the buffers (returns True then),
        of the backend or ``alpha_test`` rebuilds the tracer."""
        if settings == self.settings:
            return False
        old, self.settings = self.settings, settings
        if (settings.backend, settings.alpha_test) != (old.backend, old.alpha_test):
            self.tracer = self._make_tracer()
        realloc = any(getattr(settings, f) != getattr(old, f) for f in _BUFFER_FIELDS)
        if realloc:
            self._alloc_buffers()
        self.reset_frame()  # any UI change calls resetFrame (main.cpp:103)
        return realloc

    def set_node_transform(self, prim_idx: int, world_matrix):
        """Re-pose one scene node (the reference's instance-transform
        update, createTopLevelAsGltf hello_vulkan.cpp:1031-1047): re-bake
        the primitive into the scene tensors and rebind the tracer
        (``scene_instances.repose_tracer``: kernel A's tables are refit, the
        cost scaling with the moved subset and no SAH build; the ``bvh``
        backend's LBVH is rebuilt on the device). Resets the frame; the
        denoiser's history stays. Needs an engine built from an
        ``InstancedScene``."""
        if self.instances is None:
            raise ValueError("engine was not built from an InstancedScene; load via "
                             "scene_instances.load_scene_instanced to enable re-posing")
        from vkrt_tpu_torch import scene_instances as si

        with profiling.pass_label("repose"):
            self.instances, moved = si.repose(self.instances, prim_idx, world_matrix)
            self.scene = self.instances.scene
            self.tracer = si.repose_tracer(self.tracer, self.instances, moved)
        self.reset_frame()  # geometry changed: restart accumulation

    def resize(self, width: int, height: int):
        """onResize (hello_vulkan.cpp:620-626)."""
        self.width, self.height = width, height
        self.reset_frame()
        self._alloc_buffers()

    def render_frame(self) -> torch.Tensor:
        """One main-loop iteration. Returns the linear composite (N,3) in
        scanline order."""
        # named range in device traces around the whole frame: the
        # reference's beginLabel / endLabel (hello_vulkan.cpp:587,
        # 1432-1447, 1459)
        with profiling.pass_label("pathtrace" if self.settings.rt_mode == 1 else "hybrid"):
            return self._frame()

    def _frame(self) -> torch.Tensor:
        self.update_frame()
        s = self.settings
        at_limit = s.stop_at_max_frames and self.frame >= s.max_frames
        if s.rt_mode == 0 and self.gbuffer is None:
            at_limit = False  # nothing to show yet: render once first
        if not at_limit:
            cam = self.camera.matrices(self.width, self.height, self.device)
            seeds = tea(self._perm, self.frame)  # original pixel ids
            kw = dict(width=self.width, height=self.height, depth=s.depth,
                      clamp_weights=bool(s.clamp_weights), corr=s.corr_sampler,
                      pix=self._pix, seeds=seeds)
            if s.rt_mode == 1:
                self.accum, rays = pathtrace_frame(
                    self.scene, self.tracer, cam, self.frame, self.accum,
                    self.clear_color, samples=s.samples, **kw)
            else:
                self.gbuffer, self.accum_rt, rays, self.denoise_state = hybrid_frame(
                    self.scene, self.tracer, cam, self.frame, self.accum_rt,
                    self.clear_color, use_shadows=s.use_shadows, use_ao=s.use_ao,
                    use_gi=s.use_gi, use_denoiser=s.use_denoiser, perm=self._perm,
                    inv_perm=self._inv_perm, denoise_state=self.denoise_state, **kw)
            self._total_rays = self._total_rays + rays
        if s.rt_mode == 1:
            out = post_mod.composite(self.accum, None, rt_mode=1,
                                     view_accumulated=s.view_accumulated, use_gi=s.use_gi)
        else:
            out = post_mod.composite(self.gbuffer.color[:, :3], self.accum_rt, rt_mode=0,
                                     view_accumulated=s.view_accumulated, use_gi=s.use_gi)
        out = self._untile(out)
        if profiling.nan_debug_enabled():
            profiling.check_finite(out, f"frame {self.frame}")  # one device read
        return out

    def render(self, frames: int = 1) -> np.ndarray:
        """Render ``frames`` progressive frames, return (H,W,3) uint8."""
        out = None
        for _ in range(frames):
            out = self.render_frame()
        return post_mod.to_u8_image(out, self.width, self.height)
