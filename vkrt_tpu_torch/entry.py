"""Entry points of the frame step and the dry run (the port's twin of ``__graft_entry__.py``).

``entry(device=None)`` returns ``(fn, example_args)``: ``fn`` is the
path-traced frame step of the main path (``models/pathtracer.py::
pathtrace_frame``) on the Cornell box (``make_cornell_box``) at 64x48,
spp 1, depth 3, over ``make_tracer(scene, "auto")`` (kernels A and B on
the card), with the engine's default correlated sampler; ``example_args``
is ``(cam, 0, accum, clear)``. ``fn(*example_args)`` returns ``(accum',
rays)``. It is a plain callable (no ``torch.compile``), on the card unless
the caller asks for the CPU (``device="cpu"``: the plain versions).

``dryrun_multichip`` is ``parallel/dryrun.py``'s, the sharded dry run on
CPU ranks.
"""

from __future__ import annotations

from functools import partial

import torch

from vkrt_tpu_torch.parallel.dryrun import dryrun_multichip

__all__ = ["entry", "dryrun_multichip"]

WIDTH, HEIGHT = 64, 48


def entry(device=None):
    """(fn, example_args) of the frame step; ``device`` None means the card
    (raises without one)."""
    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.device import select
    from vkrt_tpu_torch.models.pathtracer import pathtrace_frame
    from vkrt_tpu_torch.ops.trace import make_tracer
    from vkrt_tpu_torch.scene import make_cornell_box
    from vkrt_tpu_torch.utils.camera import Camera

    dev = device if isinstance(device, torch.device) else select(device or "cuda")
    scene = make_cornell_box(device=dev)
    fn = partial(pathtrace_frame, scene, make_tracer(scene, "auto"), width=WIDTH,
                 height=HEIGHT, samples=1, depth=3, corr=RenderSettings().corr_sampler)
    accum = torch.zeros((WIDTH * HEIGHT, 3), dtype=torch.float32, device=dev)
    clear = torch.tensor([1.0, 1.0, 1.0, 1.0], dtype=torch.float32, device=dev)
    return fn, (Camera().matrices(WIDTH, HEIGHT, dev), 0, accum, clear)
