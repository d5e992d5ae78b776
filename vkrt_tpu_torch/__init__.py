"""vkrt_tpu_torch — the PyTorch + CUDA port of ``vkrt_tpu``.

Module paths mirror ``vkrt_tpu/``: each module here has one reference twin
in the JAX package and is tested against it on the same inputs. Plain
tensor code is PyTorch; the Pallas kernels of the JAX package are
hand-written CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at first
use and bound with ``ctypes`` (``device.py``).

Subpackages
-----------
``vkrt_tpu_torch.utils``       camera, glTF, PNG, the native SAH BVH builder
``vkrt_tpu_torch.ops``         RNG, intersection, trace backends, textures,
                               sampling, BRDF, NRD packing, CUDA kernels
``vkrt_tpu_torch.models``      path tracer, shading, G-buffer, hybrid, post
``vkrt_tpu_torch.benchmarks``  trace-kernel probes (launch floor, ablations,
                               traversal variants, FP32 FMA peak)

This package imports ``torch`` and never ``jax`` or ``vkrt_tpu``: it keeps
its own copies of the JAX package's host modules (``config``,
``utils/gltf``, ``utils/png``, ``utils/native`` with its builder source in
``native/``). Entry points run on the card unless the caller passes
``device="cpu"`` (``--device cpu``).
"""

__version__ = "0.1.0"
