"""Acceleration structures built on the device (port of ``vkrt_tpu/bvh``)."""
