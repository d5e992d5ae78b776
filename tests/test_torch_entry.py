"""``vkrt_tpu_torch/entry.py`` (the port's ``__graft_entry__.py``) and the dry
run's hybrid leg (``parallel/dryrun.py::dryrun_hybrid``), on the CPU.

* ``entry(device="cpu")``'s ``fn(*args)`` against ``__graft_entry__.entry()``'s
  run eagerly (the Cornell box, 64x48, spp 1, depth 3, the correlated
  sampler on): the display gate of tests/test_accuracy_oracle.py:83-88 and
  ray counts within 0.1%; a plain callable, not compiled;
* the hybrid + temporal-denoiser leg's rank function on 2 gloo ranks at
  32x16 (finite, non-black and rays > 0, checked in the ranks): with the
  correlated sampler off, its second frame's ray count is the unsharded
  engine's (``dryrun_multichip(4)``, the leg with the default sampler, is
  tests/test_torch_parallel_app.py's)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkrt_tpu_torch.benchmarks import accuracy
from vkrt_tpu_torch.config import RenderSettings
from vkrt_tpu_torch.engine import Engine
from vkrt_tpu_torch.entry import dryrun_multichip, entry
from vkrt_tpu_torch.parallel import dryrun
from vkrt_tpu_torch.parallel.mesh import launch
from vkrt_tpu_torch.scene import make_cornell_box

torch.set_num_threads(2)


def test_entry_matches_jax_entry():
    from __graft_entry__ import entry as jax_entry

    fn, args = entry(device="cpu")
    assert isinstance(fn, functools.partial)  # a plain callable
    cam, frame, accum, clear = args
    assert frame == 0 and accum.shape == (64 * 48, 3) and accum.device.type == "cpu"
    assert clear.tolist() == [1.0, 1.0, 1.0, 1.0]
    assert fn.keywords["corr"] == RenderSettings().corr_sampler
    out, rays = fn(*args)
    jfn, jargs = jax_entry()
    jout, jrays = jfn(*jargs)  # eager
    out, jout = out.numpy(), np.asarray(jout)
    assert np.isfinite(out).all() and float(out.max()) > 0
    assert abs(float(rays) - float(jrays)) <= 1e-3 * float(jrays), (float(rays), float(jrays))
    rec = accuracy.gate(out, jout)
    print(f"entry() against JAX's: rays {float(rays):.0f} vs {float(jrays):.0f}; {rec}")
    assert rec["ok"], rec
    np.testing.assert_array_equal(jnp.asarray(jargs[3]), clear.numpy())


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_entry_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_dryrun_reexported():
    assert dryrun_multichip is dryrun.dryrun_multichip


def test_dryrun_hybrid_rays_equal_the_unsharded_frame():
    """The leg's rank function on 2 ranks with the correlated sampler off
    (on, its tables are salted by band, a different estimator)."""
    out = launch(dryrun.dryrun_hybrid_rank, 2, 1, "cpu", 32, 16, False)
    assert out["mesh"] == {"tile": 2, "spp": 1} and (out["width"], out["height"]) == (32, 16)
    eng = Engine(make_cornell_box(device="cpu"), 32, 16,
                 RenderSettings(rt_mode=0, depth=2, use_shadows=True, use_ao=True, use_gi=True,
                                use_denoiser=True, corr_sampler=False),
                 clear_color=(1.0, 1.0, 1.0, 1.0))
    eng.render_frame()
    before = eng.total_rays
    eng.render_frame()
    assert out["rays"] == eng.total_rays - before > 0
