"""The port's hybrid mode against the JAX package on the Cornell box at
64x48 (the JAX leg eager, on its brute-force tracer):

* the GI chain, ``bounce_chain(start_depth=1, hitdist_accumulate=False)``, with
  a GI-like carry (non-unit weights, an ``is_specular`` carry, a ray count
  already in ``rays_main``, a zero clear colour) at depth 2 and 4, through
  the packed loop (kernel B's plain version) and the general loop, sampler
  on: seeds and ray counts bit for bit, radiance within 1e-4
  relative (1e-5 absolute), hit distances within 1e-5;
* ``hybrid_effects`` on one G-buffer: shadows only, AO only, GI only and
  all three, sampler on and off: seeds and rays exact,
  ``diff_rad_hitd`` within 1e-5, the accumulated RGBA through the display
  gate of tests/test_accuracy_oracle.py:83-88.

Module-level parity runs the port against the same hits (``JaxTracer``);
the engine runs of ``test_torch_hybrid_engine.py`` use the port's own
tracer."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vkrt_tpu.scene as jscene
import vkrt_tpu_torch.models.pathtracer as tpt
from test_torch_gbuffer import JaxTracer, port_scene
from test_torch_pathtracer import display_gate
from vkrt_tpu.models.gbuffer import gbuffer_pass as j_gbuffer_pass
from vkrt_tpu.models.hybrid import hybrid_effects as j_hybrid_effects
from vkrt_tpu.models.pathtracer import BounceCarry as JCarry, bounce_chain as j_bounce_chain
from vkrt_tpu.ops.rng import seed_pixels as j_seed_pixels
from vkrt_tpu.ops.trace import make_tracer as j_make_tracer
from vkrt_tpu.utils.camera import Camera as JCamera
from vkrt_tpu_torch.models.gbuffer import GBuffer
from vkrt_tpu_torch.models.hybrid import hybrid_corr_seed, hybrid_effects
from vkrt_tpu_torch.models.pathtracer import BounceCarry
from vkrt_tpu_torch.utils.camera import camera_from_numpy

torch.set_num_threads(2)
W, H = 64, 48
N = W * H
FRAME = 1
CLEAR = (1.0, 1.0, 1.0, 1.0)


@pytest.fixture(scope="module")
def box():
    """The JAX Cornell box, its brute-force tracer, camera matrices and
    G-buffer; the port's scene."""
    js = jscene.make_cornell_box()
    jt = j_make_tracer(js, "auto")
    jm = JCamera().matrices(W, H)
    jg = j_gbuffer_pass(js, jt, jm, W, H, jnp.asarray(CLEAR))
    return dict(js=js, jt=jt, jm=jm, jg=jg, ts=port_scene(js))


def _gi_carry(jg):
    """A GI-like carry as numpy arrays: G-buffer origins, a seeded lobe per
    lane (30% specular: a mirror direction and unit weight; else a
    direction in the normal's hemisphere and the albedo as weight), random
    seeds, and the visibility rays of a frame already in ``rays_main``."""
    rng = np.random.default_rng(11)
    pos, nrm = np.asarray(jg.position[:, :3]), np.asarray(jg.normal[:, :3])
    albedo = np.stack([np.asarray(jg.color[:, 3]), np.asarray(jg.position[:, 3]),
                       np.asarray(jg.normal[:, 3])], -1)
    shaded = ~((pos == 0).all(-1) & (nrm == 0).all(-1))
    spec = rng.random(N) < 0.3
    diffuse_dir = nrm + rng.normal(size=(N, 3))
    view = np.array([0.0, 0.0, -1.0])
    mirror = view - 2.0 * (nrm @ view)[:, None] * nrm  # reflect(view, n)
    direction = np.where(spec[:, None], mirror, diffuse_dir)
    direction /= np.maximum(np.linalg.norm(direction, axis=1, keepdims=True), 1e-9)
    return dict(
        origin=pos.astype(np.float32), direction=direction.astype(np.float32),
        seed=rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32),
        cur_weight=np.where(spec[:, None], 1.0, albedo).astype(np.float32),
        hit_value=np.zeros((N, 3), np.float32), active=shaded, is_specular=spec,
        light_dist=np.zeros(N, np.float32), hit_dists=np.zeros(N, np.float32),
        rays_main=np.float32(5 * shaded.sum()), rays_shadow=np.float32(0.0),
    )


def _port_carry(c) -> BounceCarry:
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()}
    t["seed"] = torch.from_numpy(c["seed"].view(np.int32).copy())
    return BounceCarry(**t)


@pytest.fixture(scope="module")
def jax_chains(box):
    """depth -> the JAX chain's output (sampler on), computed once a depth."""
    carry = _gi_carry(box["jg"])
    cache = {}

    def get(depth):
        if depth not in cache:
            cache[depth] = j_bounce_chain(
                box["js"], box["jt"], JCarry(**{k: jnp.asarray(v) for k, v in carry.items()}),
                depth=depth, start_depth=1, clear_color=jnp.zeros(4), hitdist_weight=1.0,
                hitdist_accumulate=False, corr_seed=jnp.uint32(hybrid_corr_seed(FRAME)))
        return cache[depth]

    return carry, get


@pytest.mark.parametrize("depth", [2, 4])
@pytest.mark.parametrize("loop", ["packed", "general"])
def test_bounce_chain_from_depth_1(box, jax_chains, monkeypatch, loop, depth):
    """With the correlated sampler, as hybrid GI runs by default (per-lane
    draws reach the chain in the ``gi`` cases below)."""
    carry, jax_chain = jax_chains
    want = jax_chain(depth)
    packed_calls = []
    packed = tpt.bounce_chain_packed
    monkeypatch.setattr(tpt, "bounce_chain_packed",
                        lambda *a, **k: packed_calls.append(1) or packed(*a, **k))
    chain = tpt.bounce_chain if loop == "packed" else tpt.general_bounce_chain
    got = chain(box["ts"], JaxTracer(box["jt"]), _port_carry(carry), depth=depth,
                start_depth=1, clear_color=(0.0, 0.0, 0.0, 0.0), hitdist_weight=1.0,
                hitdist_accumulate=False, corr_seed=hybrid_corr_seed(FRAME))
    assert len(packed_calls) == (loop == "packed")
    np.testing.assert_array_equal(got.seed.numpy(), np.asarray(want.seed).view(np.int32))
    assert float(got.rays_main) == float(want.rays_main)
    assert float(got.rays_shadow) == float(want.rays_shadow) > 0
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    hv = np.asarray(want.hit_value)
    assert (hv > 0).any(-1).mean() > 0.3
    np.testing.assert_allclose(got.hit_value.numpy(), hv, rtol=1e-4, atol=1e-5)
    hd = np.asarray(want.hit_dists)
    assert (hd > 0).mean() > 0.1  # the depth-1 bookkeeping ran, overwriting
    np.testing.assert_allclose(got.hit_dists.numpy(), hd, rtol=1e-5, atol=1e-5)


EFFECTS = {"shadows": (True, False, False), "ao": (False, True, False),
           "gi": (False, False, True), "all": (True, True, True)}


@pytest.mark.parametrize("corr", [False, True])
@pytest.mark.parametrize("effects", list(EFFECTS))
def test_hybrid_effects_match_jax(box, effects, corr):
    use_shadows, use_ao, use_gi = EFFECTS[effects]
    jg = box["jg"]
    rng = np.random.default_rng(5)
    accum = rng.uniform(0, 1, (N, 4)).astype(np.float32)  # frame 1 mixes it in
    kw = dict(depth=3, use_shadows=use_shadows, use_ao=use_ao, use_gi=use_gi, corr=corr)
    j_acc, j_drh, j_seed, j_rays = j_hybrid_effects(
        box["js"], box["jt"], jg, box["jm"], j_seed_pixels(W, H, FRAME), FRAME,
        jnp.asarray(accum), **kw)
    cam = camera_from_numpy({k: np.asarray(v) for k, v in box["jm"]._asdict().items()})
    tg = GBuffer(*(torch.from_numpy(np.array(x)) for x in jg))
    seed = torch.from_numpy(np.asarray(j_seed_pixels(W, H, FRAME)).view(np.int32).copy())
    acc, drh, seed, rays = hybrid_effects(box["ts"], JaxTracer(box["jt"]), tg, cam, seed, FRAME,
                                          torch.from_numpy(accum), **kw)
    np.testing.assert_array_equal(seed.numpy(), np.asarray(j_seed).view(np.int32))
    assert float(rays) == float(j_rays) > 0
    np.testing.assert_allclose(drh.numpy(), np.asarray(j_drh), rtol=1e-5, atol=1e-5)
    assert drh.numpy().any() == use_gi
    want = np.asarray(j_acc, np.float64)
    display_gate(acc.numpy().astype(np.float64), want)
    new_alpha = 2.0 * want[:, 3] - accum[:, 3]  # frame 1 mixes half and half
    if use_shadows or use_ao:
        assert (new_alpha < 0.99).mean() > 0.02
    else:
        np.testing.assert_allclose(new_alpha, 1.0, atol=1e-6)
