"""Port vs JAX package: ``shade_plain`` (the plain version of the CUDA shade
kernel) against the Pallas ``shade_call`` in interpret mode, bounce by
bounce, on the same inputs.

The inputs are real bounce states: a 64x32 Cornell frame (2048 lanes, two
correlated-sampler blocks) traced and shaded by the port. The JAX leg gets
them packed into its (R, K*128) blocks, its resolve block built in numpy
from the same (t, tri, u, v). Tolerances (as tests/test_shade_kernel.py):
the active and do_shadow masks equal on >= 99.5% of lanes, seeds
bit-exact there, float columns with mean abs diff < 1e-3 and > 1e-3 on
< 1% of lanes."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vkrt_tpu.scene as jscene
from vkrt_tpu.ops.pallas.shade import (
    shade_call, scene_tables as j_scene_tables, xla_albedo_block,
)
from vkrt_tpu.ops.rng import block_table_rep as j_block_table_rep
from vkrt_tpu.utils.camera import tile_perm
from vkrt_tpu_torch.models.pathtracer import corr_seed_for
from vkrt_tpu_torch.ops.cuda.shade import (
    C_ACTIVE, C_PSH, ShadeParams, clamp_bounds, scene_tables, shade, shade_plain,
)
from vkrt_tpu_torch.ops.intersect import T_MAX, T_MIN
from vkrt_tpu_torch.ops.rng import block_uniform_table, rnd, tea
from vkrt_tpu_torch.ops.trace import Tracer
from vkrt_tpu_torch.scene import scene_from_numpy
from vkrt_tpu_torch.utils.camera import Camera, generate_rays, orbit_camera, pixel_coords

torch.set_num_threads(2)
W, H = 64, 32
N = W * H
LANES = 128
CLEAR = (0.9, 0.8, 0.7)
FRAME = 1


def _states(ts, corr: bool, cam=Camera(), albedo: bool = False):
    """Per bounce d = 0..2: (carry, seed, rays, hit, prev shadow tri) as
    the port's loop feeds its shade step."""
    perm, _ = tile_perm(W, H)
    pid = torch.from_numpy(perm.astype(np.int64))
    seed = tea(pid, FRAME)
    seed, r1 = rnd(seed)
    seed, r2 = rnd(seed)
    o, d = generate_rays(cam.matrices(W, H), W, H, torch.stack([r1, r2], -1),
                         pix=pixel_coords(W, H)[pid])
    rays = torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                        torch.full((N,), T_MAX)])
    carry = torch.zeros((14, N))
    carry[0:3] = 1.0
    carry[C_ACTIVE] = 1.0
    tracer = Tracer(ts)
    mat_tab, light_tab = scene_tables(ts)
    lo, hi = clamp_bounds(True)
    sh_tri = None
    out = []
    for dd in range(3):
        hit = tracer.trace_block(rays)
        tab = (block_uniform_table(N // 1024, corr_seed_for(FRAME, 0), dd)
               if corr else None)
        out.append((carry, seed, rays, hit, sh_tri, tab))
        p = ShadeParams(d=dd, first=dd == 0, resolve_hd=dd == 2,
                        hitdist_weight=1.0, hitdist_accumulate=True,
                        t_min=T_MIN, t_max=T_MAX, clear=CLEAR,
                        clamp_lo=lo, clamp_hi=hi, albedo=albedo)
        carry, seed, rays, shadow = shade(carry, seed, rays, hit, sh_tri, ts,
                                          mat_tab, light_tab, tab, p)
        sh_tri = tracer.trace_block(shadow).tri
    return out


@pytest.fixture(scope="module")
def scenes():
    js = jscene.make_cornell_box()
    ts = scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu")
    return js, ts, {c: _states(ts, c) for c in (True, False)}


def _pack(cols) -> np.ndarray:
    """(K, N) lane columns -> the JAX (N/128, K*128) packed block."""
    return np.concatenate([np.asarray(c).reshape(-1, LANES) for c in cols], axis=1)


def _unpack(block: np.ndarray, k: int) -> np.ndarray:
    return block[:, k * LANES:(k + 1) * LANES].reshape(-1)


def _resolve_block(js, hit) -> np.ndarray:
    """The Pallas resolve layout [t | idx | u | v | nrm | tan | tw | uv |
    mat] from (t, tri, u, v), interpolated as the trace kernel does."""
    t, tri, u, v = (x.numpy() for x in hit)
    is_hit = tri >= 0
    safe = np.where(is_hit, tri, 0)
    uu, vv = u[:, None], v[:, None]

    def interp(c):
        c = np.asarray(c)[safe]
        val = c[:, 0] + uu * (c[:, 1] - c[:, 0]) + vv * (c[:, 2] - c[:, 0])
        return np.where(is_hit[:, None], val, 0.0).astype(np.float32)

    nrm = interp(js.corner_normal)
    tg = interp(np.asarray(js.corner_tangent)[:, :, :3])
    tw = np.where(is_hit, np.asarray(js.corner_tangent)[safe, 0, 3], 0.0)
    uv = interp(js.corner_uv)
    mat = np.where(is_hit, np.asarray(js.tri_mat)[safe], 0).astype(np.float32)
    cols = [t, tri.view(np.float32), u, v, *nrm.T, *tg.T, tw, *uv.T, mat]
    return _pack([np.asarray(c, np.float32) for c in cols])


CASES = [  # (d, first, resolve_hd)
    (0, True, False), (1, False, False), (2, False, True),
    (1, True, False), (2, False, False),
]


@pytest.mark.parametrize("corr", [True, False])
@pytest.mark.parametrize("d,first,resolve_hd", CASES)
def test_shade_plain_matches_pallas(scenes, corr, d, first, resolve_hd):
    js, ts, states = scenes
    _check_against_pallas(js, ts, states[corr][d], corr, d, first, resolve_hd)


@pytest.fixture(scope="module")
def city():
    js = jscene.make_city(grid=4)
    ts = scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu")
    cam = orbit_camera(0.12, radius=14.0, height=5.0)
    return js, ts, {c: _states(ts, c, cam, albedo=True) for c in (True, False)}


@pytest.mark.parametrize("corr", [True, False])
def test_shade_plain_albedo_matches_pallas(city, corr):
    """The albedo branch (baseColor-only scenes) on bounce 1 of a
    make_city(grid=4) frame, against ``shade_call(..., albedo=
    xla_albedo_block(...))``: the texel fetch moves into the shade step."""
    js, ts, states = city
    from vkrt_tpu_torch.scene import scene_base_only_textured

    assert scene_base_only_textured(ts)
    _check_against_pallas(js, ts, states[corr][1], corr, 1, False, False, albedo=True)


def _check_against_pallas(js, ts, state, corr, d, first, resolve_hd, albedo=False):
    carry, seed, rays, hit, sh_tri, tab = state
    if not first and sh_tri is None:
        pytest.fail("a non-first bounce needs the previous shadow verdicts")
    lo, hi = clamp_bounds(True)
    p = ShadeParams(d=d, first=first, resolve_hd=resolve_hd, hitdist_weight=1.0,
                    hitdist_accumulate=True, t_min=T_MIN, t_max=T_MAX,
                    clear=CLEAR, clamp_lo=lo, clamp_hi=hi, albedo=albedo)
    mat_tab, light_tab = scene_tables(ts)
    got = shade_plain(carry, seed, rays, hit, None if first else sh_tri, ts,
                      mat_tab, light_tab, tab, p)

    # --- the JAX leg on the same inputs ---
    jmat, jlight = j_scene_tables(js)
    params = np.zeros((1, 8), np.float32)
    params[0, :3] = CLEAR
    params[0, 3:5] = (lo, hi)
    if corr:
        jtab = np.asarray(j_block_table_rep(N // 1024, jnp.uint32(corr_seed_for(FRAME, 0)), d))
        np.testing.assert_array_equal(jtab, tab.numpy())
        params = np.concatenate([params, jtab])
    carry_j = _pack([seed.numpy().view(np.float32), *carry.numpy()])
    sh_blk = None
    if not first:
        tri = sh_tri.numpy()
        sh_blk = jnp.asarray(_pack([np.zeros(N, np.float32), tri.view(np.float32),
                                    np.zeros(N, np.float32), np.zeros(N, np.float32)]))
    res_blk = jnp.asarray(_resolve_block(js, hit))
    c2, nx, sh = shade_call(
        jmat, jlight, jnp.asarray(params), jnp.asarray(carry_j),
        jnp.asarray(_pack(rays.numpy())), res_blk,
        d=d, first=first, resolve_hd=resolve_hd, n_mats=int(jmat.shape[0]),
        n_lights=int(jlight.shape[0]), hitdist_weight=1.0,
        hitdist_accumulate=True, t_min=T_MIN, t_max=T_MAX, interpret=True,
        trace_out_shadow=sh_blk, corr=corr,
        albedo=xla_albedo_block(js, res_blk) if albedo else None,
    )
    c2, nx, sh = np.asarray(c2), np.asarray(nx), np.asarray(sh)

    # masks, then seeds bit-exact on the lanes whose masks agree
    act_j, act_t = _unpack(c2, 1 + C_ACTIVE) > 0, got.carry[C_ACTIVE].numpy() > 0
    psh_j, psh_t = _unpack(c2, 1 + C_PSH) > 0, got.carry[C_PSH].numpy() > 0
    agree = (act_j == act_t) & (psh_j == psh_t)
    assert agree.mean() >= 0.995, agree.mean()
    assert act_t.mean() > 0.3 if d == 0 else act_t.any()
    seed_j = _unpack(c2, 0).view(np.uint32)
    np.testing.assert_array_equal(got.seed.numpy().view(np.uint32)[agree], seed_j[agree])

    pairs = [(got.carry[k].numpy(), _unpack(c2, 1 + k)) for k in range(14)]
    pairs += [(got.next_rays[k].numpy(), _unpack(nx, k)) for k in range(7)]
    pairs += [(got.shadow_rays[k].numpy(), _unpack(sh, k)) for k in range(7)]
    for k, (a, b) in enumerate(pairs):
        same = (a == b) | (np.isnan(a) & np.isnan(b))
        diff = np.where(same, 0.0, np.abs(a.astype(np.float64) - b))
        assert diff.mean() < 1e-3, (k, diff.mean())
        assert (diff > 1e-3).mean() < 0.01, (k, (diff > 1e-3).mean())
    if albedo:  # the fetched texels move the shading: the branch is live
        plain = shade_plain(carry, seed, rays, hit, None if first else sh_tri, ts,
                            mat_tab, light_tab, tab, p._replace(albedo=False))
        moved = (plain.carry[:3] != got.carry[:3]).any(0).float().mean()
        assert moved > 0.05, moved
