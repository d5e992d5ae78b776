"""Port vs JAX package: the RNG (bit-exact) and the camera (permutations
exact, rays to 1e-6). The RNG's dispatch: CPU calls keep the int64 path,
card calls hand the kernels of ``csrc/rng.cu`` their host integers, whose
constants are this path's."""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vkrt_tpu.ops.rng as jrng
import vkrt_tpu.utils.camera as jcam
import vkrt_tpu_torch.ops.cuda.rng as crng
import vkrt_tpu_torch.ops.rng as trng
import vkrt_tpu_torch.utils.camera as tcam

torch.set_num_threads(2)

EDGE = np.array([0, 1, 5, 2**31 - 1, 2**31, 2**31 + 7, 0xFFFFFFFE, 0xFFFFFFFF],
                np.uint32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _values(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE, rng.integers(0, 2**32, n, dtype=np.uint32)])


@pytest.mark.parametrize("rounds", [8, 16])
def test_tea_bit_exact(rounds):
    a = _values(1)
    b = np.roll(_values(2), 3)
    want = np.asarray(jrng.tea(jnp.asarray(a), jnp.asarray(b), rounds=rounds))
    got = trng.tea(torch.from_numpy(a.astype(np.int64)),
                   torch.from_numpy(b.astype(np.int64)), rounds=rounds)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)
    # int32-bit inputs (how the port stores state) give the same hash
    got32 = trng.tea(torch.from_numpy(a.view(np.int32)),
                     torch.from_numpy(b.view(np.int32)), rounds=rounds)
    np.testing.assert_array_equal(_u32(got32), want)


def test_lcg_rnd_bit_exact():
    s = _values(3)
    js, jbits = jrng.lcg(jnp.asarray(s))
    ts, tbits = trng.lcg(torch.from_numpy(s.view(np.int32)))
    np.testing.assert_array_equal(_u32(ts), np.asarray(js))
    np.testing.assert_array_equal(_u32(tbits), np.asarray(jbits))
    # a chain of draws stays bit-exact (state and the f32 uniform)
    jst, tst = jnp.asarray(s), torch.from_numpy(s.view(np.int32))
    for _ in range(5):
        jst, ju = jrng.rnd(jst)
        tst, tu = trng.rnd(tst)
        np.testing.assert_array_equal(_u32(tst), np.asarray(jst))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


@pytest.mark.parametrize("frame", [0, 1, 2**31, 0xFFFFFFFF])
def test_seed_pixels_bit_exact(frame):
    want = np.asarray(jrng.seed_pixels(40, 24, frame))
    np.testing.assert_array_equal(_u32(trng.seed_pixels(40, 24, frame)), want)


@pytest.mark.parametrize("corr_seed", [0, 2**31, 0xFFFFFFFF, 0x9E3779B9])
@pytest.mark.parametrize("depth", [0, 1, 2, 64, 67, 72])  # 64+: hybrid's pre-chain draws
def test_corr_tables_bit_exact(corr_seed, depth):
    want = np.asarray(jrng.block_uniform_table(13, jnp.uint32(corr_seed), depth))
    got = trng.block_uniform_table(13, corr_seed, depth)
    np.testing.assert_array_equal(got.numpy(), want)
    # the table JAX's shade step reads (its block_table_rep) is this one
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jrng.block_table_rep(13, jnp.uint32(corr_seed), depth)))
    n = 3 * 1024 + 77
    np.testing.assert_array_equal(
        trng.corr_draws(n, corr_seed, depth).numpy(),
        np.asarray(jrng.corr_draws(n, jnp.uint32(corr_seed), depth)),
    )


def test_rng_cu_constants_are_the_plain_paths():
    src = (Path(trng.__file__).resolve().parents[1] / "csrc" / "rng.cu").read_text()
    got = {name: int(v, 0) for name, v in
           re.findall(r"constexpr uint32_t (k\w+) = (0x[0-9A-Fa-f]+|\d+)u;", src)}
    assert got == {
        "kTeaDelta": trng.TEA_DELTA,
        **{f"kTeaKey{i}": k for i, k in enumerate(trng.TEA_KEYS)},
        "kLcgA": trng._LCG_A, "kLcgC": trng._LCG_C, "kDepthKey": trng.DEPTH_KEY,
    }
    assert got["kLcgA"] == 1664525 and got["kLcgC"] == 1013904223
    assert got["kDepthKey"] == 0x85EBCA6B and got["kTeaDelta"] == 0x9E3779B9
    assert f"kDraws = {trng.CORR_DRAWS};" in src
    assert crng.LANE_COLS == trng.CORR_DRAWS


def test_cpu_calls_keep_the_int64_path(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a CPU call reached the CUDA wrapper")

    monkeypatch.setattr(crng, "tea", refuse)
    monkeypatch.setattr(crng, "table", refuse)
    a = _values(4)
    want = np.asarray(jrng.tea(jnp.asarray(a), jnp.uint32(5), rounds=8))
    np.testing.assert_array_equal(_u32(trng.tea(torch.from_numpy(a.view(np.int32)), 5, 8)), want)
    # a tensor seed is the plain version's on the CPU, the named plain call the same
    np.testing.assert_array_equal(
        _u32(trng.tea(torch.from_numpy(a.view(np.int32)), torch.tensor(5), 8)), want)
    np.testing.assert_array_equal(_u32(trng.tea_plain(torch.from_numpy(a), 5, 8)), want)
    trng.seed_pixels(40, 24, 3)
    for device in (None, "cpu", torch.device("cpu")):
        np.testing.assert_array_equal(
            _u32(trng.block_uniform_table(13, 7, 2, device=device)),
            _u32(trng.block_uniform_table_plain(13, torch.tensor(7), 2, device=device)))
        np.testing.assert_array_equal(
            _u32(trng.corr_draws(3 * 1024 + 77, 7, 2, device=device)),
            _u32(trng.corr_draws_plain(3 * 1024 + 77, 7, 2, device=device)))


def test_card_dispatch_passes_host_ints_as_scalars(monkeypatch):
    seen = []

    def tea(val0, val1, rounds):
        seen.append(("tea", val1, rounds))
        return val0

    def table(*args, **kw):
        seen.append(("table", args, kw))

    # the CPU stands in for the card: only the device of the decision is replaced
    real = trng._on_card
    monkeypatch.setattr(trng, "_on_card", lambda device, seed: real("cuda", seed))
    monkeypatch.setattr(crng, "tea", tea)
    monkeypatch.setattr(crng, "table", table)
    ids = torch.arange(10)
    trng.tea(ids, 5)
    trng.tea(ids.to(torch.int32), 0xFFFFFFFF, rounds=8)
    trng.seed_pixels(4, 3, 9)
    trng.block_uniform_table(13, 0xFFFFFFFF, 3, device="cpu")
    trng.corr_draws(3 * 1024 + 77, 9, 66, device="cpu")
    trng.corr_draws(250, 9, 1, block=100, device="cpu")
    assert seen == [
        ("tea", 5, 16), ("tea", 0xFFFFFFFF, 8), ("tea", 9, 16),
        ("table", (13, 0xFFFFFFFF, 3, "cpu"), {}),
        ("table", (4, 9, 66, "cpu"), {"n_lanes": 3 * 1024 + 77, "block": 1024}),
        ("table", (3, 9, 1, "cpu"), {"n_lanes": 250, "block": 100}),
    ]
    # on the card a tensor seed raises: no call falls back to the int64 rounds
    for call in (lambda: trng.tea(ids, torch.tensor(5)),
                 lambda: trng.block_uniform_table(13, torch.tensor(5), 3, device="cpu"),
                 lambda: trng.corr_draws(250, torch.tensor(5), 1, device="cpu")):
        with pytest.raises(TypeError, match="host integer"):
            call()
    assert len(seen) == 6


def test_card_decision_and_wrapper_checks():
    assert trng._on_card("cuda", 5) and trng._on_card(torch.device("cuda", 0), np.uint32(5))
    assert not trng._on_card("cpu", 5) and not trng._on_card(None, 5)
    assert not trng._on_card("cpu", torch.tensor(5))
    with pytest.raises(TypeError, match="host integer"):
        trng._on_card("cuda", torch.tensor(5))
    with pytest.raises(ValueError, match="CUDA"):
        crng.tea(torch.arange(3), 1, 16)
    with pytest.raises(TypeError, match="int64 or int32"):
        crng.tea(torch.arange(3.0), 1, 16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        crng.table(4, 1, 0, "cpu")


@pytest.mark.parametrize("w,h", [(64, 48), (96, 40), (50, 37)])
def test_tile_perm_and_untile_exact(w, h):
    jp, ji = jcam.tile_perm(w, h)
    tp, ti = tcam.tile_perm(w, h)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ti, ji)
    if w % 32 == 0:
        x = np.random.default_rng(0).normal(size=(w * h, 3)).astype(np.float32)
        want = np.asarray(jcam.untile(jnp.asarray(x), w, h))
        got = tcam.untile(torch.from_numpy(x), w, h).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, x[ti])


def test_pixel_coords_exact():
    np.testing.assert_array_equal(tcam.pixel_coords(13, 7).numpy(),
                                  np.asarray(jcam.pixel_coords(13, 7)))


@pytest.mark.parametrize("cam_kw", [
    {},
    {"eye": (3.0, 2.0, 11.0), "center": (0.5, -1.0, 0.0), "fov_deg": 45.0},
])
def test_generate_rays(cam_kw):
    w, h = 64, 48
    jc = jcam.Camera(**cam_kw)
    tc = tcam.Camera(**cam_kw)
    jm = jc.matrices(w, h)
    tm = tc.matrices(w, h)
    for k in jcam.CameraMatrices._fields:
        np.testing.assert_array_equal(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)))
    # the carry-over path gives the same matrices
    tm2 = tcam.camera_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})
    for k in jcam.CameraMatrices._fields:
        np.testing.assert_array_equal(getattr(tm2, k).numpy(), getattr(tm, k).numpy())

    rng = np.random.default_rng(7)
    jitter = rng.uniform(0, 1, (w * h, 2)).astype(np.float32)
    perm, _ = jcam.tile_perm(w, h)
    pix = np.asarray(jcam.pixel_coords(w, h))[perm]
    jo, jd = jcam.generate_rays(jm, w, h, jnp.asarray(jitter), pix=jnp.asarray(pix))
    to, td = tcam.generate_rays(tm, w, h, torch.from_numpy(jitter),
                                pix=torch.from_numpy(pix))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6, rtol=0)
    # default pixel grid + a broadcast jitter pair
    jo, jd = jcam.generate_rays(jm, w, h, jnp.asarray([0.5, 0.5], jnp.float32))
    to, td = tcam.generate_rays(tm, w, h, torch.tensor([0.5, 0.5]))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6, rtol=0)
