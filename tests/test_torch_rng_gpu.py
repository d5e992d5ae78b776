"""The RNG prologue's kernels (``csrc/rng.cu``) on the card, held bit for
bit to the int64 plain path (``ops/rng.py`` on CPU tensors). Marked
``gpu``; each test skips without a CUDA device (decided in the fixture, not
at import). The card's machine has no JAX: run with
``python -m pytest --noconftest tests/test_torch_rng_gpu.py -q``.

* ``tea`` at 16 and 8 rounds, ``val0`` int64 (high words set too) and int32
  bits, ``val1`` up to 2^32 - 1, ids whose ``>> 5`` differs when the shift
  is arithmetic; a tensor seed or another dtype on the card raises, and the
  named plain version on the card agrees;
* ``block_uniform_table`` at G = 1, 7 and 8,100 over several depth keys;
  ``corr_draws`` at lane counts that leave the last block ragged;
* a small engine frame in path mode (kernel B's chain, and the general
  loop of a normal-mapped scene) and in hybrid mode with every RNG call
  under ``torch.cuda.set_sync_debug_mode("error")``: no synchronise, no
  CUDA call reaching the plain version, one seed launch a frame plus one
  table launch for each table, each launch's output equal to the plain
  path's."""

import contextlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

EDGE = np.array([0, 1, 31, 32, 33, 2**31 - 1, 2**31, 2**31 + 31, 2**31 + 32,
                 0xFFFFFFE0, 0xFFFFFFFE, 0xFFFFFFFF], np.int64)
VAL1 = (0, 1, 7, 2**31, 0x9E3779B9, 0xFFFFFFFF)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return torch.device("cuda")


def _launches(entry: str) -> int:
    from vkrt_tpu_torch import device as kdev

    return kdev.counts[entry]["launches"]


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _ids(n=100_000):
    rng = np.random.default_rng(5)
    return np.concatenate([EDGE, rng.integers(0, 2**32, n, dtype=np.int64)])


@pytest.mark.parametrize("rounds", [8, 16])
def test_tea_kernel_bit_exact(cuda, rounds):
    from vkrt_tpu_torch.ops import rng

    ids = _ids()
    high = ids + (np.arange(ids.size) % 3 - 1) * 2**32  # other high words, negatives too
    bits = ids.astype(np.uint32).view(np.int32)         # >= 2^31 is negative as int32
    for val1 in VAL1:
        want = _u32(rng.tea(torch.from_numpy(ids), val1, rounds))
        for v0 in (ids, high, bits):
            before = _launches("vkrt_rng_tea")
            got = rng.tea(torch.from_numpy(v0).to(cuda), val1, rounds)
            assert _launches("vkrt_rng_tea") == before + 1
            assert got.dtype == torch.int32 and got.shape == (ids.size,)
            np.testing.assert_array_equal(_u32(got), want)
        # the plain version on the card, called by name, agrees
        np.testing.assert_array_equal(
            _u32(rng.tea_plain(torch.from_numpy(ids).to(cuda), val1, rounds)), want)
    # on the card a tensor seed, or an id that is not int64 or int32, raises
    before = _launches("vkrt_rng_tea")
    with pytest.raises(TypeError, match="host integer"):
        rng.tea(torch.from_numpy(ids).to(cuda), torch.tensor(VAL1[-1], device=cuda), rounds)
    with pytest.raises(TypeError, match="int64 or int32"):
        rng.tea(torch.from_numpy(ids).to(cuda).to(torch.int16), 5, rounds)
    assert _launches("vkrt_rng_tea") == before


def test_seed_pixels_on_the_card(cuda):
    from vkrt_tpu_torch.ops import rng

    for frame in (0, 1, 2**31, 0xFFFFFFFF):
        np.testing.assert_array_equal(_u32(rng.seed_pixels(333, 77, frame, cuda)),
                                      _u32(rng.seed_pixels(333, 77, frame)))


@pytest.mark.parametrize("g", [1, 7, 8100])
def test_table_kernel_bit_exact(cuda, g):
    from vkrt_tpu_torch.ops import rng

    for corr_seed in (0, 2**31, 0x9E3779B9, 0xFFFFFFFF):
        for depth in (0, 1, 3, 64, 67, 72):
            before = _launches("vkrt_rng_table")
            got = rng.block_uniform_table(g, corr_seed, depth, device=cuda)
            assert _launches("vkrt_rng_table") == before + 1
            assert got.shape == (g, 8) and got.dtype == torch.float32
            np.testing.assert_array_equal(_u32(got),
                                          _u32(rng.block_uniform_table(g, corr_seed, depth)))


@pytest.mark.parametrize("n,block", [(1, 1024), (1023, 1024), (3 * 1024 + 77, 1024),
                                     (100_003, 1024), (5_000, 100)])
def test_corr_draws_kernel_bit_exact(cuda, n, block):
    from vkrt_tpu_torch.ops import rng

    for depth in (0, 2, 66):
        before = _launches("vkrt_rng_table")
        got = rng.corr_draws(n, 0x12345678, depth, block=block, device=cuda)
        assert _launches("vkrt_rng_table") == before + 1
        assert got.shape == (n, 6) and got.is_contiguous()
        np.testing.assert_array_equal(_u32(got),
                                      _u32(rng.corr_draws(n, 0x12345678, depth, block=block)))


def _settings(mode):
    from vkrt_tpu_torch.config import RenderSettings

    if mode == "path":
        return RenderSettings(rt_mode=1, samples=1, depth=4, corr_sampler=True)
    if mode == "general":
        return RenderSettings(rt_mode=1, samples=1, depth=3, corr_sampler=True)
    return RenderSettings(rt_mode=0, samples=1, depth=3, use_shadows=True, use_ao=True,
                          use_gi=True, use_denoiser=False, corr_sampler=True)


@pytest.mark.parametrize("mode", ["path", "general", "hybrid"])
def test_engine_frame_rng_without_sync(cuda, mode, monkeypatch, tmp_path):
    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.benchmarks.suite import SPONZOID_CAMERA
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.ops import rng
    from vkrt_tpu_torch.ops.cuda import rng as rng_cuda
    from vkrt_tpu_torch.ops.cuda.shade import kernel_shading_available
    from vkrt_tpu_torch.scene import make_city
    from vkrt_tpu_torch.utils import profiling
    from vkrt_tpu_torch.utils.camera import Camera, orbit_camera
    from vkrt_tpu_torch.utils.sponzoid import load_sponzoid

    kdev.kernels()  # the build stays outside the frames
    calls = []      # (kind, args, output) of every kernel launch
    real_tea, real_table = rng_cuda.tea, rng_cuda.table

    def tea(val0, val1, rounds):  # records on the card: a copy to the host synchronises
        out = real_tea(val0, val1, rounds)
        calls.append(("tea", (val0.clone(), val1, rounds), out))
        return out

    def table(n_rows, corr_seed, dk, device, n_lanes=None, block=0):
        out = real_table(n_rows, corr_seed, dk, device, n_lanes=n_lanes, block=block)
        calls.append(("table", (n_rows, corr_seed, dk, n_lanes, block), out))
        return out

    monkeypatch.setattr(rng_cuda, "tea", tea)
    monkeypatch.setattr(rng_cuda, "table", table)

    def card_refused(plain):  # the plain version serves no call on the card
        def call(*args, **kw):
            dev_of = [a.device for a in args if torch.is_tensor(a)] + [kw.get("device")]
            assert not any(d is not None and torch.device(d).type == "cuda" for d in dev_of)
            return plain(*args, **kw)
        return call

    for name in ("tea_plain", "block_uniform_table_plain", "corr_draws_plain"):
        monkeypatch.setattr(rng, name, card_refused(getattr(rng, name)))

    depth = {"n": 0, "top": 0}
    real_label = profiling.pass_label

    @contextlib.contextmanager
    def strict_rng():
        prev = torch.cuda.get_sync_debug_mode()
        depth["n"] += 1
        depth["top"] += depth["n"] == 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)
            depth["n"] -= 1

    monkeypatch.setattr(profiling, "pass_label",
                        lambda name: strict_rng() if name == "rng" else real_label(name))

    s = _settings(mode)
    if mode == "general":  # normal maps: the general loop's corr_draws views
        scene = load_sponzoid(str(tmp_path), tess=1, device=cuda)
        assert not kernel_shading_available(scene)
        eng = Engine(scene, 160, 120, s, Camera(**SPONZOID_CAMERA))
    else:
        eng = Engine(make_city(grid=8, device=cuda), 160, 120, s,
                     orbit_camera(0.12, radius=25.0, height=4.0))
    frames = 2
    for _ in range(frames):
        img = eng.render_frame()
    torch.cuda.synchronize()
    assert img.shape == (160 * 120, 3)
    n_tea = sum(k == "tea" for k, _, _ in calls)
    n_table = sum(k == "table" for k, _, _ in calls)
    assert n_tea == frames
    assert n_tea + n_table == depth["top"]  # every RNG call is one launch
    assert n_table == frames * (s.depth if s.rt_mode == 1 else 1 + 4 + 1 + (s.depth - 1))
    for kind, args, out in calls:
        if kind == "tea":
            val0, val1, rounds = args
            want = rng.tea(val0.cpu(), val1, rounds)
        else:
            n_rows, corr_seed, dk, n_lanes, block = args
            if n_lanes is None:
                want = rng.block_uniform_table(n_rows, corr_seed, dk)
            else:
                want = rng.corr_draws(n_lanes, corr_seed, dk, block=block)
        np.testing.assert_array_equal(_u32(out), _u32(want))
