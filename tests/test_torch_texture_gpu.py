"""The texel fetch's kernel (``csrc/texture.cu``) on the card, held bit for
bit to the plain PyTorch path (``ops/texture.py``'s ``*_plain`` functions,
run on the card too). Marked ``gpu``; each test skips without a CUDA
device (decided in the fixture, not at import). The card's machine has no
JAX: run with ``python -m pytest --noconftest tests/test_torch_texture_gpu.py -q``.

* each sampler (level 0, trilinear, anisotropic with 2 and 4 taps) on f32
  and bf16 atlases, int32 and int64 indices, index -1; uv negative and
  beyond 1, non-finite and huge; images smaller than the padded stack and
  of sizes that are not powers of two; lod below 0, above the last level,
  -0.0 and non-finite; non-finite derivatives; N = 0, 1 and counts that
  are not a multiple of the block; compared as int32 bits, so NaN lanes
  must match too;
* what the wrappers refuse on the card (strided lanes among it), without
  launching;
* small engine frames (the normal-mapped sponzoid in path and hybrid
  mode, the city in hybrid mode, anisotropic and isotropic) with each
  texture call under ``torch.cuda.set_sync_debug_mode("error")``: every
  call one launch, no synchronise, each launch's output equal to the plain
  path's on its inputs, and the frame equal to the frame rendered with the
  plain path in the kernel's place."""

import contextlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

SIZES = [(16, 16), (8, 12), (5, 7), (1, 3)]  # (h, w); the stack pads to 16 x 16
ODD = np.array([np.nan, np.inf, -np.inf, 3e38, -3e38, 0.0, -0.0, 1e-30, 1.0, -1.0,
                0.5, -0.5, 2.0**24, 1.0 - 2.0**-24], np.float32)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32).cpu().numpy()


def _images(seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for h, w in SIZES]


def _level0(device):
    imgs = _images()
    th, tw = max(h for h, _ in SIZES), max(w for _, w in SIZES)
    tex = np.zeros((len(imgs), th, tw, 4), np.float32)
    size = np.zeros((len(imgs), 2), np.int32)
    for k, im in enumerate(imgs):
        tex[k, :im.shape[0], :im.shape[1]] = im / 255.0
        size[k] = (im.shape[1], im.shape[0])
    return torch.from_numpy(tex).to(device), torch.from_numpy(size).to(device)


def _mip(device, bf16):
    from vkrt_tpu_torch.ops.texture import pack_mip_atlas

    atlas, ls, lo, nl = pack_mip_atlas(_images(), [True, False, True, False])
    a = torch.from_numpy(atlas).to(device)
    return (a.to(torch.bfloat16) if bf16 else a,
            *(torch.from_numpy(t).to(device) for t in (ls, lo, nl)))


def _lanes(n, device, idx_dtype, seed=11):
    """(idx, uv, lod, ddx, ddy) for n lanes: uv in [-2.5, 3.5) with texel
    edges and integers, a tenth of the indices -1, lod in [-2, 7), the
    derivatives over three decades; the first lanes take the odd values."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    q = min(n, 64)
    uv[:q] = np.round(uv[:q] * 4) / 4
    idx = rng.integers(-1, len(SIZES), n)
    idx[rng.random(n) < 0.1] = -1
    lod = rng.uniform(-2.0, 7.0, n).astype(np.float32)
    scale = rng.choice([0.001, 0.05, 0.4, 3.0], (n, 1))
    ddx = (rng.normal(size=(n, 2)) * scale).astype(np.float32)
    ddy = (rng.normal(size=(n, 2)) * scale).astype(np.float32)
    m = min(n, 3 * ODD.size)
    if n > 1:  # odd values on lanes of every texture, white ones too
        odd = np.resize(ODD, m)
        uv[-m:, 0], lod[-m:], ddx[-m:, 1], ddy[-m:, 0] = odd, odd, odd, np.roll(odd, 5)
        uv[:m, 1], ddx[:m, 0] = np.roll(odd, 3), odd
        idx[-m:] = np.arange(m) % len(SIZES)
    t = (torch.from_numpy(idx.astype(np.int64)).to(idx_dtype),
         *(torch.from_numpy(a) for a in (uv, lod, ddx, ddy)))
    return tuple(x.to(device) for x in t)


# each sampler's entry point in device.counts
ENTRY = {"level0": "vkrt_tex_level0", "trilinear": "vkrt_tex_lod", "aniso": "vkrt_tex_aniso"}


def _launches(sampler) -> int:
    from vkrt_tpu_torch import device as kdev

    return kdev.counts[ENTRY[sampler]]["launches"]


def _launched(sampler, fn):
    before = _launches(sampler)
    out = fn()
    return out, _launches(sampler) - before


def _all_launches():
    return sum(map(_launches, ENTRY))


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [0, 1, 1000, 100_003])
def test_level0_bit_exact(cuda, idx_dtype, n):
    from vkrt_tpu_torch.ops import texture as tex

    tex_rgba, tex_size = _level0(cuda)
    idx, uv, _, _, _ = _lanes(n, cuda, idx_dtype)
    got, k = _launched("level0", lambda: tex.sample_texture(tex_rgba, tex_size, idx, uv))
    assert k == (1 if n else 0)
    assert got.shape == (n, 4) and got.dtype == torch.float32
    want = tex.sample_texture_plain(tex_rgba, tex_size, idx, uv)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if n:
        assert (got[idx < 0] == 1.0).all()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [0, 1, 1000, 100_003])
def test_trilinear_bit_exact(cuda, bf16, idx_dtype, n):
    from vkrt_tpu_torch.ops import texture as tex

    mip = _mip(cuda, bf16)
    idx, uv, lod, _, _ = _lanes(n, cuda, idx_dtype)
    got, k = _launched("trilinear", lambda: tex.sample_texture_lod(*mip, idx, uv, lod))
    assert k == (1 if n else 0) and got.shape == (n, 4)
    want = tex.sample_texture_lod_plain(*mip, idx, uv, lod)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("taps", [2, 4, None])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [0, 1, 1000, 100_003])
def test_aniso_bit_exact(cuda, bf16, taps, idx_dtype, n):
    from vkrt_tpu_torch.ops import texture as tex

    mip = _mip(cuda, bf16)
    idx, uv, _, ddx, ddy = _lanes(n, cuda, idx_dtype)
    got, k = _launched("aniso",
                       lambda: tex.sample_texture_aniso(*mip, idx, uv, ddx, ddy, taps=taps))
    assert k == (1 if n else 0) and got.shape == (n, 4)
    want = tex.sample_texture_aniso_plain(*mip, idx, uv, ddx, ddy, taps=taps)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if n > 1:
        assert torch.isnan(got).any()  # the non-finite derivatives reached a fetch


def test_strided_lanes(cuda):
    """Lanes' inputs as views of wider tensors (columns of a block, every
    other row) are refused on the card, before a launch: the kernel reads
    contiguous rows."""
    from vkrt_tpu_torch.ops import texture as tex

    n = 4099
    idx, uv, lod, ddx, ddy = _lanes(n, cuda, torch.int64)
    block = torch.cat([uv, ddx, ddy], dim=1).t().contiguous().t()  # (n, 6) column-major
    s_uv, s_dx, s_dy = block[:, 0:2], block[:, 2:4], block[:, 4:6]
    s_idx, s_lod = (torch.stack([t, t], dim=1)[:, 0] for t in (idx, lod))
    assert not any(t.is_contiguous() for t in (s_uv, s_dx, s_dy, s_idx, s_lod))
    tex_rgba, tex_size = _level0(cuda)
    mip = _mip(cuda, True)
    before = _all_launches()
    for call in (lambda: tex.sample_texture(tex_rgba, tex_size, s_idx, uv),
                 lambda: tex.sample_texture(tex_rgba, tex_size, idx, s_uv),
                 lambda: tex.sample_texture_lod(*mip, idx, uv, s_lod),
                 lambda: tex.sample_texture_aniso(*mip, idx, uv, s_dx, ddy),
                 lambda: tex.sample_texture_aniso(*mip, idx, uv, ddx, s_dy)):
        with pytest.raises(ValueError, match="must be contiguous"):
            call()
    assert _all_launches() == before


def test_wrappers_refuse_on_the_card(cuda):
    from vkrt_tpu_torch.ops import texture as tex

    tex_rgba, tex_size = _level0(cuda)
    mip = _mip(cuda, True)
    idx, uv, lod, ddx, ddy = _lanes(64, cuda, torch.int32)
    before = _all_launches()
    with pytest.raises(TypeError, match="int32 or int64"):
        tex.sample_texture(tex_rgba, tex_size, idx.to(torch.int16), uv)
    with pytest.raises(TypeError, match="float32"):
        tex.sample_texture_lod(*mip, idx, uv.double(), lod)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tex.sample_texture_aniso(mip[0].half(), *mip[1:], idx, uv, ddx, ddy)
    with pytest.raises(TypeError, match="int32"):
        tex.sample_texture_lod(mip[0], mip[1].long(), *mip[2:], idx, uv, lod)
    with pytest.raises(ValueError, match="taps"):
        tex.sample_texture_aniso(*mip, idx, uv, ddx, ddy, taps=3)
    with pytest.raises(ValueError, match="lod is on cpu"):
        tex.sample_texture_lod(*mip, idx, uv, lod.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        tex.sample_texture(tex_rgba.transpose(1, 2), tex_size, idx, uv)
    assert _all_launches() == before


def _engine(mode, device, tmp_path):
    from vkrt_tpu_torch.benchmarks.suite import SPONZOID_CAMERA
    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.scene import make_city
    from vkrt_tpu_torch.utils.camera import Camera, orbit_camera
    from vkrt_tpu_torch.utils.sponzoid import load_sponzoid

    hybrid = RenderSettings(rt_mode=0, samples=1, depth=3, use_shadows=True, use_ao=True,
                            use_gi=True, use_denoiser=False, corr_sampler=True)
    if mode == "sponzoid path":
        s = RenderSettings(rt_mode=1, samples=1, depth=3, corr_sampler=True)
    else:
        s = hybrid
    if mode.startswith("sponzoid"):
        return Engine(load_sponzoid(str(tmp_path), tess=1, device=device), 160, 120, s,
                      Camera(**SPONZOID_CAMERA))
    return Engine(make_city(grid=8, device=device), 160, 120, s,
                  orbit_camera(0.12, radius=25.0, height=4.0))


@pytest.mark.parametrize("mode,aniso", [("sponzoid path", "1"), ("sponzoid hybrid", "1"),
                                        ("city hybrid", "1"), ("city hybrid", "0")])
def test_engine_frame_texture_one_launch_without_sync(cuda, mode, aniso, monkeypatch,
                                                      tmp_path):
    from vkrt_tpu_torch import device as kdev
    from vkrt_tpu_torch.ops import texture as tex
    from vkrt_tpu_torch.ops.cuda import texture as tex_cuda
    from vkrt_tpu_torch.utils import profiling

    monkeypatch.setenv("VKRT_ANISO", aniso)
    kdev.kernels()  # the build stays outside the frames
    plain = {"level0": tex.sample_texture_plain, "trilinear": tex.sample_texture_lod_plain,
             "aniso": tex.sample_texture_aniso_plain}
    calls = []  # (sampler, args, output) of every launch

    def recorded(name):
        real = getattr(tex_cuda, name)

        def call(*args):
            before = _launches(name)
            out = real(*args)
            assert _launches(name) == before + 1
            # copies to the host would synchronise: keep the inputs on the card
            calls.append((name, [a.clone() if torch.is_tensor(a) else a for a in args], out))
            return out
        return call

    for name in plain:
        monkeypatch.setattr(tex_cuda, name, recorded(name))
    entered = {"n": 0, "top": 0}
    real_label = profiling.pass_label

    @contextlib.contextmanager
    def strict_texture():
        prev = torch.cuda.get_sync_debug_mode()
        entered["n"] += 1
        entered["top"] += entered["n"] == 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)
            entered["n"] -= 1

    monkeypatch.setattr(profiling, "pass_label",
                        lambda name: strict_texture() if name == "texture" else real_label(name))
    frames = 2
    eng = _engine(mode, cuda, tmp_path)
    for _ in range(frames):
        img = eng.render_frame()
    torch.cuda.synchronize()
    assert img.shape == (160 * 120, 3)
    assert calls and len(calls) == entered["top"]  # every texture call is one launch
    used = {name for name, _, _ in calls}
    if mode == "sponzoid hybrid":
        assert {"aniso", "trilinear"} <= used
    if mode == "city hybrid":
        assert used == {"aniso" if aniso == "1" else "trilinear"}
    for name, args, out in calls:
        np.testing.assert_array_equal(_bits(out), _bits(plain[name](*args)))

    # the same frames with the plain path in the kernel's place
    monkeypatch.setattr(profiling, "pass_label", real_label)
    monkeypatch.setattr(tex_cuda, "level0", lambda *a: plain["level0"](*a))
    monkeypatch.setattr(tex_cuda, "trilinear", lambda *a: plain["trilinear"](*a))
    monkeypatch.setattr(tex_cuda, "aniso", lambda *a: plain["aniso"](*a))
    ref = _engine(mode, cuda, tmp_path)
    for _ in range(frames):
        want = ref.render_frame()
    np.testing.assert_array_equal(_bits(img), _bits(want))
