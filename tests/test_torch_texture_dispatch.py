"""The texel fetch's dispatch on the CPU (``ops/texture.py`` ->
``ops/cuda/texture.py``): CPU tensors take the plain PyTorch path, bit for
bit, under the "texture" range and without touching the kernel's counts in
``device.counts``; the wrappers refuse CPU tensors, wrong dtypes and
shapes, strided lanes, and a tap count other than 2 or 4, before any
launch. The kernel itself runs only on the card
(``tests/test_torch_texture_gpu.py``)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from vkrt_tpu_torch import device as kdev
from vkrt_tpu_torch.ops import texture as tex
from vkrt_tpu_torch.ops.cuda import texture as tex_cuda

REPO = Path(__file__).resolve().parents[1]
N = 513


def _inputs(idx_dtype=torch.int32, bf16=True):
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for h, w in ((8, 8), (5, 6))]
    tex_rgba = torch.zeros((2, 8, 8, 4))
    for k, im in enumerate(imgs):
        tex_rgba[k, :im.shape[0], :im.shape[1]] = torch.from_numpy(im / 255.0)
    tex_size = torch.tensor([[8, 8], [6, 5]], dtype=torch.int32)
    atlas, ls, lo, nl = tex.pack_mip_atlas(imgs)
    a = torch.from_numpy(atlas)
    mip = (a.to(torch.bfloat16) if bf16 else a, *(torch.from_numpy(t) for t in (ls, lo, nl)))
    idx = torch.from_numpy(rng.integers(-1, 2, N)).to(idx_dtype)
    uv = torch.from_numpy(rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32))
    lod = torch.from_numpy(rng.uniform(-1.0, 5.0, N).astype(np.float32))
    ddx = torch.from_numpy(rng.normal(size=(N, 2)).astype(np.float32) * 0.05)
    ddy = torch.from_numpy(rng.normal(size=(N, 2)).astype(np.float32) * 0.2)
    return tex_rgba, tex_size, mip, idx, uv, lod, ddx, ddy


def _calls(sampler, t):
    """(public call, plain call) of one sampler on ``_inputs``' tensors."""
    tex_rgba, tex_size, mip, idx, uv, lod, ddx, ddy = t
    return {
        "level0": (lambda: tex.sample_texture(tex_rgba, tex_size, idx, uv),
                   lambda: tex.sample_texture_plain(tex_rgba, tex_size, idx, uv)),
        "trilinear": (lambda: tex.sample_texture_lod(*mip, idx, uv, lod),
                      lambda: tex.sample_texture_lod_plain(*mip, idx, uv, lod)),
        "aniso": (lambda: tex.sample_texture_aniso(*mip, idx, uv, ddx, ddy, taps=2),
                  lambda: tex.sample_texture_aniso_plain(*mip, idx, uv, ddx, ddy, taps=2)),
    }[sampler]


def _counters():
    return {e: dict(kdev.counts[e]) for e in ("vkrt_tex_level0", "vkrt_tex_lod",
                                              "vkrt_tex_aniso")}


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("sampler", ["level0", "trilinear", "aniso"])
def test_cpu_takes_the_plain_path(sampler, idx_dtype):
    before = _counters()
    public, plain = _calls(sampler, _inputs(idx_dtype))
    got, want = public(), plain()
    assert got.shape == (N, 4) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.view(torch.int32).numpy(), want.view(torch.int32).numpy())
    assert _counters() == before


@pytest.mark.parametrize("sampler", ["level0", "trilinear", "aniso"])
def test_each_call_is_one_texture_range(sampler):
    """The range stays around the dispatch, one a call (the plain
    anisotropic path calls the plain trilinear one, not the public one)."""
    from torch.profiler import ProfilerActivity, profile

    public, _ = _calls(sampler, _inputs())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        public()
        public()
    assert sum(e.name == "texture" for e in prof.events()) == 2


@pytest.mark.parametrize("sampler", ["level0", "trilinear", "aniso"])
def test_wrappers_refuse_cpu_tensors(sampler):
    tex_rgba, tex_size, mip, idx, uv, lod, ddx, ddy = _inputs()
    call = {"level0": lambda: tex_cuda.level0(tex_rgba, tex_size, idx, uv),
            "trilinear": lambda: tex_cuda.trilinear(*mip, idx, uv, lod),
            "aniso": lambda: tex_cuda.aniso(*mip, idx, uv, ddx, ddy, 4)}[sampler]
    before = _counters()
    with pytest.raises(ValueError, match="not a CUDA device"):
        call()
    assert _counters() == before


BAD_DTYPES = {
    "level0 index int16": lambda t: tex_cuda.level0(t[0], t[1], t[3].short(), t[4]),
    "level0 index float": lambda t: tex_cuda.level0(t[0], t[1], t[3].float(), t[4]),
    "level0 uv float64": lambda t: tex_cuda.level0(t[0], t[1], t[3], t[4].double()),
    "level0 texels bf16": lambda t: tex_cuda.level0(t[0].bfloat16(), t[1], t[3], t[4]),
    "level0 sizes int64": lambda t: tex_cuda.level0(t[0], t[1].long(), t[3], t[4]),
    "trilinear lod float64": lambda t: tex_cuda.trilinear(*t[2], t[3], t[4], t[5].double()),
    "trilinear atlas f16": lambda t: tex_cuda.trilinear(t[2][0].half(), *t[2][1:], t[3], t[4],
                                                        t[5]),
    "trilinear offsets int64": lambda t: tex_cuda.trilinear(t[2][0], t[2][1], t[2][2].long(),
                                                            t[2][3], t[3], t[4], t[5]),
    "aniso ddx f16": lambda t: tex_cuda.aniso(*t[2], t[3], t[4], t[6].half(), t[7], 4),
    "aniso ddy float64": lambda t: tex_cuda.aniso(*t[2], t[3], t[4], t[6], t[7].double(), 4),
    "aniso levels int64": lambda t: tex_cuda.aniso(*t[2][:3], t[2][3].long(), t[3], t[4], t[6],
                                                   t[7], 4),
}


@pytest.mark.parametrize("case", sorted(BAD_DTYPES))
def test_wrappers_refuse_wrong_dtypes(case):
    """Refused on CPU tensors too: every dtype is checked before the device."""
    before = _counters()
    with pytest.raises(TypeError, match="want"):
        BAD_DTYPES[case](_inputs())
    assert _counters() == before


BAD_SHAPES = {
    "uv (N, 3)": lambda t: tex_cuda.level0(t[0], t[1], t[3], torch.zeros((N, 3))),
    "index (N, 1)": lambda t: tex_cuda.level0(t[0], t[1], t[3][:, None], t[4]),
    "lod (N + 1,)": lambda t: tex_cuda.trilinear(*t[2], t[3], t[4], torch.zeros(N + 1)),
    "ddy (N - 1, 2)": lambda t: tex_cuda.aniso(*t[2], t[3], t[4], t[6], t[7][1:], 4),
    "texels (K, H, W, 3)": lambda t: tex_cuda.level0(t[0][..., :3], t[1], t[3], t[4]),
    "level tables of another K": lambda t: tex_cuda.trilinear(t[2][0][:1], *t[2][1:], t[3],
                                                              t[4], t[5]),
    "taps 3": lambda t: tex_cuda.aniso(*t[2], t[3], t[4], t[6], t[7], 3),
    "taps 8": lambda t: tex_cuda.aniso(*t[2], t[3], t[4], t[6], t[7], 8),
}


@pytest.mark.parametrize("case", sorted(BAD_SHAPES))
def test_wrappers_refuse_wrong_shapes_and_taps(case):
    before = _counters()
    with pytest.raises(ValueError):
        BAD_SHAPES[case](_inputs())
    assert _counters() == before


def _strided(t):
    """``t`` as a view of every other row of a tensor twice as long."""
    return torch.stack([t, t], dim=1).flatten(0, 1)[::2]


STRIDED = {
    "level0 index": lambda t: tex_cuda.level0(t[0], t[1], _strided(t[3]), t[4]),
    "level0 uv": lambda t: tex_cuda.level0(t[0], t[1], t[3], _strided(t[4])),
    "level0 uv column-major": lambda t: tex_cuda.level0(t[0], t[1], t[3], t[4].t().contiguous().t()),
    "trilinear lod": lambda t: tex_cuda.trilinear(*t[2], t[3], t[4], _strided(t[5])),
    "aniso ddx": lambda t: tex_cuda.aniso(*t[2], t[3], t[4], _strided(t[6]), t[7], 4),
    "aniso ddy": lambda t: tex_cuda.aniso(*t[2], t[3], t[4], t[6], _strided(t[7]), 4),
}


@pytest.mark.parametrize("case", sorted(STRIDED))
def test_wrappers_refuse_strided_lanes(case):
    """The kernel reads each lane's inputs as contiguous rows, so a strided
    view is refused (checked before the device), not read wrong."""
    t = _inputs()
    before = _counters()
    with pytest.raises(ValueError, match="must be contiguous"):
        STRIDED[case](t)
    assert _counters() == before


def test_kernel_named_for_the_profile():
    """framebench's own-kernel rule finds the kernel by its declaration, and
    its name is no substring of the PyTorch kernels seen in the traces."""
    from framebench.profile import own_kernel_names

    assert "tex_sample_kernel" in own_kernel_names(str(REPO))
    for torch_name in ("vectorized_gather_kernel", "index_elementwise_kernel",
                       "vectorized_elementwise_kernel", "unrolled_elementwise_kernel",
                       "elementwise_kernel", "CatArrayBatchedCopy", "reduce_kernel",
                       "floor_kernel_cuda"):
        assert "tex_sample_kernel" not in torch_name
