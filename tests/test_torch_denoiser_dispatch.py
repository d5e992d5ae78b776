"""The denoiser's dispatch to its CUDA kernels (``models/denoiser.py`` ->
``ops/cuda/denoise.py``) on the CPU: CPU tensors take the plain PyTorch
bodies and launch nothing; the kernels' wrappers refuse malformed inputs
with ``device.check_args``' ``TypeError`` / ``ValueError`` (dtypes before
shapes and layouts, those before the device); the tap table holds what the
card's plain path computes. The kernels themselves run only on the card
(``tests/test_torch_denoiser_gpu.py``)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vkrt_tpu_torch import device as kdev
from vkrt_tpu_torch.models import denoiser as dn
from vkrt_tpu_torch.ops.cuda import denoise as dn_cuda

W, H = 24, 16
N = W * H


def _inputs(seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, lo=0.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))

    packed = torch.cat([t(N, 1, hi=2.0), t(N, 2, lo=-0.2, hi=0.2), t(N, 1)], dim=1)
    state = dn.init_state(W, H, "cpu")._replace(
        hist_rad=t(N, 3), hist_m1=t(N), hist_m2=t(N), hist_len=t(N, hi=8.0),
        prev_view_z=t(N, lo=4.0, hi=6.0), prev_normal=t(N, 3),
        prev_view_proj=torch.eye(4) + 0.01 * t(4, 4))
    return state, packed, t(N, 4), -t(N, lo=4.0, hi=6.0), t(N, 3, lo=-1.0, hi=1.0), torch.eye(4)


def _refuse(monkeypatch):
    def never(*a, **kw):
        raise AssertionError("a CPU call reached the kernels")
    monkeypatch.setattr(dn_cuda, "atrous", never)
    monkeypatch.setattr(dn_cuda, "temporal", never)


def test_cpu_takes_the_plain_path(monkeypatch):
    """Every denoiser entry on CPU tensors runs the PyTorch bodies: equal to
    the ``*_plain`` functions, no launch counted, no wrapper called."""
    _refuse(monkeypatch)
    state, packed, norm_rough, view_z, pos, view_proj = _inputs()
    kdev.reset_counts()
    got = dn.denoise_temporal(state, packed, norm_rough, view_z, pos, view_proj, W, H)
    want = dn.denoise_temporal_plain(state, packed, norm_rough, view_z, pos, view_proj, W, H)
    for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
        assert torch.equal(a, b)
    t = dn.temporal_pass(state, packed, norm_rough, view_z, pos, W, H, H)
    for a, b in zip(t, dn.temporal_pass_plain(state, packed, norm_rough, view_z, pos, W, H, H)):
        assert torch.equal(a, b)
    args = (t.rad_acc, t.prev_normal, view_z, W, H, 3)
    assert torch.equal(dn.atrous_filter(*args, variance=t.variance, hit_dist_norm=t.hit_dist),
                       dn.atrous_filter_plain(*args, variance=t.variance,
                                              hit_dist_norm=t.hit_dist))
    dn.denoise_gi(packed, norm_rough, view_z, W, H)
    assert all(c == {"launches": 0, "lanes": 0} for c in kdev.counts.values())


def _periodic(x, k):
    return x[-k:], x[:k]


def _atrous_args(**change):
    rad, nrm = torch.rand(N, 3), torch.rand(N, 3)
    args = dict(radiance=rad, normal=nrm, view_z=torch.rand(N), variance=torch.rand(N),
                hit_dist_norm=torch.rand(N))
    args.update(change)
    return args


@pytest.mark.parametrize("case,error,match", [
    ("radiance f64", TypeError, "radiance is torch.float64, want float32"),
    ("variance f16", TypeError, "variance is torch.float16"),
    ("normal shape", ValueError, r"normal is \(384, 4\), want \(384, 3\)"),
    ("hit distance strided", ValueError, "hit_dist_norm must be contiguous"),
    ("on the cpu", ValueError, "cpu is not a CUDA device"),
])
def test_atrous_refusals(case, error, match):
    change = {"radiance f64": dict(radiance=torch.rand(N, 3, dtype=torch.float64)),
              "variance f16": dict(variance=torch.rand(N, dtype=torch.float16)),
              "normal shape": dict(normal=torch.rand(N, 4)),
              "hit distance strided": dict(hit_dist_norm=torch.rand(N, 2)[:, 0]),
              "on the cpu": {}}[case]
    a = _atrous_args(**change)
    with pytest.raises(error, match=match):
        dn_cuda.atrous(a["radiance"], a["normal"], a["view_z"], W, H, 3, a["variance"],
                       a["hit_dist_norm"], _periodic, (dn._KERNEL, 1.0, 64.0, 4.0))


@pytest.mark.parametrize("case,error,match", [
    ("history length i32", TypeError, "hist_len is torch.int32, want float32"),
    ("packed shape", ValueError, r"diff_rad_hitd is \(384, 3\), want \(384, 4\)"),
    ("history size", ValueError, r"prev_view_z is \(383,\), want \(384,\)"),
    ("view_proj strided", ValueError, "prev_view_proj must be contiguous"),
    ("on the cpu, strided positions", ValueError, "cpu is not a CUDA device"),
])
def test_temporal_refusals(case, error, match):
    state, packed, norm_rough, view_z, pos, _ = _inputs()
    if case == "history length i32":
        state = state._replace(hist_len=state.hist_len.to(torch.int32))
    elif case == "packed shape":
        packed = packed[:, :3].contiguous()
    elif case == "history size":
        state = state._replace(prev_view_z=state.prev_view_z[1:])
    elif case == "view_proj strided":
        state = state._replace(prev_view_proj=state.prev_view_proj.t())
    else:  # the G-buffer's positions as a band passes them: a view of (N, 4) rows
        pos = torch.cat([pos, torch.zeros(N, 1)], dim=1)[:, :3]
    with pytest.raises(error, match=match):
        dn_cuda.temporal(state, packed, norm_rough, view_z, pos, W, H,
                         lambda x: (x[:1], x[-1:]), (32.0, 0.05, 0.8))


def test_tap_table():
    """78 f32 in ``csrc/denoise.cu``'s ``TapTable`` order: the B3 weights
    (summing to 1), the reciprocals of the depth and radius divisors as the
    card's plain path takes them (in double, then rounded to f32), the
    sigmas and 1 / 9."""
    src = (Path(kdev.__file__).parent / "csrc" / "denoise.cu").read_text()
    taps = int(re.search(r"constexpr int kTaps = (\d+);", src).group(1))
    assert "constexpr int kTableFloats = 3 * kTaps + 3;" in src
    assert dn_cuda.TAP_FLOATS == 3 * taps + 3 == 78
    for step in (1, 2, 4):
        table = np.array(dn_cuda.tap_table(step, dn._KERNEL, dn.SIGMA_Z, dn.SIGMA_N,
                                           dn.SIGMA_L), dtype=np.float32)
        kw, inv_z, inv_r = table[:25], table[25:50], table[50:75]
        assert kw.sum() == 1.0 and kw[12] == np.float32(9.0 / 64.0)
        assert inv_z[12] == np.float32(1000.0)  # 1 / 1e-3, not f32(1) / f32(1e-3)
        assert inv_z[13] == np.float32(1.0 / (step + 1e-3))
        assert inv_r[12] == 0.0 and inv_r[13] == 2.0
        assert inv_r[0] == np.float32(1.0 / (8 ** 0.5 / 2.0))
        assert list(table[75:]) == [64.0, 4.0, np.float32(1.0 / 9.0)]
