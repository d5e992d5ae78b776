"""The mip atlas's storage dtype in the port follows ``VKRT_TEX_BF16`` as
the JAX package's does (tests/test_tex_bf16.py): bf16 by default, f32 with
``VKRT_TEX_BF16=0``, read when the scene is built; ``tex_rgba`` stays f32.
The textured quad is that test's document, built by both packages. Under
each value the port's atlas equals the JAX package's, a trilinear
fetch from the bf16 atlas stays within 1/128 of the f32 one, and a hybrid
render (the textured quad, 32x32, AO off) passes the display gate against
the JAX package's render under the same value."""

import numpy as np
import pytest
import torch

import vkrt_tpu.scene as jscene
import vkrt_tpu_torch.scene as tscene
from test_tex_bf16 import _textured_doc
from test_torch_hybrid_engine import jax_engine_frames
from test_torch_pathtracer import display_gate
from vkrt_tpu.config import RenderSettings as JSettings
from vkrt_tpu.utils.camera import Camera as JCamera
from vkrt_tpu_torch.config import RenderSettings
from vkrt_tpu_torch.engine import Engine
from vkrt_tpu_torch.ops.texture import sample_texture, sample_texture_lod
from vkrt_tpu_torch.utils.camera import Camera

torch.set_num_threads(2)


def _build(monkeypatch, knob: str):
    monkeypatch.setenv("VKRT_TEX_BF16", knob)
    return jscene.build_scene(_textured_doc()), tscene.build_scene(_textured_doc(), device="cpu")


def test_atlas_dtype_follows_the_knob(monkeypatch):
    j32, s32 = _build(monkeypatch, "0")
    j16, s16 = _build(monkeypatch, "1")
    assert s32.tex_mip_atlas.dtype == torch.float32
    assert s16.tex_mip_atlas.dtype == torch.bfloat16
    assert s32.tex_rgba.dtype == s16.tex_rgba.dtype == torch.float32
    for j, t in ((j32, s32), (j16, s16)):
        want = np.asarray(j.tex_mip_atlas).astype(np.float32)
        np.testing.assert_array_equal(t.tex_mip_atlas.float().numpy(), want)
        assert str(np.asarray(j.tex_mip_atlas).dtype) == str(t.tex_mip_atlas.dtype).split(".")[1]
    monkeypatch.delenv("VKRT_TEX_BF16")  # unset: the default, bf16
    assert tscene.build_scene(_textured_doc(), device="cpu").tex_mip_atlas.dtype == torch.bfloat16

    n = 257
    rng = np.random.RandomState(11)
    uv = torch.tensor(rng.rand(n, 2) * 3.0 - 1.0, dtype=torch.float32)
    idx = torch.zeros((n,), dtype=torch.int32)
    a = sample_texture(s32.tex_rgba, s32.tex_size, idx, uv)
    b = sample_texture(s16.tex_rgba, s16.tex_size, idx, uv)
    assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
    lod = torch.tensor(rng.rand(n) * 4.0, dtype=torch.float32)
    a, b = (sample_texture_lod(s.tex_mip_atlas, s.tex_level_size, s.tex_level_off,
                               s.tex_n_levels, idx, uv, lod) for s in (s32, s16))
    assert a.dtype == b.dtype == torch.float32
    assert 0.0 < float((a - b).abs().max()) <= 1.0 / 128.0


@pytest.mark.parametrize("knob", ["0", "1"])
def test_hybrid_render_matches_jax_under_the_knob(monkeypatch, knob):
    js, ts = _build(monkeypatch, knob)
    want, rays_j = jax_engine_frames(js, JSettings(rt_mode=0, use_ao=False), 1,
                                     JCamera(eye=(0, 0, 6)), 32, 32)
    eng = Engine(ts, 32, 32, RenderSettings(use_ao=False), Camera(eye=(0, 0, 6)))
    got = eng.render_frame().numpy().astype(np.float64)
    display_gate(got, want)
    assert eng.total_rays == rays_j
    assert got.mean() > 0.05
