"""Port vs JAX package: every function of ``ops/texture.py`` on the same
seeded inputs. Three textures of different sizes padded into one stack
(each image in its own (w, h) corner), uv in [-2.5, 3.5) (negative and
> 1, so REPEAT and the floor modulo of x0 = -1 are exercised), a quarter of
the lanes at index -1 (white). Tolerance: 1e-6 absolute on the f32 level 0
and on the atlas in f32 and in bf16 (both packages cast after the gather).
Also the sampling cases of tests/test_obj_textures.py and
tests/test_tex_bf16.py, and the import-time check of VKRT_ANISO_TAPS."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkrt_tpu.ops.texture as jtex
import vkrt_tpu_torch.ops.texture as ttex

torch.set_num_threads(2)
N = 4096
SIZES = [(16, 16), (8, 12), (5, 7)]  # (h, w) of each image
ATOL = 1e-6


def _images():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for h, w in SIZES]


@pytest.fixture(scope="module")
def case():
    imgs = _images()
    th, tw = max(h for h, _ in SIZES), max(w for _, w in SIZES)
    tex = np.zeros((len(imgs), th, tw, 4), np.float32)
    size = np.zeros((len(imgs), 2), np.int32)
    for k, im in enumerate(imgs):
        tex[k, :im.shape[0], :im.shape[1]] = im / 255.0
        size[k] = (im.shape[1], im.shape[0])
    rng = np.random.default_rng(11)
    uv = rng.uniform(-2.5, 3.5, (N, 2)).astype(np.float32)
    uv[:64] = np.round(uv[:64] * 4) / 4  # texel edges and exact integers
    idx = rng.integers(-1, len(imgs), N).astype(np.int32)
    idx[rng.random(N) < 0.1] = -1
    lod = rng.uniform(-1.0, 6.0, N).astype(np.float32)
    ddx = (rng.normal(size=(N, 2)) * rng.choice([0.001, 0.05, 0.4], (N, 1))).astype(np.float32)
    ddy = (rng.normal(size=(N, 2)) * rng.choice([0.001, 0.05, 0.4], (N, 1))).astype(np.float32)
    atlas = ttex.pack_mip_atlas(imgs, [True, False, True])
    return dict(imgs=imgs, tex=tex, size=size, uv=uv, idx=idx, lod=lod, ddx=ddx, ddy=ddy,
                atlas=atlas)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _atlas(atlas, bf16: bool):
    a, ls, lo, nl = atlas
    ja = jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)
    ta = _t(a).to(torch.bfloat16) if bf16 else _t(a)
    return (ja, jnp.asarray(ls), jnp.asarray(lo), jnp.asarray(nl)), (ta, _t(ls), _t(lo), _t(nl))


def _close(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_sample_texture_matches_jax(case):
    want = jtex.sample_texture(jnp.asarray(case["tex"]), jnp.asarray(case["size"]),
                               jnp.asarray(case["idx"]), jnp.asarray(case["uv"]))
    got = ttex.sample_texture(_t(case["tex"]), _t(case["size"]), _t(case["idx"]), _t(case["uv"]))
    assert got.dtype == torch.float32 and got.shape == (N, 4)
    _close(got, want)
    assert (got[_t(case["idx"]) < 0] == 1.0).all()
    # uv 1.25 wraps to 0.25, and x0 = -1 (u*w - 0.5 < 0) to the last column
    shift = ttex.sample_texture(_t(case["tex"]), _t(case["size"]), _t(case["idx"]),
                                _t(case["uv"]) + 1.0)
    np.testing.assert_allclose(shift.numpy(), got.numpy(), atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_bilinear_at_level_matches_jax(case, bf16):
    (ja, jls, jlo, _), (ta, tls, tlo, _) = _atlas(case["atlas"], bf16)
    k = np.maximum(case["idx"], 0)
    lv = np.random.default_rng(2).integers(0, 3, N)
    w, h = case["atlas"][1][k, lv, 0], case["atlas"][1][k, lv, 1]
    off = case["atlas"][2][k, lv]
    kk, th, tw2, _ = ja.shape
    want = jtex._bilinear_at_level(ja.reshape(-1, 4), jnp.asarray(k), th, tw2,
                                   jnp.asarray(case["uv"]), jnp.asarray(w), jnp.asarray(h),
                                   jnp.asarray(off))
    got = ttex._bilinear_at_level(ta.reshape(-1, 4), _t(k), th, tw2, _t(case["uv"]), _t(w),
                                  _t(h), _t(off))
    _close(got, want)


@pytest.mark.parametrize("bf16", [False, True])
def test_sample_texture_lod_matches_jax(case, bf16):
    jargs, targs = _atlas(case["atlas"], bf16)
    want = jtex.sample_texture_lod(*jargs, jnp.asarray(case["idx"]), jnp.asarray(case["uv"]),
                                   jnp.asarray(case["lod"]))
    got = ttex.sample_texture_lod(*targs, _t(case["idx"]), _t(case["uv"]), _t(case["lod"]))
    assert got.dtype == torch.float32
    _close(got, want)


def test_aniso_minor_lod_matches_jax(case):
    ls = case["atlas"][1]
    want = jtex.aniso_minor_lod(jnp.asarray(ls), jnp.asarray(case["idx"]),
                                jnp.asarray(case["ddx"]), jnp.asarray(case["ddy"]))
    got = ttex.aniso_minor_lod(_t(ls), _t(case["idx"]), _t(case["ddx"]), _t(case["ddy"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bf16,taps", [(False, 4), (True, 4), (False, 2), (True, None)])
def test_sample_texture_aniso_matches_jax(case, bf16, taps):
    jargs, targs = _atlas(case["atlas"], bf16)
    want = jtex.sample_texture_aniso(*jargs, jnp.asarray(case["idx"]), jnp.asarray(case["uv"]),
                                     jnp.asarray(case["ddx"]), jnp.asarray(case["ddy"]),
                                     taps=taps)
    got = ttex.sample_texture_aniso(*targs, _t(case["idx"]), _t(case["uv"]), _t(case["ddx"]),
                                    _t(case["ddy"]), taps=taps)
    _close(got, want)
    assert ttex.ANISO_TAPS == jtex.ANISO_TAPS


def test_mip_pyramid_and_atlas_match_jax(case):
    img = np.random.default_rng(0).random((8, 4, 4)).astype(np.float32)
    for a, b in zip(ttex.build_mip_pyramid(img), jtex.build_mip_pyramid(img)):
        np.testing.assert_array_equal(a, b)
    levels = ttex.build_mip_pyramid(img)
    assert [lv.shape[:2] for lv in levels] == [(8, 4), (4, 2), (2, 1), (1, 1)]
    np.testing.assert_allclose(levels[-1][0, 0], img.mean(axis=(0, 1)), rtol=1e-5)
    for a, b in zip(case["atlas"], jtex.pack_mip_atlas(case["imgs"], [True, False, True])):
        np.testing.assert_array_equal(a, b)
    from vkrt_tpu_torch import scene as tscene

    # scene.py builds its atlas with these functions, not copies of them
    assert tscene.pack_mip_atlas is ttex.pack_mip_atlas


def test_exact_texels_wrap_and_white():
    """tests/test_obj_textures.py's sampling cases through the port."""
    tex = np.zeros((1, 2, 2, 4), np.float32)
    tex[0, 0, 0] = [1, 0, 0, 1]
    tex[0, 0, 1] = [0, 1, 0, 1]
    tex[0, 1, 0] = [0, 0, 1, 1]
    tex[0, 1, 1] = [1, 1, 0, 1]
    uv = torch.tensor([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]])
    out = ttex.sample_texture(_t(tex), torch.tensor([[2, 2]], dtype=torch.int32),
                              torch.zeros(4, dtype=torch.int32), uv).numpy()
    np.testing.assert_allclose(out, tex[0].reshape(4, 4), atol=1e-6)
    ramp = np.zeros((1, 1, 2, 4), np.float32)
    ramp[0, 0, 0] = [0, 0, 0, 1]
    ramp[0, 0, 1] = [1, 1, 1, 1]
    size = torch.tensor([[2, 1]], dtype=torch.int32)
    zero = torch.zeros(1, dtype=torch.int32)
    mid = ttex.sample_texture(_t(ramp), size, zero, torch.tensor([[0.5, 0.5]])).numpy()
    np.testing.assert_allclose(mid[0, :3], 0.5, atol=1e-6)
    a = ttex.sample_texture(_t(ramp), size, zero, torch.tensor([[1.25, 0.5]]))
    b = ttex.sample_texture(_t(ramp), size, zero, torch.tensor([[0.25, 0.5]]))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    white = ttex.sample_texture(torch.zeros((1, 1, 1, 4)), torch.tensor([[1, 1]], dtype=torch.int32),
                                torch.tensor([-1], dtype=torch.int32), torch.tensor([[0.3, 0.7]]))
    assert (white == 1.0).all()


def test_atlas_lod_levels_and_bf16_scene():
    """tests/test_obj_textures.py's mip-atlas case and tests/test_tex_bf16.py's
    parity: level 0 of the atlas is the plain bilinear sampler, the top
    level the mean; a built scene keeps level 0 in f32 and the atlas in
    bf16, within bf16's quantisation of the f32 atlas."""
    from vkrt_tpu_torch.scene import scene_from_soup
    from vkrt_tpu_torch.utils import gltf as gltf_mod

    img = np.zeros((8, 8, 4), np.uint8)
    img[::2, ::2] = 255
    img[1::2, 1::2] = 255
    img[..., 3] = 255
    atlas, lsize, loff, nlev = ttex.pack_mip_atlas([img])
    assert nlev[0] == 4 and tuple(lsize[0, 0]) == (8, 8) and tuple(lsize[0, 3]) == (1, 1)
    uv = torch.tensor([[0.31, 0.77]])
    idx = torch.zeros(1, dtype=torch.int32)
    args = (_t(atlas), _t(lsize), _t(loff), _t(nlev), idx, uv)
    top = ttex.sample_texture_lod(*args, torch.tensor([10.0])).numpy()
    np.testing.assert_allclose(top[0, :3], 0.5, atol=0.02)
    lvl0 = ttex.sample_texture_lod(*args, torch.tensor([0.0])).numpy()
    plain = ttex.sample_texture(_t(img[None].astype(np.float32) / 255.0),
                                torch.tensor([[8, 8]], dtype=torch.int32), idx, uv).numpy()
    np.testing.assert_allclose(lvl0, plain, atol=1e-5)
    l15 = ttex.sample_texture_lod(*args, torch.tensor([1.5])).numpy()
    l1 = ttex.sample_texture_lod(*args, torch.tensor([1.0])).numpy()
    l2 = ttex.sample_texture_lod(*args, torch.tensor([2.0])).numpy()
    assert (np.minimum(l1, l2) - 1e-6 <= l15).all() and (l15 <= np.maximum(l1, l2) + 1e-6).all()

    rgb = np.random.RandomState(3).randint(0, 256, (16, 16, 4), np.uint8)
    rgb[..., 3] = 255
    mats = [gltf_mod.GltfMaterial(np.ones(4, np.float32), base_color_texture=0)]
    lights = [gltf_mod.GltfLight(np.zeros(3, np.float32), np.ones(3, np.float32), 1.0, 0)]
    sc = scene_from_soup([np.eye(3, dtype=np.float32)], [0], mats, lights,
                         images=[gltf_mod.GltfImage(rgb, "t")], device="cpu")
    assert sc.tex_mip_atlas.dtype == torch.bfloat16 and sc.tex_rgba.dtype == torch.float32
    a32 = ttex.pack_mip_atlas([rgb], [True])
    rng = np.random.RandomState(11)
    uvs = torch.tensor(rng.rand(257, 2) * 3.0 - 1.0, dtype=torch.float32)
    lod = torch.tensor(rng.rand(257) * 4.0, dtype=torch.float32)
    i0 = torch.zeros(257, dtype=torch.int32)
    a = ttex.sample_texture_lod(_t(a32[0]), *(_t(x) for x in a32[1:]), i0, uvs, lod)
    b = ttex.sample_texture_lod(sc.tex_mip_atlas, sc.tex_level_size, sc.tex_level_off,
                                sc.tex_n_levels, i0, uvs, lod)
    assert b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1 / 128, atol=1e-3)


@pytest.mark.parametrize("taps,ok", [("2", True), ("3", False)])
def test_aniso_taps_validated_at_import(taps, ok):
    env = dict(os.environ, VKRT_ANISO_TAPS=taps)
    res = subprocess.run([sys.executable, "-c",
                          "import vkrt_tpu_torch.ops.texture as t; print(t.ANISO_TAPS)"],
                         capture_output=True, text=True, env=env, timeout=120)
    if ok:
        assert res.returncode == 0 and res.stdout.strip() == taps, res.stderr
    else:
        assert res.returncode != 0 and "VKRT_ANISO_TAPS must be 2 or 4" in res.stderr
