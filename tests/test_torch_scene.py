"""Port vs JAX package: scene builds are equal field for field; the state
carry-over round-trips; textured scenes build and render; the port imports
neither jax nor the JAX package."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import vkrt_tpu.scene as jscene
import vkrt_tpu.utils.gltf as jgltf
import vkrt_tpu_torch.scene as tscene
import vkrt_tpu_torch.utils.gltf as gltf_mod

torch.set_num_threads(2)


def _np(x) -> np.ndarray:
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _tnp(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _assert_equal_scenes(js, ts):
    assert tscene.SceneTensors._fields == jscene.SceneArrays._fields
    for k in jscene.SceneArrays._fields:
        want, got = _np(getattr(js, k)), _tnp(getattr(ts, k))
        assert got.shape == want.shape, k
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("build", [
    ("make_cornell_box", ()),
    ("make_random_soup", (300, 3)),
    ("make_random_soup", (2048, 0, 2.0)),
])
def test_scene_builds_equal(build):
    name, args = build
    js = getattr(jscene, name)(*args)
    ts = getattr(tscene, name)(*args, device="cpu")
    _assert_equal_scenes(js, ts)
    assert ts.num_tris == js.num_tris and ts.num_lights == js.num_lights


def test_cornell_box_shape_and_fallback():
    ts = tscene.make_cornell_box(device="cpu")
    assert ts.num_tris == 128 and ts.mat_base_color.shape[0] == 5
    assert ts.num_lights == 1
    assert not tscene.scene_is_textured(ts)
    assert not tscene.scene_base_only_textured(ts)
    # load_cornell falls back to the box exactly when the JAX one does
    assert tscene.find_reference_cornell() == jscene.find_reference_cornell()
    if tscene.find_reference_cornell() is None:
        _assert_equal_scenes(jscene.load_cornell(), tscene.load_cornell(device="cpu"))


def test_scene_from_numpy_round_trip():
    js = jscene.make_cornell_box()
    ts = tscene.scene_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                                 device="cpu")
    _assert_equal_scenes(js, ts)
    assert ts.tex_mip_atlas.dtype == torch.bfloat16
    back = tscene.scene_from_numpy({k: _tnp(v) for k, v in ts._asdict().items()},
                                   device="cpu")
    for a, b in zip(ts, back):
        np.testing.assert_array_equal(_tnp(a), _tnp(b))


def test_textured_scene_raises():
    """Textured scenes build (the JAX package's arrays, the atlas included),
    and the shading entry points, ``Engine`` and ``pathtrace_frame``, render
    them: one finite, non-black 32x24 frame each."""
    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.models.pathtracer import pathtrace_frame
    from vkrt_tpu_torch.ops.trace import make_tracer
    from vkrt_tpu_torch.utils.camera import Camera

    jtex = jgltf.GltfImage(np.full((4, 4, 4), 200, np.uint8), "t")
    jmats = [jgltf.GltfMaterial(np.ones(4, np.float32), base_color_texture=0)]
    jlights = [jgltf.GltfLight(np.zeros(3, np.float32), np.ones(3, np.float32), 1.0, 0)]
    tex = gltf_mod.GltfImage(jtex.data, "t")
    mats = [gltf_mod.GltfMaterial(np.ones(4, np.float32), base_color_texture=0)]
    lights = [gltf_mod.GltfLight(np.zeros(3, np.float32), np.ones(3, np.float32), 1.0, 0)]
    tris = [np.eye(3, dtype=np.float32)]
    soup = tscene.scene_from_soup(tris, [0], mats, lights, images=[tex], device="cpu")
    _assert_equal_scenes(jscene.scene_from_soup(tris, [0], jmats, jlights, images=[jtex]), soup)
    city = jscene.make_city(grid=2)
    ts = tscene.scene_from_numpy({k: np.asarray(v) for k, v in city._asdict().items()},
                                 device="cpu")
    _assert_equal_scenes(city, ts)
    for scene in (soup, ts):
        assert tscene.scene_is_textured(scene)
        img = Engine(scene, 32, 24, RenderSettings(rt_mode=1)).render_frame()
        assert img.shape == (32 * 24, 3) and torch.isfinite(img).all() and img.max() > 0
        cam = Camera().matrices(32, 24, scene.device)
        acc, rays = pathtrace_frame(scene, make_tracer(scene), cam, 0,
                                    torch.zeros((32 * 24, 3)), (1.0, 1.0, 1.0, 1.0),
                                    width=32, height=24, samples=1, depth=1)
        assert torch.isfinite(acc).all() and acc.max() > 0 and float(rays) >= 32 * 24


def test_textured_decided_without_read_back(monkeypatch):
    """Whether a scene is textured is decided from the host arrays when it
    is built, so the check in every frame reads nothing back; a scene whose
    texture slots were replaced is decided anew, once."""
    box = tscene.make_cornell_box(device="cpu")
    city = tscene.make_city(grid=2, device="cpu")
    retex = box._replace(mat_mr_tex=torch.zeros_like(box.mat_mr_tex))

    def no_read_back(self, *args, **kwargs):
        raise AssertionError("read back to the host")

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "cpu", no_read_back)
        assert not tscene.scene_is_textured(box)
        assert tscene.scene_is_textured(city)
        with pytest.raises(AssertionError, match="read back"):
            tscene.scene_is_textured(retex)
    assert tscene.scene_is_textured(retex) and not tscene.scene_is_textured(box)


def test_constructors_default_to_the_card():
    """``device=None`` means the card: without one the constructors raise
    (before any host build) instead of building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    calls = [lambda: tscene.make_cornell_box(), lambda: tscene.make_random_soup(8),
             lambda: tscene.load_cornell(), lambda: tscene.make_city(grid=1),
             lambda: tscene.scene_from_numpy(
                 {k: np.asarray(v) for k, v in jscene.make_cornell_box()._asdict().items()})]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_port_imports_no_jax():
    """Every module of the port, the probe entry points included, imports
    with ``jax``, ``vkrt_tpu`` and PIL blocked (``sys.modules[name] = None``
    makes any import of them raise)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vkrt_tpu'] = None\n"
        "sys.modules['PIL'] = None\n"
        "import vkrt_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(vkrt_tpu_torch.__path__,\n"
        "                                               'vkrt_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'vkrt_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(' '.join(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 25
    for name in ("config", "utils.native", "utils.gltf", "utils.png", "app", "engine",
                 "ops.cuda.probes", "ops.cuda.trace_variants", "benchmarks.micro_trace",
                 "benchmarks.ablate_kernel", "benchmarks.variants", "benchmarks.vpupeak",
                 "utils.smath", "utils.obj", "ops.texture", "ops.sampling", "ops.brdf",
                 "models.shading", "ops.nrd", "models.gbuffer", "models.hybrid",
                 "models.post", "models.denoiser", "ops.alpha", "utils.metrics",
                 "scene_instances", "utils.sponzoid", "utils.profiling", "utils.checkpoint",
                 "benchmarks.suite", "parallel.mesh", "parallel.render", "parallel.dryrun",
                 "bvh.lbvh", "ops.sort_rays", "bench", "entry", "benchmarks.accuracy", "ops.cuda.rng"):
        assert f"vkrt_tpu_torch.{name}" in names, name
