"""The port's sponzoid (``vkrt_tpu_torch/utils/sponzoid.py``) against
``vkrt_tpu/utils/sponzoid.py`` and tests/test_sponzoid.py:

* the JPEG form (the default) is the JAX package's asset byte for byte
  (the .gltf, the .bin and every texture file), and parses to the same
  geometry through either package's parser;
* the PNG form's decoded textures equal the JAX package's synthesised
  arrays (lossless), its URIs name .png files, and it writes, parses and
  builds in a process where PIL cannot be imported, every texture at full
  size;
* tests/test_sponzoid.py's two tests (the asset's layout; a hybrid render
  through ``Engine`` that shows texture variation) on the port;
* the cache marker keys the form as well as tess and seed, so two forms in
  one directory never mix; ``instanced=True`` gives an ``InstancedScene``."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

import vkrt_tpu.utils.sponzoid as jsp
from vkrt_tpu.utils.gltf import parse_gltf as j_parse_gltf
from vkrt_tpu_torch.config import RenderSettings
from vkrt_tpu_torch.engine import Engine
from vkrt_tpu_torch.scene_instances import InstancedScene
from vkrt_tpu_torch.utils.camera import Camera
from vkrt_tpu_torch.utils.gltf import parse_gltf
from vkrt_tpu_torch.utils.png import decode_png
from vkrt_tpu_torch.utils.sponzoid import load_sponzoid, write_sponzoid

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_jpeg_form_is_the_jax_asset_byte_for_byte(tmp_path):
    a, b = tmp_path / "jax", tmp_path / "port"
    jsp.write_sponzoid(str(a), tess=1)
    path = write_sponzoid(str(b), tess=1)
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name] == fb[name], name
    jdoc, tdoc = j_parse_gltf(str(a / "sponzoid.gltf")), parse_gltf(path)
    assert len(jdoc.primitives) == len(tdoc.primitives) == 4
    for jp, tp in zip(jdoc.primitives, tdoc.primitives):
        for field in ("positions", "indices", "normals", "tangents", "uvs", "world_matrix"):
            x, y = getattr(jp, field), getattr(tp, field)
            assert x.dtype == y.dtype and np.array_equal(x, y), field
        assert jp.material == tp.material
    for ji, ti in zip(jdoc.images, tdoc.images):
        np.testing.assert_array_equal(ji.data, ti.data)


def test_png_form_decodes_to_the_synthesised_textures(tmp_path):
    path = write_sponzoid(str(tmp_path), tess=1, texture_format="png")
    uris = [im["uri"] for im in json.load(open(path))["images"]]
    assert uris == ["textures/stone.png", "textures/stone_n.png", "textures/plaster.png",
                    "textures/brick.png", "textures/brick_n.png", "textures/marble.png"]
    assert not list((tmp_path / "textures").glob("*.jpg"))
    rng = np.random.default_rng(7)  # write_sponzoid's draw order
    stone, stone_n = jsp._tex_stone(rng)
    plaster = jsp._tex_plaster(rng)
    brick, brick_n = jsp._tex_brick(rng)
    marble = jsp._tex_marble(rng)
    for name, want in (("stone", stone), ("plaster", plaster), ("brick", brick),
                       ("marble", marble), ("stone_n", stone_n), ("brick_n", brick_n)):
        got = decode_png((tmp_path / "textures" / f"{name}.png").read_bytes())
        want = want.astype(np.uint8)
        np.testing.assert_array_equal(got[..., :want.shape[-1]], want, err_msg=name)
        assert (got[..., 3] == 255).all(), name
    # the geometry is the JPEG form's
    jpeg = parse_gltf(write_sponzoid(str(tmp_path / "jpeg"), tess=1))
    for a, b in zip(parse_gltf(path).primitives, jpeg.primitives):
        np.testing.assert_array_equal(a.positions, b.positions)


def test_png_form_loads_without_pil(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from vkrt_tpu_torch.utils.gltf import parse_gltf\n"
        "from vkrt_tpu_torch.utils.sponzoid import load_sponzoid, sponzoid_path\n"
        f"d = {str(tmp_path)!r}\n"
        "doc = parse_gltf(sponzoid_path(d, tess=1, texture_format='png'))\n"
        "assert all(im.data.shape[:2] == (256, 256) for im in doc.images), "
        "[im.data.shape for im in doc.images]\n"
        "s = load_sponzoid(d, tess=1, texture_format='png', device='cpu')\n"
        "assert 'PIL' not in sys.modules or sys.modules['PIL'] is None\n"
        "print(s.num_tris, s.num_lights, s.tex_rgba.shape[0], int(s.tex_size.min()))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["26752", "5", "6", "256"]


def test_sponzoid_asset_layout(tmp_path):
    doc = parse_gltf(write_sponzoid(str(tmp_path), tess=1, texture_format="png"))
    assert len(doc.primitives) == 4          # one per material
    assert len(doc.materials) == 4
    assert len(doc.lights) == 5              # KHR point rig
    assert len(doc.images) == 6              # 4 colour + 2 normal maps
    for im in doc.images:  # every image decoded from its external URI
        assert im.data.shape[0] >= 256 and im.data.shape[-1] == 4
    for pr in doc.primitives:
        assert pr.tangents is not None
        assert np.abs(pr.tangents[:, :3]).max() > 0.9
    assert sum(len(pr.indices) // 3 for pr in doc.primitives) > 20_000


def test_sponzoid_render_smoke(tmp_path):
    scene = load_sponzoid(str(tmp_path), tess=1, texture_format="png", device="cpu")
    assert scene.num_tris > 20_000 and scene.num_lights == 5
    # normal maps wired: stone floor (mat 0) and brick (mat 2)
    assert int(scene.mat_normal_tex[0]) >= 0 and int(scene.mat_normal_tex[2]) >= 0
    cam = Camera(eye=(0.0, 6.0, 26.0), center=(0.0, 5.0, 0.0))
    eng = Engine(scene, 64, 36, RenderSettings(rt_mode=0, use_gi=False), cam)
    img = eng.render(frames=1).astype(np.float32)
    assert np.isfinite(img).all() and img.max() > 0.0
    assert img[8:28, 8:56].std() > 10.0  # texture and material variation, not a flat fill
    assert load_sponzoid(str(tmp_path), tess=1, texture_format="png",
                         device="cpu").num_tris == scene.num_tris  # the cached asset


def test_cache_marker_keys_the_form(tmp_path):
    d = str(tmp_path)

    def uris():
        return {im["uri"].rsplit(".", 1)[1]
                for im in json.load(open(tmp_path / "sponzoid.gltf"))["images"]}

    def markers():
        return sorted(n for n in os.listdir(d) if n.startswith(".sponzoid_"))

    load_sponzoid(d, tess=1, device="cpu")
    assert uris() == {"jpg", "png"} and markers() == [".sponzoid_t1_s7_jpeg"]
    inst = load_sponzoid(d, tess=1, texture_format="png", device="cpu", instanced=True)
    assert uris() == {"png"} and markers() == [".sponzoid_t1_s7_png"]
    assert isinstance(inst, InstancedScene) and inst.num_nodes == 4
    assert [e - s for s, e in inst.prim_ranges] == [1536, 2176, 1920, 21120]
    load_sponzoid(d, tess=1, device="cpu")
    assert uris() == {"jpg", "png"} and markers() == [".sponzoid_t1_s7_jpeg"]
