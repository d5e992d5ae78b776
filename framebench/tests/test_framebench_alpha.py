"""The check of alpha-tested materials on the CPU at 32x24: two small cells of
the foliage hall (``scenes/foliage.py``: MASK leaves and chains with cutout
alpha, a BLEND veil) reached from new files alone, correct against the port
in path and hybrid mode, each planted fault of the port's punch-through and
the bfloat16 control not correct; an opaque scene never enters the
reference's punch-through; the glTF writer's alpha modes load alike on both
sides; the sponzoid's asset is byte for byte what it was."""

import dataclasses
import hashlib
import inspect
import json
import os
import shutil

import pytest
import torch

from framebench import check, scenes
from framebench.cells import program_scene, resolve
from framebench.reference import alpha as ref_alpha
from framebench.reference import scene as ref_scene
from framebench.run import run_cell
from framebench.tests.conftest import BENCH, write_tiny_root

W, H = 32, 24
CELLS = ("foliagetiny.path-d3-alpha", "foliagetiny.hybrid-gi-alpha")
SCENE = {"generator": "foliage", "tess": 1, "seed": 7, "plants": 3, "chains": 4, "veils": 1}


def _quiet(*_):
    pass


def write_alpha_root(path: str) -> str:
    """The tiny root (``conftest.write_tiny_root``) and, as new files and
    new ``BENCHMARK.json`` entries, a configuration of the foliage hall at
    32x24 looking at a plant with the veil behind it, two traffic mixes
    with ``alpha_test`` (path depth 3, hybrid with GI) and their limits,
    the cells' own (sponzoid path, city hybrid)."""
    write_tiny_root(path)
    fb = os.path.join(path, "framebench")
    bench = json.load(open(os.path.join(path, "BENCHMARK.json")))
    bench["configs"].append({"name": "foliagetiny", "source": "test",
                             "file": "framebench/configs/foliagetiny.json",
                             "reduced": ["tess", "plants", "chains", "veils", "width", "height",
                                         "camera"], "why": "test"})
    cfg = json.load(open(os.path.join(BENCH, "configs", "sponzoid-1440p.json")))
    cfg.update(scene=SCENE, width=W, height=H,
               camera={"eye": [1.0, 2.6, 26.5], "center": [3.6, 1.9, 17.5], "fov_deg": 60.0})
    json.dump(cfg, open(os.path.join(fb, "configs", "foliagetiny.json"), "w"))
    for cell, src, limits in ((CELLS[0], "path-d3", "sponzoid-1440p.path-d3"),
                              (CELLS[1], "hybrid-gi", "city-2160p.hybrid-gi")):
        traffic = cell.split(".")[1]
        d = json.load(open(os.path.join(fb, "traffic", f"{src}.json")))
        d["settings"]["alpha_test"] = True
        json.dump(d, open(os.path.join(fb, "traffic", f"{traffic}.json"), "w"))
        shutil.copy(os.path.join(BENCH, "limits", f"{limits}.json"),
                    os.path.join(fb, "limits", f"{cell}.json"))
        bench["workloads"].append({"name": cell, "config": "foliagetiny", "traffic": traffic,
                                   "chips": 1, "why": "test"})
    json.dump(bench, open(os.path.join(path, "BENCHMARK.json"), "w"))
    return path


@pytest.fixture(scope="module")
def alpha_root(tmp_path_factory):
    return write_alpha_root(str(tmp_path_factory.mktemp("framebench_alpha")))


@pytest.mark.parametrize("seed", [5, 2**33 + 11, 2**31 + 7])
@pytest.mark.parametrize("workload", CELLS)
def test_alpha_run_is_correct(alpha_root, workload, seed):
    cell = resolve(workload, root=alpha_root)
    res = run_cell(cell, seed, 0.0, False, "cpu", log=_quiet)
    assert res["correct"], res["numbers"]
    assert res["numbers"]["nonfinite"] == 0 and res["pixels"] == W * H


def _mutated(module, name: str, old: str, new: str):
    """``module.name`` recompiled from its source with ``old`` replaced by
    ``new`` (a fault planted in the port's own code)."""
    src = inspect.getsource(getattr(module, name))
    assert src.count(old) == 1, (name, old)
    ns = dict(vars(module))
    exec(compile(src.replace(old, new), f"<{name}, planted>", "exec"), ns)
    return ns[name]


def plant(monkeypatch, kind: str):
    """A fault of the port's punch-through, planted where it is produced."""
    from vkrt_tpu_torch import engine as engine_mod
    from vkrt_tpu_torch.ops import alpha as alpha_mod

    if kind == "alpha_ignored":  # the engine's tracer built without the punch-through
        real = engine_mod.make_tracer
        monkeypatch.setattr(engine_mod, "make_tracer", lambda scene, backend="auto",
                            alpha=False, **kw: real(scene, backend, alpha=False, **kw))
    elif kind == "texture_alpha_ignored":  # opacity from the material factor alone
        monkeypatch.setattr(alpha_mod, "scene_is_textured", lambda scene: False)
    elif kind == "mask_as_blend":
        monkeypatch.setattr(alpha_mod, "opacity_at_hit", _mutated(
            alpha_mod, "opacity_at_hit", "torch.where(mode == 1, masked, alpha)",
            "torch.where(mode == 1, alpha, alpha)"))
    elif kind == "punch_key":
        monkeypatch.setattr(alpha_mod, "_PUNCH_KEY", alpha_mod._PUNCH_KEY ^ 0x100)
    elif kind == "no_advance":  # the re-trace starts at the ray's own origin
        monkeypatch.setattr(alpha_mod, "alpha_closest", _mutated(
            alpha_mod, "alpha_closest", "new_o = orig + direction * adv[:, None]",
            "new_o = orig"))
    elif kind == "visibility_first_hit":  # a shadow or AO ray ends at any first hit
        monkeypatch.setattr(alpha_mod.AlphaTracer, "any",
                            lambda self, o, d, t_min, t_max: self.inner.any(o, d, t_min, t_max))
    else:
        raise ValueError(kind)


FAULTS = ("alpha_ignored", "texture_alpha_ignored", "mask_as_blend", "punch_key", "no_advance",
          "visibility_first_hit")


@pytest.mark.parametrize("kind", FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_alpha_faults_are_not_correct(alpha_root, workload, kind, monkeypatch):
    plant(monkeypatch, kind)
    res = run_cell(resolve(workload, root=alpha_root), 77, 0.0, False, "cpu", log=_quiet)
    assert not res["correct"], res["numbers"]


@pytest.mark.parametrize("workload", CELLS)
def test_alpha_control_is_not_correct(alpha_root, workload):
    """The reference in bfloat16, punch-through and all, in the program's
    place fails the cell's limits."""
    cell = resolve(workload, root=alpha_root)
    inp = scenes.make("foliage", cell.config["scene"], os.path.join(alpha_root, "framebench",
                                                                    "assets"))
    frames = [40, 41]
    pids = check.draw_pixels(5, W * H, W * H)
    f32 = check.Reference(cell, inp, "cpu")
    assert f32.alpha is not None
    nums = check.numbers(check.Reference(cell, inp, "cpu", torch.bfloat16).image(pids, frames),
                         f32.image(pids, frames))
    assert not check.judge(nums, cell.limits)[0], nums
    assert nums["diverged"] > 0.1


def test_cells_reached_from_new_files_alone(alpha_root, tmp_path):
    """The alpha cells add files to the tiny root and entries to its
    BENCHMARK.json; no other file of it changes."""
    before = write_tiny_root(str(tmp_path))

    def files(root):
        out = {}
        for d, _, names in os.walk(root):
            for n in names:
                p = os.path.join(d, n)
                out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
        return out

    old, new = files(before), files(alpha_root)
    changed = {p for p in old if old[p] != new.get(p)}
    assert changed == {"BENCHMARK.json"}, changed
    bench_old = json.load(open(os.path.join(before, "BENCHMARK.json")))
    bench_new = json.load(open(os.path.join(alpha_root, "BENCHMARK.json")))
    assert bench_new["workloads"][:len(bench_old["workloads"])] == bench_old["workloads"]
    assert {k for k in bench_old if bench_old[k] != bench_new[k]} == {"configs", "workloads"}
    for name in CELLS:
        assert resolve(name, root=alpha_root).traffic["settings"]["alpha_test"] is True


@pytest.mark.parametrize("workload", ["citytiny.path-d4", "citytiny.hybrid-gi"])
def test_opaque_scene_never_enters_the_punch_through(tiny_root, workload, monkeypatch):
    """On the city, whose materials are all opaque, ``alpha_test`` leaves
    the engine's tracer and the reference's walk as they are: the
    reference's image is the one without ``alpha_test``, bit for bit, and
    its punch-through is never called. Run on an opaque scene anyway, the
    punch-through gives the plain walk's hits bit for bit."""
    from framebench.cells import make_engine

    cell = resolve(workload, root=tiny_root)
    inp = scenes.make("city", cell.config["scene"], "")
    pids = check.draw_pixels(3, cell.width * cell.height, 512)
    frames = [7, 8]
    plain = check.Reference(cell, inp, "cpu").image(pids, frames)
    cell.traffic = {**cell.traffic, "settings": {**cell.traffic["settings"], "alpha_test": True}}
    assert type(make_engine(cell, inp, "cpu").tracer).__name__ != "AlphaTracer"

    def refuse(*_a, **_kw):
        raise AssertionError("the punch-through ran on an opaque scene")

    with monkeypatch.context() as mp:
        mp.setattr(ref_alpha.Tracer, "closest", refuse)
        ref = check.Reference(cell, inp, "cpu")
        assert ref.alpha is None
        assert torch.equal(ref.image(pids, frames), plain)
    walk = ref.walk
    g = torch.Generator().manual_seed(4)
    o = torch.rand(2000, 3, generator=g) * 16.0 - torch.tensor([8.0, -0.5, 8.0])
    d = torch.nn.functional.normalize(torch.randn(2000, 3, generator=g), dim=1)
    lim = torch.full((2000,), 1e4)
    want = walk.closest(o, d, lim)
    got = ref_alpha.Tracer(ref.scn, walk).closest(o, d, lim, torch.arange(2000))
    assert int(want.hit.sum()) > 200
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_writer_alpha_modes_load_alike(tmp_path):
    """A MASK and a BLEND material written by the shared glTF writer load
    with the same mode and cutoff in the port and in ``RefScene``; so does
    a soup's through ``cells.program_scene``; a texture with alpha is
    written as RGBA (PNG colour type 6)."""
    from vkrt_tpu_torch.scene import load_scene

    inp = scenes.make("foliage", {**SCENE, "cutoff": 0.375}, str(tmp_path))
    ours = load_scene(inp.path, device="cpu")
    ref = ref_scene.build(inp, "cpu")
    modes = [m.alpha_mode for m in inp.materials]
    assert modes == [0, 0, 0, 0, 0, 1, 1, 2]
    assert torch.equal(ours.mat_alpha_mode, ref.mat_alpha_mode)
    assert torch.equal(ours.mat_alpha_cutoff, ref.mat_alpha_cutoff)
    assert ref.mat_alpha_cutoff.tolist()[5:7] == [0.375, 0.375]
    doc = json.load(open(inp.path))
    assert [m.get("alphaMode") for m in doc["materials"]][4:] == [None, "MASK", "MASK", "BLEND"]
    tex = os.path.join(os.path.dirname(inp.path), "textures")
    assert open(os.path.join(tex, "leaves.png"), "rb").read()[25] == 6
    assert open(os.path.join(tex, "plaster.png"), "rb").read()[25] == 2

    city = scenes.make("city", {"grid": 2, "seed": 7}, "")
    city.materials = [dataclasses.replace(m, alpha_mode=k % 3, alpha_cutoff=0.25 + 0.125 * k)
                      for k, m in enumerate(city.materials)]
    soup = program_scene(city, "cpu")
    ref = ref_scene.build(city, "cpu")
    assert soup.mat_alpha_mode.tolist() == [k % 3 for k in range(len(city.materials))]
    assert torch.equal(soup.mat_alpha_mode, ref.mat_alpha_mode)
    assert torch.equal(soup.mat_alpha_cutoff, ref.mat_alpha_cutoff)


# sha256 of the sponzoid's files (seed 7) as written before its writer was
# shared: tess 1 (the tests' size) and tess 4 (the cell's)
SPONZOID_SHA256 = {
    1: {"sponzoid.gltf": "5c5245f49cc2e79d324994305d992e071c04b77e647c6a1ef42fe2e9cfa5e4a3",
        "sponzoid.bin": "78fcda82a2a7cb8649b9c4f7fe53a34160a83c5d14b692f32d4045bbd8ca89dd"},
    4: {"sponzoid.gltf": "b75d62eff1d52d9290e237f1c4f5b9e7ffdab52471fb449bb2e0d1cf4f166ae1",
        "sponzoid.bin": "e9ec85bb758b20a40c5e8549a7e5e4513654bcc25d642c6eecd68a878e45a5a7"},
}
TEXTURE_SHA256 = {
    "stone": "a7994d7ced0eecf02cf16bd728ad3b3f2e765a3c244d77d7403a15848122e95c",
    "stone_n": "c2baad14164ed14b4e1b61f91a1be9ec74b715a7809561815509a2cd4a427a17",
    "plaster": "b199c6163d5ea1c4f447ea05c46ccf04a5396feaa007640abb0ec9a83d82109b",
    "brick": "0ceb1313c57e576dce11ada4ed1f7c63bc0b0deab500031ae9205154c98850bc",
    "brick_n": "54ff78cd366ec385e3073b62454bb7aa8536eb12d9594dd33b2375a010d1e9e4",
    "marble": "890e7835e3381b0811269805a531685c0b80b79d2b4ad529db7444f8799eddd0",
}


@pytest.mark.parametrize("tess", [1, 4])
def test_sponzoid_asset_unchanged(tmp_path, tess):
    scenes.make("sponzoid", {"tess": tess, "seed": 7}, str(tmp_path))
    d = os.path.join(str(tmp_path), f"sponzoid_t{tess}_s7")
    want = dict(SPONZOID_SHA256[tess], **{f"textures/{k}.png": v
                                          for k, v in TEXTURE_SHA256.items()})
    for rel, sha in want.items():
        assert hashlib.sha256(open(os.path.join(d, rel), "rb").read()).hexdigest() == sha, rel
