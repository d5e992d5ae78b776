"""Whole runs on the CPU at small sizes (the program's plain paths): the
benchmark's inputs equal the program's own generators, the reference agrees
with the program, a broken timed path and the lower-precision control come
out not correct, and the command refuses to measure without a card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from framebench import check, scenes
from framebench.cells import ROOT, resolve
from framebench.reference import bvh as ref_bvh
from framebench.reference import scene as ref_scene
from framebench.run import run_cell


def _quiet(*_):
    pass


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "framebench.run", "--workload",
                          "city-2160p.path-d4", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


@pytest.mark.parametrize("generator,params", [("city", {"grid": 6, "seed": 7}),
                                            ("sponzoid", {"tess": 1, "seed": 7})])
def test_inputs_and_reference_tables_match_the_program(generator, params, tmp_path):
    """The benchmark's frozen generators give the program's own scene, and
    the reference's derived tables equal the program's baked ones."""
    from framebench.cells import program_scene
    from vkrt_tpu_torch.scene import load_scene, make_city
    from vkrt_tpu_torch.utils.sponzoid import write_sponzoid

    inp = scenes.make(generator, params, str(tmp_path))
    ours = program_scene(inp, "cpu")
    theirs = (make_city(grid=params["grid"], device="cpu") if generator == "city" else
              load_scene(write_sponzoid(str(tmp_path / "p"), tess=1, seed=7,
                                        texture_format="png"), device="cpu"))
    for f in ours._fields:
        assert torch.equal(getattr(ours, f), getattr(theirs, f)), f
    ref = ref_scene.build(inp, "cpu")
    n = inp.num_tris
    for f in ("tri_v0", "tri_e1", "tri_e2", "corner_normal", "corner_tangent", "corner_uv",
              "tri_mat", "mat_base_color", "light_pos", "light_intensity", "tex_size"):
        assert torch.equal(getattr(ref, f), getattr(ours, f)[:n] if f.startswith(("tri", "corner"))
                           else getattr(ours, f)), f
    k, th, tw, _ = ours.tex_rgba.shape
    assert torch.equal(ref.tex_rgba, ours.tex_rgba)


def test_walk_equals_brute_force():
    from vkrt_tpu_torch.ops.trace import trace_rays_bruteforce

    inp = scenes.make("city", {"grid": 8, "seed": 7}, "")
    scn = ref_scene.build(inp, "cpu")
    walk = ref_bvh.Walk(ref_bvh.build_sah(inp.v0, inp.v1, inp.v2), scn.tri_v0, scn.tri_e1,
                        scn.tri_e2, "cpu")
    g = torch.Generator().manual_seed(3)
    n = 3000
    o = torch.rand(n, 3, generator=g) * torch.tensor([30.0, 8.0, 30.0]) - torch.tensor(
        [15.0, -0.5, 15.0])
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    lim = torch.full((n,), 1e4)
    lim[:400], lim[400:500] = -4.0, 0.0
    h = walk.closest(o, d, lim)
    b = trace_rays_bruteforce(scn.tri_v0, scn.tri_e1, scn.tri_e2, o, d, lim)
    assert torch.equal(h.tri, b.tri.long())
    assert torch.equal(torch.where(h.hit, h.t, lim.abs()), b.t)
    assert torch.equal(h.u, b.u) and torch.equal(h.v, b.v)
    boxes, tris, rays = walk.counts
    assert rays == n - 100 and boxes > rays and tris > 0


@pytest.mark.parametrize("workload", ["citytiny.path-d4", "sponztiny.path-d3",
                                      "citytiny.hybrid-gi"])
def test_run_is_correct(tiny_root, workload):
    cell = resolve(workload, root=tiny_root)
    res = run_cell(cell, 2**33 + 11, 0.0, False, "cpu", log=_quiet)
    assert res["correct"], res["numbers"]
    assert res["numbers"]["diverged"] < 0.005 and res["numbers"]["nonfinite"] == 0
    assert res["frames"] >= 1 and res["setup_s"] > 0


def _broken(new, kind):
    """A frame's answers (radiance or RT colour, one row a pixel) broken."""
    new = new.clone()
    n = new.shape[0]
    if kind == "half":  # half the pixels left out, the mean of the rest in their place
        new[n // 2:] = new[:n // 2].mean(dim=0)
    else:  # "altered": every answer scaled by 5% where it is produced
        new = new * 1.05
    return new


def _mix(kind):
    """The progressive mix with a fault: the decay of the old image dropped,
    or the weight 1/frame in place of 1/(frame+1)."""
    def mix(accum, new, frame):
        if frame <= 0:
            return new
        if kind == "no_decay":
            return accum + new / (frame + 1.0)
        return accum * (1.0 - 1.0 / frame) + new / frame
    return mix


def _break(monkeypatch, mode, kind):
    from vkrt_tpu_torch import engine as engine_mod
    from vkrt_tpu_torch.models import hybrid, pathtracer

    if kind in ("no_decay", "weight_1_over_f"):
        monkeypatch.setattr(pathtracer if mode == "path" else hybrid, "accumulate", _mix(kind))
    elif kind == "unchanged":  # a frame that returns its state unchanged
        if mode == "path":
            monkeypatch.setattr(engine_mod, "pathtrace_frame",
                                lambda scene, tracer, cam, frame, accum, *a, **kw: (accum, 0.0))
        else:
            real = engine_mod.hybrid_frame

            def frame(scene, tracer, cam, frame, accum_rt, *a, **kw):
                g, _, rays, state = real(scene, tracer, cam, frame, accum_rt, *a, **kw)
                return g, accum_rt, rays, state

            monkeypatch.setattr(engine_mod, "hybrid_frame", frame)
    elif mode == "path":
        real = pathtracer.trace_pixels
        monkeypatch.setattr(pathtracer, "trace_pixels", lambda *a, **kw: (
            lambda r: r._replace(radiance=_broken(r.radiance, kind)))(real(*a, **kw)))
    else:
        real = hybrid.accumulate
        monkeypatch.setattr(hybrid, "accumulate", lambda accum, new, frame: real(
            accum, _broken(new, kind), frame))


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered", "no_decay",
                                  "weight_1_over_f"])
@pytest.mark.parametrize("workload", ["citytiny.path-d4", "citytiny.hybrid-gi"])
def test_broken_timed_path_is_not_correct(tiny_root, workload, kind, monkeypatch):
    cell = resolve(workload, root=tiny_root)
    _break(monkeypatch, "path" if "path" in workload else "hybrid", kind)
    res = run_cell(cell, 77, 0.0, False, "cpu", log=_quiet)
    assert not res["correct"], res["numbers"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_broken_orbit_is_not_correct(tiny_root, kind, monkeypatch):
    """The faults of the timed path that a cell restarting its accumulation
    every frame can have (the mix's weight is 1 there, so the two faults of
    the mix change nothing)."""
    cell = resolve("cityorbit.hybrid-denoised-orbit", root=tiny_root)
    _break(monkeypatch, "hybrid", kind)
    res = run_cell(cell, 77, 0.0, False, "cpu", log=_quiet)
    assert not res["correct"], res["numbers"]


@pytest.mark.parametrize("workload", ["citytiny.path-d4", "citytiny.hybrid-gi"])
def test_lower_precision_control_is_not_correct(tiny_root, workload):
    """The reference in bfloat16 in the program's place fails the limit."""
    cell = resolve(workload, root=tiny_root)
    inp = scenes.make("city", cell.config["scene"], "")
    frames = list(range(1001, 1005))
    pids = check.draw_pixels(5, cell.width * cell.height, 1024)
    f32 = check.Reference(cell, inp, "cpu").image(pids, frames)
    bf16 = check.Reference(cell, inp, "cpu", torch.bfloat16).image(pids, frames)
    nums = check.numbers(bf16, f32)
    assert not check.judge(nums, cell.limits)[0], nums
    assert np.isfinite(nums["diverged"]) and nums["diverged"] > 0.1


@pytest.mark.gpu
def test_run_on_the_card(tiny_root, card):
    cell = resolve("citytiny.path-d4", root=tiny_root)
    res = run_cell(cell, 5, 0.5, False, "cuda", log=_quiet)
    assert res["correct"], res["numbers"]
