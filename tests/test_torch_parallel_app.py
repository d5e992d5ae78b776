"""The port's mesh entry points on gloo CPU ranks: ``factor_mesh`` and the
band layout (``vkrt_tpu_torch/parallel``), the app's ``--mesh`` (as
tests/test_parallel.py::test_app_mesh_cli drives the JAX app's: the spp
error before any rank starts, then a (2,2) render to PNG), suite row 6
(``cornell_sharded_mesh``) at 32x24 with the JAX suite's keys,
``dryrun_multichip(4)`` (the port's ``__graft_entry__.dryrun_multichip``: the path
leg, then the hybrid + denoiser leg),
and a failing rank failing ``launch``."""

import json

import numpy as np
import pytest
import torch

from vkrt_tpu.parallel.mesh import factor_mesh as j_factor_mesh
from vkrt_tpu_torch import app
from vkrt_tpu_torch.benchmarks import suite
from vkrt_tpu_torch.parallel.dryrun import dryrun_multichip
from vkrt_tpu_torch.parallel.mesh import RenderMesh, factor_mesh, launch
from vkrt_tpu_torch.parallel.render import band_pixels, run_jobs, zeros_accum
from vkrt_tpu_torch.utils.camera import tile_perm
from vkrt_tpu_torch.utils.png import decode_png


def test_factor_mesh():
    assert factor_mesh(8) == (4, 2)
    assert factor_mesh(2) == (2, 1)
    assert factor_mesh(1) == (1, 1)
    assert factor_mesh(6) == (3, 2)
    for n in range(1, 17):
        assert factor_mesh(n) == j_factor_mesh(n)


def band_mesh(tile, n_tile):
    return RenderMesh(shape={"tile": n_tile, "spp": 1}, tile=tile, spp=0, groups={},
                      backend="gloo", device=torch.device("cpu"))


@pytest.mark.parametrize("w,h,n_tile", [(64, 32, 4), (64, 32, 1), (48, 10, 4)])
def test_bands_partition_the_frame(w, h, n_tile):
    """A rank's pixels and accumulator are its band only; the bands
    partition the frame, each band in 32x32-tile order when the rows split
    evenly (contiguous scanline chunks otherwise), and ``inv_perm`` maps
    the gathered bands to scanline order. Hybrid bands are scanline rows."""
    pids, pixs = [], []
    for b in range(n_tile):
        pix, pid, inv = band_pixels(band_mesh(b, n_tile), w, h, tiled=True)
        assert pid.shape == (w * h // n_tile,)
        assert zeros_accum(band_mesh(b, n_tile), w, h, 4).shape == (w * h // n_tile, 4)
        assert torch.equal(pix[:, 0].long(), pid % w) and torch.equal(pix[:, 1].long(), pid // w)
        pids.append(pid)
        hyb = band_pixels(band_mesh(b, n_tile), w, h, tiled=False)[1]
        band_n = w * h // n_tile
        assert torch.equal(hyb, torch.arange(b * band_n, (b + 1) * band_n))
    order = torch.cat(pids)
    assert torch.equal(order[inv], torch.arange(w * h))
    if h % n_tile == 0:
        hb = h // n_tile
        perm, _ = tile_perm(w, hb)
        for b, pid in enumerate(pids):
            assert torch.equal(pid, torch.from_numpy(perm.astype(np.int64)) + b * hb * w)
    else:
        assert torch.equal(order, torch.arange(w * h))


def test_app_mesh_cli(tmp_path, capsys):
    """``--mesh`` end to end: the spp error exits 2 before any rank starts,
    then a (2,2) path render writes its PNG."""
    out = str(tmp_path / "mesh.png")
    base = ["--device", "cpu", "--procedural", "cornell", "--mode", "path", "--width", "64",
            "--height", "48", "--out", out]
    assert app.main(base + ["--mesh", "4,2", "--spp", "1"]) == 2
    assert "divisible by the spp mesh axis" in capsys.readouterr().err
    assert app.main(["--device", "cpu", "--procedural", "cornell", "--mesh", "2,2",
                     "--out", out]) == 2  # hybrid shards pixels only
    assert app.main(base + ["--mode", "hybrid", "--gi", "--denoiser", "--height", "50",
                            "--mesh", "4,1"]) == 2  # no whole row bands
    assert app.main(base + ["--mesh", "2,2", "--spp", "2", "--frames", "2",
                            "--backend", "bruteforce"]) == 0
    assert "mesh(tile=2, spp=2) over gloo, 4 ranks on the CPU" in capsys.readouterr().out
    img = decode_png(open(out, "rb").read())
    assert img.shape[:2] == (48, 64)
    assert img[..., :3].std() > 5.0  # an actual image, not a constant


def test_suite_row_6(capsys):
    """Row 6 at 32x24 on the CPU: one rank (mesh (1,1)), the JAX suite's
    keys, and the last batch's image equal to the engine's."""
    from vkrt_tpu_torch.config import RenderSettings
    from vkrt_tpu_torch.engine import Engine
    from vkrt_tpu_torch.scene import load_cornell

    recs = suite.main(["--device", "cpu", "--width", "32", "--height", "24", "--frames", "2",
                       "--configs", "6"])
    (rec,) = recs
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert {"config", "mesh", "ms_per_frame", "fps", "mrays_per_s", "frames",
            "resolution"} <= set(rec)
    assert rec["config"] == "cornell_sharded_mesh" and rec["mesh"] == "tile=1,spp=1"
    assert rec["frames"] == 2 and rec["resolution"] == "32x24" and rec["mrays_per_s"] > 0
    out = suite.run_sharded_bench("row6", 32, 24, 2, 3, torch.device("cpu"), batches=2)
    assert len(out["batches"]) == 2
    e = Engine(load_cornell(device="cpu"), 32, 24,
               RenderSettings(rt_mode=1, samples=1, depth=3), clear_color=(1, 1, 1, 1))
    for _ in range(2):
        e.render_frame()
    assert torch.equal(out["accum"], e.accum[e._inv_perm])


def test_dryrun_multichip(capsys):
    out = dryrun_multichip(4)
    assert out["mesh"] == {"tile": 2, "spp": 2} and out["rays"] > 0
    assert (out["width"], out["height"]) == (32, 8)
    printed = capsys.readouterr().out
    assert "dryrun_multichip OK: mesh(tile=2, spp=2)" in printed
    # the hybrid + denoiser leg after the path step's line, as in the JAX dry run
    hybrid = out["hybrid"]
    assert hybrid["mesh"] == {"tile": 4, "spp": 1} and hybrid["rays"] > 0
    assert (hybrid["width"], hybrid["height"]) == (32, 32)
    assert printed.index("dryrun_multichip OK") < printed.index(
        "dryrun_multichip hybrid+denoiser OK: mesh(tile=4, spp=1)")


def test_a_failing_rank_fails_launch():
    with pytest.raises(Exception, match="unknown job kind"):
        launch(run_jobs, 2, 1, "cpu", [{"kind": "bogus"}])
    with pytest.raises(ValueError, match="has no ranks"):
        launch(run_jobs, 0, 1, "cpu", [])
