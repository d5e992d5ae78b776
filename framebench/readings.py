"""The readings a cell's limits are set from, in one process on the card:
the program's check numbers over many seeds (each a short window at the
cell's own size, as many (pixel, frame) pairs compared as a run compares),
and the control's (the reference in bfloat16 in the program's place) on the
first ``--control`` seeds. Not part of a benchmark run. A cell whose
camera moves or that denoises is read as ``framebench.run`` checks it: each
seed starts a fresh history at the seed's first pose, and one check frame
after the window is compared (``check.Reference.step``).

    python -m framebench.readings --workload <cell> --seconds 8 --control 3 \
        --seeds 11 12 13 ...
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from framebench import check, scenes
from framebench.cells import make_engine, resolve
from framebench.run import check_frame, frame_start, poses, renderer


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("framebench.readings needs a CUDA device", file=sys.stderr)
        return 3
    cell = resolve(args.workload)
    inp = scenes.make(cell.config["scene"]["generator"], cell.config["scene"],
                      f"{cell.bench_dir}/assets")
    engine = make_engine(cell, inp, "cuda")
    engine.render_frame()
    ref = check.Reference(cell, inp, "cuda")
    ctrl = check.Reference(cell, inp, "cuda", torch.bfloat16) if args.control else None
    for i, seed in enumerate(args.seeds):
        pose_at = poses(cell, seed)
        render = renderer(engine, pose_at)
        if check.stepwise(cell):  # a run's build frame, from a fresh history
            for t in engine.denoise_state or ():
                t.zero_()
            render()
        engine.frame = frame_start(seed) - 1
        engine.accum.zero_()
        engine.accum_rt.zero_()
        frames = []
        t0 = time.perf_counter()
        for _ in range(int(cell.traffic["warmup_frames"])):
            render()
            frames.append(engine.frame)
        while time.perf_counter() - t0 < args.seconds:
            out = render()
            frames.append(engine.frame)
        torch.cuda.synchronize()
        if check.stepwise(cell):
            program, pose, inputs = check_frame(engine, cell, seed, render, pose_at, frames[-1])
            t1 = time.perf_counter()
            want = ref.posed(pose).step(**inputs)
            err = check.pixel_errors(program[0], want[0].cpu())
            row = {"seed": seed, "frames": len(frames), "pixels": len(inputs["centres"]),
                   "footprint": len(inputs["footprint"]),
                   "program": check.step_numbers(program, want),
                   "reference_s": time.perf_counter() - t1,
                   "largest_pixel_errors": sorted(err.tolist())[-5:],
                   "pixels_over": {f"{t:g}": int((err > t).sum())
                                   for t in (1e-6, 1e-4, 1e-3, 1e-2)}}
            if i < args.control:
                got = ctrl.posed(pose).step(**inputs)
                row["control"] = check.step_numbers(
                    (got[0].float().cpu(),
                     got[1] and {k: v.float().cpu() for k, v in got[1].items()}), want)
            print(json.dumps(row), flush=True)
            continue
        pids = check.draw_pixels(seed, cell.width * cell.height,
                                 check.sample_count(len(frames)))
        program = out[torch.as_tensor(pids, device=out.device)].float().cpu()
        t1 = time.perf_counter()
        want = ref.image(pids, frames).cpu()
        err = check.pixel_errors(program, want)
        row = {"seed": seed, "frames": len(frames), "pixels": len(pids),
               "program": check.numbers(program, want),
               "reference_s": time.perf_counter() - t1,
               "largest_pixel_errors": sorted(err.tolist())[-5:],
               "pixels_over": {f"{t:g}": int((err > t).sum()) for t in (1e-6, 1e-4, 1e-3, 1e-2)}}
        if i < args.control:
            row["control"] = check.numbers(ctrl.image(pids, frames).cpu(), want)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
