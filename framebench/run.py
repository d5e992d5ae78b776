"""The port's frame benchmark: one run of one cell.

    python -m framebench.run --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

Builds the cell's scene from the benchmark's own inputs, drives
``vkrt_tpu_torch.engine.Engine.render_frame`` through warm-up and then for
``--seconds`` of frames, checks the final image against the plain
reference (``framebench/check.py``) and prints one JSON line last. A cell
whose traffic moves the camera (``"camera": {"orbit_turns_per_frame": x}``)
sets the engine's camera before each frame, and it or a denoised cell is
checked on one more frame after the window (``check.Reference.step``). With
``--trace 0`` it reports the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics from a profiled stretch of whole frames inside the
window. It needs as many CUDA devices as the cell asks for and runs on
nothing else. ``BENCHMARK.json`` at the root of the checkout names the
cells; everything a cell needs is found by name under ``framebench/``.
"""

from __future__ import annotations

import time

_T0 = time.time()  # process start, for setup_s

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from framebench.cells import camera_pose  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

FORBIDDEN = ("jax", "jaxlib", "flax", "vkrt_tpu")
START_FRAMES = 64  # the frame a run's accumulation starts at: 1 .. START_FRAMES
TRACE_FROM = 2  # the traced stretch: window frames [2, 2 + frames)


def loaded_forbidden():
    """Top-level names in ``sys.modules`` that a run must not load, compared
    whole (``vkrt_tpu_torch`` is not ``vkrt_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def frame_start(seed: int) -> int:
    """The frame the accumulation restarts at, from the seed: small beside a
    window's hundreds of frames, so the final image is most of the mean a
    session from frame 0 shows and the mix's weights 1/(frame+1) are a real
    session's."""
    return 1 + int(seed) % START_FRAMES


def poses(cell, seed: int):
    """Call j of ``render_frame`` in a run (j = 0 the build frame) -> its
    camera pose (eye, center, fov_deg), or None for a static camera. An
    orbit advances ``orbit_turns_per_frame`` a call from the config's orbit
    parameter plus the seed's start frame's worth: the seed picks the start
    pose, and every pose follows from it and the call's number."""
    motion = cell.traffic.get("camera", "static")
    if motion == "static":
        return None
    cam = cell.config["camera"]
    if "orbit" not in cam or set(motion) != {"orbit_turns_per_frame"}:
        raise ValueError(f"{cell.name}: camera motion {motion!r} needs an orbit camera and "
                         "orbit_turns_per_frame alone")
    turns, f0 = float(motion["orbit_turns_per_frame"]), frame_start(seed)
    return lambda j: camera_pose({**cam, "orbit": float(cam["orbit"]) + (f0 + j) * turns})


def renderer(engine, pose_at):
    """``render()`` for calls 0, 1, ... of a run: ``engine.render_frame``
    itself on a static camera, else the camera set to the call's pose and
    then the frame (building the ``Camera`` is part of the frame, as for a
    viewer). ``render.calls`` counts the calls."""
    if pose_at is None:
        return engine.render_frame
    from vkrt_tpu_torch.utils.camera import Camera

    def render():
        eye, center, fov = pose_at(render.calls)
        engine.camera = Camera(eye=eye, center=center, fov_deg=fov)
        render.calls += 1
        return engine.render_frame()

    render.calls = 0
    return render


def check_frame(engine, cell, seed: int, render, pose_at, last_frame: int):
    """Renders the check frame after the window and takes what its check
    compares: (the program's image and new history at the compared pixels,
    the pose, the reference's inputs: ``check.Reference.step``'s
    arguments). The RT buffer at those pixels and the denoiser's whole history
    are taken from the timed path just before the frame."""
    import torch

    from framebench import check
    from framebench.reference import denoise as ref_dn
    from framebench.reference.render import tile_position

    centres, footprint = check.step_pixels(cell, seed)
    ids = torch.as_tensor(centres, device=engine.device)
    hybrid = cell.traffic["settings"].get("rt_mode", 0) == 0
    buf = engine.accum_rt if hybrid else engine.accum  # in the engine's tile order
    accum = buf[tile_position(ids, cell.width, cell.height)].float().cpu()
    state = None
    if check.denoises(cell) and engine.denoise_state is not None:
        state = {f: getattr(engine.denoise_state, f).clone() for f in ref_dn.STATE}
    moving = pose_at is not None
    j = render.calls if moving else None
    out = render()
    image = out[ids].float().cpu()
    new_state = None
    if state is not None:
        new_state = {f: getattr(engine.denoise_state, f)[ids].float().cpu()
                     for f in ref_dn.STATE}
    static = camera_pose(cell.config["camera"])
    inputs = dict(centres=centres, footprint=footprint,
                  frame=0 if moving else last_frame + 1,  # a pose change restarts at 0
                  prev_pose=pose_at(j - 1) if moving else static, accum=accum, state=state)
    return (image, new_state), (pose_at(j) if moving else static), inputs


def _cache_dirs():
    """Kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(HERE, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def _quantile(values, q):
    """Nearest-rank quantile."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def _load_reader(bench_dir, name):
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"framebench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str, t0: float = None,
             log=print):
    """One run of ``cell``; returns its measurements and the check's verdict
    as a dict."""
    import torch

    from framebench import check, scenes
    from framebench.cells import make_engine

    t0 = _T0 if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    inp = scenes.make(cell.config["scene"]["generator"], cell.config["scene"],
                      os.path.join(cell.bench_dir, "assets"))
    engine = make_engine(cell, inp, device)
    pose_at = poses(cell, seed)
    render = renderer(engine, pose_at)

    # warm-up: frame 0 builds the kernels and the tree; then accumulation
    # restarts at the seed's frame, so only the RNG stream follows the seed
    render()
    f0 = frame_start(seed)
    engine.frame = f0 - 1
    engine.accum.zero_()     # path mode's buffer
    engine.accum_rt.zero_()  # hybrid mode's
    frames = []
    for _ in range(int(cell.traffic["warmup_frames"])):
        render()
        frames.append(engine.frame)
    sync()
    setup_s = time.time() - t0

    recorder = None
    n_trace = int(cell.traffic.get("trace_frames", 4))
    if trace:
        from framebench.profile import Recorder

        recorder = Recorder()
    ends = []
    if cuda:
        start_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
    t_start = time.perf_counter()
    n = 0
    out = None
    while True:
        if recorder is not None and n == TRACE_FROM:
            recorder.start()
        if recorder is not None and TRACE_FROM <= n < TRACE_FROM + n_trace:
            with torch.autograd.profiler.record_function("framebench.frame"):
                out = render()
        else:
            out = render()
        frames.append(engine.frame)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
        n += 1
        if recorder is not None and n == TRACE_FROM + n_trace:
            recorder.stop()
        if (time.perf_counter() - t_start >= seconds
                and (recorder is None or n >= TRACE_FROM + n_trace)):
            break
    sync()
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    intervals = []
    if cuda:
        prev = start_ev
        for ev in ends:
            intervals.append(prev.elapsed_time(ev))
            prev = ev
    result = {"frames": n, "window_s": window_s, "setup_s": setup_s,
              "frame_ms": 1e3 * window_s / n, "f0": f0,
              "frame_ms_p95": _quantile(intervals, 0.95) if intervals else None,
              "memory_peak_bytes": int(peak)}
    log(f"[framebench] {cell.name} seed {seed}: {n} frames in {window_s:.6f} s "
        f"({result['frame_ms']:.6f} ms/frame), set-up {setup_s:.6f} s, frames "
        f"{frames[0]}..{frames[-1]}, peak {peak} B")

    # the program's state goes before the reference runs
    if check.stepwise(cell):
        program, pose, inputs = check_frame(engine, cell, seed, render, pose_at, frames[-1])
        del engine, out
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        ref = check.Reference(cell, inp, device, pose=pose)
        nums = check.step_numbers(program, ref.step(**inputs))
        n_px = len(inputs["centres"])
        what = f"{n_px} pixels of one frame (footprint {len(inputs['footprint'])})"
        del inputs
    else:
        k = check.sample_count(len(frames))
        pids = check.draw_pixels(seed, cell.width * cell.height, k)
        program = out[torch.as_tensor(pids, device=out.device)].float().cpu()
        del engine, out
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        ref = check.Reference(cell, inp, device)
        reference = ref.image(pids, frames).cpu()
        nums = check.numbers(program, reference)
        n_px = len(pids)
        what = f"{n_px} pixels x {len(frames)} frames"
    correct, lines = check.judge(nums, cell.limits)
    log(f"[framebench] reference over {what} in {time.perf_counter() - t_ref:.3f} s; "
        f"rel_l1 {nums['rel_l1']!r}")
    result.update(correct=correct, numbers=nums, check_lines=lines, pixels=n_px)

    if recorder is not None:
        from framebench.profile import own_kernel_names, reduce_trace
        from framebench.roofline import Yardsticks, power_limit

        stretch = reduce_trace(recorder.events(), own_kernel_names(ROOT))
        # kernel A's yardstick walks the pose of the stretch's first frame
        traced = pose_at(1 + int(cell.traffic["warmup_frames"]) + TRACE_FROM) if pose_at else None
        stretch.yard = Yardsticks(cell, ref.posed(traced) if traced else ref)
        per_layer = {}
        for m in cell.per_layer:
            v = _load_reader(cell.bench_dir, m["name"])(stretch)
            if v is not None:
                per_layer[m["name"]] = {"value": v, "unit": m["unit"]}
        result.update(per_layer=per_layer, busy_s=stretch.busy_s,
                      trace_window_s=stretch.window_s, breakdown=stretch.breakdown,
                      power_limit=power_limit() if cuda else "not read")
        log(f"[framebench] traced {stretch.frames} frames: " + ", ".join(
            f"{k} {v['value']}" for k, v in per_layer.items()))
    return result


def result_line(cell, res, trace: bool, device_name: str, count: int) -> dict:
    if trace:
        metrics = res["per_layer"]
    else:
        vals = {"frame_ms": res["frame_ms"], "frame_ms_p95": res["frame_ms_p95"],
                "setup_s": res["setup_s"]}
        metrics = {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": device_name, "count": count,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if trace:
        device.update(busy_s=res["busy_s"], window_s=res["trace_window_s"],
                      power_limit=res["power_limit"])
    line = {"correct": res["correct"], "attempted": res["frames"], "failed": 0,
            "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = res["breakdown"]
    line["compared"] = {name: {"value": v, "limit": lim} for name, v, lim, _ in
                        res["check_lines"]}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()

    import torch

    from framebench.cells import resolve

    cell = resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"framebench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", log=log)
    found = loaded_forbidden()
    if found:
        print(f"framebench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    line = result_line(cell, res, bool(args.trace), torch.cuda.get_device_name(0), cell.chips)
    for name, v, lim, good in res["check_lines"]:
        print(f"[check] {name} {v!r} limit {lim!r} {'ok' if good else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
