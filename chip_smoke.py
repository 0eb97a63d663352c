#!/usr/bin/env python
"""Bring-up check of the map-building pipeline on NVIDIA GPUs.

Drives the main path through the entry points a user calls
(``SegmentationEngine.run_replay``, ``process_frame``, ``start`` +
``run_streaming_from_log``) at the shipped widths, and compares every
phase with the numpy oracle (the executable spec):

    python chip_smoke.py                  # one GPU: every single-card phase
    python chip_smoke.py --multi-gpu 4    # four GPUs: the mesh phase only

Output: first the card's ``name, power.limit`` as nvidia-smi reports it,
then one JSON object per phase (wall and compile seconds, the step's
``memory_analysis()``, ``peak_bytes_in_use``, parity drift, which runtime
components ran), and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Exits non-zero without that line when JAX finds no GPU, when the package
is not importable, or when any phase fails.  Everything runs in this one
process: a JAX process reserves most of the card when it starts.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

F32_TOL = 5e-3      # endpoint/parameter drift per segment, f32 pipeline (m)
F64_TOL = 1e-4      # f64 parity mode, end to end (tests/test_parity_f64.py)
N_TRUTH = 7         # beams in the wp_tests scene


# ------------------------------------------------------------ comparisons

def oracle_segments(wm) -> list[dict]:
    """Oracle world map as rows keyed like SegmentationEngine.world_segments."""
    return [{"a": np.asarray(s.a, np.float64), "b": np.asarray(s.b, np.float64),
             "t_min": float(s.t_min), "t_max": float(s.t_max),
             "radius": float(s.radius), "points_size": int(s.points_size),
             "pca_coeff": float(s.pca_coeff)} for s in wm.segments]


def _endpoints(s):
    a, b = np.asarray(s["a"], np.float64), np.asarray(s["b"], np.float64)
    return a + s["t_min"] * b, a + s["t_max"] * b


def compare_world(got_segs, got_inter, ref_segs, ref_inter, tol) -> dict:
    """Device world map vs the oracle's: segment count, inlier counts and
    radii exact (radii compared as f32, the pipeline's storage type),
    endpoints, pca_coeff and intersection parameters within ``tol``,
    intersection topology exact."""
    errors = []
    drift = {"endpoint": 0.0, "pca_coeff": 0.0, "intersection_t": 0.0}
    if len(got_segs) != len(ref_segs):
        errors.append(f"segment count {len(got_segs)} != {len(ref_segs)}")
    for k, (g, r) in enumerate(zip(got_segs, ref_segs)):
        if int(g["points_size"]) != int(r["points_size"]):
            errors.append(f"seg {k} points_size {g['points_size']} != "
                          f"{r['points_size']}")
        if np.float32(g["radius"]) != np.float32(r["radius"]):
            errors.append(f"seg {k} radius {g['radius']} != {r['radius']}")
        (g1, g2), (r1, r2) = _endpoints(g), _endpoints(r)
        d = max(np.linalg.norm(g1 - r1), np.linalg.norm(g2 - r2))
        drift["endpoint"] = max(drift["endpoint"], float(d))
        if not d <= tol:
            errors.append(f"seg {k} endpoints drift {d:.3g} > {tol:g}")
        dp = abs(float(g["pca_coeff"]) - float(r["pca_coeff"]))
        drift["pca_coeff"] = max(drift["pca_coeff"], dp)
        if not dp <= tol:
            errors.append(f"seg {k} pca_coeff drift {dp:.3g} > {tol:g}")
    got_pairs = [(i, j) for i, _, j, _ in got_inter]
    ref_pairs = [(i, j) for i, _, j, _ in ref_inter]
    if got_pairs != ref_pairs:
        errors.append(f"intersection topology {got_pairs} != {ref_pairs}")
    else:
        for (_, gt1, _, gt2), (_, rt1, _, rt2) in zip(got_inter, ref_inter):
            dt = max(abs(gt1 - rt1), abs(gt2 - rt2))
            drift["intersection_t"] = max(drift["intersection_t"], float(dt))
            if not dt <= tol:
                errors.append(f"intersection t drift {dt:.3g} > {tol:g}")
    return {"ok": not errors, "errors": errors, "max_drift": drift}


def compare_frame(record, ref) -> list[str]:
    """Per-frame counters of an engine record vs the oracle's frame."""
    errors = []
    if record is None:
        return ["frame skipped (no pose)"]
    if record["nblines"] != ref["nblines"]:
        errors.append(f"nblines {record['nblines']} != {ref['nblines']}")
    if record["status"] != ref["status"]:
        errors.append(f"status {record['status']} != {ref['status']}")
    if record["seg_vec_size"] != len(ref["segments"]):
        errors.append(f"seg_vec_size {record['seg_vec_size']} != "
                      f"{len(ref['segments'])}")
    return errors


def beams_recovered(segs, scene) -> int:
    """Ground-truth beams matched by the world map (eval/structure.py: the
    reference's tests_structure.py criteria)."""
    from pointcloud_segmentation_tpu.eval import match_report
    from pointcloud_segmentation_tpu.io.scene import scene_truth

    proc = [dict(s, endpoints=[s["t_min"], s["t_max"]]) for s in segs]
    return match_report(scene_truth(scene), proc)["n_truth_matched"]


def oracle_trace(cfg, frames) -> list[dict]:
    """Oracle state after each frame: counters, world rows, intersections."""
    from pointcloud_segmentation_tpu import oracle

    wm = oracle.WorldMap(cfg)
    out = []
    for f in frames:
        res = oracle.process_frame(wm, f.points, f.position, f.quat_wxyz, cfg)
        out.append({"nblines": res.nblines, "status": res.status,
                    "segments": oracle_segments(wm),
                    "inter": wm.intersections_rows()})
    return out


# ------------------------------------------------------------ measurement

class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, process-wide."""

    EVENTS = ("/jax/core/compile/backend_compile_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/jaxpr_trace_duration")

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


def step_memory(cfg, frame) -> dict:
    """memory_analysis() of the engine's packed per-frame step."""
    import jax.numpy as jnp

    from pointcloud_segmentation_tpu.pipeline import (
        init_world, make_process_frame_packed)

    dt = np.float64 if cfg.compute_dtype == "float64" else np.float32
    raw = np.full((cfg.shapes.max_raw_points, 3), np.nan, dt)
    raw[: len(frame.points)] = frame.points[: len(raw)]
    compiled = make_process_frame_packed(cfg).lower(
        init_world(cfg), jnp.asarray(raw), jnp.asarray(frame.position, dt),
        jnp.asarray(frame.quat_wxyz, dt)).compile()
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes", "peak_memory_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


def peak_bytes_in_use():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def runtime_components(eng) -> dict:
    from pointcloud_segmentation_tpu import native

    have = native.available()
    return {
        "mailbox": ("native" if have and isinstance(eng.mailbox,
                                                    native.NativeMailbox)
                    else "python"),
        "pose_buffer": ("native" if have and isinstance(
            eng.poses, native.NativePoseBuffer) else "python"),
        "csv_writers": "native" if have else "python",
    }


# ------------------------------------------------------------ scenarios

def make_cfg(granularity, sensor=64, **kw):
    from pointcloud_segmentation_tpu.config import StaticShapes, default_config

    shapes = (StaticShapes(max_raw_points=4096, max_points=2048)
              if sensor == 64 else
              StaticShapes(max_raw_points=16384, max_points=6144))
    return default_config(granularity=granularity, shapes=shapes, **kw)


def make_frames(sensor=64, n=None, seed=0):
    """wp_tests flight over the 7-beam scene: 145 frames at 4 Hz, 0.1 m/s,
    noise 0.002 (the README accuracy protocol)."""
    from pointcloud_segmentation_tpu.io.scene import (
        OBS_TESTS_SCENE, WP_TESTS, trajectory_poses)
    from pointcloud_segmentation_tpu.io.simulator import (
        TofSpec, simulate_trajectory)

    poses = trajectory_poses(WP_TESTS, hz=4.0, velocity=0.1)
    if n is not None:
        poses = poses[:n]
    return simulate_trajectory(
        OBS_TESTS_SCENE, poses,
        TofSpec(width=sensor, height=sensor, noise_frac=0.002), seed=seed)


def replay_phase(cfg, frames, ref, tol, outdir, min_beams=N_TRUTH,
                 mem_label="step") -> dict:
    """Step the first len(ref) frames one at a time through the engine,
    comparing the world map with the oracle after each; replay the rest;
    write the CSVs; count recovered beams."""
    from pointcloud_segmentation_tpu.io.scene import OBS_TESTS_SCENE
    from pointcloud_segmentation_tpu.runtime import SegmentationEngine

    eng = SegmentationEngine(cfg, backend="jax")
    errors = []
    drift = {"endpoint": 0.0, "pca_coeff": 0.0, "intersection_t": 0.0}
    for k, (fr, r) in enumerate(zip(frames, ref)):
        eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
        rec = eng.process_frame(fr.t, fr.points)
        errors += [f"frame {k}: {e}" for e in compare_frame(rec, r)]
        segs, inter = eng.world_snapshot()
        cmp = compare_world(segs, inter, r["segments"], r["inter"], tol)
        errors += [f"frame {k}: {e}" for e in cmp["errors"]]
        drift = {key: max(drift[key], cmp["max_drift"][key]) for key in drift}
    recs = eng.run_replay(frames[len(ref):])
    paths = eng.finalize(outdir)
    segs = eng.world_segments()
    beams = beams_recovered(segs, OBS_TESTS_SCENE)
    if beams < min_beams:
        errors.append(f"recovered {beams}/{N_TRUTH} beams, need {min_beams}")
    csv_rows = {k: sum(1 for _ in open(p)) - 1 for k, p in paths.items()}
    if csv_rows["processing_time"] != len(ref) + len(recs):
        errors.append(f"processing_time.csv rows {csv_rows}")
    return {"ok": not errors, "errors": errors[:20],
            "frames": len(frames), "oracle_frames": len(ref),
            "max_drift": drift, "world_segments": len(segs),
            "beams": f"{beams}/{N_TRUTH}", "csv_rows": csv_rows,
            "memory": {mem_label: step_memory(cfg, frames[0])},
            "runtime_components": runtime_components(eng)}


def stream_phase(cfg, frames, rate_hz=30.0, min_beams=N_TRUTH - 1) -> dict:
    """start() + run_streaming_from_log at sensor rate, with a second
    thread reading the world map every ~50 ms: the donated state buffer
    must never be read after deletion."""
    from pointcloud_segmentation_tpu import native
    from pointcloud_segmentation_tpu.io.replay import save_frames
    from pointcloud_segmentation_tpu.io.scene import OBS_TESTS_SCENE
    from pointcloud_segmentation_tpu.runtime import SegmentationEngine

    logged = []

    class _Capture(logging.Handler):
        def emit(self, record):
            logged.append(record.getMessage() + (
                str(record.exc_info[1]) if record.exc_info else ""))

    logger = logging.getLogger("pointcloud_segmentation_tpu")
    handler = _Capture(level=logging.WARNING)
    logger.addHandler(handler)
    reader_errors, reads = [], [0]
    stop = threading.Event()
    eng = SegmentationEngine(cfg, backend="jax")

    def reader():
        while not stop.is_set():
            try:
                eng.world_segments()
                eng.intersections_rows()
                reads[0] += 1
            except Exception as e:      # recorded and judged below
                reader_errors.append(f"{type(e).__name__}: {e}")
            stop.wait(0.05)

    with tempfile.TemporaryDirectory() as tmp:
        log_path = os.path.join(tmp, "stream.pcsl")
        save_frames(log_path, frames)
        # compile the step before the paced feed starts
        eng.push_pose(frames[0].t, frames[0].position, frames[0].quat_wxyz)
        eng.process_frame(frames[0].t, frames[0].points)
        eng.start()
        th = threading.Thread(target=reader, daemon=True)
        th.start()
        try:
            stats = eng.run_streaming_from_log(log_path, rate_hz=rate_hz)
        finally:
            stop.set()
            th.join(timeout=30.0)
            eng.stop()
            logger.removeHandler(handler)
    beams = beams_recovered(eng.world_segments(), OBS_TESTS_SCENE)
    errors = list(reader_errors[:5])
    errors += [m for m in logged if "deleted" in m.lower()][:5]
    if eng.frames_failed:
        errors.append(f"frames_failed={eng.frames_failed}")
    if beams < min_beams:
        errors.append(f"recovered {beams}/{N_TRUTH} beams, need {min_beams}")
    if reads[0] == 0:
        errors.append("the reader thread never completed a read")
    feeder = ("native" if native.available()
              and isinstance(eng.mailbox, native.NativeMailbox) else "python")
    return {"ok": not errors, "errors": errors, "rate_hz": rate_hz,
            "stream": stats, "reader_reads": reads[0],
            "frames_failed": eng.frames_failed,
            "beams": f"{beams}/{N_TRUTH}",
            "runtime_components": dict(runtime_components(eng),
                                       feeder=feeder)}


def multi_gpu_phase(devices) -> dict:
    """The mesh paths on every card against the single-card result: carry
    and lazy voting on a 2x2 batch/direction mesh and a 1x4
    direction-tensor-parallel mesh, with the g6 sharded-lazy pass."""
    from pointcloud_segmentation_tpu.config import StaticShapes

    import __graft_entry__

    shapes = StaticShapes(max_raw_points=4096, max_points=2048,
                          max_world_segments=64)
    n = len(devices)
    meshes = [(2, 2), (1, 4)] if n == 4 else [(1, n)]
    return {"ok": True, "meshes": [
        __graft_entry__.check_multichip(devices, b, d, shapes=shapes)
        for b, d in meshes]}


# ------------------------------------------------------------ driver

def _emit(obj) -> None:
    print(json.dumps(obj, default=str), flush=True)


def run_phase(name, fn, clock) -> bool:
    t0, c0 = time.perf_counter(), clock.total
    try:
        out = fn()
    except Exception as e:      # a phase failure is reported, not fatal
        import traceback

        out = {"ok": False, "errors": [f"{type(e).__name__}: {e}"],
               "traceback": traceback.format_exc()[-2000:]}
    out = {"phase": name, **out,
           "wall_s": time.perf_counter() - t0,
           "compile_s": clock.total - c0,
           "peak_bytes_in_use": peak_bytes_in_use()}
    _emit(out)
    return bool(out["ok"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-gpu", type=int, default=0, metavar="N",
                    help="run only the N-card mesh phase")
    args = ap.parse_args(argv)

    from pointcloud_segmentation_tpu.devices import nvidia_smi_lines

    smi = nvidia_smi_lines()
    for line in smi or ["nvidia-smi: not available"]:
        print(line, flush=True)

    import jax

    devs = jax.devices()
    want = max(args.multi_gpu, 1)
    if devs[0].platform != "gpu" or len(devs) < want:
        print(f"chip_smoke: needs {want} GPU(s); JAX found "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 1
    from pointcloud_segmentation_tpu.compile_cache import enable_compile_cache

    _emit({"phase": "guard", "ok": True, "platform": devs[0].platform,
           "kind": devs[0].device_kind, "count": len(devs),
           "nvidia_smi": smi, "jax": jax.__version__,
           "compile_cache": enable_compile_cache()})
    clock = CompileClock()

    if args.multi_gpu:
        ok = run_phase(f"multi_gpu_{args.multi_gpu}",
                       lambda: multi_gpu_phase(devs[:args.multi_gpu]), clock)
    else:
        ok = single_gpu(clock)
    if not ok:
        return 1
    _emit({"ok": True, "device": {"platform": devs[0].platform,
                                  "kind": devs[0].device_kind,
                                  "count": want if args.multi_gpu else 1}})
    return 0


def single_gpu(clock) -> bool:
    import jax

    frames64 = make_frames(64)
    frames128 = make_frames(128, n=12)
    g6, g4 = make_cfg(6), make_cfg(4)
    s128 = make_cfg(4, sensor=128)
    assert g6.voting_mode == "lazy" and g4.voting_mode == "carry"
    # the oracle runs on host threads while the card compiles
    with ThreadPoolExecutor(max_workers=3) as pool:
        ref_g6 = pool.submit(oracle_trace, g6, frames64[:6])
        ref_g4 = pool.submit(oracle_trace, g4, frames64[:12])
        ref_128 = pool.submit(oracle_trace, s128, frames128[:3])
        with tempfile.TemporaryDirectory() as tmp:
            ok = run_phase("replay_g6", lambda: replay_phase(
                g6, frames64, ref_g6.result(), F32_TOL,
                os.path.join(tmp, "g6")), clock)
            ok &= run_phase("replay_g4", lambda: replay_phase(
                g4, frames64, ref_g4.result(), F32_TOL,
                os.path.join(tmp, "g4")), clock)
            ok &= run_phase("sensor_128", lambda: replay_phase(
                s128, frames128, ref_128.result(), F32_TOL,
                os.path.join(tmp, "s128"), min_beams=0), clock)

            def f64():
                with jax.enable_x64(True):
                    return replay_phase(
                        g4.replace(compute_dtype="float64"), frames64,
                        ref_g4.result(), F64_TOL, os.path.join(tmp, "f64"))

            ok &= run_phase("f64_parity", f64, clock)
    ok &= run_phase("stream_g6", lambda: stream_phase(g6, frames64), clock)
    return ok


if __name__ == "__main__":
    sys.exit(main())
