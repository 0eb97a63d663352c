#!/usr/bin/env python
"""Benchmark: full per-frame pipeline (cloud -> segments + world map) on
the GPU.  Refuses to run when JAX's default device is not a GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "device": {"platform", "kind", "count", "gpu": [nvidia-smi name,
   power.limit per card]}, ...}

metric  = clouds/sec per device on the full node loop (the reference's
          per-frame `processing_time` path: filter -> Hough -> transform ->
          cutoff -> fusion -> intersections), simulated wp_tests replay over
          the 7-beam benchmark scene at the shipped radius config.
baseline = the faithful numpy oracle (the CPU reference reimplementation —
          the C++ original cannot run here: no ROS/PCL and its Hough
          submodule is missing from the snapshot; BASELINE.md).
vs_baseline = device clouds/sec / CPU-oracle clouds/sec  (>1 is faster).

Extra diagnostics go to stderr.  Granularity defaults to 4 (the fork's
effective direction-table level — SURVEY.md §2.3); set BENCH_GRANULARITY=6
for the stress configuration.
"""

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_frames(cfg, n_frames):
    from pointcloud_segmentation_tpu.io.scene import (
        OBS_TESTS_SCENE, WP_TESTS, trajectory_poses)
    from pointcloud_segmentation_tpu.io.simulator import simulate_trajectory, TofSpec

    poses = trajectory_poses(WP_TESTS, hz=4.0, velocity=0.25)
    while len(poses) < n_frames:
        poses = poses + poses
    frames = simulate_trajectory(OBS_TESTS_SCENE, poses[:n_frames],
                                 TofSpec(noise_frac=0.002), seed=0)
    return frames


def bench_device(cfg, frames, warmup=2):
    """Measures:
      * steady-state throughput — frames dispatched back-to-back (each step
        consumes the previous step's world state, so this is a real
        sequential pipeline rate), one block_until_ready at the end;
      * per-frame latency — block_until_ready on every step's outputs;
      * device time per step — the step chained on device in a fori_loop.
    """
    import jax
    import jax.numpy as jnp
    from pointcloud_segmentation_tpu.pipeline import make_process_frame, init_world

    step = make_process_frame(cfg)
    state = init_world(cfg)

    def pad(fr):
        raw = np.full((cfg.shapes.max_raw_points, 3), np.nan, np.float32)
        k = min(len(fr.points), cfg.shapes.max_raw_points)
        raw[:k] = fr.points[:k]
        return (jnp.asarray(raw), jnp.asarray(fr.position, jnp.float32),
                jnp.asarray(fr.quat_wxyz, jnp.float32))

    args_all = [pad(fr) for fr in frames]

    # warmup/compile
    t0 = time.perf_counter()
    for a in args_all[:warmup]:
        state, out = step(state, *a)
    jax.block_until_ready((state, out))
    log(f"device compile+warmup: {time.perf_counter()-t0:.1f}s")

    # latency: every step waited for
    lat = []
    half = warmup + (len(args_all) - warmup) // 2
    for a in args_all[warmup:half]:
        t0 = time.perf_counter()
        state, out = step(state, *a)
        jax.block_until_ready((state, out))
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat) if lat else np.asarray([np.nan])

    # throughput: chained dispatch, single sync
    t0 = time.perf_counter()
    n_tp = 0
    for a in args_all[half:]:
        state, out = step(state, *a)
        n_tp += 1
    jax.block_until_ready((state, out))
    dt = time.perf_counter() - t0

    # device time per full step: chain the step on-device (state threaded
    # through a fori_loop) so host dispatch drops out of the number
    from pointcloud_segmentation_tpu.pipeline import process_frame, init_world as _iw

    reps = 16
    a0 = args_all[min(warmup, len(args_all) - 1)]

    @jax.jit
    def dev_loop(st, raw, pos, quat):
        def body(i, s):
            s2, _ = process_frame(s, raw, pos, quat, cfg)
            return s2
        return jax.lax.fori_loop(0, reps, body, st)

    jax.block_until_ready(dev_loop(_iw(cfg), *a0))
    st0 = _iw(cfg)
    jax.block_until_ready(st0)
    t0 = time.perf_counter()
    jax.block_until_ready(dev_loop(st0, *a0))
    dev_ms = (time.perf_counter() - t0) / reps * 1e3

    return {
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p95_ms": float(np.percentile(lat, 95) * 1e3),
        "device_ms_per_frame": float(dev_ms),
        "clouds_per_sec": float(n_tp / dt) if n_tp else float("nan"),
        "world_segments": int(np.asarray(state.count)),
    }


def bench_batched_node_loop(cfg, frames, batch=8):
    """Full node loop in batch mode (pipeline.make_batched_process):
    vmapped per-frame stages + scanned in-order fusion — the data-parallel
    building block whose batch axis pays off sharded across a mesh."""
    import jax
    import jax.numpy as jnp
    from pointcloud_segmentation_tpu.pipeline import make_batched_process, init_world

    step = make_batched_process(cfg)
    state = init_world(cfg)
    T = len(frames) // batch
    clouds = np.full((T, batch, cfg.shapes.max_raw_points, 3), np.nan, np.float32)
    poss = np.zeros((T, batch, 3), np.float32)
    quats = np.zeros((T, batch, 4), np.float32)
    for i, fr in enumerate(frames[: T * batch]):
        k = min(len(fr.points), cfg.shapes.max_raw_points)
        clouds[i // batch, i % batch, :k] = fr.points[:k]
        poss[i // batch, i % batch] = fr.position
        quats[i // batch, i % batch] = fr.quat_wxyz
    cj, pj, qj = jnp.asarray(clouds), jnp.asarray(poss), jnp.asarray(quats)

    state, *_ = step(state, cj[0], pj[0], qj[0])   # compile
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for ti in range(1, T):
        state, *_ = step(state, cj[ti], pj[ti], qj[ti])
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    n = (T - 1) * batch
    return {"clouds_per_sec": float(n / dt), "batch": batch,
            "ms_per_cloud": float(dt / n * 1e3),
            "world_segments": int(np.asarray(state.count))}


def bench_oracle(cfg, frames):
    from pointcloud_segmentation_tpu import oracle

    wm = oracle.WorldMap(cfg)
    lat = []
    for fr in frames:
        t0 = time.perf_counter()
        oracle.process_frame(wm, fr.points, fr.position, fr.quat_wxyz, cfg)
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat)
    return {
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "clouds_per_sec": float(1.0 / np.percentile(lat, 50)),
        "world_segments": len(wm.segments),
    }


def bench_standalone_hough(cfg, frames, iters=20):
    """BASELINE config 1: standalone hough-3d-lines on one recorded cloud."""
    import jax
    import jax.numpy as jnp
    from pointcloud_segmentation_tpu.ops.preproc import preprocess
    from pointcloud_segmentation_tpu.ops.hough import extract_lines

    raw = np.full((cfg.shapes.max_raw_points, 3), np.nan, np.float32)
    raw[: len(frames[0].points)] = frames[0].points
    rawj = jnp.asarray(raw)
    # NB: the loop body must carry a REAL data dependency on the iteration
    # (acc * eps, not acc * 0) — XLA folds `x + 0*acc` to a loop-invariant
    # and hoists work out of the loop, under-reporting the per-cloud time
    eps = jnp.float32(1e-20)

    @jax.jit
    def loop(rawp):
        f, v, _ = preprocess(rawp, cfg)
        return jax.lax.fori_loop(
            0, iters,
            lambda i, acc: acc + extract_lines(
                f + acc * eps, v, cfg).nlines.astype(jnp.float32) * (1.0 + eps),
            jnp.float32(0))

    _ = float(loop(rawj))                 # compile
    t0 = time.perf_counter()
    _ = float(loop(rawj))
    dt = (time.perf_counter() - t0) / iters
    return {"ms_per_cloud": dt * 1e3, "clouds_per_sec": 1.0 / dt}


def bench_batched(cfg, frames, batch=8, reps=4):
    """BASELINE config 5 (single-device part): batched multi-frame
    extraction via vmap — the multi-device version shards this batch over
    a mesh (parallel/sharding.make_batched_extract).  The vmapped
    while_loop runs the union of every frame's rounds, so batching need
    not amortize extraction on one device.
    """
    import jax
    import jax.numpy as jnp
    from pointcloud_segmentation_tpu.ops.preproc import preprocess
    from pointcloud_segmentation_tpu.ops.hough import extract_lines

    clouds = np.full((batch, cfg.shapes.max_raw_points, 3), np.nan, np.float32)
    for i, fr in enumerate(frames[:batch]):
        clouds[i, : len(fr.points)] = fr.points
    cj = jnp.asarray(clouds)
    eps = jnp.float32(1e-20)

    def one(raw):
        f, v, _ = preprocess(raw, cfg)
        return extract_lines(f, v, cfg).nlines.astype(jnp.float32)

    @jax.jit
    def loop(c):
        return jax.lax.fori_loop(
            0, reps,
            lambda i, acc: acc + jax.vmap(one)(c + acc * eps).sum() * (1.0 + eps),
            jnp.float32(0))

    _ = float(loop(cj))
    t0 = time.perf_counter()
    _ = float(loop(cj))
    dt = (time.perf_counter() - t0) / (reps * batch)
    return {"ms_per_cloud": dt * 1e3, "clouds_per_sec": 1.0 / dt,
            "batch": batch}


def bench_large_sensor(n_frames=40):
    """Scaling config: a 128x128 ToF (16,384 rays/frame — 4x the reference
    sensor) through the full node loop.  Exercises the sort-based gap check
    (N > 4096 would hit the O(N^2) rank-matrix wall) and the larger voxel
    compaction; static caps max_raw_points=16384, max_points=6144 (post-voxel
    occupancy on this trajectory peaks ~4-5k; 4096 truncates)."""
    from pointcloud_segmentation_tpu.config import default_config, StaticShapes
    from pointcloud_segmentation_tpu.io.scene import (
        OBS_TESTS_SCENE, WP_TESTS, trajectory_poses)
    from pointcloud_segmentation_tpu.io.simulator import simulate_trajectory, TofSpec

    cfg = default_config(
        granularity=4,
        shapes=StaticShapes(max_raw_points=16384, max_points=6144,
                            max_world_segments=64))
    poses = trajectory_poses(WP_TESTS, hz=4.0, velocity=0.25)
    while len(poses) < n_frames:
        poses = poses + poses
    frames = simulate_trajectory(
        OBS_TESTS_SCENE, poses[:n_frames],
        TofSpec(width=128, height=128, noise_frac=0.002), seed=0)
    return bench_device(cfg, frames)


def bench_streaming(cfg, frames, rates=(30.0, 100.0, 200.0), loops=3):
    """BASELINE config 4 — streaming map build through the PRODUCTION
    runtime: native C++ feeder pacing clouds into the latest-wins mailbox +
    pose buffer at sensor rate, consumer thread driving the jit'd step.
    Reports sustained processed/s and the drop fraction per feed rate
    (drops are the depth-1 mailbox's latest-wins behavior under load, like
    the reference's queue-size-1 /tof_pc subscription).  The 200 Hz rate
    over-feeds the device deliberately: its processed/s is the streaming
    path's saturation throughput (drops there are latest-wins by design)."""
    import tempfile

    from pointcloud_segmentation_tpu.io.replay import save_frames
    from pointcloud_segmentation_tpu.runtime.engine import SegmentationEngine

    log_path = os.path.join(tempfile.gettempdir(), "bench_stream.pcsl")
    save_frames(log_path, frames)
    out = {}
    for rate in rates:
        eng = SegmentationEngine(cfg)
        # warm the compiles outside the timed window: the per-frame step AND
        # the deferred path's flush stack (engine.start pre-compiles it)
        eng.push_pose(frames[0].t, frames[0].position, frames[0].quat_wxyz)
        eng.process_frame(frames[0].t, frames[0].points)
        eng.start()
        t0 = time.perf_counter()
        stats = eng.run_streaming_from_log(log_path, rate_hz=rate,
                                           loops=loops)
        dt = time.perf_counter() - t0
        out[f"rate_{int(rate)}hz"] = {
            "fed": stats["fed"],
            "processed_per_sec": round(stats["processed"] / dt, 2),
            "drop_fraction": round(stats["dropped"] / max(stats["fed"], 1), 3),
            "world_segments": len(eng.world_segments()),
            "feed_s": stats["feed_s"],
            "drain_s": stats["drain_s"],
        }
    return out


def bench_streaming_viz(cfg, frames, rate=100.0, loops=3):
    """Flush-cadence live viz cost: the same saturating stream as
    bench_streaming's 100 Hz row, but with a viz stream attached.  The
    flusher emits one marker record per readback batch from a single
    packed-state snapshot, so watching the map live should cost ~one extra
    read per flush — the acceptance bar is >= 90% of the no-viz
    saturation rate."""
    import tempfile

    from pointcloud_segmentation_tpu.io.replay import save_frames
    from pointcloud_segmentation_tpu.runtime.engine import SegmentationEngine

    log_path = os.path.join(tempfile.gettempdir(), "bench_stream.pcsl")
    save_frames(log_path, frames)
    viz_path = os.path.join(tempfile.gettempdir(), "bench_viz.jsonl")
    eng = SegmentationEngine(cfg, viz_stream=viz_path)
    assert eng._stream_deferred, "viz must not disable the deferred path"
    eng.push_pose(frames[0].t, frames[0].position, frames[0].quat_wxyz)
    eng.process_frame(frames[0].t, frames[0].points)
    eng.start()
    t0 = time.perf_counter()
    stats = eng.run_streaming_from_log(log_path, rate_hz=rate, loops=loops)
    dt = time.perf_counter() - t0
    # count flush-cadence records only: the pre-start warmup frame above
    # emitted one synchronous per-frame record into the same file
    with open(viz_path) as f:
        viz_records = sum(1 for line in f
                          if json.loads(line).get("viz_cadence") == "flush")
    return {
        "rate_hz": rate,
        "processed_per_sec": round(stats["processed"] / dt, 2),
        "drop_fraction": round(stats["dropped"] / max(stats["fed"], 1), 3),
        "viz_records": viz_records,
        "deferred_path": True,
        "feed_s": stats["feed_s"],
        "drain_s": stats["drain_s"],
    }


def build_tower_frames(cfg, n_frames):
    from pointcloud_segmentation_tpu.io.scene import (
        tower_scene, spiral_waypoints, trajectory_poses)
    from pointcloud_segmentation_tpu.io.simulator import simulate_trajectory, TofSpec

    # Orbit radius 1.2: the tower's near face sits ~0.5-0.7 m ahead, inside
    # the 1.5 m forward crop window.  (Round 1 flew at 1.8 m, which pushed
    # the whole structure to the crop boundary — tower recall was 2/12 for
    # scenario-scaling reasons, not algorithmic ones.)
    scene = tower_scene(levels=2, width=1.0)
    poses = trajectory_poses(
        spiral_waypoints(radius=1.2, z0=0.4, z1=2.2, turns=2.0, n=40),
        hz=4.0, velocity=0.4)
    # replay the FULL spiral (~150 frames): the tower entry doubles as the
    # whole-structure recall check (world_segments ≈ the 12 beams)
    n = max(n_frames, len(poses))
    while len(poses) < n:
        poses = poses + poses
    return simulate_trajectory(scene, poses[:n], TofSpec(noise_frac=0.002),
                               seed=0)


def main():
    from pointcloud_segmentation_tpu.compile_cache import enable_compile_cache
    from pointcloud_segmentation_tpu.config import default_config, StaticShapes
    from pointcloud_segmentation_tpu.devices import NoGpuError, require_gpu

    try:
        device = require_gpu()
    except NoGpuError as e:
        log(f"bench: {e}")
        return 1
    enable_compile_cache()

    granularity = int(os.environ.get("BENCH_GRANULARITY", "4"))
    n_frames = int(os.environ.get("BENCH_FRAMES", "40"))
    n_oracle = int(os.environ.get("BENCH_ORACLE_FRAMES", "12"))
    mode = os.environ.get("BENCH_CONFIG", "node")
    profile_dir = os.environ.get("BENCH_PROFILE", "")

    cfg = default_config(
        granularity=granularity,
        shapes=StaticShapes(max_raw_points=4096, max_points=2048,
                            max_world_segments=64),
    )
    frames = build_frames(cfg, n_frames)
    log(f"bench: granularity={granularity} frames={n_frames} "
        f"points/frame<=4096 (64x64 ToF)")

    log(f"device: {device}")

    details = {}
    if mode == "all":
        details["standalone_hough_g4"] = bench_standalone_hough(cfg, frames)
        log(f"standalone hough g4: {details['standalone_hough_g4']}")
        sweep = {}
        for r2l, minv in ((1.5, 12), (2.0, 12), (1.5, 24)):
            c = cfg.replace(rad_2_leaf_ratio=r2l, opt_minvotes=minv)
            sweep[f"r2l={r2l},minvotes={minv}"] = bench_standalone_hough(
                c, build_frames(c, 2), iters=10)
        details["preproc_hough_sweep"] = sweep
        log(f"preproc+hough sweep: {sweep}")
        tower = build_tower_frames(cfg, n_frames)
        # report §5.2 benchmark pca threshold (0.99) — the shipped 0.995
        # rejects oblique views of the tower beams and caps recall (~9/12)
        details["tower_replay"] = bench_device(
            cfg.replace(min_pca_coeff=0.99), tower)
        log(f"tower replay: {details['tower_replay']}")
        details["batched_g4"] = bench_batched(cfg, frames)
        log(f"batched g4: {details['batched_g4']}")
        details["node_loop_batched8"] = bench_batched_node_loop(cfg, frames)
        log(f"node loop batched8: {details['node_loop_batched8']}")
        cfg6 = cfg.replace(granularity=6)
        details["stress_g6"] = bench_standalone_hough(cfg6, frames, iters=4)
        log(f"stress g6: {details['stress_g6']}")
        # full node loop at the SHIPPED config (granularity 6,
        # config_pc_seg/config.yaml:22) — the reference-parity headline
        details["node_loop_g6"] = bench_device(cfg6, frames)
        log(f"node loop g6: {details['node_loop_g6']}")
        details["large_sensor_128"] = bench_large_sensor()
        log(f"large sensor 128x128: {details['large_sensor_128']}")
        details["streaming_map_build"] = bench_streaming(cfg, frames)
        log(f"streaming map build: {details['streaming_map_build']}")
        # the SHIPPED config streamed: granularity 6 is what the reference
        # deploys (config_pc_seg/config.yaml:22), so the production-loop
        # claim must hold there too.
        details["streaming_map_build_g6"] = bench_streaming(
            cfg6, frames, rates=(30.0, 100.0))
        log(f"streaming map build g6: {details['streaming_map_build_g6']}")
        details["streaming_viz_100hz"] = bench_streaming_viz(cfg, frames)
        log(f"streaming + live viz 100 Hz: {details['streaming_viz_100hz']}")

    if profile_dir:
        import jax

        with jax.profiler.trace(profile_dir):
            dev = bench_device(cfg, frames)
    else:
        dev = bench_device(cfg, frames)
    log(f"device: {dev}")

    cpu = bench_oracle(cfg, frames[:n_oracle])
    log(f"cpu oracle: {cpu}")

    if details:
        details["node_loop"] = dev
        details["cpu_oracle"] = cpu
        details["device"] = device
        path = os.environ.get("BENCH_DETAILS", "bench_details.json")
        with open(path, "w") as f:
            json.dump(details, f, indent=2)
        log(f"details -> {path}")

    vs = dev["clouds_per_sec"] / cpu["clouds_per_sec"]
    print(json.dumps({
        "metric": "clouds_per_sec_per_device_full_node_loop",
        "value": dev["clouds_per_sec"],
        "unit": "clouds/s",
        "vs_baseline": vs,
        "device_ms_per_frame": dev["device_ms_per_frame"],
        "p50_ms": dev["p50_ms"],
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
