"""Endurance soak: sustained streaming through the production runtime.

The streaming benchmarks measure short windows; this tool runs the SAME
production path — native C++ feeder -> latest-wins mailbox -> consumer
thread -> jit'd step -> async flusher — continuously for minutes to hours
(ONE stream, like a deployed mapping node over a whole flight) and samples
throughput, drop fraction, host RSS, and world-map size every ~30 s.
Throughput must hold steady (no compile storms, no queue leaks, no
degradation as the world map saturates its fixed capacity) and host memory
must stay flat.

This tool's first run caught a real one: restarting the engine's
worker/flusher threads per chunk leaked glibc arena high-water on every
restart — fixed by the package-wide M_ARENA_MAX cap
(pointcloud_segmentation_tpu/_malloc.py).

    python tools/endurance.py [minutes=10] [rate_hz=30] [granularity=4]

Prints one line per sample window and a final JSON summary; exit 1 if the
trailing-5-window median throughput fell >15% below the run median
(sustained degradation; transient outage windows are counted separately as
``outage_windows``, and each window carries the slowest single step
dispatch and flusher read for attribution) or the RSS-minima floor keeps
rising (leak heuristic; window point samples swing with XLA scratch
buffers, minima are the stable floor).
"""

import json
import math
import os
import sys
import tempfile
import threading
import time


# A window whose slowest flusher read exceeded the engine's wedge threshold
# (engine._STREAM_READ_WEDGE_S) is a stalled read, not code decay:
# judge_windows excludes such windows from the degradation tail.
WEDGE_READ_MS = 3000.0


def _floor_halves(seg):
    """(min RSS of first half, min RSS of last half, rises?) for a window
    segment."""
    h = max(len(seg) // 2, 1)
    lo_first = min(c["rss_mb"] for c in seg[:h]) if seg else 0.0
    lo_last = min(c["rss_mb"] for c in seg[h:]) if seg[h:] else lo_first
    return lo_first, lo_last, lo_last > 1.25 * lo_first


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


def judge_windows(windows, rate, window_s=30.0):
    """Pure verdict over per-window samples (unit-tested in
    tests/test_endurance_judge.py).  Returns the judgment fields merged into
    the summary.

    - Drops the final partial window, then trailing DRAIN windows (feed
      ended, runner still settling at ~0 fed/s) — shutdown latency, not
      stream throughput.
    - ``degraded``: trailing five-window median < 85% of the run median,
      computed over the last five windows without a stalled read
      (max_flush_read_ms above WEDGE_READ_MS).  Sustained decay means
      compile storms or queue leaks; a stalled read is counted in
      ``outage_windows`` instead.
    - ``leaked``: RSS window-MINIMA floor rising by more than 25% across
      the halves of the run (>= 6 windows).
    """
    full = windows[:-1] if len(windows) > 1 else list(windows)
    while len(full) > 1 and full[-1]["fed_in_window"] < rate * window_s * 0.05:
        full = full[:-1]
    rates_seen = sorted(c["processed_per_sec"] for c in full)
    median = rates_seen[len(rates_seen) // 2] if rates_seen else 0.0
    last = full[-1]["processed_per_sec"] if full else 0.0
    unwedged = [c for c in full
                if c.get("max_flush_read_ms", 0.0) <= WEDGE_READ_MS]
    tail = sorted(c["processed_per_sec"] for c in unwedged[-5:])
    tail_median = tail[len(tail) // 2] if tail else 0.0
    degraded = (len(full) >= 6 and len(tail) >= 3
                and tail_median < 0.85 * median)
    rss_min_first, rss_min_last, rises = _floor_halves(full)
    leaked = len(full) >= 6 and rises
    return {
        "median_processed_per_sec": median,
        "min_processed_per_sec": rates_seen[0] if rates_seen else 0.0,
        "max_processed_per_sec": rates_seen[-1] if rates_seen else 0.0,
        "last_processed_per_sec": last,
        "rss_mb_first_window": full[0]["rss_mb"] if full else 0.0,
        "rss_mb_last": full[-1]["rss_mb"] if full else 0.0,
        "rss_mb_min_first_half": rss_min_first,
        "rss_mb_min_last_half": rss_min_last,
        "outage_windows": sum(
            1 for c in full if c["processed_per_sec"] < 0.5 * median),
        "degraded": degraded, "leaked": leaked,
    }


def main() -> int:
    minutes = float(sys.argv[1]) if len(sys.argv) > 1 else 10.0
    rate = float(sys.argv[2]) if len(sys.argv) > 2 else 30.0
    granularity = int(sys.argv[3]) if len(sys.argv) > 3 else 4

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench

    from pointcloud_segmentation_tpu.config import (
        default_config, StaticShapes)
    from pointcloud_segmentation_tpu.io.replay import save_frames
    from pointcloud_segmentation_tpu.runtime.engine import SegmentationEngine

    cfg = default_config(
        granularity=granularity,
        shapes=StaticShapes(max_raw_points=4096, max_points=2048,
                            max_world_segments=64))
    frames = bench.build_frames(cfg, 40)
    log_path = os.path.join(tempfile.gettempdir(), "endurance.pcsl")
    save_frames(log_path, frames)

    eng = SegmentationEngine(cfg)
    # warm every compile outside the measured window (per-frame step +
    # the deferred flush stack pre-compiled by engine.start)
    eng.push_pose(frames[0].t, frames[0].position, frames[0].quat_wxyz)
    eng.process_frame(frames[0].t, frames[0].points)

    # ONE continuous stream for the whole soak — the deployed shape.
    loops = max(1, math.ceil(minutes * 60.0 * rate / len(frames)))
    result = {}

    def _run():
        result.update(eng.run_streaming_from_log(
            log_path, rate_hz=rate, loops=loops))

    runner = threading.Thread(target=_run, daemon=True)
    window_s = 30.0
    print(f"endurance: {minutes:.1f} min @ {rate:.0f} Hz, g{granularity}, "
          f"one stream of {loops * len(frames)} frames, "
          f"rss0={rss_mb():.0f} MB", flush=True)
    runner.start()
    windows = []
    last_proc, last_drop, last_t = (eng.frames_processed,
                                    eng.dropped_frames, time.perf_counter())
    while runner.is_alive():
        runner.join(timeout=window_s)
        now = time.perf_counter()
        proc, drop = eng.frames_processed, eng.dropped_frames
        dt = now - last_t
        fed_delta = (proc - last_proc) + (drop - last_drop)
        stall = eng.pop_stall_max()
        windows.append({
            "processed_per_sec": round((proc - last_proc) / dt, 2),
            "processed_in_window": proc - last_proc,
            "fed_in_window": fed_delta,
            "drop_fraction": round(
                (drop - last_drop) / max(fed_delta, 1), 4),
            "rss_mb": round(rss_mb(), 1),
            "max_step_ms": stall["step_ms"],
            "max_flush_read_ms": stall["flush_read_ms"],
            "flush_batches_shed_cum": eng.flush_batches_shed,
        })
        last_proc, last_drop, last_t = proc, drop, now
        c = windows[-1]
        print(f"window {len(windows)}: {c['processed_per_sec']:.1f} proc/s "
              f"drops={c['drop_fraction']:.1%} rss={c['rss_mb']:.0f} MB "
              f"skip={eng.frames_skipped_no_pose} "
              f"shed={eng.flush_batches_shed} "
              f"maxstep={c['max_step_ms']:.0f}ms "
              f"maxread={c['max_flush_read_ms']:.0f}ms",
              flush=True)
    n_segs = len(eng.world_segments())

    verdict = judge_windows(windows, rate, window_s)
    summary = {
        "minutes": minutes, "rate_hz": rate, "granularity": granularity,
        "windows": len(windows),
        "fed": result.get("fed"), "processed": result.get("processed"),
        "dropped": result.get("dropped"),
        **verdict,
        "drop_fraction_overall": round(
            result.get("dropped", 0) / max(result.get("fed", 1), 1), 4),
        "world_segments_final": n_segs,
        "skipped_no_pose": eng.frames_skipped_no_pose,
        "flush_batches_shed": eng.flush_batches_shed,
        "windows_detail": windows,
    }
    print(json.dumps(summary), flush=True)
    return 1 if (verdict["degraded"] or verdict["leaked"]) else 0


if __name__ == "__main__":
    sys.exit(main())
