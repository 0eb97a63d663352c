"""Runtime engine: pose buffer, mailbox, CSV outputs, replay, streaming."""

import os
import threading
import time

import numpy as np
import pytest

from pointcloud_segmentation_tpu.config import default_config, StaticShapes
from pointcloud_segmentation_tpu.runtime import (
    SegmentationEngine, PoseBuffer, LatestWinsMailbox, csvio, slerp)
from pointcloud_segmentation_tpu.io.scene import OBS_TESTS_SCENE, WP_TESTS, trajectory_poses
from pointcloud_segmentation_tpu.io.simulator import simulate_trajectory, TofSpec
from pointcloud_segmentation_tpu.eval import (
    match_report, load_processing_time_csv, summarize)
from pointcloud_segmentation_tpu.io.scene import scene_truth

CFG = default_config(
    granularity=2,
    shapes=StaticShapes(max_raw_points=4096, max_points=2048,
                        max_world_segments=32),
)


# ---------------------------------------------------------------- pose buffer

def test_pose_buffer_interpolation():
    pb = PoseBuffer()
    q0 = np.array([1.0, 0, 0, 0])
    yaw = 1.0
    q1 = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)])
    pb.push(0.0, [0, 0, 0], q0)
    pb.push(1.0, [2, 0, 0], q1)
    pos, quat = pb.lookup(0.5)
    np.testing.assert_allclose(pos, [1, 0, 0])
    half = np.array([np.cos(yaw / 4), 0, 0, np.sin(yaw / 4)])
    np.testing.assert_allclose(quat, half, atol=1e-9)


def test_pose_buffer_timeout_and_edges():
    pb = PoseBuffer(timeout=1.0)
    assert pb.lookup(0.0) is None
    pb.push(10.0, [1, 2, 3], [1, 0, 0, 0])
    # within timeout of the range -> clamps to nearest
    pos, _ = pb.lookup(9.5)
    np.testing.assert_allclose(pos, [1, 2, 3])
    # outside timeout -> failure
    assert pb.lookup(8.0) is None
    assert pb.lookup(12.0) is None


def test_slerp_antipodal():
    q0 = np.array([1.0, 0, 0, 0])
    q1 = -np.array([np.cos(0.1), 0, 0, np.sin(0.1)])  # same rotation, flipped
    out = slerp(q0, q1, 0.5)
    assert abs(np.linalg.norm(out) - 1) < 1e-12


# ---------------------------------------------------------------- mailbox

def test_mailbox_latest_wins():
    mb = LatestWinsMailbox()
    mb.put(1)
    mb.put(2)
    mb.put(3)
    assert mb.take(timeout=0.1) == 3
    assert mb.dropped == 2
    assert mb.take(timeout=0.05) is None


def test_mailbox_threaded():
    mb = LatestWinsMailbox()
    got = []

    def consumer():
        while True:
            v = mb.take(timeout=1.0)
            if v is None:
                return
            got.append(v)
            if v == "stop":
                return

    th = threading.Thread(target=consumer)
    th.start()
    time.sleep(0.05)
    mb.put("stop")
    th.join(timeout=2)
    assert got == ["stop"]


# ---------------------------------------------------------------- csv format

def test_csv_double_format():
    assert csvio.fmt_double(0.1234567) == "0.123457"
    assert csvio.fmt_double(5123456.0) == "5.12346e+06"
    assert csvio.fmt_double(-1.0) == "-1"
    assert csvio.fmt_double(0.05) == "0.05"


def test_csv_roundtrip(tmp_path):
    segs = [{"a": np.array([0.1234567, 2, 3]), "b": np.array([0, 0, 1]),
             "t_min": -1.0, "t_max": 1.0}]
    p = str(tmp_path / "segments.csv")
    csvio.write_segments_csv(p, segs)
    with open(p) as f:
        header = f.readline().strip()
    assert header == "segment,a_x,a_y,a_z,b_x,b_y,b_z,t_min,t_max"
    back = csvio.read_segments_csv(p)
    assert len(back) == 1
    assert back[0]["t_min"] == -1.0
    np.testing.assert_allclose(back[0]["a"], [0.123457, 2, 3], atol=1e-6)


# ---------------------------------------------------------------- engine replay

@pytest.fixture(scope="module")
def replay_frames():
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:8]
    return simulate_trajectory(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.002),
                               seed=1)


@pytest.mark.parametrize("backend", ["jax", "oracle"])
def test_engine_replay_and_csv(tmp_path, replay_frames, backend):
    eng = SegmentationEngine(CFG.replace(path_to_output=str(tmp_path)),
                             backend=backend)
    recs = eng.run_replay(replay_frames)
    assert len(recs) == len(replay_frames)
    assert eng.frames_processed == len(replay_frames)
    segs = eng.world_segments()
    assert len(segs) >= 3
    # accuracy vs ground truth with the reference criteria
    rep = match_report(scene_truth(OBS_TESTS_SCENE),
                       [dict(s, endpoints=[s["t_min"], s["t_max"]]) for s in segs])
    assert rep["n_truth_matched"] >= 3

    paths = eng.finalize()
    for k in ("segments", "intersections", "processing_time"):
        assert os.path.exists(paths[k])
    data = load_processing_time_csv(paths["processing_time"])
    assert len(data["processing_time_s"]) == len(replay_frames)
    s = summarize(data)
    assert s["n_frames"] == len(replay_frames)
    assert s["p50_ms"] > 0
    # headers exact
    with open(paths["intersections"]) as f:
        assert f.readline().strip() == "seg1,t1,seg2,t2"
    with open(paths["processing_time"]) as f:
        assert f.readline().strip() == "wall_time,processing_time,seg_vec_size,nblines"


def test_engine_streaming_latest_wins(replay_frames):
    eng = SegmentationEngine(CFG, backend="jax")
    for fr in replay_frames:
        eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
    eng.start()
    for fr in replay_frames:
        eng.submit_cloud(fr.t, fr.points)  # faster than processing -> drops
    # wait (generously, for loaded CI machines) until the worker consumed
    # at least one frame
    deadline = time.time() + 60.0
    while eng.frames_processed < 1 and time.time() < deadline:
        time.sleep(0.1)
    eng.stop()
    assert eng.frames_processed >= 1
    # drops + processed covers all frames
    assert eng.frames_processed + eng.mailbox.dropped >= len(replay_frames) - 1


def test_engine_skips_frames_without_pose():
    eng = SegmentationEngine(CFG, backend="jax")
    rec = eng.process_frame(5.0, np.random.rand(100, 3).astype(np.float32))
    assert rec is None
    assert eng.frames_skipped_no_pose == 1
    assert eng.records == []


def test_engine_visualization(replay_frames):
    eng = SegmentationEngine(CFG, backend="jax", collect_inlier_points=True)
    eng.run_replay(replay_frames[:3])
    viz = eng.visualization()
    assert len(viz["cylinders"]) == len(eng.world_segments())
    for c in viz["cylinders"]:
        assert c["height"] > 0
    assert len(viz["segment_texts"]) == len(viz["cylinders"])
    if eng.world_segments():
        assert "hough_points" in viz


def test_engine_pipelined_replay(replay_frames):
    eng = SegmentationEngine(CFG, backend="jax")
    recs = eng.run_replay(replay_frames, pipelined=True)
    assert len(recs) == len(replay_frames)
    # counters backfilled after the single sync
    assert all(r["seg_vec_size"] >= 0 for r in recs)
    assert all(r["nblines"] >= 0 for r in recs)
    # same world map as the synchronous path
    eng2 = SegmentationEngine(CFG, backend="jax")
    eng2.run_replay(replay_frames)
    assert len(eng.world_segments()) == len(eng2.world_segments())


def test_engine_pipelined_records_match_synchronous(replay_frames):
    """Pipelined replay must record TRUTHFUL per-frame counters — identical
    seg_vec_size / nblines columns to a synchronous replay (round-1 backfill
    wrote the final frame's values into every row)."""
    eng_p = SegmentationEngine(CFG, backend="jax")
    recs_p = eng_p.run_replay(replay_frames, pipelined=True)
    eng_s = SegmentationEngine(CFG, backend="jax")
    recs_s = eng_s.run_replay(replay_frames)
    assert [r["seg_vec_size"] for r in recs_p] == [r["seg_vec_size"] for r in recs_s]
    assert [r["nblines"] for r in recs_p] == [r["nblines"] for r in recs_s]


def test_engine_worker_survives_poisoned_frame():
    """A frame that raises must not kill the streaming worker (D-ERR):
    the error is counted and later frames still process."""
    # stream_sync_every=1 pins the synchronous worker path, whose
    # _process_jax this test monkeypatches; the deferred path's poison
    # survival is covered by test_engine_streaming_deferred_poison.
    eng = SegmentationEngine(CFG, backend="jax", stream_sync_every=1)
    assert not eng._stream_deferred
    poses = trajectory_poses(WP_TESTS, hz=2.0, velocity=0.25)
    frames = simulate_trajectory(OBS_TESTS_SCENE, poses[:2], TofSpec(), seed=0)
    for fr in frames:
        eng.push_pose(fr.t, fr.position, fr.quat_wxyz)

    boom = {"armed": True}
    orig = eng._process_jax

    def exploding(points, position, quat):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("poisoned frame")
        return orig(points, position, quat)

    eng._process_jax = exploding
    eng.start()
    eng.submit_cloud(frames[0].t, frames[0].points)
    deadline = time.time() + 60.0
    while eng.frames_failed < 1 and time.time() < deadline:
        time.sleep(0.05)
    eng.submit_cloud(frames[1].t, frames[1].points)
    deadline = time.time() + 60.0
    while eng.frames_processed < 1 and time.time() < deadline:
        time.sleep(0.05)
    eng.stop()
    assert eng.frames_failed == 1
    assert eng.frames_processed >= 1


def test_world_capacity_overflow_is_reported():
    """Segments beyond max_world_segments are dropped with a counted
    overflow (D-CAP), not silently."""
    cfg = default_config(
        granularity=1, opt_minvotes=8, min_pca_coeff=0.8, opt_nlines=4,
        floor_trim_height=-10.0,
        shapes=StaticShapes(max_raw_points=2048, max_points=1024,
                            max_world_segments=2))
    eng = SegmentationEngine(cfg, backend="jax")
    rng = np.random.default_rng(3)
    # 4 well-separated beams in one frame -> 2 fit, 2 overflow
    clouds = []
    for i in range(4):
        a = np.array([0.2 + 0.35 * i, -0.7, 0.4])  # inside the crop window
        b = np.array([0.0, 1.0, 0.15 * (i + 1)])
        b /= np.linalg.norm(b)
        t = np.linspace(0, 1.2, 200)
        clouds.append(a + t[:, None] * b + rng.normal(0, 0.004, (200, 3)))
    pts = np.concatenate(clouds).astype(np.float32)
    eng.push_pose(0.0, np.zeros(3), np.array([1.0, 0, 0, 0]))
    rec = eng.process_frame(0.0, pts)
    assert rec is not None
    assert rec["seg_vec_size"] == 2
    assert eng.world_overflow_frames == 1


def test_engine_viz_stream(replay_frames, tmp_path):
    """Per-frame viz stream (the RViz re-publish loop analog): one JSON
    line per processed frame, cumulative world map, final record matches
    the end state."""
    path = str(tmp_path / "viz.jsonl")
    eng = SegmentationEngine(CFG, backend="jax", viz_stream=path)
    eng.run_replay(replay_frames[:4])
    eng.finalize(str(tmp_path))
    import json as _json
    with open(path) as f:
        recs = [_json.loads(line) for line in f]
    assert len(recs) == 4
    assert [r["frame"] for r in recs] == [1, 2, 3, 4]
    counts = [r["world_count"] for r in recs]
    assert all(len(r["cylinders"]) == c for r, c in zip(recs, counts))
    assert counts == sorted(counts)  # world map only grows in this replay
    assert counts[-1] == len(eng.world_segments())
    for c in recs[-1]["cylinders"]:
        assert len(c["p1"]) == 3 and len(c["p2"]) == 3 and c["radius"] > 0
    # each record carries the frame's drone pose (the RViz pose/path
    # displays, rviz/drone_pc.rviz): position+quat match the fed pose
    for r, fr in zip(recs, replay_frames):
        assert np.allclose(r["drone"]["position"], fr.position, atol=1e-6)
        assert np.allclose(r["drone"]["quat_wxyz"], fr.quat_wxyz, atol=1e-6)


def test_engine_viz_stream_callback(replay_frames):
    got = []
    eng = SegmentationEngine(CFG, backend="jax", viz_stream=got.append)
    eng.run_replay(replay_frames[:2])
    assert len(got) == 2 and got[0]["frame"] == 1
    assert len(got[0]["drone"]["position"]) == 3


def test_engine_batched_replay_matches_synchronous(replay_frames):
    """batch=k replay: same world map and per-frame counters as the
    one-frame-at-a-time path (vmapped stages + scanned fusion)."""
    eng_b = SegmentationEngine(CFG, backend="jax")
    recs_b = eng_b.run_replay(replay_frames, batch=4)
    eng_s = SegmentationEngine(CFG, backend="jax")
    recs_s = eng_s.run_replay(replay_frames)
    assert len(recs_b) == len(recs_s) == len(replay_frames)
    assert [r["seg_vec_size"] for r in recs_b] == [r["seg_vec_size"] for r in recs_s]
    assert [r["nblines"] for r in recs_b] == [r["nblines"] for r in recs_s]
    sb = eng_b.world_segments()
    ss = eng_s.world_segments()
    assert len(sb) == len(ss)
    for x, y in zip(sb, ss):
        np.testing.assert_allclose(x["a"], y["a"], atol=1e-5)
        assert x["points_size"] == y["points_size"]


def _submit_and_wait(eng, fr, deadline_s=60.0):
    """Submit one frame and wait until the worker accounted for it — keeps
    the latest-wins mailbox from dropping anything, so the deferred-mode
    record list lines up 1:1 with a synchronous replay."""
    target = (eng.frames_processed + eng.frames_skipped_no_pose
              + eng.frames_failed + 1)
    eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
    eng.submit_cloud(fr.t, fr.points)
    deadline = time.time() + deadline_s
    while (eng.frames_processed + eng.frames_skipped_no_pose
           + eng.frames_failed) < target and time.time() < deadline:
        time.sleep(0.002)


def test_engine_streaming_deferred_records_truthful(replay_frames):
    """The streaming worker's deferred (pipelined-dispatch) path must
    backfill every record with the frame's OWN counters — identical
    seg_vec_size / nblines columns and world map to a synchronous replay.
    stream_sync_every=3 forces several mid-run batched flushes plus an
    idle/final flush."""
    eng = SegmentationEngine(CFG, backend="jax", stream_sync_every=3)
    assert eng._stream_deferred
    eng.start()
    for fr in replay_frames:
        _submit_and_wait(eng, fr)
    eng.stop()
    assert eng._pending == []            # final flush ran
    assert eng.frames_processed == len(replay_frames)
    # no -1 sentinel survived the flushes
    assert all(r["seg_vec_size"] >= 0 and r["nblines"] >= 0
               for r in eng.records)
    eng_s = SegmentationEngine(CFG, backend="jax")
    recs_s = eng_s.run_replay(replay_frames)
    assert [r["seg_vec_size"] for r in eng.records] == \
        [r["seg_vec_size"] for r in recs_s]
    assert [r["nblines"] for r in eng.records] == \
        [r["nblines"] for r in recs_s]
    segs_d, segs_s = eng.world_segments(), eng_s.world_segments()
    assert len(segs_d) == len(segs_s)
    for x, y in zip(segs_d, segs_s):
        np.testing.assert_allclose(x["a"], y["a"], atol=1e-5)


def test_engine_streaming_deferred_poison(replay_frames):
    """Deferred streaming survives a frame whose dispatch raises."""
    eng = SegmentationEngine(CFG, backend="jax", stream_sync_every=4)
    assert eng._stream_deferred
    boom = {"armed": True}
    orig = eng._step

    def exploding(state, raw, pos, quat):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("poisoned frame")
        return orig(state, raw, pos, quat)

    eng._step = exploding
    eng.start()
    for fr in replay_frames[:3]:
        _submit_and_wait(eng, fr)
    eng.stop()
    assert eng.frames_failed == 1
    assert eng.frames_processed == 2
    assert all(r["seg_vec_size"] >= 0 for r in eng.records)


def test_engine_streaming_deferred_checkpoints(replay_frames, tmp_path):
    """Deferred mode still honors the checkpoint cadence (at flush
    boundaries) and the checkpoint resumes into the same world map."""
    ckpt = str(tmp_path / "ck.npz")
    eng = SegmentationEngine(CFG, backend="jax", stream_sync_every=3,
                             checkpoint_every=4, checkpoint_path=ckpt)
    assert eng._stream_deferred
    eng.start()
    for fr in replay_frames:
        _submit_and_wait(eng, fr)
    eng.stop()
    assert os.path.exists(ckpt)
    eng2 = SegmentationEngine(CFG, backend="jax")
    eng2.load_checkpoint(ckpt)
    assert eng2.frames_processed >= 4


def test_stream_rides_through_wedged_flusher_read(replay_frames):
    """A flusher device->host read that wedges must NOT stall the stream:
    once the head read exceeds _STREAM_READ_WEDGE_S, the worker's
    backpressure loop keeps dispatching under _STREAM_WEDGE_MAX_BATCHES
    instead of parking behind the stuck read.  Records still backfill
    truthfully once the read recovers."""
    eng = SegmentationEngine(CFG, backend="jax", stream_sync_every=2)
    assert eng._stream_deferred
    eng._STREAM_READ_WEDGE_S = 0.05      # test wedge qualifies instantly
    orig = eng._backfill_batch
    wedge = {"armed": True}
    release = threading.Event()

    def wedged(batch, stacked):
        if wedge["armed"]:
            wedge["armed"] = False
            eng._read_started_mono = time.monotonic()
            try:
                release.wait(timeout=30.0)   # the parked read
            finally:
                eng._read_started_mono = None
        return orig(batch, stacked)

    eng._backfill_batch = wedged
    eng.start()
    try:
        # batch 1 (frames 1-2) reaches the flusher and wedges; batches
        # 2-3 queue past _STREAM_MAX_UNREAD_BATCHES — without the wedge
        # escape the worker parks there and frames 7-8 time out
        for fr in replay_frames:
            _submit_and_wait(eng, fr, deadline_s=20.0)
        assert eng.frames_processed == len(replay_frames)
        assert not wedge["armed"]            # the wedge really engaged
    finally:
        release.set()
        eng.stop()
    # every record truthfully backfilled once the read recovered
    assert all(r["seg_vec_size"] >= 0 and r["nblines"] >= 0
               for r in eng.records)


def test_pop_stall_max_reports_in_flight_read_age():
    """A read still in flight at sampling time must report its current
    age, so the soak's wedge classification sees a long stall in the
    window it happens in, not only in the one it ends in."""
    eng = SegmentationEngine(CFG, backend="jax", stream_sync_every=2)
    eng._read_started_mono = time.monotonic() - 5.0
    out = eng.pop_stall_max()
    assert out["flush_read_ms"] >= 4900.0, out
    eng._read_started_mono = None
    # completed-read max still reported and reset as before
    eng._stall_read_ms = 123.0
    assert eng.pop_stall_max()["flush_read_ms"] == 123.0
    assert eng.pop_stall_max()["flush_read_ms"] == 0.0


def test_idle_age_flush_also_sheds_past_wedge_cap(replay_frames):
    """Regression: the idle-age flush path bypassed the unread-batch cap
    — near saturation nearly every flush goes through it (pending rarely
    reaches stream_sync_every before a >_STREAM_FLUSH_AGE_S idle gap), so
    a long stalled read accumulated unread batches without bound.  Every
    flush site must run _bound_unread_batches: with the head read wedged
    and the cap at 1, idle-age flushes alone must shed."""
    eng = SegmentationEngine(CFG, backend="jax", stream_sync_every=1000)
    assert eng._stream_deferred
    eng._STREAM_READ_WEDGE_S = 0.05
    eng._STREAM_WEDGE_MAX_BATCHES = 1
    eng._STREAM_FLUSH_AGE_S = 0.01       # idle gap flushes near-immediately
    orig = eng._backfill_batch
    wedge = {"armed": True}
    release = threading.Event()

    def wedged(batch, stacked):
        if wedge["armed"]:
            wedge["armed"] = False
            eng._read_started_mono = time.monotonic()
            try:
                release.wait(timeout=30.0)
            finally:
                eng._read_started_mono = None
        return orig(batch, stacked)

    eng._backfill_batch = wedged
    eng.start()
    try:
        # paced submissions: each frame is followed by an idle window, so
        # every flush is an idle-age flush (pending never nears 1000)
        for fr in replay_frames:
            _submit_and_wait(eng, fr, deadline_s=20.0)
            time.sleep(0.15)
        assert eng.frames_processed == len(replay_frames)
        assert not wedge["armed"]            # the wedge really engaged
        deadline = time.time() + 10.0
        while eng.flush_batches_shed < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert eng.flush_batches_shed >= 1
    finally:
        release.set()
        eng.stop()
    # shed batches keep sentinels; the map still matches a sync replay
    assert any(r["seg_vec_size"] == -1 for r in eng.records)
    eng_s = SegmentationEngine(CFG, backend="jax")
    eng_s.run_replay(replay_frames)
    segs_d, segs_s = eng.world_segments(), eng_s.world_segments()
    assert len(segs_d) == len(segs_s)


def test_stream_sheds_telemetry_past_wedge_cap(replay_frames):
    """A wedge outlasting _STREAM_WEDGE_MAX_BATCHES must shed the oldest
    unread readback batch (telemetry loss: those records keep their -1
    sentinels, flush_batches_shed counts them) rather than stall the map
    build — the world state already advanced on device, so the final map
    still matches a synchronous replay."""
    eng = SegmentationEngine(CFG, backend="jax", stream_sync_every=2)
    assert eng._stream_deferred
    eng._STREAM_READ_WEDGE_S = 0.05
    eng._STREAM_WEDGE_MAX_BATCHES = 1    # cap trips immediately mid-wedge
    orig = eng._backfill_batch
    wedge = {"armed": True}
    release = threading.Event()

    def wedged(batch, stacked):
        if wedge["armed"]:
            wedge["armed"] = False
            eng._read_started_mono = time.monotonic()
            try:
                release.wait(timeout=30.0)
            finally:
                eng._read_started_mono = None
        return orig(batch, stacked)

    eng._backfill_batch = wedged
    eng.start()
    try:
        for fr in replay_frames:
            _submit_and_wait(eng, fr, deadline_s=20.0)
        assert eng.frames_processed == len(replay_frames)
        assert eng.flush_batches_shed >= 1
    finally:
        release.set()
        eng.stop()
    # shed batches keep sentinels (honest telemetry loss) ...
    assert any(r["seg_vec_size"] == -1 for r in eng.records)
    # ... but the map is byte-for-byte the synchronous replay's
    eng_s = SegmentationEngine(CFG, backend="jax")
    eng_s.run_replay(replay_frames)
    segs_d, segs_s = eng.world_segments(), eng_s.world_segments()
    assert len(segs_d) == len(segs_s)
    for x, y in zip(segs_d, segs_s):
        np.testing.assert_allclose(x["a"], y["a"], atol=1e-5)


def test_engine_batched_replay_ragged_tail(replay_frames):
    """A frame count not divisible by the batch pads with degenerate
    no-op frames — the tail chunk must not corrupt the map."""
    eng = SegmentationEngine(CFG, backend="jax")
    recs = eng.run_replay(replay_frames[:5], batch=3)
    assert len(recs) == 5
    assert eng.frames_processed == 5


def test_engine_streaming_deferred_concurrent_queries(replay_frames):
    """Server-style readers (world_snapshot / world_segments) issued WHILE
    the deferred stream is active must coexist with the flusher thread's
    batched readbacks: reads serialize through _read_lock, dispatches keep
    flowing, and the final map still matches a synchronous replay."""
    eng = SegmentationEngine(CFG, backend="jax", stream_sync_every=2)
    assert eng._stream_deferred
    eng.start()
    stop_flag = threading.Event()
    snap_counts = []
    errors = []

    def reader():
        while not stop_flag.is_set():
            try:
                segs, inter = eng.world_snapshot()
                snap_counts.append(len(segs))
            except Exception as e:        # pragma: no cover - failure path
                errors.append(e)
                return
            time.sleep(0.003)

    rt = threading.Thread(target=reader)
    rt.start()
    for fr in replay_frames:
        _submit_and_wait(eng, fr)
    stop_flag.set()
    rt.join(timeout=30.0)
    eng.stop()
    assert not errors
    assert snap_counts, "reader thread never got a snapshot"
    # monotone non-decreasing world growth seen by the concurrent reader
    assert all(b >= a for a, b in zip(snap_counts, snap_counts[1:]))
    assert all(r["seg_vec_size"] >= 0 for r in eng.records)
    eng_s = SegmentationEngine(CFG, backend="jax")
    eng_s.run_replay(replay_frames)
    assert len(eng.world_segments()) == len(eng_s.world_segments())


def test_engine_deferred_restart_after_stop(replay_frames):
    """A second deferred-streaming session after stop() gets a fresh
    flusher thread + flush queue; records from BOTH sessions end up
    backfilled and the world map equals one continuous synchronous
    replay."""
    half = len(replay_frames) // 2
    eng = SegmentationEngine(CFG, backend="jax", stream_sync_every=3)
    assert eng._stream_deferred
    eng.start()
    for fr in replay_frames[:half]:
        _submit_and_wait(eng, fr)
    eng.stop()
    assert eng._flusher is None          # joined at stop
    eng.start()
    for fr in replay_frames[half:]:
        _submit_and_wait(eng, fr)
    eng.stop()
    assert eng.frames_processed == len(replay_frames)
    assert all(r["seg_vec_size"] >= 0 and r["nblines"] >= 0
               for r in eng.records)
    eng_s = SegmentationEngine(CFG, backend="jax")
    eng_s.run_replay(replay_frames)
    assert len(eng.world_segments()) == len(eng_s.world_segments())


def test_engine_deferred_overfeed_bounded_inflight(replay_frames):
    """Sustained overfeed must NOT grow the unread-flush queue without
    bound: once _STREAM_MAX_UNREAD_BATCHES batches are enqueued the worker
    pauses dispatch (opening the idle window the flusher's gated read
    needs) until the flusher catches up.  A deliberately slowed backfill
    forces the queue toward the cap while frames are force-fed."""
    eng = SegmentationEngine(CFG, backend="jax", stream_sync_every=2)
    assert eng._stream_deferred
    # warm the step's jit cache BEFORE the timed overfeed window: a cold
    # compile eats the whole window (the worker processes ~1 frame, no
    # batch ever queues, and the pile-up assertion below is vacuous —
    # this test only passed after other tests had compiled the step)
    eng.run_replay(replay_frames[:1])
    seen = {"max_q": 0}
    orig = eng._backfill_batch

    def slow_backfill(batch, stacked):
        seen["max_q"] = max(seen["max_q"], eng._flush_q.qsize())
        time.sleep(0.15)
        orig(batch, stacked)

    eng._backfill_batch = slow_backfill
    eng.start()
    for fr in replay_frames:
        eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
    # overfeed for a fixed window: the worker flushes every 2 frames while
    # each backfill takes >=50 ms, so unread batches pile up to the cap
    t_end = time.time() + 4.0
    i = 0
    while time.time() < t_end:
        fr = replay_frames[i % len(replay_frames)]
        eng.submit_cloud(fr.t, fr.points)
        i += 1
        time.sleep(0.002)
    # settle: give the (slowed) flusher time to drain before stopping
    deadline = time.time() + 60.0
    while eng._flush_q.qsize() > 0 and time.time() < deadline:
        time.sleep(0.05)
    eng.stop()
    # the pile-up really happened (>=1 batch was still queued when a
    # backfill started), and the cap was respected (qsize is sampled
    # after the flusher pops, so the bound is the cap itself)
    assert seen["max_q"] >= 1
    assert seen["max_q"] <= eng._STREAM_MAX_UNREAD_BATCHES
    # every processed frame's record was eventually backfilled
    assert all(r["seg_vec_size"] >= 0 and r["nblines"] >= 0
               for r in eng.records)
    assert eng.frames_processed >= 1


def test_engine_atexit_guard_stops_abandoned_engine():
    """start() registers an atexit hook that stops a still-running engine
    (an abandoned engine's daemon threads must not be killed mid-device-
    call at interpreter exit).
    The hook holds only a weakref, so dropped engines stay collectable."""
    import atexit
    import gc
    import weakref

    recorded = []
    orig_register = atexit.register
    try:
        atexit.register = lambda fn, *a, **k: recorded.append(fn) or fn
        eng = SegmentationEngine(CFG, backend="oracle")
        eng.start()
    finally:
        atexit.register = orig_register
    assert len(recorded) == 1
    assert eng._running
    recorded[0]()                 # simulate interpreter exit
    assert not eng._running
    assert eng._worker is None
    # weakref: the hook must not keep the engine alive
    wr = weakref.ref(eng)
    del eng
    gc.collect()
    assert wr() is None
    recorded[0]()                 # hook on a collected engine is a no-op


def test_engine_streaming_flush_failure_not_a_failed_frame(replay_frames):
    """A readback-batch flush failure (a device error in jnp.stack) loses that
    batch's counters — it must NOT be folded into frames_failed: every
    frame really processed, so drain()/drop accounting stays exact and the
    batch is retried by the next flush."""
    eng = SegmentationEngine(CFG, backend="jax", stream_sync_every=2)
    assert eng._stream_deferred
    orig = eng._flush_pending
    boom = {"armed": True}

    def exploding_flush():
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("device hiccup")
        orig()

    eng._flush_pending = exploding_flush
    eng.start()
    for fr in replay_frames[:4]:
        _submit_and_wait(eng, fr)
    eng.stop()
    assert eng.frames_failed == 0
    assert eng.frames_processed == 4
    # the failed batch stayed pending and the next flush backfilled it
    assert all(r["seg_vec_size"] >= 0 and r["nblines"] >= 0
               for r in eng.records)


def test_checkpoint_skips_sentinel_records(tmp_path):
    """Deferred mode dispatches ahead of the backfill, so a checkpoint can
    race records still carrying -1 sentinels; those rows are telemetry not
    yet synced and must not be serialized (a resumed engine's
    processing_time.csv would otherwise contain -1 rows the synchronous
    path never produces)."""
    ckpt = str(tmp_path / "ck.npz")
    eng = SegmentationEngine(CFG, backend="jax")
    eng.records = [
        {"wall_time": 1.0, "processing_time": 2.0,
         "seg_vec_size": 3, "nblines": 1},
        {"wall_time": 2.0, "processing_time": 2.5,
         "seg_vec_size": -1, "nblines": -1},
    ]
    eng.frames_processed = 2
    eng.save_checkpoint(ckpt)
    eng2 = SegmentationEngine(CFG, backend="jax")
    eng2.load_checkpoint(ckpt)
    assert [r["seg_vec_size"] for r in eng2.records] == [3]
    assert eng2.frames_processed == 2        # world state is device truth
    assert int(np.load(ckpt)["records_pending"]) == 1


def test_engine_viz_stream_appends_across_restarts(replay_frames, tmp_path):
    """stop()+finalize() closes the viz JSONL; a later run on the SAME
    engine must APPEND, not truncate — records and CSVs are cumulative
    across restarts, and truncation would erase run 1's frames (and
    desync any live follower).  A fresh engine on the same path still
    truncates (new session, new stream)."""
    import json as _json

    path = str(tmp_path / "viz.jsonl")
    eng = SegmentationEngine(CFG, backend="jax", viz_stream=path)
    eng.run_replay(replay_frames[:2])
    eng.finalize(str(tmp_path))              # closes the viz file
    eng.run_replay(replay_frames[2:4])       # second session, same engine
    eng.finalize(str(tmp_path))
    with open(path) as f:
        recs = [_json.loads(line) for line in f]
    assert [r["frame"] for r in recs] == [1, 2, 3, 4]
    # a NEW engine starts its own stream: first open truncates
    eng2 = SegmentationEngine(CFG, backend="jax", viz_stream=path)
    eng2.run_replay(replay_frames[:1])
    with open(path) as f:
        recs = [_json.loads(line) for line in f]
    assert [r["frame"] for r in recs] == [1]


def test_load_checkpoint_reanchors_cadence_and_dcap(tmp_path):
    """A resumed engine must neither immediately re-save the checkpoint it
    just loaded nor skip the next cadence boundary; the cumulative D-CAP
    counter rides the checkpoint."""
    ckpt = str(tmp_path / "ck.npz")
    eng = SegmentationEngine(CFG, backend="jax")
    eng.frames_processed = 7
    eng.world_overflow_frames = 3
    eng.save_checkpoint(ckpt)
    eng2 = SegmentationEngine(CFG, backend="jax",
                              checkpoint_every=2, checkpoint_path=ckpt)
    eng2.load_checkpoint(ckpt)
    assert eng2._last_checkpoint_k == 3      # 7 // 2
    assert eng2.world_overflow_frames == 3


def test_tail_points_matches_full_concat():
    """_tail_points(chunks, q) == full-history concat's newest q rows,
    without ever materializing the full history."""
    from pointcloud_segmentation_tpu.runtime.engine import _tail_points

    chunks = [np.arange(5), np.arange(5, 8), np.arange(8, 20)]
    full = np.concatenate(chunks)
    for q in (1, 3, 12, 15, 20):
        np.testing.assert_array_equal(_tail_points(chunks, q), full[-q:])


def test_collect_inlier_points_last_writer_wins():
    """Two frame segments fusing into the SAME world slot in one frame:
    the world map keeps only the later fusion (oracle new_world[j]
    overwrite, node.cpp:823-829 republish), so only the winning dseg's
    points may enter the accumulated hough_points store."""
    from types import SimpleNamespace

    eng = SegmentationEngine(CFG, backend="jax", collect_inlier_points=True)
    filtered = np.arange(12, dtype=np.float64).reshape(4, 3)
    masks = np.array([[True, True, False, False],
                      [False, False, True, True]])
    out = SimpleNamespace(
        filtered=filtered,
        segments=SimpleNamespace(point_mask=masks,
                                 valid=np.array([True, True])),
        slots=np.array([5, 5]))
    eng._collect_points_jax(out, np.zeros(3), np.array([1.0, 0, 0, 0]))
    assert list(eng._inlier_points) == [5]
    assert len(eng._inlier_points[5]) == 1
    np.testing.assert_allclose(eng._inlier_points[5][0], filtered[2:4])


def test_engine_restart_rss_bounded(replay_frames):
    """Repeated start/stream/stop sessions must not grow host RSS: each
    restarted worker/flusher thread lands on a glibc malloc arena, and
    without the package-wide M_ARENA_MAX cap (_malloc.py) every restart
    retained ~8 MB of arena high-water on CPU — the leak
    tools/endurance.py caught.  With the cap the
    measured growth is ~0.03 MB/session; assert a generous bound that
    still fails hard if the cap is removed."""

    def rss_mb():
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
        return float("nan")

    eng = SegmentationEngine(CFG, backend="jax", stream_sync_every=3)

    def session():
        eng.start()
        for fr in replay_frames[:2]:
            _submit_and_wait(eng, fr)
        eng.stop()

    session()   # warm: first-session compiles + arena touch
    session()
    # Point samples oscillate by ~85 MB (an XLA CPU scratch buffer is
    # live-or-freed at sample time), so compare window MINIMA: the arena
    # retention being hunted is monotonic and raises the floor.
    samples = []
    n = 8
    for _ in range(n):
        session()
        # a single point sample can land while the ~85 MB XLA scratch is
        # live; take the min of a few spaced samples per session so the
        # window-minima comparison is load-robust (measured flake when the
        # suite ran alongside two soak processes)
        per = []
        for _ in range(3):
            per.append(rss_mb())
            time.sleep(0.05)
        samples.append(min(per))
    growth = min(samples[-3:]) - min(samples[:3])
    assert growth < 3.0 * n, (
        f"streaming restarts leak {growth / n:.1f} MB/session "
        "(glibc arena retention — is the M_ARENA_MAX cap still applied?)")
