"""Live viz following (the RViz live-view analog) + hough_pointcloud
world-accumulated semantics.

The reference is watched live in RViz while the node maps
(node.cpp:676-842, rviz/drone_pc.rviz); `pcs-tpu viz --follow` serves the
HTML player plus a /stream endpoint that tails the growing viz JSONL.
node.cpp:823-829 republishes ALL world segments' accumulated inlier points
every frame; the engine reproduces that with
viz_points + collect_inlier_points.
"""

import json
import os
import urllib.request

import numpy as np
import pytest

from pointcloud_segmentation_tpu.config import default_config, StaticShapes
from pointcloud_segmentation_tpu.runtime import SegmentationEngine
from pointcloud_segmentation_tpu.viz import VizStreamServer
from pointcloud_segmentation_tpu.io.scene import (
    OBS_TESTS_SCENE, WP_TESTS, trajectory_poses)
from pointcloud_segmentation_tpu.io.simulator import simulate_trajectory, TofSpec

CFG = default_config(
    granularity=2,
    shapes=StaticShapes(max_raw_points=4096, max_points=2048,
                        max_world_segments=32),
)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def _stream(base, frm, gen=None):
    url = base + f"stream?from={frm}"
    if gen is not None:
        url += f"&gen={gen}"
    return json.loads(_get(url))


def test_viz_server_follows_growing_stream(tmp_path):
    """One full refresh cycle: player served, initial frames fetched, the
    producer appends a frame, the incremental poll returns ONLY the new
    frame — live following of a growing stream."""
    path = str(tmp_path / "viz.jsonl")
    recs = [{"frame": i + 1, "t": 0.1 * i, "nlines": 1, "status": 0,
             "world_count": i + 1, "cylinders": [], "intersections": []}
            for i in range(3)]
    with open(path, "w") as f:
        for r in recs[:2]:
            f.write(json.dumps(r) + "\n")

    srv = VizStreamServer(path)
    srv.start_background()
    try:
        page = _get(srv.url).decode()
        assert "FRAMES" in page and "/stream?from=" in page  # live player
        resp = _stream(srv.url, 0)
        assert [g["frame"] for g in resp["frames"]] == [1, 2]
        assert resp["next"] == 2
        # producer appends while the server is live (one refresh cycle)
        with open(path, "a") as f:
            f.write(json.dumps(recs[2]) + "\n")
        new = _stream(srv.url, resp["next"], resp["gen"])
        assert [g["frame"] for g in new["frames"]] == [3]
        assert new["next"] == 3 and new["gen"] == resp["gen"]
        # an incremental poll past the end returns nothing
        assert _stream(srv.url, new["next"], new["gen"])["frames"] == []
    finally:
        srv.shutdown()


def test_viz_server_tolerates_missing_and_torn_file(tmp_path):
    path = str(tmp_path / "notyet.jsonl")
    srv = VizStreamServer(path)
    srv.start_background()
    try:
        assert _stream(srv.url, 0)["frames"] == []
        # torn tail line (producer mid-write) is skipped, not fatal
        with open(path, "w") as f:
            f.write(json.dumps({"frame": 1, "cylinders": [],
                                "intersections": []}) + "\n")
            f.write('{"frame": 2, "cyl')
        resp = _stream(srv.url, 0)
        assert [g["frame"] for g in resp["frames"]] == [1]
        assert resp["next"] == 1          # the torn line is NOT consumed
        # an unparseable but newline-TERMINATED line is consumed (counted
        # in `next`) yet not served — the follower must not re-request it
        # forever (that duplicated every later frame under the old
        # client-count protocol)
        with open(path, "a") as f:
            f.write("NOT JSON }}\n")
            f.write(json.dumps({"frame": 3, "cylinders": [],
                                "intersections": []}) + "\n")
        resp = _stream(srv.url, resp["next"], resp["gen"])
        assert [g["frame"] for g in resp["frames"]] == [3]
        assert resp["next"] == 3
    finally:
        srv.shutdown()


def test_serve_session_watched_live(tmp_path):
    """The full live-RViz-loop analog: a serve session writes the viz
    stream while a follower server tails it — a watcher sees the world
    grow DURING the session (node.cpp:676-842's live loop, end to end)."""
    import time

    from pointcloud_segmentation_tpu.runtime.server import (
        SegmentationServer, SegmentationClient)

    path = str(tmp_path / "serve_viz.jsonl")
    eng = SegmentationEngine(CFG, backend="oracle", viz_stream=path)
    srv = SegmentationServer(eng, outdir=str(tmp_path)).start()
    watcher = VizStreamServer(path)
    watcher.start_background()
    try:
        cli = SegmentationClient(srv.host, srv.port)
        poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:2]
        frames = simulate_trajectory(OBS_TESTS_SCENE, poses,
                                     TofSpec(noise_frac=0.002), seed=1)
        for fr in frames:
            want = int(eng.frames_processed) + 1
            cli.send_frame(fr.t, fr.position, fr.quat_wxyz, fr.points)
            deadline = time.time() + 60.0
            while eng.frames_processed < want and time.time() < deadline:
                time.sleep(0.02)
        # the watcher sees the session's frames while it is still live
        got = _stream(watcher.url, 0)["frames"]
        assert [g["frame"] for g in got] == [1, 2]
        assert got[-1]["world_count"] >= got[0]["world_count"]
        cli.finalize()
        cli.close()
    finally:
        watcher.shutdown()
        srv.stop()


def test_deferred_stream_viz_flush_cadence():
    """A viz stream must NOT kick a deferred stream back to the synchronous
    per-frame path: the flusher
    emits flush-cadence records built from one packed state snapshot, and
    their geometry matches the engine's own world map."""
    import time

    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:6]
    frames = simulate_trajectory(OBS_TESTS_SCENE, poses,
                                 TofSpec(noise_frac=0.002), seed=1)
    got = []
    eng = SegmentationEngine(CFG, backend="jax", viz_stream=got.append,
                             stream_sync_every=3)
    assert eng._stream_deferred          # the point of the feature
    assert eng._viz_flush
    eng.start()
    for fr in frames:
        target = (eng.frames_processed + eng.frames_skipped_no_pose
                  + eng.frames_failed + 1)
        eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
        eng.submit_cloud(fr.t, fr.points)
        deadline = time.time() + 60
        while (eng.frames_processed + eng.frames_skipped_no_pose
               + eng.frames_failed) < target and time.time() < deadline:
            time.sleep(0.002)
    eng.stop()
    assert eng.frames_processed == len(frames)
    assert got, "flush-cadence stream produced no viz records"
    assert all(r["viz_cadence"] == "flush" for r in got)
    # batches cover every frame; records are in stream order
    assert sum(r["frames_in_batch"] for r in got) == len(frames)
    fnos = [r["frame"] for r in got]
    assert fnos == sorted(fnos) and fnos[-1] == len(frames)
    # the last record's geometry IS the engine's world map
    last = got[-1]
    segs = eng.world_segments()
    assert last["world_count"] == len(segs)
    assert len(last["cylinders"]) == len(segs)
    for c, s in zip(last["cylinders"], segs):
        np.testing.assert_allclose(
            c["p1"], np.asarray(s["a"]) + s["t_min"] * np.asarray(s["b"]),
            atol=1e-6)
        assert c["radius"] == pytest.approx(s["radius"])
    assert len(last["intersections"]) == len(eng.intersections_rows())
    # the player HUD contract (viz.py) — every key it renders is present,
    # and EVERY record is internally consistent: world_count comes from
    # the same state snapshot as the geometry (the batch's packed scalar
    # can lag the snapshot when the worker keeps dispatching while the
    # emit waits for an idle window)
    for r in got:
        for key in ("frame", "t", "nlines", "status", "world_count",
                    "cylinders", "intersections", "drone"):
            assert key in r, key
        assert r["world_count"] == len(r["cylinders"]), r["frame"]


def test_viz_every_frame_forces_per_frame_records():
    """The opt-in fidelity knob: viz_every_frame disables the deferred path
    and emits one record per processed frame (the pre-round-4 behavior)."""
    import time

    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:3]
    frames = simulate_trajectory(OBS_TESTS_SCENE, poses,
                                 TofSpec(noise_frac=0.002), seed=1)
    got = []
    eng = SegmentationEngine(CFG, backend="jax", viz_stream=got.append,
                             viz_every_frame=True, stream_sync_every=3)
    assert not eng._stream_deferred
    eng.start()
    for fr in frames:
        target = eng.frames_processed + 1
        eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
        eng.submit_cloud(fr.t, fr.points)
        deadline = time.time() + 60
        while eng.frames_processed < target and time.time() < deadline:
            time.sleep(0.002)
    eng.stop()
    assert len(got) == len(frames)
    assert all("viz_cadence" not in r for r in got)


def test_viz_world_accumulated_hough_points():
    """With collect_inlier_points + viz_points, each viz record's
    hough_points carries the ACCUMULATED world inliers (node.cpp:823-829),
    so later frames' clouds are supersets in size of earlier ones."""
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:3]
    frames = simulate_trajectory(OBS_TESTS_SCENE, poses,
                                 TofSpec(noise_frac=0.002), seed=1)
    got = []
    eng = SegmentationEngine(CFG, backend="jax", viz_stream=got.append,
                             viz_points=True, collect_inlier_points=True)
    eng.run_replay(frames)
    assert len(got) == 3
    assert all(r.get("hough_points_world_accumulated") for r in got)
    sizes = [len(r["hough_points"]) for r in got]
    # accumulated: monotone non-decreasing (an empty world republishes an
    # empty cloud), with real points once segments exist
    assert sizes == sorted(sizes)
    assert sizes[-1] > 0
    # the cap is enforced
    assert all(s <= 4096 for s in sizes)


def test_cap_points_per_slot_fairness():
    """The 4096-point hough_points cap waterfills across world slots —
    a tail slice of the slot-ordered concatenation starved low-numbered
    segments entirely once the total exceeded the cap."""
    from pointcloud_segmentation_tpu.runtime.engine import _cap_points_per_slot

    arrs = [np.arange(3000), np.arange(3000), np.arange(10)]
    parts = _cap_points_per_slot(arrs, 4096)
    assert sum(len(p) for p in parts) == 4096
    assert len(parts) == 3                    # no slot starved
    assert len(parts[2]) == 10                # short slot fully kept
    assert abs(len(parts[0]) - len(parts[1])) <= 1   # even split of the rest
    # each slot keeps its NEWEST points
    assert parts[0][-1] == 2999 and parts[0][0] == 3000 - len(parts[0])
    # under budget: everything kept, empties dropped
    parts = _cap_points_per_slot(
        [np.arange(5), np.arange(0), np.arange(7)], 100)
    assert [len(p) for p in parts] == [5, 7]


def test_viz_server_incremental_poll_and_truncation(tmp_path):
    """Polls are O(new data): a follow-up poll past the end reads nothing,
    and a truncated/recreated producer file resets the line index instead
    of serving stale offsets."""
    path = str(tmp_path / "grow.jsonl")
    line = lambda i: json.dumps({"frame": i, "cylinders": [],
                                 "intersections": []}) + "\n"
    with open(path, "w") as f:
        f.write(line(1) + line(2) + line(3))
    srv = VizStreamServer(path)
    srv.start_background()
    try:
        r0 = _stream(srv.url, 1)
        assert [g["frame"] for g in r0["frames"]] == [2, 3]
        # recreated SHORTER file (new session overwrote the stream): the
        # server bumps `gen`; a follower presenting the stale gen gets a
        # full resync from line 0 regardless of its `from`
        with open(path, "w") as f:
            f.write(line(7))
        r1 = _stream(srv.url, r0["next"], r0["gen"])
        assert r1["gen"] == r0["gen"] + 1
        assert [g["frame"] for g in r1["frames"]] == [7]
        assert r1["next"] == 1
        assert _stream(srv.url, 1, r1["gen"])["frames"] == []
        # recreated file that already OUTGREW the old size between polls
        # (shrink check alone cannot see this): the boundary-byte check
        # resets the index — no stale offsets, no mixed runs
        with open(path, "w") as f:
            f.write('{"frame": 8, "cylinders": [], "intersections": [], '
                    '"pad": "' + "x" * 200 + '"}\n')
            f.write(line(9))
        r2 = _stream(srv.url, r1["next"], r1["gen"])
        assert r2["gen"] == r1["gen"] + 1
        assert [g["frame"] for g in r2["frames"]] == [8, 9]
    finally:
        srv.shutdown()
