"""CLI + viz smoke tests."""

import json
import os

import numpy as np
import pytest

from pointcloud_segmentation_tpu.cli import main

CONFIG_YAML = os.path.join(os.path.dirname(__file__), "..", "configs",
                           "config.yaml")


def test_cli_run_and_eval_and_timing(tmp_path, capsys):
    out = str(tmp_path / "out")
    rc = main(["run", "--granularity", "2", "--backend", "jax", "--out", out,
               "--hz", "1.0", "--velocity", "0.4", "--max-frames", "6",
               "--plots"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "world segments" in text
    assert os.path.exists(os.path.join(out, "segments.csv"))
    assert os.path.exists(os.path.join(out, "world.png"))

    rc = main(["eval", os.path.join(out, "segments.csv")])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["n_truth_matched"] >= 2

    rc = main(["timing", os.path.join(out, "processing_time.csv")])
    assert rc == 0
    s = json.loads(capsys.readouterr().out)
    assert s["n_frames"] == 6


def test_cli_record_and_replay(tmp_path, capsys):
    log = str(tmp_path / "frames.pcsl")
    rc = main(["record", log, "--hz", "1.0", "--velocity", "0.4",
               "--max-frames", "4"])
    assert rc == 0
    assert os.path.getsize(log) > 100

    out = str(tmp_path / "out2")
    rc = main(["run", "--granularity", "2", "--replay", log, "--out", out,
               "--backend", "oracle"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "processing_time.csv"))


def test_cli_stream(tmp_path, capsys):
    """record -> stream: the live-runtime path (feeder thread -> latest-wins
    mailbox + pose buffer -> consumer thread) from the CLI."""
    log = str(tmp_path / "frames.pcsl")
    rc = main(["record", log, "--hz", "2.0", "--velocity", "0.4",
               "--max-frames", "5"])
    assert rc == 0

    out = str(tmp_path / "out_stream")
    rc = main(["stream", log, "--granularity", "2", "--backend", "oracle",
               "--out", out, "--rate", "15"])
    assert rc == 0
    msg = capsys.readouterr().out
    assert "fed 5 frames" in msg
    assert os.path.exists(os.path.join(out, "segments.csv"))
    assert os.path.exists(os.path.join(out, "processing_time.csv"))


def test_cli_run_from_reference_wbt(tmp_path, capsys, reference_file):
    """--wbt: fly the simulated trajectory against the REFERENCE's actual
    benchmark world file and evaluate against its parsed ground truth.
    The reference checkout is not carried in this repo: point
    PCS_REFERENCE_DIR at one to run this test."""
    wbt = reference_file("webots_project", "worlds",
                         "flying_arena_ros_obs_tests.wbt")
    out = str(tmp_path / "out_wbt")
    rc = main(["run", "--granularity", "2", "--backend", "oracle",
               "--out", out, "--hz", "2.0", "--velocity", "0.3",
               "--wbt", wbt])
    assert rc == 0
    capsys.readouterr()
    rc = main(["eval", os.path.join(out, "segments.csv"), "--wbt", wbt])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["n_truth"] == 7
    assert rep["recall"] >= 6 / 7


def test_cli_viz_stream_to_html(tmp_path, capsys):
    """run --viz-stream -> viz: the per-frame marker stream renders into a
    self-contained HTML player with every frame embedded."""
    out = str(tmp_path / "outv")
    stream = str(tmp_path / "stream.jsonl")
    rc = main(["run", "--granularity", "2", "--backend", "oracle",
               "--out", out, "--hz", "1.0", "--velocity", "0.5",
               "--max-frames", "3", "--viz-stream", stream])
    assert rc == 0
    html = str(tmp_path / "viewer.html")
    rc = main(["viz", stream, "-o", html])
    assert rc == 0
    assert "3 frames" in capsys.readouterr().out
    doc = open(html).read()
    assert "<canvas" in doc and "FRAMES" in doc
    assert doc.count('"frame"') == 3      # all three records embedded


def test_cli_with_reference_yaml(tmp_path, capsys):
    out = str(tmp_path / "out3")
    rc = main(["run", "--config", CONFIG_YAML,
               "--granularity", "2", "--out", out, "--hz", "1.0",
               "--velocity", "0.5", "--max-frames", "3"])
    assert rc == 0


def test_cli_scene_selection(tmp_path, capsys):
    """--scene picks the world + default flight; eval uses matching truth."""
    out = str(tmp_path / "mock")
    rc = main(["run", "--granularity", "2", "--scene", "mockup", "--out", out,
               "--hz", "0.5", "--velocity", "0.8", "--max-frames", "8"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "segments.csv"))
    capsys.readouterr()
    rc = main(["eval", os.path.join(out, "segments.csv"), "--scene", "mockup"])
    rep = json.loads(capsys.readouterr().out)
    assert rep["n_truth"] == 20          # the mockup scaffold's beam count


def test_cli_viz_points_feed(tmp_path, capsys):
    """--viz-points embeds the frame's world-frame clouds in each record —
    the filtered_pointcloud / hough_pointcloud topics analog
    (node.cpp:417-420, 833-841) — on both backends."""
    for backend in ("jax", "oracle"):
        stream = str(tmp_path / f"pts_{backend}.jsonl")
        rc = main(["run", "--granularity", "2", "--backend", backend,
                   "--out", str(tmp_path / f"outp_{backend}"),
                   "--hz", "1.0", "--velocity", "0.5", "--max-frames", "2",
                   "--viz-stream", stream, "--viz-points"])
        assert rc == 0
        recs = [json.loads(l) for l in open(stream)]
        assert len(recs) == 2
        for r in recs:
            assert "filtered_points" in r and "hough_points" in r
            pts = np.asarray(r["filtered_points"])
            assert pts.ndim == 2 and pts.shape[1] == 3 and len(pts) > 0
            assert np.isfinite(pts).all()
            # world frame: the filtered window is drone-local [0,1.5] fwd;
            # transformed points should sit near the scene, not at origin
            assert np.abs(pts).max() < 10.0
        # the jax path also exposes the accepted lines' inliers
        if backend == "jax" and any(r["nlines"] > 0 for r in recs):
            assert any(len(r["hough_points"]) > 0
                       for r in recs if r["nlines"] > 0)


def test_cli_rejects_orphan_viz_world_points(tmp_path, capsys):
    """--viz-world-points without --viz-stream would silently accumulate
    inlier points host-side (and kill the deferred streaming fast path)
    with zero output — the CLI refuses it."""
    rc = main(["run", "--granularity", "2", "--backend", "oracle",
               "--viz-world-points", "--max-frames", "1",
               "--out", str(tmp_path)])
    assert rc == 2
    assert "--viz-stream" in capsys.readouterr().err


def test_cli_replay_respects_max_frames(tmp_path, capsys):
    """--max-frames must truncate a --replay log too, not only simulated
    trajectories."""
    log = str(tmp_path / "frames.pcsl")
    rc = main(["record", log, "--hz", "1.0", "--velocity", "0.4",
               "--max-frames", "4"])
    assert rc == 0
    out = str(tmp_path / "out_trunc")
    rc = main(["run", "--granularity", "2", "--replay", log, "--out", out,
               "--backend", "oracle", "--max-frames", "2"])
    assert rc == 0
    with open(os.path.join(out, "processing_time.csv")) as f:
        rows = [ln for ln in f.read().splitlines() if ln.strip()]
    assert len(rows) - 1 == 2       # header + exactly 2 frames
