"""chip_smoke.py off the card: its comparisons, its guard, and one replay
phase at a tiny size on the CPU.  On the GPU the script itself runs every
phase at the shipped widths (`python chip_smoke.py`)."""

import copy
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

from pointcloud_segmentation_tpu.config import StaticShapes, default_config  # noqa: E402
from pointcloud_segmentation_tpu.io.scene import (  # noqa: E402
    OBS_TESTS_SCENE, WP_TESTS, scene_truth, trajectory_poses)
from pointcloud_segmentation_tpu.io.simulator import (  # noqa: E402
    TofSpec, simulate_trajectory)

TINY = default_config(granularity=1,
                      shapes=StaticShapes(max_raw_points=1024,
                                          max_points=512,
                                          max_world_segments=16))


@pytest.fixture(scope="module")
def tiny_frames():
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:5]
    return simulate_trajectory(OBS_TESTS_SCENE, poses,
                               TofSpec(width=32, height=32,
                                       noise_frac=0.002), seed=0)


@pytest.fixture(scope="module")
def tiny_ref(tiny_frames):
    return cs.oracle_trace(TINY, tiny_frames[:3])


def _last_with_segments(ref):
    r = [r for r in ref if r["segments"]]
    assert r, "tiny scene produced no oracle segments"
    return r[-1]


def test_compare_world_accepts_identical(tiny_ref):
    r = _last_with_segments(tiny_ref)
    out = cs.compare_world(r["segments"], r["inter"], r["segments"],
                           r["inter"], cs.F32_TOL)
    assert out["ok"], out
    assert out["max_drift"]["endpoint"] == 0.0


def _perturb_endpoint(segs, inter):
    segs[0]["a"] = segs[0]["a"] + np.array([0.0, 0.0, 0.01])


def _perturb_points_size(segs, inter):
    segs[0]["points_size"] += 1


def _perturb_radius(segs, inter):
    segs[0]["radius"] *= 2.0


def _perturb_count(segs, inter):
    segs.pop()


def _perturb_pca(segs, inter):
    segs[0]["pca_coeff"] -= 0.01


def _perturb_topology(segs, inter):
    inter.append((len(segs) + 5, 0.0, 0, 0.0))


@pytest.mark.parametrize("perturb", [
    _perturb_endpoint, _perturb_points_size, _perturb_radius,
    _perturb_count, _perturb_pca, _perturb_topology])
def test_compare_world_rejects_perturbed(tiny_ref, perturb):
    r = _last_with_segments(tiny_ref)
    segs, inter = copy.deepcopy(r["segments"]), list(r["inter"])
    perturb(segs, inter)
    out = cs.compare_world(segs, inter, r["segments"], r["inter"],
                           cs.F32_TOL)
    assert not out["ok"], out


def test_compare_world_f64_tolerance_is_tighter(tiny_ref):
    """A 1e-3 endpoint drift passes the f32 bound but not the f64 one."""
    r = _last_with_segments(tiny_ref)
    segs = copy.deepcopy(r["segments"])
    segs[0]["a"] = segs[0]["a"] + np.array([1e-3, 0.0, 0.0])
    assert cs.compare_world(segs, r["inter"], r["segments"], r["inter"],
                            cs.F32_TOL)["ok"]
    assert not cs.compare_world(segs, r["inter"], r["segments"],
                                r["inter"], cs.F64_TOL)["ok"]


def test_compare_frame(tiny_ref):
    r = tiny_ref[-1]
    rec = {"nblines": r["nblines"], "status": r["status"],
           "seg_vec_size": len(r["segments"])}
    assert cs.compare_frame(rec, r) == []
    assert cs.compare_frame(dict(rec, nblines=rec["nblines"] + 1), r)
    assert cs.compare_frame(dict(rec, seg_vec_size=-1), r)
    assert cs.compare_frame(None, r)


def test_beams_recovered_truth_and_rotated():
    truth = [dict(s, t_min=s["endpoints"][0], t_max=s["endpoints"][1])
             for s in scene_truth(OBS_TESTS_SCENE)]
    assert cs.beams_recovered(truth, OBS_TESTS_SCENE) == 7
    # a quarter-turn about z breaks every direction match but vertical ones
    Rz = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    turned = [dict(s, b=Rz @ np.asarray(s["b"], float)) for s in truth]
    assert cs.beams_recovered(turned, OBS_TESTS_SCENE) < 7


def test_replay_phase_tiny_on_cpu(tiny_frames, tiny_ref, tmp_path):
    """The replay phase's plumbing end to end on the CPU: per-frame oracle
    comparisons, the rest of the replay, CSVs, memory analysis."""
    out = cs.replay_phase(TINY, tiny_frames, tiny_ref, cs.F32_TOL,
                          str(tmp_path), min_beams=0)
    assert out["ok"], out["errors"]
    assert out["csv_rows"]["processing_time"] == len(tiny_frames)
    assert out["memory"]["step"]["argument_size_in_bytes"] > 0
    assert set(out["runtime_components"]) == {"mailbox", "pose_buffer",
                                              "csv_writers"}


def test_replay_phase_detects_oracle_mismatch(tiny_frames, tiny_ref,
                                              tmp_path):
    bad = copy.deepcopy(tiny_ref)
    _last_with_segments(bad)["nblines"] += 1
    out = cs.replay_phase(TINY, tiny_frames, bad, cs.F32_TOL,
                          str(tmp_path), min_beams=0)
    assert not out["ok"]
    assert any("nblines" in e for e in out["errors"])


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_guard_exits_nonzero_without_gpu():
    r = _run_script(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs 1 GPU" in r.stderr


def test_script_alone_exits_nonzero(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    (the package not importable), it fails without printing a result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys; "
         "sys.modules['pointcloud_segmentation_tpu'] = None; "
         "sys.argv = ['chip_smoke.py']; "
         "runpy.run_path('chip_smoke.py', run_name='__main__')"],
        cwd=tmp_path, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "pointcloud_segmentation_tpu" in r.stderr
