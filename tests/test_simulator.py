import numpy as np

from pointcloud_segmentation_tpu import geometry
from pointcloud_segmentation_tpu.io.scene import (
    OBS_TESTS_SCENE, WP_TESTS, Cylinder, trajectory_poses, yaw_to_quat_wxyz)
from pointcloud_segmentation_tpu.io.simulator import (
    TofSpec, ray_directions, render_depth, simulate_trajectory)


def test_obs_tests_scene_matches_reference_truth():
    # 7 beams, radius 0.05, default cylinder height 2 (obs_tests.wbt:57-168)
    assert len(OBS_TESTS_SCENE) == 7
    for c in OBS_TESTS_SCENE:
        assert c.radius == 0.05
        assert c.height == 2.0
        assert abs(np.linalg.norm(np.array(c.axis)) - 1.0) < 1e-9
    # SEG2's rotation is ~pi about (0.129, -0.966, -0.224): z-axis maps near
    # the plane... sanity: all beams intersect the arena volume
    for c in OBS_TESTS_SCENE:
        p1, p2 = c.endpoints()
        assert min(p1[2], p2[2]) < 3.5


def test_ray_directions_shape_and_fov():
    spec = TofSpec()
    d = ray_directions(spec)
    assert d.shape == (64 * 64, 3)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-12)
    # all rays point forward
    assert (d[:, 0] > 0).all()
    # edge rays reach about fov/2 horizontally
    ang = np.arctan2(np.abs(d[:, 1]), d[:, 0]).max()
    assert 0.8 < ang <= 1.02 + 0.05


def test_render_depth_hits_beam():
    # beam 1 m in front of the camera, vertical
    beam = Cylinder(center=(1.0, 0.0, 0.0), axis=(0.0, 0.0, 1.0), radius=0.05, height=2.0)
    pts = render_depth(np.zeros(3), np.array([1.0, 0, 0, 0]), [beam],
                       TofSpec(noise_frac=0.0), ground_plane=False)
    valid = pts[np.isfinite(pts).all(axis=1)]
    assert len(valid) > 20
    # hit points lie on the cylinder surface (distance to axis == radius)
    d = geometry.point_line_distance(np.array(beam.center), np.array(beam.axis), valid)
    np.testing.assert_allclose(d, 0.05, atol=1e-6)
    # all in front, within range
    assert (valid[:, 0] >= 0.1).all()


def test_render_depth_pose_transform():
    # same beam, but drone displaced: world-frame reconstruction must match
    beam = Cylinder(center=(1.0, 0.5, 1.0), axis=(0.0, 0.0, 1.0), radius=0.05, height=2.0)
    pos = np.array([0.0, 0.5, 1.0])
    yaw = 0.3
    quat = yaw_to_quat_wxyz(yaw)
    pts = render_depth(pos, quat, [beam], TofSpec(noise_frac=0.0), ground_plane=False)
    valid = pts[np.isfinite(pts).all(axis=1)]
    assert len(valid) > 10
    R = np.array(geometry.quat_to_rot(*quat))
    world = valid @ R.T + pos
    d = geometry.point_line_distance(np.array(beam.center), np.array(beam.axis), world)
    np.testing.assert_allclose(d, 0.05, atol=1e-5)


def test_ground_plane():
    pts = render_depth(np.array([0, 0, 1.0]), np.array([1.0, 0, 0, 0]), [],
                       TofSpec(noise_frac=0.0), ground_plane=True)
    valid = pts[np.isfinite(pts).all(axis=1)]
    assert len(valid) > 50
    # floor points in drone frame have z ~= -1.0
    np.testing.assert_allclose(valid[:, 2].max(), -1.0, atol=0.05)


def test_trajectory_poses_and_sim():
    poses = trajectory_poses(WP_TESTS, hz=2.0, velocity=0.5)
    assert len(poses) > 3
    t = [p[0] for p in poses]
    assert all(t2 > t1 for t1, t2 in zip(t, t[1:]))
    frames = simulate_trajectory(OBS_TESTS_SCENE, poses[:3], TofSpec(), seed=0)
    assert len(frames) == 3
    assert frames[0].points.shape == (4096, 3)
    assert frames[0].points.dtype == np.float32


def test_parse_wbt_matches_transcribed_scene(reference_file):
    # the parser applied to the reference's own benchmark world reproduces
    # the transcribed fixture exactly
    from pointcloud_segmentation_tpu.io.scene import parse_wbt_scene

    parsed = parse_wbt_scene(reference_file(
        "webots_project", "worlds", "flying_arena_ros_obs_tests.wbt"))
    assert len(parsed) == len(OBS_TESTS_SCENE) == 7
    for p, t in zip(parsed, OBS_TESTS_SCENE):
        np.testing.assert_allclose(p.center, t.center, atol=1e-12)
        np.testing.assert_allclose(p.axis, t.axis, atol=1e-9)
        assert p.radius == t.radius == 0.05
        assert p.height == t.height == 2.0


def test_parse_wbt_dev_world_has_no_labeled_truth(reference_file):
    # the development world's 9 beams carry no DEF SEGn labels (only the
    # benchmark world is machine-readable — same as tests_structure.py)
    from pointcloud_segmentation_tpu.io.scene import parse_wbt_scene

    parsed = parse_wbt_scene(reference_file(
        "webots_project", "worlds", "flying_arena_ros_obs.wbt"))
    assert parsed == ()


def test_parse_wbt_out_of_order_defs(tmp_path):
    """SEG defs appearing out of ascending file order must still slice
    their own blocks (a later-numbered def earlier in the file used to
    produce an empty block -> fabricated origin cylinders)."""
    from pointcloud_segmentation_tpu.io.scene import parse_wbt_scene

    wbt = tmp_path / "ooo.wbt"
    wbt.write_text("""
DEF SEG2 Solid {
  translation 5 6 7
  rotation 0 0 1 0
  children [ Shape { geometry Cylinder { radius 0.07 height 2 } } ]
}
DEF SEG1 Solid {
  translation 1 2 3
  rotation 0 0 1 0
  children [ Shape { geometry Cylinder { radius 0.05 height 2 } } ]
}
""")
    beams = parse_wbt_scene(str(wbt))
    assert len(beams) == 2
    assert beams[0].center == (1.0, 2.0, 3.0) and beams[0].radius == 0.05
    assert beams[1].center == (5.0, 6.0, 7.0) and beams[1].radius == 0.07


def test_load_waypoints_csv_rejects_headerless(tmp_path):
    from pointcloud_segmentation_tpu.io.scene import load_waypoints_csv

    p = tmp_path / "wp.csv"
    p.write_text("1.0,2.0,3.0,0.0,5.0\n")
    import pytest
    with pytest.raises(ValueError, match="header"):
        load_waypoints_csv(str(p))


def test_shipped_reference_trajectories_load():
    """configs/wp_tower.csv and configs/wp_mockup.csv are the reference's
    REAL flight plans carried verbatim
    (/root/reference/config_auto_pilot/wp_tower.csv, wp_mockup.csv —
    byte-identical); they load through load_waypoints_csv (blank lines
    skipped: the tower file has 49 waypoints across its 53 data lines)
    and feed trajectory_poses.  The tower BENCH keeps the code-side
    spiral (scene.spiral_waypoints): the stand-in tower scene's geometry
    differs from the reference's missing STL, so the verbatim flight
    plan would orbit empty space there."""
    import os

    from pointcloud_segmentation_tpu.io.scene import (load_waypoints_csv,
                                                      trajectory_poses)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tower = load_waypoints_csv(os.path.join(root, "configs", "wp_tower.csv"))
    mockup = load_waypoints_csv(os.path.join(root, "configs",
                                             "wp_mockup.csv"))
    assert len(tower) == 49 and len(mockup) == 16
    assert all(len(w) == 5 for w in tower + mockup)
    assert tower[0] == (0.5, 2.5, 0.1, -1.57, 5.0)
    assert mockup[-1] == (1.5, 1.0, 0.3, 3.14, 15.0)
    poses = trajectory_poses(mockup, hz=1.0, velocity=0.5)
    assert len(poses) > 50           # a real multi-minute scan pattern
