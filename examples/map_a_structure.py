#!/usr/bin/env python
"""End-to-end example: map a steel structure from simulated ToF frames.

Simulates a drone orbit-climbing a lattice tower, streams the frames through
the device pipeline, evaluates against ground truth with the reference's match
criteria, and writes the CSVs + plots.

    python examples/map_a_structure.py [out_dir]
"""

import sys

import numpy as np

from pointcloud_segmentation_tpu import default_config, SegmentationEngine
from pointcloud_segmentation_tpu.config import StaticShapes
from pointcloud_segmentation_tpu.io.scene import (
    tower_scene, spiral_waypoints, trajectory_poses, scene_truth)
from pointcloud_segmentation_tpu.io.simulator import simulate_trajectory, TofSpec
from pointcloud_segmentation_tpu.eval import match_report
from pointcloud_segmentation_tpu import viz


def main(out_dir: str = "./tower_output") -> int:
    scene = tower_scene(levels=2, width=1.0)
    poses = trajectory_poses(
        spiral_waypoints(radius=1.2, z0=0.4, z1=2.2, turns=2.0, n=40),
        hz=3.0, velocity=0.2)
    print(f"simulating {len(poses)} ToF frames over a "
          f"{len(scene)}-beam tower ...")
    frames = simulate_trajectory(scene, poses, TofSpec(noise_frac=0.002), seed=0)

    cfg = default_config(
        granularity=4, path_to_output=out_dir,
        min_pca_coeff=0.99,  # report §5.2 benchmark value; the shipped
                             # 0.995 rejects oblique beam views (~9/12)
        shapes=StaticShapes(max_raw_points=4096, max_points=2048,
                            max_world_segments=64))
    eng = SegmentationEngine(cfg, backend="jax")
    eng.run_replay(frames)

    segs = eng.world_segments()
    proc = [dict(s, endpoints=[s["t_min"], s["t_max"]]) for s in segs]
    rep = match_report(scene_truth(scene), proc)
    print(f"world map: {len(segs)} segments, "
          f"{len(eng.intersections_rows())} intersections; "
          f"recall {rep['n_truth_matched']}/{rep['n_truth']} beams")

    paths = eng.finalize()
    viz.plot_world(proc, scene_truth(scene), rep["matches"],
                   out_path=f"{out_dir}/world.png")
    print("outputs:")
    for k, v in paths.items():
        print(f"  {k}: {v}")
    print(f"  plot: {out_dir}/world.png")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
