"""Randomized end-to-end parity soak: oracle vs device pipeline.

Runs full replays over randomly generated scenes with randomly drawn
configurations on BOTH backends and compares the resulting world maps
(segment count, matched endpoints, radii, intersection topology).  Any
mismatch prints a self-contained repro line.  Run on CPU:

    JAX_PLATFORMS=cpu python tools/parity_soak.py [n_iters] [start_seed] [--f64]

Coverage modes (mutually exclusive flags; default draws granularity 1-3 on
a 32x32 sensor):

    --g6         granularity-6 configs (20,481 directions — the SHIPPED
                 direction count), which resolve to the LAZY voting path
                 (ops/hough._vote_state_tiles); smaller clouds/frame
                 budgets keep the CPU oracle tractable
    --sensor128  128x128 ToF frames (16,384 rays — the large-sensor
                 scaling config), exercising the sort-based gap check
                 (N > 4096) and the big voxel compaction

This is a soak harness, not a CI test (tests/test_robustness.py and the
per-layer parity tests cover fixed seeds); use it to hunt for rare
inlier-boundary / tie-break disagreements across the config space.

Mismatches are CLASSIFIED (soak of seeds 2000-2059, 10 diverging):

* ``bx-knife-edge`` — the reference's frame abort on EXACT ``b.x == 0.0``
  (hough_3d_lines.h:43-45) applied to zero-noise, axis-aligned synthetic
  scenes: every refined direction has |b.x| ~ 1e-10..1e-16, so WHICH
  iteration rounds to exactly 0.0 is decided by eigensolver float noise.
  The reference itself has this instability (Eigen vs LAPACK vs the
  closed-form solver all differ in their last-ulp noise); backends
  aborting different frames here is inherent to the spec, not a bug.
  Detected when EITHER backend reports the BX_ZERO status anywhere in the
  run: even with identical status columns, which *iteration* aborts (and
  hence which already-accepted segments survive the abort) differs.
* ``f32-gate-boundary`` — adversarial random configs put candidates
  exactly on acceptance-gate thresholds (radius/gap/min_nb) where the f32
  device path and f64 oracle legitimately flip; rerunning the same seed
  with ``--f64`` (device pipeline in float64 parity mode) MATCHES the
  oracle exactly — verified for every such seed in the 2000-2059 soak.
  Reported as a mismatch line but counted separately.
"""

import json
import os
import subprocess
import sys
import time

# The soak compares against the numpy oracle on the CPU.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax

F64 = "--f64" in sys.argv
MODE = ("g6" if "--g6" in sys.argv
        else "sensor128" if "--sensor128" in sys.argv else "base")
if F64:
    jax.config.update("jax_enable_x64", True)

import numpy as np

STATUS_BX_ZERO = 3


def random_cfg(rng):
    from pointcloud_segmentation_tpu.config import StaticShapes, default_config

    if MODE == "g6":
        # the shipped direction count; every such config resolves voting to
        # "lazy" (carry would be >= 131 MB even at radius 0.1).  Round 4
        # widened the class to the remaining config corners (VERDICT r3 #7):
        # multi-radius draws whose MIN radius shrinks num_x's cell size,
        # and opt_nlines=0 (D-ITER: iterate until the vote floor, not a
        # fixed line count).  Every 8th seed (deterministic, reproducible)
        # pins min radius 0.012: B * num_x_max^2 = 2.18e9 > 2^31 — the
        # flat-key overflow regime ops/hough._global_argmax_winner exists
        # for.  Those seeds cost 10-30 CPU-min each (num_x=326 blows up
        # both the oracle's bincount chunking and the device init einsum),
        # so they are rationed rather than drawn uniformly.
        if rng.integers(0, 8) == 0:
            radii = [0.012, float(rng.choice([0.05, 0.08, 0.1]))]
        else:
            nrad = int(rng.integers(1, 3))
            radii = sorted(rng.choice([0.03, 0.05, 0.08, 0.1], size=nrad,
                                      replace=False).tolist())
        radii = sorted(radii)
        cfg = default_config(
            granularity=6,
            opt_minvotes=int(rng.integers(6, 14)),
            opt_nlines=int(rng.choice([0, 4, 10])),
            min_pca_coeff=float(rng.choice([0.9, 0.95, 0.995])),
            rad_2_leaf_ratio=float(rng.choice([1.5, 2.0])),
            floor_trim_height=float(rng.choice([0.0, 0.3])),
            radius_sizes=tuple(radii),
            surface_offset_correction=bool(rng.integers(0, 2)),
            shapes=StaticShapes(max_raw_points=1024, max_points=512,
                                max_world_segments=32),
            compute_dtype="float64" if F64 else "float32",
        )
        assert cfg.voting_mode == "lazy"
        return cfg
    nrad = rng.integers(1, 3)
    radii = sorted(rng.choice([0.03, 0.05, 0.08, 0.1], size=nrad,
                              replace=False).tolist())
    shapes = (StaticShapes(max_raw_points=16384, max_points=6144,
                           max_world_segments=32) if MODE == "sensor128"
              else StaticShapes(max_raw_points=2048, max_points=1024,
                                max_world_segments=32))
    return default_config(
        granularity=int(rng.integers(1, 4)),
        opt_minvotes=int(rng.integers(6, 16)),
        opt_nlines=int(rng.choice([0, 4, 10])),
        min_pca_coeff=float(rng.choice([0.9, 0.95, 0.995])),
        rad_2_leaf_ratio=float(rng.choice([1.5, 2.0])),
        floor_trim_height=float(rng.choice([0.0, 0.3])),
        radius_sizes=tuple(radii),
        surface_offset_correction=bool(rng.integers(0, 2)),
        shapes=shapes,
        compute_dtype="float64" if F64 else "float32",
    )


def run_pair(seed: int) -> list:
    from pointcloud_segmentation_tpu.io.scene import simple_scene, scene_truth
    from pointcloud_segmentation_tpu.io.simulator import (TofSpec,
                                                          simulate_trajectory)
    from pointcloud_segmentation_tpu.runtime import SegmentationEngine

    rng = np.random.default_rng(seed)
    cfg = random_cfg(rng)
    print(f"seed {seed} cfg: g{cfg.granularity} radii={cfg.radius_sizes} "
          f"nlines={cfg.opt_nlines} minvotes={cfg.opt_minvotes} "
          f"voting={cfg.voting_mode}", flush=True)
    # beams at ANY drawn radius (not always the smallest): multi-radius
    # configs must exercise radius matching against every table entry
    scene = simple_scene(n_beams=int(rng.integers(2, 6)),
                         radius=float(rng.choice(cfg.radius_sizes)),
                         seed=seed)
    n = int(rng.integers(3, 6)) if MODE == "g6" else int(rng.integers(4, 10))
    poses = [(float(i), np.array([0.0, 0.0, 0.5 + 0.15 * i]),
              np.array([1.0, 0.0, 0.0, 0.0])) for i in range(n)]
    side = 128 if MODE == "sensor128" else 32
    frames = simulate_trajectory(
        scene, poses,
        TofSpec(width=side, height=side,
                noise_frac=float(rng.choice([0.0, 0.002]))),
        seed=seed + 1)

    outs = {}
    statuses = {}
    for backend in ("oracle", "jax"):
        eng = SegmentationEngine(cfg, backend=backend)
        recs = eng.run_replay(frames)
        statuses[backend] = [r.get("status") for r in recs]
        outs[backend] = (eng.world_segments(), eng.intersections_rows())

    errs = []
    so, sj = outs["oracle"][0], outs["jax"][0]
    if len(so) != len(sj):
        errs.append(f"segment count {len(so)} vs {len(sj)}")
    for i, (a, b) in enumerate(zip(so, sj)):
        for k in ("t_min", "t_max", "radius"):
            if abs(a[k] - b[k]) > 5e-2:
                errs.append(f"seg{i}.{k}: {a[k]:.6g} vs {b[k]:.6g}")
        pa1 = np.asarray(a["a"]) + a["t_min"] * np.asarray(a["b"])
        pb1 = np.asarray(b["a"]) + b["t_min"] * np.asarray(b["b"])
        pa2 = np.asarray(a["a"]) + a["t_max"] * np.asarray(a["b"])
        pb2 = np.asarray(b["a"]) + b["t_max"] * np.asarray(b["b"])
        d = max(np.linalg.norm(pa1 - pb1), np.linalg.norm(pa2 - pb2))
        dr = max(np.linalg.norm(pa1 - pb2), np.linalg.norm(pa2 - pb1))
        if min(d, dr) > 5e-2:
            errs.append(f"seg{i} endpoints drift {min(d, dr):.4g}")
    io_, ij = set((r[0], r[2]) for r in outs["oracle"][1]), \
        set((r[0], r[2]) for r in outs["jax"][1])
    if io_ != ij:
        errs.append(f"intersection topology {sorted(io_)} vs {sorted(ij)}")

    klass = "real"
    so_st, sj_st = statuses["oracle"], statuses["jax"]
    if errs and (STATUS_BX_ZERO in so_st or STATUS_BX_ZERO in sj_st):
        # any aborted frame taints the run: WHICH iteration hits the exact
        # b.x == 0 (and hence which already-accepted segments survive the
        # abort) is eigensolver-noise-determined, even when the per-frame
        # status columns agree (seed 2030: the oracle's only world segment
        # came from an aborting frame's pre-abort iterations)
        klass = "bx-knife-edge"
    elif errs and not F64:
        klass = "f32-gate-boundary?"  # verify with --f64 on this seed
    return errs, klass


def _verify_f64(seed: int) -> bool:
    """Re-run one seed in a --f64 subprocess (x64 can't be flipped after
    jax init in-process); True iff the f64 device path matches the
    oracle — the definitive test for the f32-gate-boundary class."""
    import subprocess

    mode_flag = [f"--{MODE}"] if MODE != "base" else []
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "1", str(seed),
             "--f64", "--no-artifact"] + mode_flag,
            capture_output=True, text=True, timeout=1800)
    except Exception:
        return False
    return "MISMATCH" not in r.stdout


def merge_batch(data: dict, batch: dict) -> dict:
    """Pure: append one soak batch to the cumulative SOAK.json payload and
    recompute the totals block.  Separated from IO for unit testing
    (tests/test_soak_artifact.py).  Totals sum across batches — the same
    seed re-run in a later batch counts again (each batch stands on its
    own git rev); ``unexplained`` is the cross-batch sum of class
    ``real``, the only class that fails a soak."""
    data = dict(data or {})
    batches = list(data.get("batches", [])) + [batch]
    per_class = {}
    for b in batches:
        for k, v in b.get("counts", {}).items():
            per_class[k] = per_class.get(k, 0) + v
    data["batches"] = batches
    data["totals"] = {
        "seeds_run": sum(b["n"] for b in batches),
        "diverging_by_class": per_class,
        "unexplained": per_class.get("real", 0),
    }
    return data


def persist_batch(batch: dict, path: str) -> dict:
    """Append ``batch`` to the cumulative machine-readable soak artifact
    (SOAK.json at the repo root) — the committed, re-checkable form of
    the README's seed-count claims.

    Concurrent-safe and crash-safe: batches in different modes are run as
    separate processes (often in parallel), so the read-modify-write holds
    an flock on ``<path>.lock`` (no lost batches) and the result lands via
    write-to-temp + os.replace (a crash mid-dump can't leave a torn file
    that a later run would silently treat as an empty history)."""
    import fcntl

    with open(path + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        data = merge_batch(data, batch)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
    return data


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n = int(args[0]) if len(args) > 0 else 50
    s0 = int(args[1]) if len(args) > 1 else 1000
    verify = not F64 and "--no-verify" not in sys.argv
    counts = {}
    diverging = []
    t0 = time.time()
    for seed in range(s0, s0 + n):
        try:
            errs, klass = run_pair(seed)
        except Exception as e:  # a crash on either backend is also a finding
            errs, klass = [f"EXCEPTION {type(e).__name__}: {e}"], "real"
        if errs:
            f64_ok = None
            if klass == "f32-gate-boundary?" and verify:
                # self-verifying: boundary suspects are re-run under f64;
                # a seed that STILL mismatches is a real divergence and
                # fails the soak
                f64_ok = _verify_f64(seed)
                klass = "f32-gate-boundary" if f64_ok else "real"
            counts[klass] = counts.get(klass, 0) + 1
            diverging.append({"seed": seed, "class": klass,
                              "f64_matches_oracle": f64_ok,
                              "errors": errs})
            print(f"SEED {seed} MISMATCH [{klass}]: " + "; ".join(errs),
                  flush=True)
        else:
            print(f"seed {seed} ok", flush=True)
    print(f"done: {sum(counts.values())}/{n} diverging seeds by class: "
          f"{counts or '{}'}", flush=True)
    if "--no-artifact" not in sys.argv:
        try:
            rev = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                capture_output=True, text=True,
                cwd=os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))).stdout.strip()
        except OSError:
            rev = ""
        batch = {
            "rev": rev,
            "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "mode": MODE, "f64": F64,
            "seed_start": s0, "n": n,
            "duration_s": round(time.time() - t0, 1),
            "counts": counts, "diverging": diverging,
        }
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "SOAK.json")
        data = persist_batch(batch, path)
        print(f"SOAK.json: {data['totals']}", flush=True)
    # only unexplained ("real") divergences fail the soak; the two known
    # classes are characterized in the module docstring
    return 1 if counts.get("real") else 0


if __name__ == "__main__":
    sys.exit(main())
