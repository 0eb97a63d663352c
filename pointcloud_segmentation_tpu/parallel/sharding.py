"""Multi-chip scaling: device meshes, frame data-parallelism, direction
tensor-parallelism.

The reference is a single-host, single-thread robotics node (SURVEY.md §2.6)
— its only concurrency is a 2-thread mailbox.  This framework adds
two honest axes of scale for high-throughput map building and the
granularity-6 stress configuration (BASELINE.json configs 4-5):

  * ``batch`` (data parallel): a batch of frames is sharded across devices;
    each device runs preproc + Hough extraction + frame transform on its
    frames; frame segments are then all-gathered and fused into the world
    map *sequentially in frame order* (fusion is order-dependent —
    node.cpp:491-510 — so it is replicated, not parallelized).
  * ``dir`` (tensor parallel): the direction sphere is sharded; every device
    votes its slice of directions over the (replicated) cloud and the argmax
    reduces with pmax/pmin + a masked psum broadcast of the winning rows
    (ops/hough.py).  This divides the dominant (B, N) sort by the axis size
    — the scaling lever for granularity 6's 20,481 directions.

Everything rides jax.sharding + shard_map; XLA inserts the ICI collectives.
"""

from __future__ import annotations


from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import PipelineConfig
from ..sphere import hough_space
from ..ops.preproc import preprocess
from ..ops.hough import extract_lines, SegmentBatch
from ..pipeline import (transform_segments, height_cutoff,
                        surface_offset_correction, compute_dtype)
from ..worldmap import world_step


def make_mesh(n_batch: Optional[int] = None, n_dir: int = 1,
              devices=None) -> Mesh:
    """A ('batch', 'dir') mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    if n_dir < 1:
        raise ValueError(f"make_mesh: n_dir must be >= 1, got {n_dir}")
    if n_batch is None:
        n_batch = len(devices) // n_dir
    need = n_batch * n_dir
    if len(devices) < need or need == 0:
        plat = devices[0].platform if devices else "none"
        raise ValueError(
            f"make_mesh: need {n_batch}x{n_dir}={need} devices, have "
            f"{len(devices)} ({plat}). For a virtual CPU mesh set "
            f"JAX_PLATFORMS=cpu and XLA_FLAGS="
            f"--xla_force_host_platform_device_count=<n> before importing "
            f"jax (see tests/conftest.py / __graft_entry__.py).")
    devs = np.array(devices[:need]).reshape(n_batch, n_dir)
    return Mesh(devs, axis_names=("batch", "dir"))


def _padded_dir_tables(cfg: PipelineConfig, n_dir: int):
    """Direction tables padded to a multiple of n_dir.

    Padding entries are copies of direction 0: a duplicate direction can at
    best tie with the original's cell counts and then loses the smallest-
    (b, cell) tie-break, so copies are semantically inert while keeping
    every shard shape static.
    """
    dirs, c1, c2 = hough_space(cfg.granularity)
    B = dirs.shape[0]
    pad = (-B) % n_dir
    if pad:
        dirs = np.concatenate([dirs, np.repeat(dirs[:1], pad, 0)], 0)
        c1 = np.concatenate([c1, np.repeat(c1[:1], pad, 0)], 0)
        c2 = np.concatenate([c2, np.repeat(c2[:1], pad, 0)], 0)
    # dirs follow the pipeline compute dtype: truncating them to f32 here
    # would survive extract_lines' astype(dt) round-trip and silently void
    # the f64 parity contract on every sharded path (the oracle keeps its
    # directions in f64).  Only the c1/c2 binning bases are f32 BY SPEC.
    dt = jnp.dtype(cfg.compute_dtype)
    return (jnp.asarray(dirs, dt), jnp.asarray(c1, jnp.float32),
            jnp.asarray(c2, jnp.float32))


def _frame_fn(cfg: PipelineConfig, dir_axis: Optional[str]):
    """Per-frame: preproc -> extract -> world transform -> floor cutoff."""

    def fn(raw, pos, quat, dirs, c1, c2):
        # mirror pipeline.process_frame exactly: cast to the pipeline
        # compute dtype (an f32 input cloud must not silently downgrade an
        # f64 parity run) and apply the opt-in E-OFFSET between extraction
        # and the world transform
        raw = raw.astype(compute_dtype(cfg))
        filtered, fvalid, _ = preprocess(raw, cfg)
        res = extract_lines(filtered, fvalid, cfg,
                            dir_tables=(dirs, c1, c2), dir_axis=dir_axis)
        fsegs = res.segments
        if cfg.surface_offset_correction:
            fsegs = surface_offset_correction(fsegs)
        segs = transform_segments(fsegs, pos, quat)
        segs = height_cutoff(segs, cfg.floor_trim_height)
        return segs, res.nlines, res.status

    return fn


def make_multichip_step(cfg: PipelineConfig, mesh: Mesh):
    """jit-compiled multi-frame map-building step over the mesh.

    Signature: step(state, clouds (F, N_raw, 3), positions (F, 3),
    quats (F, 4)) -> (state', nlines (F,), statuses (F,)).

    F must be divisible by the mesh's batch size.  The world state is
    replicated; clouds/poses are sharded over 'batch'; the direction table
    over 'dir'.  Fusion runs in global frame order on every device.
    """
    n_dir = mesh.shape["dir"]
    dirs, c1, c2 = _padded_dir_tables(cfg, n_dir)
    dir_axis = "dir" if n_dir > 1 else None
    frame = _frame_fn(cfg, dir_axis)

    def sharded_body(state, clouds, poss, quats, dirs, c1, c2):
        # local frames -> local segment batches (vmap over the local shard)
        segs, nlines, statuses = jax.vmap(
            lambda r, p, q: frame(r, p, q, dirs, c1, c2))(clouds, poss, quats)
        # gather every device's frame segments in global frame order
        segs_all = jax.lax.all_gather(segs, "batch", axis=0, tiled=True)
        nlines_all = jax.lax.all_gather(nlines, "batch", axis=0, tiled=True)
        status_all = jax.lax.all_gather(statuses, "batch", axis=0, tiled=True)

        # sequential fusion in frame order (replicated on all devices)
        def scan_fn(st, seg):
            st, _slots = world_step(st, seg, cfg)
            return st, ()

        state, _ = jax.lax.scan(scan_fn, state, segs_all)
        return state, nlines_all, status_all

    smapped = shard_map(
        sharded_body, mesh=mesh,
        in_specs=(P(), P("batch"), P("batch"), P("batch"),
                  P("dir"), P("dir"), P("dir")),
        out_specs=(P(), P(), P()),
        check_vma=False)

    # donate the world state like make_process_frame does: the replicated
    # map updates in place instead of allocating a fresh per-device copy
    # every step
    @partial(jax.jit, donate_argnums=(0,))
    def step(state, clouds, poss, quats):
        return smapped(state, clouds, poss, quats, dirs, c1, c2)

    return step


def make_tp_process_frame(cfg: PipelineConfig, mesh: Mesh):
    """Single-frame, direction-tensor-parallel process_frame.

    The full per-frame pipeline with the direction sphere sharded over the
    mesh's 'dir' axis (cloud + world state replicated): the latency lever
    for granularity 6, where a single chip spends ~80 ms on 20,481
    directions.  Signature matches pipeline.make_process_frame.
    """
    from ..pipeline import FrameOutput

    n_dir = mesh.shape["dir"]
    dirs, c1, c2 = _padded_dir_tables(cfg, n_dir)
    dir_axis = "dir" if n_dir > 1 else None

    def body(state, raw, pos, quat, dirs, c1, c2):
        # mirror pipeline.process_frame exactly (dtype cast + E-OFFSET);
        # see _frame_fn
        raw = raw.astype(compute_dtype(cfg))
        filtered, fvalid, fcount = preprocess(raw, cfg)
        res = extract_lines(filtered, fvalid, cfg,
                            dir_tables=(dirs, c1, c2), dir_axis=dir_axis)
        fsegs = res.segments
        if cfg.surface_offset_correction:
            fsegs = surface_offset_correction(fsegs)
        segs = transform_segments(fsegs, pos, quat)
        segs = height_cutoff(segs, cfg.floor_trim_height)
        state, slots = world_step(state, segs, cfg)
        overflow = (segs.valid & (slots == -1)).sum().astype(jnp.int32)
        out = FrameOutput(filtered=filtered, filtered_valid=fvalid,
                          filtered_count=fcount, segments=segs, slots=slots,
                          nlines=res.nlines, status=res.status,
                          world_count=state.count, overflow=overflow)
        return state, out

    smapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("dir"), P("dir"), P("dir")),
        out_specs=(P(), P()),
        check_vma=False)

    @partial(jax.jit, donate_argnums=(0,))
    def step(state, raw, pos, quat):
        return smapped(state, raw, pos, quat, dirs, c1, c2)

    return step


def make_batched_extract(cfg: PipelineConfig, mesh: Mesh):
    """Data-parallel standalone extraction: frames sharded over 'batch',
    returning every frame's SegmentBatch (the throughput benchmark path)."""
    n_dir = mesh.shape["dir"]
    dirs, c1, c2 = _padded_dir_tables(cfg, n_dir)
    dir_axis = "dir" if n_dir > 1 else None
    frame = _frame_fn(cfg, dir_axis)

    def body(clouds, poss, quats, dirs, c1, c2):
        return jax.vmap(lambda r, p, q: frame(r, p, q, dirs, c1, c2))(
            clouds, poss, quats)

    smapped = shard_map(
        body, mesh=mesh,
        in_specs=(P("batch"), P("batch"), P("batch"), P("dir"), P("dir"), P("dir")),
        out_specs=(P("batch"), P("batch"), P("batch")),
        check_vma=False)

    @jax.jit
    def run(clouds, poss, quats):
        return smapped(clouds, poss, quats, dirs, c1, c2)

    return run
