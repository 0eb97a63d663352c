"""The jit-compiled per-frame pipeline: cloud in -> world map + outputs out.

This single function is the compiled replacement for the reference node's
worker-thread body (node.cpp:267-348 ``processData``): filter -> Hough ->
drone-to-world transform -> floor cutoff -> world-map fusion + intersections.
One compiled XLA program, fixed shapes, no host round-trips mid-frame.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import PipelineConfig
from .geometry import quat_to_rot
from .ops.preproc import preprocess
from .ops.hough import extract_lines, HoughResult, SegmentBatch
from .worldmap import WorldState, init_world, world_step


class FrameOutput(NamedTuple):
    """Per-frame results (the node's published topics + timing record inputs)."""

    filtered: jnp.ndarray        # (N, 3)  — `filtered_pointcloud` analog
    filtered_valid: jnp.ndarray  # (N,)
    filtered_count: jnp.ndarray  # int32
    segments: SegmentBatch       # frame segments, world frame, post-cutoff
    slots: jnp.ndarray           # (L,) int32 world slot per frame segment
    nlines: jnp.ndarray          # int32 nblines_extracted
    status: jnp.ndarray          # int32 (0 ok; 1 = hough abort, node.cpp:294)
    world_count: jnp.ndarray     # int32 `seg_vec_size` column
    overflow: jnp.ndarray        # int32 valid segments dropped because the
                                 # world map hit max_world_segments (D-CAP —
                                 # the reference's vector grows unbounded)


def rotation_from_quat(quat_wxyz: jnp.ndarray) -> jnp.ndarray:
    qw, qx, qy, qz = quat_wxyz[0], quat_wxyz[1], quat_wxyz[2], quat_wxyz[3]
    rows = quat_to_rot(qw, qx, qy, qz)
    return jnp.stack([jnp.stack(r) for r in rows])


def transform_segments(segs: SegmentBatch, position: jnp.ndarray,
                       quat_wxyz: jnp.ndarray) -> SegmentBatch:
    """drone2WorldSeg (node.cpp:429-446): a <- R a + p, b <- R b."""
    R = rotation_from_quat(quat_wxyz).astype(segs.a.dtype)
    p = position.astype(segs.a.dtype)
    # HIGHEST: on a GPU a default-precision f32 matmul may run in TF32
    rot = lambda x: jnp.matmul(x, R.T, precision=jax.lax.Precision.HIGHEST)
    return segs._replace(a=rot(segs.a) + p, b=rot(segs.b))


def surface_offset_correction(segs: SegmentBatch) -> SegmentBatch:
    """Opt-in accuracy extension (E-OFFSET, beyond the reference): undo the
    report's §6.3 "Ground Truth Offset".  ToF returns lie on the beam
    SURFACE facing the sensor, so the fitted axis is biased toward the
    sensor by about one beam radius.  In the drone frame the sensor sits at
    the origin: shift each accepted axis by its matched radius along the
    perpendicular from the sensor to the line (away from the sensor).
    Degenerate lines through the origin are left untouched."""
    bn = segs.b / jnp.maximum(
        jnp.linalg.norm(segs.b, axis=1, keepdims=True), 1e-12)
    perp = segs.a - jnp.sum(segs.a * bn, axis=1, keepdims=True) * bn
    nrm = jnp.linalg.norm(perp, axis=1, keepdims=True)
    shift = segs.radius[:, None] * perp / jnp.maximum(nrm, 1e-12)
    ok = (segs.valid & (nrm[:, 0] > 1e-6))[:, None]
    return segs._replace(a=jnp.where(ok, segs.a + shift, segs.a))


def height_cutoff(segs: SegmentBatch, floor_trim_height: float) -> SegmentBatch:
    """heighSegmentCutoff (node.cpp:454-470): keep iff either endpoint above."""
    p1 = segs.t_min[:, None] * segs.b + segs.a
    p2 = segs.t_max[:, None] * segs.b + segs.a
    keep = (p1[:, 2] > floor_trim_height) | (p2[:, 2] > floor_trim_height)
    return segs._replace(valid=segs.valid & keep)


def compute_dtype(cfg: PipelineConfig):
    """The pipeline float dtype: f32 (perf default) or f64 (parity mode —
    requires jax_enable_x64; the f32-by-spec stages stay f32, see config)."""
    return jnp.float64 if cfg.compute_dtype == "float64" else jnp.float32


def process_frame(state: WorldState, raw_points: jnp.ndarray,
                  position: jnp.ndarray, quat_wxyz: jnp.ndarray,
                  cfg: PipelineConfig) -> tuple[WorldState, FrameOutput]:
    """One full frame.  raw_points: (N_raw, 3), NaN = invalid return."""
    raw_points = raw_points.astype(compute_dtype(cfg))
    filtered, fvalid, fcount = preprocess(raw_points, cfg)
    hough: HoughResult = extract_lines(filtered, fvalid, cfg)

    frame_segs = hough.segments
    if cfg.surface_offset_correction:
        frame_segs = surface_offset_correction(frame_segs)
    segs = transform_segments(frame_segs, position, quat_wxyz)
    segs = height_cutoff(segs, cfg.floor_trim_height)

    state, slots = world_step(state, segs, cfg)

    overflow = (segs.valid & (slots == -1)).sum().astype(jnp.int32)
    out = FrameOutput(
        filtered=filtered, filtered_valid=fvalid, filtered_count=fcount,
        segments=segs, slots=slots, nlines=hough.nlines, status=hough.status,
        world_count=state.count, overflow=overflow)
    return state, out


def make_process_frame(cfg: PipelineConfig):
    """jit-compiled process_frame with the config closed over; donates the
    world state so the map updates in place on device."""

    @partial(jax.jit, donate_argnums=(0,))
    def step(state, raw_points, position, quat_wxyz):
        return process_frame(state, raw_points, position, quat_wxyz, cfg)

    return step


def make_process_frame_packed(cfg: PipelineConfig):
    """Like make_process_frame, but additionally returns the per-frame
    host-bound scalars (world_count, nlines, status, overflow) packed into
    ONE (4,) int32 array, so the host runtime pays a single synchronizing
    device->host readback per frame instead of four."""

    @partial(jax.jit, donate_argnums=(0,))
    def step(state, raw_points, position, quat_wxyz):
        state, out = process_frame(state, raw_points, position, quat_wxyz,
                                   cfg)
        scalars = jnp.stack([
            out.world_count.astype(jnp.int32), out.nlines.astype(jnp.int32),
            out.status.astype(jnp.int32), out.overflow.astype(jnp.int32)])
        return state, out, scalars

    return step


def make_batched_process(cfg: PipelineConfig):
    """jit-compiled multi-frame step: the per-frame stages (preproc, Hough,
    transform, cutoff) run vmapped over the batch and the order-dependent
    world fusion (node.cpp:491-510) then runs as a sequential `lax.scan`
    in frame order.  Semantically identical to feeding the frames one at a
    time through `process_frame` (vmapped matmuls may reassociate f32 sums
    at rounding level; vote counts are integer-exact either way).

    Use this as the data-parallel building block (frames sharded over a
    mesh — parallel/sharding.make_multichip_step is this plus collectives).
    On the accelerator it was first built for, it was slower per cloud on
    a single device than the sequential pipelined path: the vmapped
    while_loop runs the union of all frames' extraction rounds and each
    round's accumulator traffic scales with the batch.  Not yet measured
    on the GPU.

    Signature: step(state, clouds (F, N_raw, 3), positions (F, 3),
    quats (F, 4)) -> (state', nlines (F,), statuses (F,),
    world_counts (F,) — the world size after each frame's fusion,
    overflows (F,) — segments dropped at max_world_segments per frame,
    D-CAP).
    """
    from .ops.preproc import preprocess
    from .ops.hough import extract_lines

    dt = compute_dtype(cfg)

    def frame(raw, pos, quat):
        filtered, fvalid, _ = preprocess(raw.astype(dt), cfg)
        res = extract_lines(filtered, fvalid, cfg)
        fsegs = res.segments
        if cfg.surface_offset_correction:
            fsegs = surface_offset_correction(fsegs)
        segs = transform_segments(fsegs, pos.astype(dt),
                                  quat.astype(dt))
        segs = height_cutoff(segs, cfg.floor_trim_height)
        return segs, res.nlines, res.status

    @partial(jax.jit, donate_argnums=(0,))
    def step(state, clouds, positions, quats):
        segs, nlines, statuses = jax.vmap(frame)(clouds, positions, quats)

        def fuse(st, seg):
            st, slots = world_step(st, seg, cfg)
            overflow = (seg.valid & (slots == -1)).sum().astype(jnp.int32)
            return st, (st.count, overflow)

        state, (counts, overflows) = jax.lax.scan(fuse, state, segs)
        return state, nlines, statuses, counts, overflows

    return step


__all__ = [
    "FrameOutput", "WorldState", "init_world", "process_frame",
    "make_process_frame", "make_batched_process", "transform_segments",
    "height_cutoff", "surface_offset_correction", "compute_dtype",
]
