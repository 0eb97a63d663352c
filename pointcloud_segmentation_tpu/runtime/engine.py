"""Host runtime: the node shell around the jit-compiled pipeline.

Plays the role of the reference's `PtCdProcessing` node (node.cpp:34-158)
without ROS: pose stream in (the `/mavros/local_position/pose` ->
TF mocap->world path, tfbr.cpp), ToF clouds in (`/tof_pc`), persistent world
map on device, per-frame timing records, and the three CSV outputs on
shutdown (node.cpp:78-80).

Two ingestion modes:
  * synchronous replay — `process_frame` / `run_replay`: every frame is
    processed (deterministic; used by tests, benchmarks, evaluation);
  * streaming — `start()` spawns a worker thread consuming a latest-wins
    depth-1 mailbox, dropping stale frames under load exactly like the
    reference's SharedData slot (node.cpp:167-173, 267-276).

Backends: "jax" (the compiled XLA pipeline on the default JAX device) or
"oracle" (the faithful numpy reference — the CPU baseline).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from ..config import PipelineConfig, VERBOSE_INFO, VERBOSE_NONE
from .._malloc import cap_malloc_arenas as _cap_malloc_arenas
from .posebuffer import PoseBuffer
from .mailbox import LatestWinsMailbox
from . import csvio

logger = logging.getLogger("pointcloud_segmentation_tpu")

def _waterfill_quotas(lens, cap):
    """Waterfill a total point budget across per-slot lengths, favoring no
    slot.  Every non-empty slot gets an equal share; shares a short slot
    can't use are redistributed to longer ones, so the cap is met exactly
    whenever sum(lens) >= cap and no slot is starved."""
    quota = [0] * len(lens)
    remaining = min(cap, sum(lens))
    active = [i for i, n in enumerate(lens) if n > 0]
    while remaining > 0 and active:
        share = max(remaining // len(active), 1)
        still = []
        for i in active:
            take = min(share, lens[i] - quota[i], remaining)
            quota[i] += take
            remaining -= take
            if quota[i] < lens[i]:
                still.append(i)
            if remaining <= 0:
                break
        active = still
    return quota


def _cap_points_per_slot(arrs, cap):
    """Waterfill `cap` across per-segment arrays, keeping each slot's
    NEWEST points."""
    quota = _waterfill_quotas([len(a) for a in arrs], cap)
    return [a[len(a) - q:] for a, q in zip(arrs, quota) if q]


def _tail_points(chunks, q):
    """Newest `q` points from a slot's chunk list (per-frame appended
    arrays), touching only the tail chunks actually needed — the full
    accumulated history is NEVER concatenated (it grows without bound
    over a stream; copying it per viz frame would be quadratic)."""
    out = []
    need = q
    for arr in reversed(chunks):
        if need <= 0:
            break
        take = min(len(arr), need)
        out.append(arr[len(arr) - take:])
        need -= take
    out.reverse()
    return out[0] if len(out) == 1 else np.concatenate(out, axis=0)


class SegmentationEngine:
    def __init__(self, cfg: PipelineConfig, backend: str = "jax",
                 collect_inlier_points: bool = False,
                 checkpoint_every: int = 0,
                 checkpoint_path: Optional[str] = None,
                 viz_stream: Optional[object] = None,
                 viz_points: bool = False,
                 viz_every_frame: bool = False,
                 stream_sync_every: int = 64):
        """viz_stream: per-frame visualization feed (the RViz re-publish
        loop analog, node.cpp:676-842).  A str/path appends one JSON line
        per processed frame (frame counters + the marker structures of
        ``visualization()``); a callable receives the same dict instead.

        viz_points: also embed the frame's world-frame point clouds in each
        viz record — ``filtered_points`` (the `filtered_pointcloud` topic,
        node.cpp:417-420) and ``hough_points`` (the `hough_pointcloud`
        topic).  The reference republishes ALL world segments' accumulated
        inlier points every frame (node.cpp:823-829); enable
        ``collect_inlier_points`` too to get those exact semantics (capped
        at the most recent 4096 points per record), else ``hough_points``
        carries only the current frame's accepted inliers (node.cpp:833-841
        per-frame contribution).  Costs extra device->host readbacks per
        frame; viz-only, off the perf path.

        viz_every_frame: streaming-mode viz fidelity knob.  By default a
        DEFERRED stream (see stream_sync_every) emits viz records at flush
        cadence — one record per readback batch, built by the flusher from
        a single packed world-state snapshot, so watching the map live
        costs ~one extra device->host read per flush instead of collapsing
        the stream to the synchronous per-frame path (the RViz analog
        renders while the node runs at full rate, node.cpp:676-842).  Set
        True to force one viz record per processed frame instead (the
        synchronous path).  viz_points implies per-frame mode: the point clouds only
        exist in the frame's own step output.  Replay/synchronous
        processing always emits per frame regardless.

        stream_sync_every: streaming-mode dispatch pipelining depth.  The
        jit'd step's per-frame scalars cost a device->host read that waits
        for the step to finish, so the streaming worker dispatches frames
        back-to-back,
        parks the packed scalar handles on device, and backfills the
        records with ONE batched readback every `stream_sync_every` frames
        or whenever the mailbox goes idle (the sync then rides time the
        worker would have spent blocked anyway).  The flush is also the
        in-flight bound: at most `stream_sync_every` dispatched-but-unsynced
        frames exist, so an overdriven feed backpressures instead of
        queueing unboundedly.  Set <= 1 to force the synchronous per-frame
        readback path.  Deferred mode is automatically disabled when
        per-frame host work needs the frame's own values or state
        (viz_every_frame/viz_points, collect_inlier_points,
        verbose_level > 0); a plain viz_stream stays deferred and emits at
        flush cadence (see viz_every_frame)."""
        self.cfg = cfg
        self.backend = backend
        self.poses = self._make_pose_buffer()
        self.mailbox = self._make_mailbox()
        self.records: List[dict] = []
        self.frames_submitted = 0       # clouds entered via submit_cloud
        self.frames_processed = 0
        self.frames_skipped_no_pose = 0
        self.frames_failed = 0          # streaming frames that raised
        self.world_overflow_frames = 0  # frames that dropped segments at
                                        # max_world_segments capacity (D-CAP)
        self.collect_inlier_points = collect_inlier_points
        self.checkpoint_every = checkpoint_every
        self.checkpoint_path = checkpoint_path
        self._inlier_points: dict[int, list[np.ndarray]] = {}
        self._viz_stream = viz_stream
        self._viz_points = viz_points
        self._viz_every_frame = bool(viz_every_frame or viz_points)
        self._frame_points: Optional[dict] = None
        self._viz_file = None
        self._viz_file_opened = False  # first open truncates, reopens append
        self._batched_step = None
        self._batched_size = 0
        self.stream_sync_every = stream_sync_every
        # (record, scalars-handle) pairs dispatched but not yet read back;
        # touched only by the worker thread (stop() joins before finalize)
        self._pending: List[tuple] = []
        self._last_checkpoint_k = 0
        self._stream_deferred = (
            backend == "jax" and stream_sync_every > 1
            and not collect_inlier_points
            and not (viz_stream is not None and self._viz_every_frame)
            and cfg.verbose_level == VERBOSE_NONE)
        # flush-cadence live viz: deferred streaming + a viz stream
        self._viz_flush = (self._stream_deferred and viz_stream is not None)
        # Guards self._state against the donation race: each jitted step
        # DONATES the world-state buffer, so a reader (world_segments /
        # intersections / checkpoint, e.g. a server thread answering a
        # query mid-stream) that grabs self._state between the dispatch
        # and the reassignment converts a deleted buffer ("Array has been
        # deleted").  Writers hold it across dispatch+swap; readers hold
        # it across their device->host conversions.
        self._state_lock = threading.Lock()
        # Serializes blocking device->host READS against each other, so at
        # most one thread waits on the device at a time, while dispatches
        # (under _state_lock only) proceed concurrently with that read.
        # That is what lets the streaming flush readback run on a dedicated
        # flusher thread off the dispatch critical path.  Whether two
        # concurrent reads are safe on the GPU runtime, which would let
        # this lock go, is not yet measured.  Lock order is ALWAYS
        # _state_lock -> _read_lock, on EVERY thread: the flusher too
        # takes _state_lock (flush-cadence viz pack dispatch,
        # _ensure_state_packer) and may nest _state_lock -> _read_lock,
        # but must NEVER take _read_lock -> _state_lock; the worker must
        # never block on the flusher while holding _state_lock.
        self._read_lock = threading.Lock()
        self._flush_q: Optional["queue.Queue"] = None
        self._flusher: Optional[threading.Thread] = None
        # Set while the streaming worker has no fresh frame (mailbox take
        # timed out); the flusher only STARTS a batched read inside such an
        # idle window.  A device->host read waits for every step queued
        # ahead of it, so under a saturating feed a read started mid-feed
        # waits for the queue to drain.  Idle-gating keeps the saturated
        # path dispatching; queued batches drain in stream pauses and at
        # stop().
        self._worker_idle = threading.Event()
        self._worker_idle.set()
        self._program_start: Optional[float] = None
        self._worker: Optional[threading.Thread] = None
        self._running = False

        # configuration dump, as the node logs at startup (node.cpp:245-257)
        if cfg.verbose_level > VERBOSE_NONE:
            logger.info("Configuration: %s", json.dumps(cfg.to_dict()))

        if backend == "jax":
            import jax.numpy as jnp  # deferred so the oracle path is jax-free
            import jax
            from ..pipeline import make_process_frame_packed, init_world

            self._jnp = jnp
            self._jax = jax
            self._npdt = (np.float64 if cfg.compute_dtype == "float64"
                          else np.float32)
            if cfg.compute_dtype == "float64" and not jax.config.jax_enable_x64:
                raise ValueError(
                    "compute_dtype='float64' needs jax_enable_x64 (set "
                    "jax.config.update('jax_enable_x64', True) or run under "
                    "`with jax.enable_x64(True):`)")
            self._step = make_process_frame_packed(cfg)
            self._state = init_world(cfg)
        elif backend == "oracle":
            from .. import oracle

            self._oracle = oracle
            self._wm = oracle.WorldMap(cfg)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        self._state_pack = None          # jitted state -> uint32[N] pack
        self._state_unpack_host = None   # numpy twin (flush-cadence viz)
        # host-side stall forensics (tools/endurance.py correlates these
        # with throughput windows): the slowest single device waits since
        # the last pop_stall_max()
        self._stall_step_ms = 0.0        # max step dispatch wall (ms)
        self._stall_read_ms = 0.0        # max flusher read wall (ms)
        self._read_started_mono = None   # flusher head read in flight since
        self.flush_batches_shed = 0      # telemetry batches shed mid-wedge

    def _make_mailbox(self):
        """Prefer the native (C++) latest-wins mailbox; fall back to Python."""
        try:
            from .. import native

            if native.available():
                return native.NativeMailbox(
                    max_points=max(self.cfg.shapes.max_raw_points, 4096))
        except Exception:
            pass
        return LatestWinsMailbox()

    def _make_pose_buffer(self):
        """Prefer the native (C++) pose ring buffer (same TF2-analog
        semantics as runtime.posebuffer.PoseBuffer); fall back to Python."""
        try:
            from .. import native

            if native.available():
                return native.NativePoseBuffer()
        except Exception:
            pass
        return PoseBuffer()

    # ---------------------------------------------------------------- inputs

    def push_pose(self, t: float, position, quat_wxyz) -> None:
        """Pose stream input (the tfbr node's mocap->world broadcast)."""
        self.poses.push(t, position, quat_wxyz)

    def submit_cloud(self, t: float, points: np.ndarray) -> None:
        """Streaming input: latest-wins; stale unprocessed frames are dropped."""
        self.frames_submitted += 1
        self.mailbox.put((t, points))

    # ---------------------------------------------------------------- core

    def _now(self) -> float:
        return time.perf_counter()

    def process_frame(self, t: float, points: np.ndarray) -> Optional[dict]:
        """Synchronously process one cloud.  Returns the per-frame record or
        None if the pose lookup failed (frame skipped, D-POSE)."""
        if self._program_start is None:
            self._program_start = self._now()
        pose = self.poses.lookup(t)
        if pose is None:
            self.frames_skipped_no_pose += 1
            return None
        position, quat = pose

        start = self._now()
        if self.backend == "jax":
            info = self._process_jax(points, position, quat)
        else:
            info = self._process_oracle(points, position, quat)
        end = self._now()

        record = {
            "wall_time": (end - self._program_start) * 1e6,
            "processing_time": (end - start) * 1e6,
            "seg_vec_size": info["world_count"],
            "nblines": info["nlines"],
        }
        self.records.append(record)
        self.frames_processed += 1

        # verbose reporting, mirroring the node's levels (node.cpp:309-346)
        if self.cfg.verbose_level > VERBOSE_NONE:
            logger.info("Callback execution time: %d us",
                        int(record["processing_time"]))
        if self.cfg.verbose_level > VERBOSE_INFO:
            for i, t1, j, t2 in self.intersections_rows():
                logger.info("intersection_matrix[%d][%d] = (%f, %f)", i, j, t1, t2)
            for i, s in enumerate(self.world_segments()):
                logger.info("Segment %d: a = (%f, %f, %f), t_min = %f, t_max = %f",
                            i, s["a"][0], s["a"][1], s["a"][2],
                            s["t_min"], s["t_max"])

        if (self.checkpoint_every and self.checkpoint_path
                and self.frames_processed % self.checkpoint_every == 0):
            self.save_checkpoint(self.checkpoint_path)

        if self._viz_stream is not None:
            self._emit_viz_frame(t, info, position, quat)

        record = dict(record, status=info["status"], t=t)
        return record

    def _emit_viz_frame(self, t: float, info: dict,
                        position=None, quat_wxyz=None) -> None:
        """One per-frame visualization record — the node's every-frame
        marker re-publish (node.cpp:676-842) as a JSONL stream/callback.

        Includes the frame's drone pose: the reference's RViz session
        displays the `/mavros/local_position/pose` pose and its Path trail
        alongside the markers (rviz/drone_pc.rviz pose/path displays), so
        the player can render the flight path the same way."""
        viz = self.visualization(include_points=False)
        rec = {
            "frame": self.frames_processed,
            "t": t,
            "nlines": info["nlines"],
            "status": info["status"],
            "world_count": info["world_count"],
            "cylinders": [
                {"id": c["id"], "p1": [float(v) for v in c["p1"]],
                 "p2": [float(v) for v in c["p2"]],
                 "radius": float(c["radius"])}
                for c in viz["cylinders"]],
            "intersections": [
                {"position": [float(v) for v in s["position"]],
                 "text": s["text"]}
                for s in viz["intersections"]],
        }
        if position is not None:
            rec["drone"] = {
                "position": [float(v) for v in np.asarray(position)],
                "quat_wxyz": [float(v) for v in np.asarray(quat_wxyz)],
            }
        if self._frame_points is not None:
            cap = 4096
            rec["filtered_points"] = np.round(
                self._frame_points["filtered"][:cap], 4).tolist()
            # `hough_points` fidelity (node.cpp:823-829): the reference
            # republishes ALL world segments' ACCUMULATED inlier points
            # every frame.  With collect_inlier_points on, do the same from
            # the accumulated store (capped at the most recent `cap` points
            # — the reference's message grows unbounded); otherwise fall
            # back to the current frame's accepted inliers only.
            if self.collect_inlier_points:
                # Cap FAIRLY across world slots (waterfill, newest points
                # kept per slot): a tail slice of the slot-ordered
                # concatenation would drop low-numbered segments entirely
                # once the total exceeds the cap, starving them in the
                # viewer forever.
                if self.backend == "jax":
                    # quotas from lengths alone, then slice only the tail
                    # chunks — never concatenate a slot's full history
                    slot_lists = [lst for lst in self._inlier_points.values()
                                  if lst]
                    lens = [sum(len(a) for a in lst) for lst in slot_lists]
                    quotas = _waterfill_quotas(lens, cap)
                    parts = [_tail_points(lst, q)
                             for lst, q in zip(slot_lists, quotas) if q]
                else:
                    # the oracle's Segment.points ARE the accumulated
                    # world-frame inlier store (drone_to_world transforms
                    # them before fusion) — republish straight from it
                    arrs = [np.asarray(s.points)
                            for s in self._wm.segments if len(s.points)]
                    parts = _cap_points_per_slot(arrs, cap)
                acc = (np.concatenate(parts, axis=0) if parts
                       else np.zeros((0, 3)))
                rec["hough_points"] = np.round(acc, 4).tolist()
                rec["hough_points_world_accumulated"] = True
            else:
                rec["hough_points"] = np.round(
                    self._frame_points["hough"][:cap], 4).tolist()
            self._frame_points = None
        self._write_viz_record(rec)

    def _write_viz_record(self, rec: dict) -> None:
        """Deliver one viz record (callable feed or JSONL append).  Single
        writer by construction: the worker thread in synchronous/replay
        mode, the flusher thread in deferred-streaming mode — never both
        (``_viz_flush`` and the per-frame path are mutually exclusive)."""
        if callable(self._viz_stream):
            self._viz_stream(rec)
            return
        if self._viz_file is None:
            parent = os.path.dirname(os.path.abspath(self._viz_stream))
            os.makedirs(parent, exist_ok=True)
            # truncate only on the FIRST open of this engine's lifetime: a
            # restart after stop()+finalize() (which closes the file) must
            # append, not erase the frames already streamed — records and
            # CSVs are cumulative across restarts, the viz stream must be
            # too (and a live follower would desync on truncation)
            mode = "a" if self._viz_file_opened else "w"
            self._viz_file = open(self._viz_stream, mode)
            self._viz_file_opened = True
        self._viz_file.write(json.dumps(rec) + "\n")
        self._viz_file.flush()

    def _pad_raw(self, points: np.ndarray) -> np.ndarray:
        n_raw = self.cfg.shapes.max_raw_points
        dt = getattr(self, "_npdt", np.float32)
        pts = np.asarray(points, dtype=dt).reshape(-1, 3)
        out = np.full((n_raw, 3), np.nan, dtype=dt)
        k = min(len(pts), n_raw)
        out[:k] = pts[:k]
        return out

    def _process_jax(self, points, position, quat) -> dict:
        jnp = self._jnp
        raw = jnp.asarray(self._pad_raw(points))
        # The locks cover the dispatch AND every device->host read of this
        # frame: _state_lock for the donation race (see __init__), and
        # _read_lock because reads are serialized across threads (the
        # flusher thread synchronizes its batched readbacks through it
        # without blocking dispatches).
        with self._state_lock, self._read_lock:
            self._state, out, scalars = self._step(
                self._state, raw,
                jnp.asarray(position, self._npdt),
                jnp.asarray(quat, self._npdt))
            # ONE device->host readback per frame: the step packs the four
            # per-frame scalars into a (4,) int32 on device instead of
            # paying four separate synchronizing reads.  The read also
            # synchronizes the step itself.
            wc, nl, st, overflow = (int(v) for v in np.asarray(scalars))
            if self.collect_inlier_points:
                self._collect_points_jax(out, position, quat)
            if self._viz_stream is not None and self._viz_points:
                self._frame_points = self._frame_points_jax(
                    out, position, quat)
        info = {
            "world_count": wc,
            "nlines": nl,
            "status": st,
        }
        if overflow:
            self.world_overflow_frames += 1
            logger.warning(
                "world map full (max_world_segments=%d): dropped %d "
                "segment(s) this frame (D-CAP)",
                self.cfg.shapes.max_world_segments, overflow)
        return info

    def _frame_points_jax(self, out, position, quat) -> dict:
        """World-frame per-frame clouds for the viz stream: the filtered
        cloud and the accepted lines' inlier points (the reference's
        `filtered_pointcloud` / `hough_pointcloud` topics)."""
        from .. import geometry

        filtered = np.asarray(out.filtered)
        fvalid = np.asarray(out.filtered_valid).astype(bool)
        masks = np.asarray(out.segments.point_mask)
        svalid = np.asarray(out.segments.valid).astype(bool)
        R = np.array(geometry.quat_to_rot(*np.asarray(quat, np.float64)))
        pos = np.asarray(position, np.float64)
        world = filtered[fvalid] @ R.T + pos
        if svalid.any():
            inl = masks[svalid].any(axis=0) & fvalid
            hough = filtered[inl] @ R.T + pos
        else:
            hough = np.zeros((0, 3))
        return {"filtered": world, "hough": hough}

    def _collect_points_jax(self, out, position, quat) -> None:
        from .. import geometry

        filtered = np.asarray(out.filtered)
        masks = np.asarray(out.segments.point_mask)
        valid = np.asarray(out.segments.valid)
        slots = np.asarray(out.slots)
        R = np.array(geometry.quat_to_rot(*np.asarray(quat, np.float64)))
        # last-writer-wins per world slot: when two frame segments fuse
        # into the same slot in one frame, the world map keeps only the
        # later fusion (vs the frame-start state), so the earlier dseg's
        # points never enter the reference's accumulated store
        # (node.cpp:823-829; oracle new_world[j] overwrite) — collect only
        # the winning dseg's points
        winner: dict[int, int] = {}
        for i in np.nonzero(valid)[0]:
            slot = int(slots[i])
            if slot >= 0:
                winner[slot] = int(i)
        for slot, i in winner.items():
            pts = filtered[masks[i]] @ R.T + np.asarray(position)
            self._inlier_points.setdefault(slot, []).append(pts)

    def _process_oracle(self, points, position, quat) -> dict:
        # the lock gives oracle readers (world_snapshot from a server or
        # viz thread) a consistent _wm, mirroring the jax path
        with self._state_lock:
            res = self._oracle.process_frame(
                self._wm, np.asarray(points, np.float64).reshape(-1, 3),
                np.asarray(position), np.asarray(quat), self.cfg)
        if self._viz_stream is not None and self._viz_points:
            from .. import geometry

            filtered = self._oracle.cloud_filtering(
                np.asarray(points, np.float64).reshape(-1, 3), self.cfg)
            R = np.array(geometry.quat_to_rot(*np.asarray(quat, np.float64)))
            accepted = [s.points for s in res.segments_in_frame
                        if len(s.points)]
            self._frame_points = {
                "filtered": filtered @ R.T + np.asarray(position),
                "hough": (np.concatenate(accepted, axis=0) if accepted
                          else np.zeros((0, 3)))}
        return {
            "world_count": len(self._wm.segments),
            "nlines": res.nblines,
            "status": res.status,
        }

    def run_replay(self, frames, pipelined: bool = False,
                   batch: int = 0) -> List[dict]:
        """Process every frame of an io.simulator replay (poses auto-pushed).

        pipelined=True (jax backend only): dispatch frames back-to-back
        without a device sync per frame — steady-state throughput mode; the
        per-frame `processing_time` then records amortized dispatch time and
        the final sync is folded into the last frame's record.

        batch=k>1 (jax backend only): frames run through the batched step
        (pipeline.make_batched_process) — per-frame stages vmapped over k
        frames, fusion scanned sequentially in frame order; same world map,
        amortized per-frame times.  NOTE: on a single chip this is slower
        per cloud than pipelined=True (see make_batched_process) — it is
        the DP building block / multi-chip shape, kept for parity testing.
        """
        if batch > 1 and self.backend == "jax":
            return self._run_replay_batched(frames, batch)
        if not pipelined or self.backend != "jax":
            out = []
            for fr in frames:
                self.push_pose(fr.t, fr.position, fr.quat_wxyz)
                rec = self.process_frame(fr.t, fr.points)
                if rec is not None:
                    out.append(rec)
            return out
        return self._run_replay_pipelined(frames)

    def _run_replay_batched(self, frames, batch: int) -> List[dict]:
        jnp = self._jnp
        from ..pipeline import make_batched_process

        if self._batched_step is None or self._batched_size != batch:
            self._batched_step = make_batched_process(self.cfg)
            self._batched_size = batch
        step = self._batched_step
        if self._program_start is None:
            self._program_start = self._now()
        out = []
        for c0 in range(0, len(frames), batch):
            chunk = frames[c0: c0 + batch]
            clouds = np.full((batch, self.cfg.shapes.max_raw_points, 3),
                             np.nan, self._npdt)
            poss = np.zeros((batch, 3), self._npdt)
            quats = np.zeros((batch, 4), self._npdt)
            quats[:, 0] = 1.0
            live = []
            for i, fr in enumerate(chunk):
                self.push_pose(fr.t, fr.position, fr.quat_wxyz)
                pose = self.poses.lookup(fr.t)
                if pose is None:
                    self.frames_skipped_no_pose += 1
                    continue     # NaN cloud -> degenerate no-op frame
                clouds[i] = self._pad_raw(fr.points)
                poss[i], quats[i] = pose
                live.append(i)
            start = self._now()
            with self._state_lock, self._read_lock:
                self._state, nlines, statuses, counts, overflows = step(
                    self._state, jnp.asarray(clouds), jnp.asarray(poss),
                    jnp.asarray(quats))
                nl = np.asarray(nlines)
                st_codes = np.asarray(statuses)
                wc = np.asarray(counts)
                ov = np.asarray(overflows)   # one sync per chunk
            end = self._now()
            per = (end - start) / max(len(live), 1)
            # D-CAP accounting, matching the sync/pipelined paths
            self.world_overflow_frames += int((ov[live] > 0).sum())
            if ov[live].sum():
                logger.warning(
                    "world map full (max_world_segments=%d): dropped %d "
                    "segment(s) across %d frame(s) (D-CAP)",
                    self.cfg.shapes.max_world_segments, int(ov[live].sum()),
                    int((ov[live] > 0).sum()))
            for i in live:
                rec = {
                    "wall_time": (end - self._program_start) * 1e6,
                    "processing_time": per * 1e6,
                    "seg_vec_size": int(wc[i]),
                    "nblines": max(int(nl[i]), 0),
                }
                self.records.append(rec)
                out.append(dict(rec, status=int(st_codes[i])))
                self.frames_processed += 1
        return out

    def _run_replay_pipelined(self, frames) -> List[dict]:
        jnp = self._jnp
        if self._program_start is None:
            self._program_start = self._now()
        out = []
        counters = []   # per-frame (world_count, nlines) scalar device handles
        for fr in frames:
            self.push_pose(fr.t, fr.position, fr.quat_wxyz)
            pose = self.poses.lookup(fr.t)
            if pose is None:
                self.frames_skipped_no_pose += 1
                continue
            position, quat = pose
            start = self._now()
            raw = jnp.asarray(self._pad_raw(fr.points))
            with self._state_lock:
                self._state, fout, scalars = self._step(
                    self._state, raw, jnp.asarray(position, self._npdt),
                    jnp.asarray(quat, self._npdt))
            end = self._now()
            # keep only the packed scalar counters on device: per-frame
            # values are read back truthfully in ONE batched sync below, so
            # the pipelined CSV matches the synchronous replay column-for-column
            counters.append(scalars)
            rec = {
                "wall_time": (end - self._program_start) * 1e6,
                "processing_time": (end - start) * 1e6,
                "seg_vec_size": -1,
                "nblines": -1,
            }
            self.records.append(rec)
            out.append(rec)
            self.frames_processed += 1
        if counters:
            t0 = self._now()
            # pad the handle list to a fixed quantum before stacking: every
            # DISTINCT stack length is a separate compile, so replaying logs
            # of different lengths in one process would recompile per
            # length; quantum padding bounds the distinct shapes to
            # ceil(F/256) while keeping the single batched readback
            nf = len(counters)
            pad = (-nf) % 256
            if pad:
                counters = counters + [jnp.zeros((4,), jnp.int32)] * pad
            with self._state_lock, self._read_lock:
                stacked = jnp.stack(counters)   # (ceil(F/256)*256, 4) int32
                vals = np.asarray(stacked)[:nf]  # single device sync
            sync_us = (self._now() - t0) * 1e6
            for rec, row in zip(out, vals):
                rec["seg_vec_size"] = int(row[0])
                rec["nblines"] = max(int(row[1]), 0)
            out[-1]["processing_time"] += sync_us
            # D-CAP accounting matches the synchronous path (col 3 is the
            # per-frame dropped-segment count at world-map capacity)
            overflow = vals[:, 3]
            self.world_overflow_frames += int((overflow > 0).sum())
            if overflow.sum():
                logger.warning(
                    "world map full (max_world_segments=%d): dropped %d "
                    "segment(s) across %d frame(s) (D-CAP)",
                    self.cfg.shapes.max_world_segments, int(overflow.sum()),
                    int((overflow > 0).sum()))
        return out

    # ---------------------------------------------------------------- streaming

    def start(self) -> None:
        """Spawn the consumer thread (the reference's processingThread).
        Restart-safe: a mailbox closed by a previous stop() is replaced."""
        if self._worker is not None:
            return
        _cap_malloc_arenas()   # defensive: no-op if the package import did it
        if self._stream_deferred and not getattr(self, "_flush_warmed", False):
            # Pre-compile the deferred path's (K, 4) flush stack BEFORE the
            # worker needs it: a first-use compile paid mid-stream would
            # shed frames.
            jnp = self._jnp
            z = jnp.zeros((4,), jnp.int32)
            with self._state_lock, self._read_lock:
                _ = np.asarray(jnp.stack([z] * self.stream_sync_every))
            self._flush_warmed = True
        if self._viz_flush:
            # same reasoning: the flush-cadence viz snapshot pair must not
            # compile mid-stream at the first flush
            self._ensure_state_packer()
        if getattr(self, "_mailbox_closed", False):
            # carry the old mailbox's drop count so dropped_frames stays
            # cumulative across restarts
            self._dropped_accum = self.dropped_frames
            self.mailbox = self._make_mailbox()
            self._mailbox_closed = False
        self._running = True
        if not getattr(self, "_atexit_registered", False):
            # An engine abandoned without stop() would let the interpreter
            # kill the daemon worker/flusher threads mid-device-call at
            # exit, aborting inside the PJRT client.  atexit runs before
            # thread teardown, so a clean stop() here joins both threads
            # first.
            # weakref: the hook must not keep dropped engines alive.
            import atexit
            import weakref

            ref = weakref.ref(self)

            def _cleanup():
                eng = ref()
                if eng is not None and eng._running:
                    try:
                        eng.stop()
                    except Exception:       # pragma: no cover - exit path
                        logger.exception("atexit engine stop failed")

            atexit.register(_cleanup)
            self._atexit_registered = True
        if self._stream_deferred:
            # Dedicated reader: batched readbacks run here so the worker
            # never blocks on a device sync (see _read_lock notes).
            self._flush_q = queue.Queue()
            self._flusher = threading.Thread(target=self._flusher_loop,
                                             daemon=True)
            self._flusher.start()
        self._worker = threading.Thread(target=self._worker_loop, daemon=True)
        self._worker.start()

    # Mailbox-empty wait before the worker re-checks the pending flush
    # condition (shorter than a 30 Hz frame period so low rates stay
    # responsive; longer than a 100 Hz period so a saturating feed keeps
    # pipelining).
    _STREAM_IDLE_FLUSH_S = 0.02
    # Max age of the OLDEST unflushed record before an idle flush runs.
    # Flushing on every idle window would pay one synchronizing read per
    # frame at low feed rates; age-gating amortizes one read over
    # rate * age frames while keeping record backfill latency bounded.
    _STREAM_FLUSH_AGE_S = 0.5
    # Max batches enqueued-but-unread before the worker pauses dispatch
    # (bounds in-flight frames to ~(this+1) * stream_sync_every under a
    # sustained overfeed — see the backpressure note in _worker_loop).
    _STREAM_MAX_UNREAD_BATCHES = 2
    # A flusher read in flight longer than this is treated as WEDGED, not
    # slow.  While the head read is wedged the backpressure loop does NOT
    # stall the stream: dispatches run concurrently with an in-flight
    # read, so the worker keeps stepping.  Whether a read can stall this
    # long on the GPU runtime at all is not yet measured; until it is,
    # the guard stays.
    _STREAM_READ_WEDGE_S = 3.0
    # ...but device-handle accumulation is bounded: past this many queued
    # batches mid-wedge the worker SHEDS the oldest unread batch instead
    # of stalling (those frames keep their -1 telemetry sentinels — the
    # map itself already advanced on device, so this is telemetry loss,
    # never map loss; counted in flush_batches_shed).
    _STREAM_WEDGE_MAX_BATCHES = 64

    def _process_frame_deferred(self, t: float, points: np.ndarray) -> bool:
        """Streaming fast path: dispatch the jit'd step WITHOUT the per-frame
        scalar readback.  The packed (4,) counter handle is parked on device
        and the per-frame record carries -1 sentinels until `_flush_pending`
        backfills them truthfully (same convention as _run_replay_pipelined).
        Returns False iff the pose lookup failed (frame skipped, D-POSE)."""
        if self._program_start is None:
            self._program_start = self._now()
        pose = self.poses.lookup(t)
        if pose is None:
            self.frames_skipped_no_pose += 1
            return False
        position, quat = pose
        jnp = self._jnp
        start = self._now()
        raw = jnp.asarray(self._pad_raw(points))
        with self._state_lock:
            self._state, _out, scalars = self._step(
                self._state, raw, jnp.asarray(position, self._npdt),
                jnp.asarray(quat, self._npdt))
        end = self._now()
        step_ms = (end - start) * 1e3
        if step_ms > self._stall_step_ms:
            self._stall_step_ms = step_ms
        rec = {
            "wall_time": (end - self._program_start) * 1e6,
            "processing_time": (end - start) * 1e6,
            "seg_vec_size": -1,
            "nblines": -1,
        }
        self.records.append(rec)
        if not self._pending:
            self._pending_t0 = end      # oldest-pending age for idle flush
        self.frames_processed += 1
        # meta rides along only for flush-cadence viz (the flusher stamps
        # its record with the batch's newest frame/pose)
        meta = ((self.frames_processed, t, position, quat)
                if self._viz_flush else None)
        self._pending.append((rec, scalars, meta))
        return True

    def _flush_pending(self) -> None:
        """Hand the pending batch to the flusher thread: stack the scalar
        handles on device (a DISPATCH, kept on the worker thread so device
        submission order is unambiguous) and enqueue the stacked handle;
        the flusher does the only blocking read, so the worker never
        stalls on the device sync."""
        if not self._pending:
            return
        jnp = self._jnp
        batch = self._pending
        self._pending = []
        handles = [s for _, s, _ in batch]
        # Pad to the FIXED pipeline depth before stacking: every distinct
        # stack length is a distinct XLA program, so a varying-k stack would
        # compile mid-stream.  One (K, 4) shape compiles once and serves
        # every flush.
        handles += [handles[-1]] * (self.stream_sync_every - len(handles))
        with self._state_lock:
            stacked = jnp.stack(handles)        # always (K, 4) int32
        self._flush_q.put((batch, stacked))

    def _backfill_batch(self, batch, stacked) -> np.ndarray:
        """Flusher-thread half of a flush: ONE batched device->host
        readback backfills every record truthfully.  The sync time is
        folded into the batch's last processing_time, keeping the
        pipelined-replay convention that summed processing_time accounts
        for the readback cost (the read now OVERLAPS dispatches — it is an
        accounting entry, not a pipeline stall).  D-CAP accounting exact.
        Returns the (k, 4) scalar rows (flush-cadence viz reuses them)."""
        k = len(batch)
        t0 = self._now()
        with self._read_lock:                   # the ONLY concurrent read
            self._read_started_mono = time.monotonic()
            try:
                vals = np.asarray(stacked)[:k]  # single sync
            finally:
                self._read_started_mono = None
        sync_us = (self._now() - t0) * 1e6
        if sync_us / 1e3 > self._stall_read_ms:
            self._stall_read_ms = sync_us / 1e3
        for (rec, _, _), row in zip(batch, vals):
            rec["seg_vec_size"] = int(row[0])
            rec["nblines"] = max(int(row[1]), 0)
        batch[-1][0]["processing_time"] += sync_us
        overflow = vals[:, 3]
        self.world_overflow_frames += int((overflow > 0).sum())
        if overflow.sum():
            logger.warning(
                "world map full (max_world_segments=%d): dropped %d "
                "segment(s) across %d frame(s) (D-CAP)",
                self.cfg.shapes.max_world_segments, int(overflow.sum()),
                int((overflow > 0).sum()))
        # checkpoint cadence in deferred mode: flush boundaries are the only
        # points where the map is host-consistent, so save once per crossed
        # multiple of checkpoint_every rather than per exact frame
        # (save_checkpoint re-acquires _state_lock -> _read_lock, so it must
        # run OUTSIDE the read lock held above)
        if self.checkpoint_every and self.checkpoint_path:
            k = self.frames_processed // self.checkpoint_every
            if k > self._last_checkpoint_k:
                self._last_checkpoint_k = k
                self.save_checkpoint(self.checkpoint_path)
        return vals

    def _flusher_loop(self) -> None:
        while True:
            item = self._flush_q.get()
            try:
                if item is None:
                    return
                # Start the blocking read only in a worker-idle window (see
                # _worker_idle) — a read against a continuously-fed device
                # queue drags for seconds and slows the steps it overlaps.
                # Once the stream is stopping (_running False) read at will:
                # the feed has ended and the queue is draining.
                while (self._running
                        and not self._worker_idle.wait(timeout=0.05)):
                    pass
                try:
                    vals = self._backfill_batch(*item)
                    if self._viz_flush:
                        self._emit_viz_flush(item[0], vals)
                except Exception:
                    logger.exception("flush backfill failed; records keep "
                                     "their -1 sentinels for this batch")
            finally:
                self._flush_q.task_done()

    def _emit_viz_flush(self, batch, vals) -> None:
        """Flush-cadence live viz (flusher thread): render the CURRENT
        world map into one viz record without leaving the deferred fast
        path.  Cost: ONE packed world-state snapshot — a cheap dispatch
        under _state_lock plus a single batched read under _read_lock, the
        same cost class as the scalar backfill it rides behind — decoded
        on host (statepack.make_host_unpacker), vs ~9 per-field reads for
        world_snapshot() or the synchronous per-frame path.  The record carries the batch's NEWEST
        frame counters/pose, so the follower tracks the map at readback
        cadence exactly like the reference's RViz view tracks the node
        (node.cpp:676-842); per-frame fidelity is the viz_every_frame
        opt-in.  A viz failure must never kill the flusher (the record is
        telemetry; the backfill already committed)."""
        try:
            self._ensure_state_packer()
            # Re-enter a worker-idle window first: the backfill read this
            # rides behind may have outlived the idle window it started in,
            # and a read against live dispatches drags for seconds while
            # slowing them (the same reason _flusher_loop gates).  Cannot
            # deadlock: the backpressure loop sets _worker_idle while it
            # waits on this very task.
            while (self._running
                    and not self._worker_idle.wait(timeout=0.05)):
                pass
            pack = self._state_pack
            with self._state_lock:
                handle = pack(self._state)
            with self._read_lock:
                self._read_started_mono = time.monotonic()
                try:
                    vec = np.asarray(handle)   # the one read
                finally:
                    self._read_started_mono = None
            st = self._state_unpack_host(vec)
            frame_no, t, position, quat = batch[-1][2]
            nl, status = (int(v) for v in vals[-1][1:3])
            n = int(st.count)
            a = np.asarray(st.a, np.float64)[:n]
            b = np.asarray(st.b, np.float64)[:n]
            t_min = np.asarray(st.t_min, np.float64)[:n]
            t_max = np.asarray(st.t_max, np.float64)[:n]
            radius = np.asarray(st.radius, np.float64)[:n]
            cylinders = [
                {"id": i,
                 "p1": (a[i] + t_min[i] * b[i]).tolist(),
                 "p2": (a[i] + t_max[i] * b[i]).tolist(),
                 "radius": float(radius[i])}
                for i in range(n)]
            inter = np.asarray(st.inter)[:n, :n]
            spheres = [
                {"position": (a[i] + t1 * b[i]).tolist(),
                 "text": f"Intersection: {i} & {j}"}
                for i, t1, j, _t2 in self._intersection_pairs(inter, n)]
            rec = {
                "frame": int(frame_no),
                "t": float(t),
                "nlines": max(nl, 0),
                "status": status,
                # from the SAME snapshot as the geometry: the batch's
                # packed scalar can lag it (the worker keeps dispatching
                # while this emit waits for an idle window), and the HUD
                # renders world_count next to the cylinder list
                "world_count": n,
                "cylinders": cylinders,
                "intersections": spheres,
                # flush-cadence marker: one record summarizes the batch
                # (frames since the previous record share its world view)
                "viz_cadence": "flush",
                "frames_in_batch": len(batch),
                "drone": {
                    "position": [float(v) for v in np.asarray(position)],
                    "quat_wxyz": [float(v) for v in np.asarray(quat)],
                },
            }
            self._write_viz_record(rec)
        except Exception:
            logger.exception("flush-cadence viz emit failed; stream continues")

    # ------------------------------------------------------- state snapshot

    def _ensure_state_packer(self) -> None:
        """Build + compile the packed state snapshot (device pack, host
        unpack; one-time compile, done at start() so no stream pays it
        mid-flight)."""
        if self._state_pack is not None or self.backend != "jax":
            return
        from .statepack import make_host_unpacker, make_pytree_packer

        with self._state_lock, self._read_lock:
            self._state_unpack_host = make_host_unpacker(self._state)
            pack, _ = make_pytree_packer(self._state)
            pack(self._state).block_until_ready()   # compile now
            self._state_pack = pack

    def _bound_unread_batches(self) -> None:
        """Backpressure under sustained overfeed, run after EVERY flush
        (both the >= stream_sync_every path and the idle-age path): the
        old synchronous flush bounded dispatch-ahead as a side effect;
        with the async flusher an overfed stream would otherwise grow the
        device queue (and worst-case memory/latency) without limit.  Cap
        unread batches: pause dispatch — explicitly signaling an idle
        window so the flusher's gated read can proceed — until the
        flusher catches up.  The stall is device-drain time the saturated
        stream had to pay anyway; the mailbox keeps latest-wins dropping
        meanwhile, exactly like the reference under load."""
        while (self._running and self._flush_q.qsize()
                >= self._STREAM_MAX_UNREAD_BATCHES):
            # A WEDGED head read (not mere overfeed) must not stall the
            # stream: keep dispatching concurrently with the in-flight
            # read.  Past the wedge cap, shed the oldest unread batch (its
            # frames keep -1 telemetry sentinels; the map already advanced
            # on device) rather than park the whole map build behind it.
            if self._flusher_read_wedged():
                if (self._flush_q.qsize()
                        < self._STREAM_WEDGE_MAX_BATCHES):
                    break
                try:
                    shed = self._flush_q.get_nowait()
                except queue.Empty:
                    continue
                if shed is None:     # stop() poison raced in:
                    self._flush_q.task_done()
                    self._flush_q.put(None)   # hand it back
                    break
                self._flush_q.task_done()
                self.flush_batches_shed += 1
                logger.warning(
                    "device read wedged: shed one readback batch "
                    "(%d frames keep -1 telemetry sentinels; "
                    "%d batches shed total)",
                    len(shed[0]), self.flush_batches_shed)
                break
            self._worker_idle.set()
            time.sleep(0.005)

    def _flusher_read_wedged(self) -> bool:
        """True while the flusher's current device->host read has been in
        flight longer than _STREAM_READ_WEDGE_S (single-writer timestamp:
        only the flusher thread sets/clears it; a racy read here can only
        misjudge by one poll interval)."""
        s = self._read_started_mono
        return (s is not None
                and time.monotonic() - s > self._STREAM_READ_WEDGE_S)

    def pop_stall_max(self) -> dict:
        """Return-and-reset the slowest single step dispatch and flusher
        read (ms) since the last call.  Diagnostic sampling for soak
        monitors (tools/endurance.py): a throughput hole in a window with
        a huge step_ms is a wedged dispatch; a huge flush_read_ms is a
        wedged device->host read; neither large points at the feed/host
        side.  A read still IN FLIGHT reports its current age, so a long
        stall is visible in the window it happens in, not only in the one
        it ends in.  Racy by design — a lost update only shrinks a max."""
        read_ms = self._stall_read_ms
        s = self._read_started_mono
        if s is not None:
            read_ms = max(read_ms, (time.monotonic() - s) * 1e3)
        out = {"step_ms": round(self._stall_step_ms, 1),
               "flush_read_ms": round(read_ms, 1)}
        self._stall_step_ms = 0.0
        self._stall_read_ms = 0.0
        return out

    def _worker_loop(self) -> None:
        # A processing error must not silently kill the consumer thread (the
        # reference's worker dies on the first TF failure, node.cpp:281-283 —
        # a quirk this runtime deliberately fixes; skip-and-continue applies
        # to unexpected exceptions too).
        deferred = self._stream_deferred
        while self._running:
            timeout = (self._STREAM_IDLE_FLUSH_S
                       if (deferred and self._pending) else 0.1)
            item = self.mailbox.take(timeout=timeout)
            if item is None:
                self._worker_idle.set()
                if (deferred and self._pending
                        and (self._now() - self._pending_t0
                             >= self._STREAM_FLUSH_AGE_S)):
                    try:
                        self._flush_pending()
                    except Exception:
                        logger.exception("pending flush failed")
                    # Every flush site must bound the queue: a feed near
                    # saturation takes nearly every flush through THIS
                    # path (pending rarely reaches stream_sync_every
                    # before a >_STREAM_FLUSH_AGE_S idle gap).
                    self._bound_unread_batches()
                continue
            self._worker_idle.clear()
            t, points = item
            try:
                if deferred:
                    self._process_frame_deferred(t, points)
                else:
                    self.process_frame(t, points)
            except Exception:
                self.frames_failed += 1
                logger.exception("frame at t=%s failed; worker continues", t)
            # The every-K flush runs OUTSIDE the per-frame handler: a flush
            # failure is a readback-batch loss (records keep their -1
            # sentinels), NOT a failed frame — folding it into
            # frames_failed double-counted an already-processed frame and
            # skewed drain()/drop accounting.
            if deferred and len(self._pending) >= self.stream_sync_every:
                try:
                    self._flush_pending()
                except Exception:
                    logger.exception("pending flush failed; records keep "
                                     "their -1 sentinels for this batch")
                self._bound_unread_batches()
        if deferred and self._pending:
            try:
                self._flush_pending()
            except Exception:
                logger.exception("final pending flush failed")
        self._worker_idle.set()    # stream over: let the flusher drain

    def drain(self, target_total: Optional[int] = None,
              timeout: float = 60.0, poll_s: float = 0.05) -> bool:
        """Wait until every submitted cloud is accounted for (processed,
        failed, skipped, or dropped by latest-wins).  ``target_total``
        defaults to ``frames_submitted``; pass an explicit total when clouds
        bypass submit_cloud (the native feeder writes the mailbox directly).
        The window extends while the worker makes progress, so it outlasts
        a first-frame compile.  Returns True if drained."""
        import time as _time

        if target_total is None:
            target_total = self.frames_submitted
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            before = self.frames_processed + self.frames_failed \
                + self.frames_skipped_no_pose
            if before + self.dropped_frames >= target_total:
                return True
            _time.sleep(poll_s)
            after = self.frames_processed + self.frames_failed \
                + self.frames_skipped_no_pose
            if after != before:
                deadline = _time.monotonic() + timeout
        return (self.frames_processed + self.frames_failed
                + self.frames_skipped_no_pose
                + self.dropped_frames) >= target_total

    def stop(self) -> None:
        self._running = False
        self.mailbox.close()
        self._mailbox_closed = True
        if self._worker is not None:
            # Block until the worker really exits: the first compile inside
            # process_frame can take many seconds, and returning while the
            # worker still owns the (donated) world-state buffer would let
            # finalize() read a torn/deleted array.  Warn while slow rather
            # than abandoning a live thread.
            self._worker.join(timeout=10.0)
            while self._worker.is_alive():
                logger.warning("worker still busy (likely first-frame "
                               "compile); waiting for a clean stop")
                self._worker.join(timeout=30.0)
            self._worker = None
        if self._flusher is not None:
            # The worker's exit path enqueued its final batch; the sentinel
            # is therefore ordered after every real flush.  Join without a
            # deadline: abandoning a reader mid-np.asarray would leave two
            # concurrent reads on a later call.
            self._flush_q.put(None)
            self._flusher.join(timeout=30.0)
            while self._flusher.is_alive():
                logger.warning("flusher still draining readbacks; waiting")
                self._flusher.join(timeout=30.0)
            self._flusher = None

    def run_streaming_from_log(self, log_path: str, rate_hz: float = 30.0,
                               loops: int = 1, poll_s: float = 0.05) -> dict:
        """Stream a recorded frame log through the full production runtime:
        a feeder paces clouds into the latest-wins mailbox and poses into
        the pose buffer at sensor rate while the consumer thread processes
        — frames are DROPPED (not queued) when processing falls behind,
        exactly like the reference's depth-1 /tof_pc subscription.

        With the native runtime, the feeder is a C++ thread (GIL-free);
        otherwise a Python pacing thread replays the same log.  Returns
        ``{"fed": n, "processed": n, "dropped": n, "flush_batches_shed": n,
        "feed_s": s, "drain_s": s}`` — feed_s is the paced-feed phase,
        drain_s the post-feed settle.
        """
        import time as _time

        from .. import native

        self.start()
        t_feed0 = _time.perf_counter()
        # per-run accounting baseline: counters are cumulative across runs
        base_total = (self.frames_processed + self.frames_failed
                      + self.frames_skipped_no_pose + self.dropped_frames)
        base_processed = self.frames_processed
        base_dropped = self.dropped_frames
        base_skipped = self.frames_skipped_no_pose
        base_failed = self.frames_failed
        use_native = (native.available()
                      and isinstance(self.mailbox, native.NativeMailbox)
                      and isinstance(self.poses, native.NativePoseBuffer))
        if use_native:
            feeder = native.NativeFeeder(log_path, self.mailbox, self.poses,
                                         rate_hz=rate_hz, loops=loops,
                                         close_on_end=False)
            try:
                while not feeder.done:
                    _time.sleep(poll_s)
                fed = feeder.fed
            finally:
                feeder.stop()
        else:
            from ..io.replay import load_frames

            frames = load_frames(log_path)
            period = 1.0 / rate_hz if rate_hz > 0 else 0.0
            # Per-loop monotonic time offset (mirrors the native feeder):
            # replaying raw timestamps every loop rewinds the clock, and the
            # sorted pose ring then evicts everything but the largest
            # timestamps — after enough loops every fresh-frame pose lookup
            # starves (endurance-soak pathology; see pcs_feeder_run).
            gaps = [b.t - a.t for a, b in zip(frames, frames[1:]) if b.t > a.t]
            span = ((frames[-1].t - frames[0].t) if frames else 0.0) + (
                period or (gaps[-1] if gaps else 1e-3))
            fed = 0
            for loop in range(max(loops, 1)):
                off = loop * span
                for fr in frames:
                    self.push_pose(fr.t + off, fr.position, fr.quat_wxyz)
                    self.submit_cloud(fr.t + off, fr.points)
                    fed += 1
                    if period:
                        _time.sleep(period)
        t_drain0 = _time.perf_counter()
        # drain: wait until every frame of THIS run is accounted for
        # (processed/failed/skipped/dropped); the window outlasts a
        # first-frame compile (engine.drain extends on progress)
        self.drain(target_total=base_total + fed, poll_s=poll_s)
        self.stop()
        t_end = _time.perf_counter()
        processed = int(self.frames_processed - base_processed)
        skipped = int(self.frames_skipped_no_pose - base_skipped)
        failed = int(self.frames_failed - base_failed)
        # a frame still fresh in the mailbox at stop() was never taken: it
        # IS dropped under latest-wins, so account every unprocessed,
        # unskipped frame as dropped rather than leaving a silent gap
        dropped = max(int(fed) - processed - skipped - failed,
                      int(self.dropped_frames - base_dropped))
        return {"fed": int(fed), "processed": processed,
                "dropped": dropped,
                "flush_batches_shed": int(self.flush_batches_shed),
                "feed_s": round(t_drain0 - t_feed0, 3),
                "drain_s": round(t_end - t_drain0, 3)}

    @property
    def dropped_frames(self) -> int:
        d = getattr(self.mailbox, "dropped", 0)
        return getattr(self, "_dropped_accum", 0) + int(
            d() if callable(d) else d)

    # ---------------------------------------------------------------- outputs

    def _world_segments_locked(self) -> List[dict]:
        """jax-backend world rows; caller holds _state_lock."""
        # One device->host transfer per FIELD (not per segment per field).
        # The lock keeps the worker from donating st out from under us.
        st = self._state
        n = int(np.asarray(st.count))
        a = np.asarray(st.a)[:n]
        b = np.asarray(st.b)[:n]
        t_min = np.asarray(st.t_min)[:n]
        t_max = np.asarray(st.t_max)[:n]
        radius = np.asarray(st.radius)[:n]
        points_size = np.asarray(st.points_size)[:n]
        pca_coeff = np.asarray(st.pca_coeff)[:n]
        return [{"a": a[i], "b": b[i],
                 "t_min": float(t_min[i]),
                 "t_max": float(t_max[i]),
                 "radius": float(radius[i]),
                 "points_size": int(points_size[i]),
                 "pca_coeff": float(pca_coeff[i])}
                for i in range(n)]

    @staticmethod
    def _intersection_pairs(inter: np.ndarray, n: int) -> List[tuple]:
        """Upper-triangular scan of the (S, S, 2) intersection-parameter
        plane: (i, t1, j, t2) per populated pair, (-1, -1) = empty
        sentinel (worldmap.update_intersections).  The ONE place the
        sentinel convention is decoded — the device-state reader and the
        flush-cadence viz emit both go through it."""
        rows = []
        for i in range(n):
            for j in range(i):
                t1, t2 = inter[i, j]
                if t1 != -1.0 and t2 != -1.0:
                    rows.append((i, float(t1), j, float(t2)))
        return rows

    def _intersections_locked(self) -> List[tuple]:
        """jax-backend intersection rows; caller holds _state_lock."""
        st = self._state
        n = int(np.asarray(st.count))
        return self._intersection_pairs(np.asarray(st.inter)[:n, :n], n)

    def _world_segments_oracle(self) -> List[dict]:
        """Oracle-backend segment rows; caller holds _state_lock (the
        oracle WorldMap mutates in place, so unlocked readers could see a
        torn mid-frame state — same contract as the jax branch)."""
        return [{"a": s.a, "b": s.b, "t_min": s.t_min, "t_max": s.t_max,
                 "radius": s.radius, "points_size": s.points_size,
                 "pca_coeff": s.pca_coeff}
                for s in self._wm.segments]

    def world_segments(self) -> List[dict]:
        """Current world map as host dicts (segments.csv row source)."""
        if self.backend == "oracle":
            with self._state_lock:
                return self._world_segments_oracle()
        with self._state_lock, self._read_lock:
            return self._world_segments_locked()

    def intersections_rows(self) -> List[tuple]:
        """(seg1, t1, seg2, t2) rows, upper-triangular order (node.cpp:858)."""
        if self.backend == "oracle":
            # the oracle writes inter[i, j] = (t1, t2) non-atomically
            # (oracle/pipeline.py), so this read needs the same lock the
            # oracle step holds — else a row can pair a new t1 with a
            # stale t2
            with self._state_lock:
                return self._wm.intersections_rows()
        with self._state_lock, self._read_lock:
            return self._intersections_locked()

    def world_snapshot(self) -> Tuple[List[dict], List[tuple]]:
        """(world_segments, intersections_rows) as ONE mutually consistent
        pair — a frame fused between two separate calls could otherwise
        yield intersection rows referencing segments absent from the
        segment list (concurrent streaming readers: server queries, live
        viz pollers)."""
        if self.backend == "oracle":
            with self._state_lock:
                return (self._world_segments_oracle(),
                        self._wm.intersections_rows())
        with self._state_lock, self._read_lock:
            return self._world_segments_locked(), self._intersections_locked()

    def visualization(self, include_points: bool = True) -> dict:
        """Marker-style structured viz (the RViz MarkerArray analog):
        cylinders per world segment, spheres per intersection, text labels
        (node.cpp:676-842).  `include_points=False` skips the accumulated
        inlier-point concatenation — the per-frame viz stream builds its
        own capped point record, and the full store grows without bound
        over a stream (copying it every frame would be quadratic)."""
        cylinders, texts, spheres = [], [], []
        segs, inter_rows = self.world_snapshot()
        for i, s in enumerate(segs):
            p1 = np.asarray(s["a"]) + s["t_min"] * np.asarray(s["b"])
            p2 = np.asarray(s["a"]) + s["t_max"] * np.asarray(s["b"])
            mid = (p1 + p2) / 2
            cylinders.append({"id": i, "p1": p1, "p2": p2, "center": mid,
                              "radius": s["radius"],
                              "height": float(np.linalg.norm(p2 - p1))})
            texts.append({"id": i, "position": mid, "text": str(i)})
        for (i, t1, j, t2) in inter_rows:
            s = segs[i]
            p = np.asarray(s["a"]) + t1 * np.asarray(s["b"])
            r = 1.5 * max(self.cfg.radius_sizes[0], self.cfg.radius_sizes[-1])
            spheres.append({"position": p, "radius": r,
                            "text": f"Intersection: {i} & {j}"})
        out = {"cylinders": cylinders, "segment_texts": texts,
               "intersections": spheres}
        if include_points and self.collect_inlier_points \
                and self._inlier_points:
            # snapshot under the lock: the streaming worker appends chunks
            # under _state_lock (oracle AND jax paths)
            with self._state_lock:
                out["hough_points"] = {
                    k: np.concatenate(v, axis=0)
                    for k, v in self._inlier_points.items()}
        return out

    # ---------------------------------------------------------------- checkpoint

    def save_checkpoint(self, path: str) -> None:
        """Serialize the world map + per-frame records (checkpoint/resume —
        a capability gap in the reference, whose map lives only in RAM,
        SURVEY.md §5).  Fixed-capacity arrays make this a flat npz."""
        # Deferred-streaming mode: frames dispatched after the batch being
        # flushed still carry -1 sentinel counters; serializing them would
        # make a resumed engine's processing_time.csv contain -1 rows the
        # synchronous path never produces.  Keep only backfilled records
        # (the world state ahead of them is still saved — it is the device
        # truth; the skipped rows are telemetry that was not yet synced).
        done = [r for r in self.records if r["seg_vec_size"] >= 0]
        payload = {
            "backend": np.array(self.backend),
            "world_overflow_frames": np.array(self.world_overflow_frames),
            "frames_processed": np.array(self.frames_processed),
            "records_pending": np.array(len(self.records) - len(done)),
            "records": np.array(
                [[r["wall_time"], r["processing_time"], r["seg_vec_size"],
                  r["nblines"]] for r in done],
                dtype=np.float64).reshape(-1, 4),
        }
        if self.backend == "jax":
            with self._state_lock, self._read_lock:   # consistent snapshot
                for k in ("a", "b", "t_min", "t_max", "radius",
                          "points_size", "pca_coeff", "pca_eigenvalues",
                          "valid", "count", "inter"):
                    payload[f"world_{k}"] = np.asarray(
                        getattr(self._state, k))
        else:
            segs = self._wm.segments
            payload["world_count"] = np.array(len(segs))
            for name, get in (
                    ("a", lambda s: s.a), ("b", lambda s: s.b),
                    ("t_min", lambda s: s.t_min), ("t_max", lambda s: s.t_max),
                    ("radius", lambda s: s.radius),
                    ("points_size", lambda s: s.points_size),
                    ("pca_coeff", lambda s: s.pca_coeff),
                    ("pca_eigenvalues", lambda s: s.pca_eigenvalues)):
                payload[f"seg_{name}"] = np.array([get(s) for s in segs])
            payload["seg_points"] = (np.concatenate([s.points for s in segs])
                                     if segs else np.zeros((0, 3)))
            payload["seg_points_offsets"] = np.cumsum(
                [0] + [len(s.points) for s in segs])
            payload["inter"] = self._wm.inter
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, path)

    def load_checkpoint(self, path: str) -> None:
        """Resume the world map from a checkpoint written by the same backend."""
        data = np.load(path, allow_pickle=False)
        if str(data["backend"]) != self.backend:
            raise ValueError(
                f"checkpoint backend {data['backend']} != engine {self.backend}")
        self.frames_processed = int(data["frames_processed"])
        self.records = [
            {"wall_time": r[0], "processing_time": r[1],
             "seg_vec_size": int(r[2]), "nblines": int(r[3])}
            for r in data["records"]]
        if self.backend == "jax":
            import jax.numpy as jnp

            from ..worldmap import WorldState

            new_state = WorldState(**{
                k: jnp.asarray(data[f"world_{k}"])
                for k in WorldState._fields})
            # the swap must hold _state_lock: a streaming worker mid-step
            # reassigns self._state under it, and an unsynchronized store
            # here would silently lose either the load or the fused frame
            with self._state_lock:
                self._state = new_state
        else:
            from ..oracle import Segment

            n = int(data["world_count"])
            offs = data["seg_points_offsets"]
            segs = []
            for i in range(n):
                segs.append(Segment(
                    a=data["seg_a"][i], b=data["seg_b"][i],
                    t_min=float(data["seg_t_min"][i]),
                    t_max=float(data["seg_t_max"][i]),
                    radius=float(data["seg_radius"][i]),
                    points=data["seg_points"][offs[i]:offs[i + 1]],
                    points_size=int(data["seg_points_size"][i]),
                    pca_coeff=float(data["seg_pca_coeff"][i]),
                    pca_eigenvalues=data["seg_pca_eigenvalues"][i]))
            with self._state_lock:
                self._wm.segments = segs
                self._wm.inter = data["inter"]
        # re-anchor the checkpoint cadence and D-CAP counter to the
        # restored frame count: a resumed engine must neither re-save the
        # checkpoint it just loaded nor skip the next cadence boundary
        self._last_checkpoint_k = (
            self.frames_processed // self.checkpoint_every
            if self.checkpoint_every else 0)
        self.world_overflow_frames = int(data["world_overflow_frames"]) \
            if "world_overflow_frames" in data else 0

    def finalize(self, outdir: Optional[str] = None) -> dict:
        """Write the three reference CSVs (the node-destructor flush).

        Uses the native (C++) writers when available — byte-identical to
        runtime.csvio (printf %.6g IS the C++ ofstream default the
        reference writes with, node.cpp:850-919) — else the Python ones.
        """
        if self._viz_file is not None:
            self._viz_file.close()
            self._viz_file = None
        outdir = csvio.ensure_outdir(outdir or self.cfg.path_to_output)
        paths = {
            "intersections": os.path.join(outdir, "intersections.csv"),
            "segments": os.path.join(outdir, "segments.csv"),
            "processing_time": os.path.join(outdir, "processing_time.csv"),
        }
        writers = csvio
        try:
            from .. import native

            if native.available():
                writers = native
        except Exception:
            pass
        writers.write_intersections_csv(paths["intersections"],
                                        self.intersections_rows())
        writers.write_segments_csv(paths["segments"], self.world_segments())
        writers.write_processing_time_csv(paths["processing_time"],
                                          self.records)
        return paths
