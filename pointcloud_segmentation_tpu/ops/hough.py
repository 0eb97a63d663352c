"""Iterative 3D Hough line extraction, XLA-native.

Accelerator redesign of the reference's iterative Hough transform
(hough_3d_lines.h:167-349 plus the missing submodule's accumulator contract,
SURVEY.md §2.3).  Key departures from the CPU design:

* **Scatter-free accumulator as matmuls.**  The reference's (B, num_x,
  num_x) vote array with add/subtract bookkeeping (h:228, 241) maps to
  exact one-hot matmul histograms: the accumulator is built once per
  frame (bf16 one-hots, f32 accumulation — integer-exact), carried through
  the loop, and each extracted line's inliers are subtracted as a compacted
  delta histogram.  The global argmax runs two-stage (row max, then within
  the winning row) with the first-max tie-break == lexicographically
  smallest (b, xi, yi), matching the oracle.
* **Fixed-capacity everything.**  The do/while over extracted lines
  (h:237-342) becomes a ``lax.while_loop`` with masks; early exits become
  carried stop/fail flags with identical semantics (including the reference's
  b.x == 0 frame-abort path and the "nlines counts gate failures" quirk,
  h:259).

Bit-level conventions shared with the numpy oracle (both sides compute the
voting bins in float32 with fixed association order): see
oracle/pipeline.py HoughSpace.
"""

from __future__ import annotations


from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..geometry import canonicalize_direction
from ..sphere import hough_space
from .eigh3 import principal_eigenvector3, eigvalsh3

_HIGH = jax.lax.Precision.HIGHEST


class SegmentBatch(NamedTuple):
    """Fixed-capacity per-frame extracted segments (the `segment` struct,
    hough_3d_lines.h:21-29, as a structure-of-arrays)."""

    a: jnp.ndarray            # (L, 3)
    b: jnp.ndarray            # (L, 3)
    t_min: jnp.ndarray        # (L,)
    t_max: jnp.ndarray        # (L,)
    radius: jnp.ndarray       # (L,)
    points_size: jnp.ndarray  # (L,) int32
    pca_coeff: jnp.ndarray    # (L,)
    pca_eigenvalues: jnp.ndarray  # (L, 3)
    point_mask: jnp.ndarray   # (L, N) bool — inliers in the frame's cloud
    valid: jnp.ndarray        # (L,) bool

    @property
    def capacity(self) -> int:
        return self.a.shape[0]


class HoughResult(NamedTuple):
    segments: SegmentBatch
    nlines: jnp.ndarray       # int32 — nblines_extracted (0 on frame abort)
    status: jnp.ndarray       # int32 STATUS_* classification (oracle/pipeline.py):
                              # 0 ok, 1 degenerate, 2 dx>=d, 3 b.x==0 abort


def empty_segments(L: int, N: int, dtype=jnp.float32) -> SegmentBatch:
    z3 = jnp.zeros((L, 3), dtype)
    z1 = jnp.zeros((L,), dtype)
    return SegmentBatch(
        a=z3, b=z3, t_min=z1, t_max=z1, radius=z1,
        points_size=jnp.zeros((L,), jnp.int32), pca_coeff=z1,
        pca_eigenvalues=jnp.zeros((L, 3), dtype),
        point_mask=jnp.zeros((L, N), bool), valid=jnp.zeros((L,), bool))


def _masked_minmax(points, valid):
    big = jnp.asarray(jnp.inf, points.dtype)
    p_min = jnp.min(jnp.where(valid[:, None], points, big), axis=0)
    p_max = jnp.max(jnp.where(valid[:, None], points, -big), axis=0)
    return p_min, p_max


def _line_distance2(pts, a, b_unit):
    # mirrors geometry.point_line_distance's op sequence exactly
    # (elementwise-product dot, NOT a matvec — reduction-order parity)
    d = pts - a
    along = (d * b_unit[None, :]).sum(-1)
    perp = d - along[:, None] * b_unit[None, :]
    return (perp * perp).sum(-1)


def _masked_lsq(pts, mask):
    """Orthogonal LSQ over masked points (h:121-150): returns
    (rc = largest scatter eigenvalue, anchor=centroid, unit direction).

    The scatter eigensolve runs in f32 REGARDLESS of the pipeline dtype —
    the reference computes it in float32 (h:129 MatrixXf) and the oracle
    reproduces that; the anchor centroid follows the input dtype.
    """
    dt = pts.dtype
    m = mask.astype(dt)
    cnt = jnp.maximum(m.sum(), 1.0)
    mean = (pts * m[:, None]).sum(0) / cnt
    c = jnp.where(mask[:, None], pts - mean, 0.0).astype(jnp.float32)
    scatter = jnp.dot(c.T, c, precision=_HIGH)
    rc, bvec = principal_eigenvector3(scatter)
    return rc.astype(dt), mean, bvec.astype(dt)


def _masked_cov_eigs(pts, mask):
    """Descending covariance eigenvalues over masked points (segPCA,
    h:94-110).  f32 like the reference's PCL PCA (see _masked_lsq)."""
    dt = pts.dtype
    m = mask.astype(dt)
    cnt = jnp.maximum(m.sum(), 1.0)
    mean = (pts * m[:, None]).sum(0) / cnt
    c = jnp.where(mask[:, None], pts - mean, 0.0).astype(jnp.float32)
    denom = jnp.maximum(cnt.astype(jnp.float32) - 1.0, 1.0)
    cov = jnp.dot(c.T, c, precision=_HIGH) / denom
    return eigvalsh3(cov).astype(dt)


def _canonical_sign(b):
    """Flip so the first nonzero component is positive (D-SIGN).  Delegates
    to geometry.canonicalize_direction — the ONE definition of the sign
    convention both the oracle and this path must share (two hand-synced
    copies could silently desynchronize the cross-implementation
    invariant)."""
    return canonicalize_direction(b)


def _vote_bins(Xs, c1, c2, d, dx, num_x):
    """(B, N) int32 xi and yi accumulator bins.

    Float32 binning with fixed association order, matching the oracle's spec
    (oracle HoughSpace.bin_indices) — inputs are cast to f32 here so the
    f64 parity mode bins identically.
    """
    Xs = Xs.astype(jnp.float32)
    c1 = c1.astype(jnp.float32)
    c2 = c2.astype(jnp.float32)
    dx = dx.astype(jnp.float32)
    x0, x1, x2 = Xs[:, 0][None, :], Xs[:, 1][None, :], Xs[:, 2][None, :]
    xp = (c1[:, 0:1] * x0 + c1[:, 1:2] * x1) + c1[:, 2:3] * x2   # (B, N)
    yp = (c2[:, 0:1] * x0 + c2[:, 1:2] * x1) + c2[:, 2:3] * x2
    half = (d / 2.0).astype(jnp.float32)
    xi = jnp.clip(jnp.floor((xp + half) / dx).astype(jnp.int32), 0, num_x - 1)
    yi = jnp.clip(jnp.floor((yp + half) / dx).astype(jnp.int32), 0, num_x - 1)
    return xi, yi


def _onehot_histogram(xt, yt, num_x_static):
    """(B, NX, NX) exact counts from (B, N) int32 bin indices: bf16 one-hot
    rows/columns contracted as a matmul with f32 accumulation (0/1 values
    and counts < 2^24 are exact).  An out-of-range xt (the `num_x_static`
    sentinel) yields an all-zero one-hot row — callers fold inactive/empty
    masks into xt before calling.  The add path (_vote_histogram), the
    subtract path (_vote_histogram_delta) and the lazy init
    (_vote_state_tiles) MUST bin bit-identically; this is the single
    definition of the one-hot -> matmul recipe all three share."""
    num_x_static = int(num_x_static)
    x_iota = jax.lax.broadcasted_iota(jnp.int32, (num_x_static, 1), 0)
    X1 = (xt[:, None, :] == x_iota[None, :, :]).astype(jnp.bfloat16)
    Y1 = (yt[:, :, None] == x_iota[None, :, :].transpose(0, 2, 1)
          ).astype(jnp.bfloat16)
    return jnp.einsum("bxn,bny->bxy", X1, Y1,
                      preferred_element_type=jnp.float32)


# The three sizes below were tuned on the accelerator this pipeline was
# first built for (the tile matched its 128-wide matrix unit); they are
# correct on any device and await a sweep on the GPU.
_VOTE_TILE = 128  # directions per histogram tile (bounds the one-hot transient)
_GAP_RANK_MAX_N = 4096  # above this, the gap check sorts instead of using
                        # the O(N²) rank matrix (see the gate in the loop)
_SUSPECT_CAP = 2048     # lazy voting: max directions re-examined per round
                        # (overflow falls back to an exact full rebuild)


def _vote_histogram(Xs, c1, c2, d, dx, num_x, active, num_x_static):
    """Exact (B, NX, NX) vote counts of the active points, as matmuls.

    votes[b, x, y] = #{n : active[n], xi[b,n]==x, yi[b,n]==y}, computed as a
    batched one-hot matmul: X1[b,x,n] @ Y1[b,n,y] with bf16 one-hots and f32
    accumulation (0/1 values and counts < 2^24 are exact).  Tiled over the
    direction axis with lax.map; the f32-by-spec bins are recomputed INSIDE
    each tile from the (N, 3) shifted cloud — a (tile, N) flop triviality
    that keeps the (B, N) bin arrays (336 MB at granularity 6) from ever
    existing in device memory.  This is the scatter-free formulation of
    the reference accumulator's ``add`` (h:228).
    """
    B = c1.shape[0]
    N = Xs.shape[0]

    def tile_votes(args):
        c1t, c2t = args
        xt, yt = _vote_bins(Xs, c1t, c2t, d, dx, num_x)
        # fold the active mask into the x bin: inactive -> out-of-range
        # sentinel, whose one-hot row is all-zero
        xt = jnp.where(active[None, :], xt, num_x_static)
        return _onehot_histogram(xt, yt, num_x_static)

    if B <= _VOTE_TILE:
        return tile_votes((c1, c2))
    T = B // _VOTE_TILE  # B is padded to a _VOTE_TILE multiple by the caller
    votes = jax.lax.map(tile_votes,
                        (c1.reshape(T, _VOTE_TILE, 3), c2.reshape(T, _VOTE_TILE, 3)))
    return votes.reshape(B, num_x_static, num_x_static)


_SUB_CHUNK = 512  # removed-point columns for the incremental-subtract matmul


def _compact_removed(Xs, removed, n_rem, sub_chunk):
    """Gather the removed points into `sub_chunk` rows (exact int32
    scatter-built permutation; excluded rows -> sentinel column).  Returns
    (Xr (R, 3), col_live (R,) bool).  The SINGLE source of the compaction:
    the carry-mode subtract and the lazy-mode decrement must bin removed
    points bit-identically, so both call this."""
    N = removed.shape[0]
    pos = jnp.cumsum(removed.astype(jnp.int32)) - 1
    pos = jnp.where(removed, pos, sub_chunk)             # excluded -> sentinel
    perm = jnp.zeros((sub_chunk + 1,), jnp.int32).at[pos].set(
        jnp.arange(N, dtype=jnp.int32))[:sub_chunk]
    col_live = jnp.arange(sub_chunk, dtype=jnp.int32) < n_rem
    return jnp.take(Xs, perm, axis=0), col_live


def _vote_histogram_delta(Xs, c1, c2, d, dx, num_x, removed, n_rem,
                          sub_chunk, num_x_static):
    """Histogram of the removed points, compacted to `sub_chunk` columns —
    the incremental `Hough::subtract` contribution.

    Compaction gathers the removed *points* into `sub_chunk` rows and
    re-bins just those rows with the same f32 expression as `_vote_bins` —
    bit-identical bins at any num_x.  (A bf16 value-compaction matmul here
    silently corrupts bins >= 256, which valid configs reach — e.g.
    radius_sizes=(0.015,); and it costs B*N*R matmul flops vs B*3*R for
    re-binning the gathered rows.)
    """
    Xr, col_live = _compact_removed(Xs, removed, n_rem, sub_chunk)
    xt, yt = _vote_bins(Xr, c1, c2, d, dx, num_x)        # (B, R)
    xt = jnp.where(col_live[None, :], xt, num_x_static)  # empty columns
    return _onehot_histogram(xt, yt, num_x_static)


def _pad_dirs_to_tile(dirs, c1, c2):
    """Pad the direction table to a _VOTE_TILE multiple with copies of
    direction 0.  A duplicate direction reproduces direction 0's counts and
    loses the smallest-flat-index tie-break, so padding never wins."""
    B = dirs.shape[0]
    pad = (-B) % _VOTE_TILE
    if pad == 0:
        return dirs, c1, c2
    rep = lambda t: jnp.concatenate([t, jnp.broadcast_to(t[:1], (pad, 3))], 0)
    return rep(dirs), rep(c1), rep(c2)


def _vote_state_tiles(Xs, c1, c2, d, dx, num_x, active, num_x_static):
    """Per-direction (best count, best flat cell, upper bound on every OTHER
    cell) — the lazy voting state, computed tile-by-tile so the full
    (B, NX, NX) histogram NEVER exists in HBM (only ~tile-sized transients).

    `best`/`key` follow the oracle's argmax convention (first max == the
    lexicographically smallest cell); `ub` is the max count over all cells
    except `key`, which stays a valid upper bound for the rest of the
    extraction because vote counts only decrease (points are only removed,
    h:241/h:339).  c1/c2 row count must be a _VOTE_TILE multiple.
    """
    cells = num_x_static * num_x_static
    cell_iota = jax.lax.broadcasted_iota(jnp.int32, (1, cells), 1)

    def tile_state(args):
        c1t, c2t = args
        xt, yt = _vote_bins(Xs, c1t, c2t, d, dx, num_x)
        xt = jnp.where(active[None, :], xt, num_x_static)
        v = _onehot_histogram(xt, yt, num_x_static)
        vf = v.reshape(v.shape[0], cells)
        best = vf.max(axis=1)
        key = jnp.argmax(vf == best[:, None], axis=1).astype(jnp.int32)
        ub = jnp.where(cell_iota == key[:, None], -1.0, vf).max(axis=1)
        return best, key, ub

    B = c1.shape[0]
    if B <= _VOTE_TILE:
        return tile_state((c1, c2))
    T = B // _VOTE_TILE
    bs, ks, us = jax.lax.map(
        tile_state, (c1.reshape(T, _VOTE_TILE, 3), c2.reshape(T, _VOTE_TILE, 3)))
    return bs.reshape(-1), ks.reshape(-1), us.reshape(-1)


def _removed_cell_keys(Xs, c1, c2, d, dx, num_x, removed, n_rem, sub_chunk,
                       num_x_static):
    """(B, R) flat cell keys of the removed points (compacted to R columns;
    empty columns get the out-of-range sentinel `cells`).  Uses the shared
    `_compact_removed` + the same f32 `_vote_bins` binning as
    `_vote_histogram_delta` — bit-identical by construction."""
    Xr, col_live = _compact_removed(Xs, removed, n_rem, sub_chunk)
    xt, yt = _vote_bins(Xr, c1, c2, d, dx, num_x)
    keys = xt * num_x_static + yt
    return jnp.where(col_live[None, :], keys,
                     num_x_static * num_x_static)


def _global_argmax_winner(M, b_idx, cell, dir_axis):
    """Cross-shard reduction of per-shard vote winners to the global
    (max count, lex-smallest global direction, that direction's cell).

    Deliberately avoids a flat ``b_idx * cells + cell`` key: that product
    overflows int32 once B_total * num_x^2 > 2^31 (granularity 6 with min
    radius <= ~0.012 m), silently corrupting the argmax.  Shard direction
    ranges are disjoint, so the oracle's lexicographic (b, xi, yi)
    tie-break reduces to the smallest global direction index among the
    max-count shards; the unique owning shard then contributes its
    (already lex-smallest) cell via psum.
    """
    M_g = jax.lax.pmax(M, dir_axis)
    bkey = jnp.where(M == M_g, b_idx, jnp.iinfo(jnp.int32).max)
    b_min = jax.lax.pmin(bkey, dir_axis)
    cell = jax.lax.psum(jnp.where(bkey == b_min, cell, 0), dir_axis)
    return M_g, b_min, cell


class _LoopState(NamedTuple):
    it: jnp.ndarray
    active: jnp.ndarray
    vstate: tuple             # voting-mode state: carry = (votes (B,NX,NX),
                              # row_max (B,)); lazy = (best (B,), key (B,),
                              # ub (B,)) — see extract_lines
    nlines: jnp.ndarray
    nout: jnp.ndarray
    stop: jnp.ndarray
    fail: jnp.ndarray
    segs: SegmentBatch


def extract_lines(points: jnp.ndarray, valid: jnp.ndarray,
                  cfg: PipelineConfig,
                  dir_tables: tuple | None = None,
                  dir_axis: str | None = None) -> HoughResult:
    """Run the full iterative Hough extraction on one pre-filtered cloud.

    Args:
      points: (N, 3) float32 cloud (drone frame, post voxel grid).
      valid:  (N,) bool validity mask.
      cfg: static config (granularity selects the direction table — D-GRAN).
      dir_tables: optional (dirs, c1, c2) arrays overriding the builtin
        table — used by the direction-sharded multi-chip path, where each
        device holds a contiguous shard of the direction sphere.
      dir_axis: mesh axis name when running inside shard_map with the
        direction table sharded; the voting argmax then reduces across the
        axis with pmax/pmin and the winning direction's rows are broadcast
        with a masked psum (classic tensor-parallel pattern: points
        replicated, direction table sharded, O(1) collectives per round).

    Shapes are static; call under jit with cfg closed over or marked static.
    """
    N = points.shape[0]
    L = cfg.max_lines
    dt = points.dtype  # f32 (perf default) or f64 (parity mode)
    if dir_tables is None:
        dirs_np, c1_np, c2_np = hough_space(cfg.granularity)
        # direction vectors follow the pipeline dtype (the oracle keeps its
        # directions in f64); the c1/c2 binning bases are f32 BY SPEC
        dirs = jnp.asarray(dirs_np, dt)
        c1 = jnp.asarray(c1_np, jnp.float32)
        c2 = jnp.asarray(c2_np, jnp.float32)
    else:
        dirs, c1, c2 = dir_tables
        dirs = dirs.astype(dt)
        c1, c2 = c1.astype(jnp.float32), c2.astype(jnp.float32)
    dirs, c1, c2 = _pad_dirs_to_tile(dirs, c1, c2)
    B = dirs.shape[0]
    if dir_axis is not None:
        dir_offset = jax.lax.axis_index(dir_axis).astype(jnp.int32) * B
    else:
        dir_offset = jnp.int32(0)
    num_x_static = cfg.num_x_max
    dx = jnp.asarray(cfg.opt_dx, dt)
    dv = jnp.asarray(cfg.diag_voxel, dt)

    pts = points
    count_in = valid.sum()
    p_min, p_max = _masked_minmax(pts, valid)
    diag = p_max - p_min
    d = jnp.sqrt(jnp.maximum((diag * diag).sum(), 0.0))
    d = jnp.where(count_in > 0, d, 0.0)
    shift = jnp.where(count_in > 0, (p_min + p_max) / 2.0, jnp.zeros(3, dt))
    Xs = jnp.where(valid[:, None], pts - shift, 0.0)

    degenerate = (count_in == 0) | (d == 0.0)          # STATUS_DEGENERATE
    dx_too_large = ~degenerate & (dx >= d)             # STATUS_DX_TOO_LARGE
    precheck_fail = degenerate | dx_too_large
    num_x = jnp.maximum(jnp.floor(d / dx + 0.5).astype(jnp.int32), 1)

    cells = num_x_static * num_x_static
    lazy = cfg.voting_mode == "lazy"
    sub_chunk = min(_SUB_CHUNK, N)
    # capacity of the per-round suspect re-examination (lazy mode): a
    # _VOTE_TILE multiple; overflow falls back to an exact full rebuild
    s_cap = max(_VOTE_TILE,
                (min(B, _SUSPECT_CAP) // _VOTE_TILE) * _VOTE_TILE)
    s_tier = min(s_cap, 2 * _VOTE_TILE)  # fast path for the common rounds

    rs = jnp.asarray(cfg.radius_sizes, dt)
    rs_max = jnp.asarray(max(cfg.radius_sizes), dt)
    # static python-float denominator, evaluated exactly like the oracle's
    # (pipeline.py:371-372) — a pre-rounded 2/denom reciprocal reorders the
    # fp ops and can flip the int32 truncation at integer boundaries
    min_nb_denom = cfg.rad_2_leaf_ratio * (2 * cfg.diag_voxel) ** 2

    # ---- voting-state closures: "carry" keeps the exact (B, NX, NX)
    # accumulator (the reference's Hough add/subtract, h:228/241) with its
    # per-direction row max; "lazy" keeps ONLY (best, key, ub) per direction
    # — the accumulator never exists in HBM (O(B) state instead of
    # O(B·NX²); 250 KB vs 514 MB at granularity 6).  Both are exact: lazy
    # decrements each direction's best-cell count by the removed points'
    # votes and re-examines the directions whose other-cells bound `ub`
    # could reach the global max before the next argmax trusts the state.
    def _vstate_init(active0):
        if lazy:
            return _vote_state_tiles(Xs, c1, c2, d, dx, num_x, active0,
                                     num_x_static)
        v0 = _vote_histogram(Xs, c1, c2, d, dx, num_x, active0,
                             num_x_static)
        return (v0, v0.max(axis=(1, 2)))

    def _vstate_winner(vs):
        """(M, b_win, cell_win) with the first-max == smallest (b, xi, yi)
        tie-break, matching the oracle's flat argmax."""
        if lazy:
            best, key, _ = vs
            M = best.max()
            b_win = jnp.argmax(best == M).astype(jnp.int32)
            cell_win = key[b_win]
            return M, b_win, cell_win
        votes, row_max = vs
        M = row_max.max()
        b_win = jnp.argmax(row_max == M).astype(jnp.int32)
        win_row = jax.lax.dynamic_index_in_dim(votes, b_win, axis=0,
                                               keepdims=False)
        cell_win = jnp.argmax(win_row.reshape(cells) == M).astype(jnp.int32)
        return M, b_win, cell_win

    def _vstate_update(vs, branch, m2, n_rem, active_next):
        """branch 0 = keep (loop ending); 1 = incremental removal;
        2 = spill (> sub_chunk removed): exact rebuild from active_next."""
        if lazy:
            def _keep(args):
                return args

            def _increment(args):
                best, key, ub = args
                keys_r = _removed_cell_keys(Xs, c1, c2, d, dx, num_x, m2,
                                            n_rem, sub_chunk, num_x_static)
                dec = (keys_r == key[:, None]).sum(axis=1).astype(best.dtype)
                best = best - dec                       # exact best-cell count
                M_lb = best.max()
                if dir_axis is not None:
                    M_lb = jax.lax.pmax(M_lb, dir_axis)
                suspect = ub >= M_lb                    # other cells could win
                n_sus = suspect.sum()

                def _exam(cap):
                    # re-examine <= cap suspect directions: compact their
                    # indices, recompute (best, key, ub) just for them
                    def go(args):
                        best, key, ub = args
                        spos = jnp.cumsum(suspect.astype(jnp.int32)) - 1
                        spos = jnp.where(suspect, spos, cap)
                        idx = jnp.full((cap + 1,), B, jnp.int32).at[spos].set(
                            jnp.arange(B, dtype=jnp.int32))[:cap]
                        idx_c = jnp.minimum(idx, B - 1)
                        bs, ks, us = _vote_state_tiles(
                            Xs, c1[idx_c], c2[idx_c], d, dx, num_x,
                            active_next, num_x_static)
                        tgt = jnp.where(idx < B, idx, B)  # padding -> dropped
                        return (best.at[tgt].set(bs, mode="drop"),
                                key.at[tgt].set(ks, mode="drop"),
                                ub.at[tgt].set(us, mode="drop"))
                    return go

                # Suspect counts per round stay in the low hundreds at
                # granularity 6 (stale-ub decay), so a small first tier
                # handles nearly every round at a fraction of the full
                # s_cap exam; the s_cap tier and the exact full rebuild
                # remain as fallbacks.
                args2 = (best, key, ub)
                if s_tier < s_cap:
                    sel = jnp.where(n_sus <= s_tier, 0,
                                    jnp.where(n_sus <= s_cap, 1, 2))
                    return jax.lax.switch(
                        sel, [_exam(s_tier), _exam(s_cap), _rebuild], args2)
                return jax.lax.cond(n_sus > s_cap, _rebuild, _exam(s_cap),
                                    args2)

            def _rebuild(args):
                return _vote_state_tiles(Xs, c1, c2, d, dx, num_x,
                                         active_next, num_x_static)

            return jax.lax.switch(branch, [_keep, _increment, _rebuild], vs)

        def _keep(args):
            return args

        def _subtract(args):
            v, _ = args
            vn = v - _vote_histogram_delta(Xs, c1, c2, d, dx, num_x,
                                           m2, n_rem, sub_chunk,
                                           num_x_static)
            return vn, vn.max(axis=(1, 2))

        def _rebuild(args):
            vn = _vote_histogram(Xs, c1, c2, d, dx, num_x, active_next,
                                 num_x_static)
            return vn, vn.max(axis=(1, 2))

        return jax.lax.switch(branch, [_keep, _subtract, _rebuild], vs)

    # With opt_nlines > 0 every iteration either increments nlines or
    # sets stop, so opt_nlines + 1 is itself a static bound — do not let
    # shapes.max_iters silently truncate configs with opt_nlines > 24.
    it_bound = (max(cfg.shapes.max_iters, cfg.opt_nlines + 1)
                if cfg.opt_nlines > 0 else cfg.shapes.max_iters)

    def cond(s: _LoopState):
        c = (~s.stop) & (s.active.sum() > 1) & (s.it < it_bound)
        if cfg.opt_nlines > 0:
            c = c & (s.nlines < cfg.opt_nlines)
        return c

    def body(s: _LoopState) -> _LoopState:
        # ---- voting: exact global argmax from the mode's carried state
        # (see the closures above).  First-max tie-break == smallest
        # (b, xi, yi), matching the oracle.
        M, b_win, cell_win = _vstate_winner(s.vstate)
        b_idx = b_win + dir_offset
        cell = cell_win
        if dir_axis is not None:
            M, b_idx, cell = _global_argmax_winner(M, b_idx, cell, dir_axis)
        # cell decode in f32 BY SPEC (oracle HoughSpace.get_line), result
        # promoted to the pipeline dtype
        xi = (cell // num_x_static).astype(jnp.float32)
        yi = (cell % num_x_static).astype(jnp.float32)
        half = (d / 2.0).astype(jnp.float32)
        dx32 = dx.astype(jnp.float32)
        xc = (xi + 0.5) * dx32 - half
        yc = (yi + 0.5) * dx32 - half
        b_loc = jnp.clip(b_idx - dir_offset, 0, B - 1)
        if dir_axis is not None:
            owns = (b_idx >= dir_offset) & (b_idx < dir_offset + B)
            ow = owns.astype(jnp.float32)
            b0 = jax.lax.psum(dirs[b_loc] * owns.astype(dt), dir_axis)
            c1row = jax.lax.psum(c1[b_loc] * ow, dir_axis)
            c2row = jax.lax.psum(c2[b_loc] * ow, dir_axis)
        else:
            b0, c1row, c2row = dirs[b_loc], c1[b_loc], c2[b_loc]
        a0 = (xc * c1row + yc * c2row).astype(dt)

        # ---- refinement #1 (h:245-248) ----
        # sqrt'd distance compared to dx, the oracle's metric form
        # (pipeline.py:265-267; numpy's **0.5 is bitwise sqrt) — the
        # squared comparison `d2 <= dx*dx` flips membership within one ulp
        # of the boundary in f64 parity mode.  The direction is
        # RENORMALIZED first exactly like the oracle's
        # points_close_to_line (bu = b / ||b||): a handful of table rows
        # (4/1281 at granularity 4) have b/||b|| bitwise-different from b,
        # so using the raw row can flip boundary membership in f64
        b0u = b0 / jnp.sqrt((b0 * b0).sum())
        m1 = s.active & (jnp.sqrt(_line_distance2(Xs, a0, b0u)) <= dx)
        ok0 = m1.any()
        rc1, a1, b1 = _masked_lsq(Xs, m1)
        ok1 = ok0 & (rc1 > 0.0)

        # ---- refinement #2 + vote gate (h:250-255) ----
        b1u = b1 / jnp.sqrt((b1 * b1).sum())
        m2 = s.active & (jnp.sqrt(_line_distance2(Xs, a1, b1u)) <= dx)
        nv = m2.sum().astype(jnp.int32)
        ok2 = ok1 & (nv >= cfg.opt_minvotes)
        rc2, a2, b2 = _masked_lsq(Xs, m2)
        ok3 = ok2 & (rc2 > 0.0)

        bc = _canonical_sign(b2)                      # D-SIGN
        a_w = a2 + shift
        P2 = Xs + shift                               # inliers in input frame

        # ---- per-point t / radius / gaps (h:261-307) ----
        dvec = P2 - a_w
        bb = jnp.maximum((bc * bc).sum(), 1e-30)
        t_all = (dvec * bc).sum(-1) / bb
        proj = a_w[None, :] + t_all[:, None] * bc[None, :]
        prad = jnp.sqrt(jnp.maximum(((proj - P2) ** 2).sum(-1), 0.0))
        bx_zero = bc[0] == 0.0                        # find_t failure (h:43-45)
        t = (proj[:, 0] - a_w[0]) / jnp.where(bx_zero, 1.0, bc[0])

        # Gap check over t-sorted order (h:285-292).  Two formulations with
        # identical results (ties have equal t, hence equal ||a + t b||, so
        # their relative order never changes the adjacent-gap maximum):
        #   * rank-matrix: stable ranks via one (N, N) pairwise pass — beat
        #     a sort up to a few thousand points where it was first tuned
        #     (crossover not yet re-measured on the GPU) but is O(N²) memory;
        #   * sort: O(N log N), the only viable shape for large sensors
        #     (128×128 ToF ⇒ N = 16k would need three 256M-cell matrices).
        tv = jnp.where(m2, t, jnp.inf)
        pn_all = jnp.sqrt(((a_w[None, :] + t[:, None] * bc[None, :]) ** 2).sum(-1))
        if N <= _GAP_RANK_MAX_N:
            row_i = jax.lax.broadcasted_iota(jnp.int32, (N, N), 0)
            col_j = jax.lax.broadcasted_iota(jnp.int32, (N, N), 1)
            before = (tv[None, :] < tv[:, None]) | (
                (tv[None, :] == tv[:, None]) & (col_j < row_i))
            rank = before.sum(axis=1).astype(jnp.int32)  # stable rank in t
            succ = (rank[None, :] == rank[:, None] + 1) & m2[:, None] & m2[None, :]
            gap_mat = jnp.where(succ, jnp.abs(pn_all[None, :] - pn_all[:, None]),
                                -jnp.inf)
            max_gap = jnp.where(nv > 1, gap_mat.max(), 0.0)
        else:
            order = jnp.argsort(tv)                      # inliers first (inf last)
            pn_s = pn_all[order]
            pair_ok = (jnp.arange(N - 1) + 1) < nv       # both ends inliers
            gaps = jnp.where(pair_ok, jnp.abs(pn_s[1:] - pn_s[:-1]), -jnp.inf)
            max_gap = jnp.where(nv > 1, gaps.max(), 0.0)

        ifirst = jnp.argmax(m2)
        ilast = N - 1 - jnp.argmax(m2[::-1])
        radius = jnp.maximum(prad[ifirst], prad[ilast])

        t_min = jnp.where(m2, t, jnp.inf).min()
        t_max = jnp.where(m2, t, -jnp.inf).max()
        t_min = jnp.where(nv > 0, t_min, 0.0)
        t_max = jnp.where(nv > 0, t_max, 0.0)

        # ---- acceptance gates (h:295-322) ----
        diffs = jnp.abs(radius - rs)
        k = jnp.argmin(diffs)                         # first strict min
        closest = rs[k]
        min_diff = diffs[k]
        max_radius = jnp.maximum(diffs[0], rs_max)    # reference quirk h:298-307
        gate_r = (min_diff < dv) & (max_radius <= closest) & (max_gap < 2.0 * dv)

        eig = _masked_cov_eigs(P2, m2)
        pca_coeff = eig[0] / jnp.maximum(eig.sum(), 1e-30)
        # oracle form exactly (pipeline.py:368-372): endpoints first, THEN
        # the difference — the algebraically equal |Δt·b| reordering
        # diverges at fp decision boundaries in f64 parity mode
        p1g = t_min * bc + a_w
        p2g = t_max * bc + a_w
        seg_len = jnp.sqrt(((p2g - p1g) ** 2).sum())
        min_nb = (2.0 * closest * seg_len / min_nb_denom).astype(jnp.int32)
        accept = gate_r & (pca_coeff > cfg.min_pca_coeff) & (nv > min_nb)

        failx = ok3 & bx_zero
        proceed = ok3 & ~bx_zero
        write = proceed & accept & (s.nout < L)

        slot = s.nout
        segs = s.segs

        def upd(arr, val):
            return jnp.where(write, arr.at[slot].set(val), arr)

        segs = SegmentBatch(
            a=upd(segs.a, a_w), b=upd(segs.b, bc),
            t_min=upd(segs.t_min, t_min), t_max=upd(segs.t_max, t_max),
            radius=upd(segs.radius, closest),
            points_size=upd(segs.points_size, nv),
            pca_coeff=upd(segs.pca_coeff, pca_coeff),
            pca_eigenvalues=upd(segs.pca_eigenvalues, eig),
            point_mask=upd(segs.point_mask, m2),
            valid=upd(segs.valid, True),
        )

        # Incremental removal (the reference's Hough::subtract, h:241) as
        # ONE 3-way branch (extra conds would copy the carry):
        # 0 = loop ending, keep; 1 = incremental update for the removed
        # points (typical: a line removes a few hundred points); 2 = rare
        # spill (> _SUB_CHUNK removed): exact rebuild from the next active
        # set.  Every branch leaves the state exact for the next argmax.
        n_rem = nv
        active_next = s.active & ~m2
        # Skip the update when THIS round is the last: `cond` is about to
        # exit (nlines quota hit, iteration bound, or <= 1 active point)
        # and the post-loop code never reads vstate — the final round's
        # decrement + suspect exam (or worse, a spill rebuild) was pure
        # discarded work, ~0.6 ms/frame of the g6 node loop.
        ending = (s.it + 1 >= it_bound) | (active_next.sum() <= 1)
        if cfg.opt_nlines > 0:
            ending |= s.nlines + ok3.astype(jnp.int32) >= cfg.opt_nlines
        branch = jnp.where(proceed & ~ending,
                           jnp.where(n_rem <= sub_chunk, 1, 2), 0)
        vstate_next = _vstate_update(s.vstate, branch, m2, n_rem, active_next)

        return _LoopState(
            it=s.it + 1,
            active=jnp.where(proceed, active_next, s.active),
            vstate=vstate_next,
            nlines=s.nlines + ok3.astype(jnp.int32),   # counts gate failures (h:259)
            nout=s.nout + write.astype(jnp.int32),
            stop=s.stop | ~proceed,
            fail=s.fail | failx,
            segs=segs,
        )

    active0 = valid & ~precheck_fail
    init = _LoopState(
        it=jnp.int32(0), active=active0, vstate=_vstate_init(active0),
        nlines=jnp.int32(0), nout=jnp.int32(0),
        stop=precheck_fail, fail=jnp.array(False),
        segs=empty_segments(L, N, dt))

    final = jax.lax.while_loop(cond, body, init)

    # frame abort (b.x == 0): keep earlier segments, report 0 lines (h:276-279)
    nlines = jnp.where(final.fail, 0, final.nlines)
    # explicit failure classification, shared with oracle.pipeline.STATUS_*
    status = jnp.where(degenerate, 1,
                       jnp.where(dx_too_large, 2,
                                 jnp.where(final.fail, 3, 0))).astype(jnp.int32)
    return HoughResult(segments=final.segs, nlines=nlines, status=status)


@partial(jax.jit, static_argnames=("cfg",))
def extract_lines_jit(points, valid, cfg: PipelineConfig) -> HoughResult:
    return extract_lines(points, valid, cfg)
