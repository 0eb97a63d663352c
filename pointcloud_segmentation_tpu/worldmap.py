"""Persistent world-map state: segment fusion + pairwise intersections (JAX).

XLA-native rebuild of the reference's `world_segments` /
`intersection_matrix` state and segFiltering pass (node.cpp:479-667): a
fixed-capacity structure-of-arrays with a validity mask replaces the growing
std::vector; the triangular tuple matrix becomes an (S, S, 2) array with the
same (-1, -1) sentinel.

Semantics mirrored from the reference (and the numpy oracle, which is the
executable spec — oracle/pipeline.py):
  * new segments are matched against the *frame-start* world set; a later
    match overwrites an earlier fusion into the same slot (node.cpp:491-510);
  * fusion = projection similarity + weighted blend (node.cpp:596-667) with
    deviations D-WEIGHT / D-FUSE;
  * intersections are recomputed only for pairs touching a modified or newly
    appended segment (D-NEWIDX fixes the reference's index bookkeeping), and
    stale entries persist until overwritten (node.cpp:531-534).

The per-frame fusion is order-dependent (first-match-wins with in-frame
mutation), but every segment matches against the FRAME-START world set, so
the hot path (`fuse_frame`) vectorizes the similarity + fusion math for all
L frame segments at once and resolves the order dependence in closed form:
append slots via an exclusive prefix sum, repeated fuses into one slot via
a last-writer-wins scatter.  A literal unrolled sequential twin
(`fuse_frame_sequential`) is kept as the executable spec and fuzzed
bit-identical (tests/test_worldmap_jax.py).  Intersections are one batched
(S, S) component-plane Cramer solve.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import PipelineConfig
from .ops.hough import SegmentBatch


class WorldState(NamedTuple):
    """World segment store + intersection matrix (node.cpp:136-138)."""

    a: jnp.ndarray               # (S, 3)
    b: jnp.ndarray               # (S, 3)  (NOT necessarily unit after fusion)
    t_min: jnp.ndarray           # (S,)
    t_max: jnp.ndarray           # (S,)
    radius: jnp.ndarray          # (S,)
    points_size: jnp.ndarray     # (S,) int32
    pca_coeff: jnp.ndarray       # (S,)
    pca_eigenvalues: jnp.ndarray  # (S, 3)
    valid: jnp.ndarray           # (S,) bool
    count: jnp.ndarray           # int32
    inter: jnp.ndarray           # (S, S, 2), sentinel (-1, -1)

    @property
    def capacity(self) -> int:
        return self.a.shape[0]


def init_world(cfg: PipelineConfig, dtype=None) -> WorldState:
    if dtype is None:
        dtype = jnp.float64 if cfg.compute_dtype == "float64" else jnp.float32
    S = cfg.shapes.max_world_segments
    return WorldState(
        a=jnp.zeros((S, 3), dtype), b=jnp.zeros((S, 3), dtype),
        t_min=jnp.zeros((S,), dtype), t_max=jnp.zeros((S,), dtype),
        radius=jnp.zeros((S,), dtype),
        points_size=jnp.zeros((S,), jnp.int32),
        pca_coeff=jnp.zeros((S,), dtype),
        pca_eigenvalues=jnp.zeros((S, 3), dtype),
        valid=jnp.zeros((S,), bool), count=jnp.int32(0),
        inter=jnp.full((S, S, 2), -1.0, dtype))


def _endpoints(a, b, t_min, t_max):
    return t_min[..., None] * b + a, t_max[..., None] * b + a


def _proj_onto(a, b, p):
    """Project p (broadcastable) onto line(s) a + t*b; safe for b == 0."""
    bb = jnp.maximum((b * b).sum(-1), 1e-30)
    t = ((p - a) * b).sum(-1) / bb
    return a + t[..., None] * b


def _similarity_one(cfg: PipelineConfig, d, w):
    """Vectorized checkSimilarity of one drone segment against all world
    slots (node.cpp:596-667).  `d` is a dict of scalars/(3,) vectors; `w` a
    dict of (S,)/(S,3) arrays.  Returns (sim (S,), fused dict of (S,...))."""
    w_p1, w_p2 = _endpoints(w["a"], w["b"], w["t_min"], w["t_max"])
    d_p1 = d["t_min"] * d["b"] + d["a"]
    d_p2 = d["t_max"] * d["b"] + d["a"]

    proj1 = _proj_onto(w["a"], w["b"], d_p1[None, :])
    proj2 = _proj_onto(w["a"], w["b"], d_p2[None, :])

    eps = d["radius"] + w["radius"] + 2.0 * (2.0 * cfg.diag_voxel)
    dist1 = jnp.sqrt(jnp.maximum(((proj1 - d_p1) ** 2).sum(-1), 0.0))
    dist2 = jnp.sqrt(jnp.maximum(((proj2 - d_p2) ** 2).sum(-1), 0.0))
    cond1 = (dist1 < eps) & (dist2 < eps) & (d["radius"] == w["radius"])

    # D-WEIGHT: real-valued ratio
    ft = w["pca_coeff"].dtype
    wt = d["points_size"].astype(ft) / jnp.maximum(
        (w["points_size"] + d["points_size"]).astype(ft), 1.0)
    wt = jnp.maximum(jnp.asarray(cfg.min_weight, ft), wt)
    denom = w["pca_coeff"] * (1.0 - wt) + d["pca_coeff"] * wt
    coeff = (d["pca_coeff"] * wt) / jnp.where(denom != 0, denom, 1.0)

    new_a = proj1 + coeff[:, None] * (d_p1[None, :] - proj1)
    new_b = (proj2 - proj1) + coeff[:, None] * (
        (d_p2[None, :] - proj2) - (d_p1[None, :] - proj1))

    # t of the 4 endpoint projections on the candidate line, x-division quirk
    def t_of(p):
        pp = _proj_onto(new_a, new_b, p)
        bx = new_b[:, 0]
        return (pp[:, 0] - new_a[:, 0]) / jnp.where(bx != 0, bx, jnp.nan)

    t1, t2 = t_of(d_p1[None, :]), t_of(d_p2[None, :])
    t3, t4 = t_of(w_p1), t_of(w_p2)
    finite = (jnp.isfinite(t1) & jnp.isfinite(t2)
              & jnp.isfinite(t3) & jnp.isfinite(t4))
    no_overlap = (jnp.minimum(t1, t2) > jnp.maximum(t3, t4)) | (
        jnp.maximum(t1, t2) < jnp.minimum(t3, t4))
    sim = cond1 & finite & ~no_overlap

    ts = jnp.stack([t1, t2, t3, t4], axis=-1)
    fused = {
        "a": new_a,
        "b": new_b,
        "t_min": jnp.where(finite, ts.min(-1), 0.0),
        "t_max": jnp.where(finite, ts.max(-1), 0.0),
        "radius": jnp.broadcast_to(d["radius"], sim.shape),
        # D-FUSE: blend against the world segment's fields
        "points_size": w["points_size"] + d["points_size"],
        "pca_coeff": w["pca_coeff"] * (1.0 - wt) + d["pca_coeff"] * wt,
        "pca_eigenvalues": (w["pca_eigenvalues"] * (1.0 - wt[:, None])
                            + d["pca_eigenvalues"][None, :] * wt[:, None]),
    }
    return sim, fused


_FUSE_KEYS = ("a", "b", "t_min", "t_max", "radius", "points_size",
              "pca_coeff", "pca_eigenvalues")


def _frame_seg_dicts(segs: SegmentBatch) -> dict:
    return {
        "a": segs.a, "b": segs.b, "t_min": segs.t_min,
        "t_max": segs.t_max, "radius": segs.radius,
        "points_size": segs.points_size,
        "pca_coeff": segs.pca_coeff,
        "pca_eigenvalues": segs.pca_eigenvalues,
    }


def fuse_frame(state: WorldState, segs: SegmentBatch, cfg: PipelineConfig):
    """First-match-wins fusion of a frame's segments (vectorized).

    The reference fuses sequentially (node.cpp:491-510), but every segment
    matches against the FRAME-START world set, so the similarity + fusion
    math for all L segments is one batched computation; only the slot
    bookkeeping is order-dependent, and that collapses to closed form:
    append slots are an exclusive prefix sum of the append flags, and a
    later fuse into the same slot overwriting an earlier one becomes a
    last-writer-wins scatter.  Bit-identical to `fuse_frame_sequential`
    (fuzzed in tests/test_worldmap_jax.py) at a fraction of the op count —
    the unrolled 24-step chain cost ~1.3 ms/frame of the g4 node loop.

    Returns (new_state_fields dict, count, valid, modified (S,) bool,
    new_flags (S,) bool, slots (L,) int32).
    """
    S = state.capacity
    L = segs.capacity

    old = {k: getattr(state, k) for k in _FUSE_KEYS}
    old_valid = state.valid
    d_all = _frame_seg_dicts(segs)

    # One batched similarity + candidate-fusion pass vs the frame-start world.
    sim_all, fused_all = jax.vmap(
        lambda d: _similarity_one(cfg, d, old))(d_all)    # (L,S), {(L,S,...)}
    sim_all = sim_all & old_valid[None, :]

    dvalid = segs.valid
    found = sim_all.any(axis=1) & dvalid                   # (L,)
    j = jnp.argmax(sim_all, axis=1).astype(jnp.int32)      # (L,) first match

    # Append bookkeeping: the sequential count saturates at S, but while it
    # is below S every append flag is taken, so the un-saturated exclusive
    # cumsum + `< S` test reproduces it exactly.
    append_flag = dvalid & ~found
    inc = append_flag.astype(jnp.int32)
    counts_before = state.count + jnp.cumsum(inc) - inc    # (L,) exclusive
    can_append = append_flag & (counts_before < S)
    k = jnp.minimum(counts_before, S - 1).astype(jnp.int32)
    count = state.count + can_append.sum().astype(jnp.int32)

    slot = jnp.where(found, j, jnp.where(can_append, k, -1))  # (L,)
    write = found | can_append

    # Fused writes can collide (two frame segments matching the same world
    # slot): the LAST writer wins, mirroring the sequential overwrite.
    # Append slots are unique and disjoint from fused slots (appends target
    # indices >= frame-start count; every valid slot is below it).
    ii = jnp.arange(L, dtype=jnp.int32)
    later_same = (slot[None, :] == slot[:, None]) & (
        ii[None, :] > ii[:, None]) & write[None, :]
    winner = write & ~later_same.any(axis=1)
    tgt = jnp.where(winner, slot, S)                       # S -> dropped

    new = {}
    for key in _FUSE_KEYS:
        fused_rows = fused_all[key][ii, j]                 # (L,) / (L,3)
        vals = jnp.where(
            found if fused_rows.ndim == 1 else found[:, None],
            fused_rows, d_all[key])
        new[key] = old[key].at[tgt].set(vals, mode="drop")

    modified = jnp.zeros(S, bool).at[
        jnp.where(found, j, S)].set(True, mode="drop")
    new_flags = jnp.zeros(S, bool).at[
        jnp.where(can_append, k, S)].set(True, mode="drop")
    valid = old_valid | new_flags
    return new, count, valid, modified, new_flags, slot


def fuse_frame_sequential(state: WorldState, segs: SegmentBatch,
                          cfg: PipelineConfig):
    """The literal sequential fusion loop (node.cpp:491-510 semantics).

    Kept as the executable spec twin of the vectorized `fuse_frame`; the
    fuzz test asserts bit-identical outputs.  Not used on the hot path.
    """
    S = state.capacity
    L = segs.capacity

    old = {k: getattr(state, k) for k in _FUSE_KEYS}
    old_valid = state.valid

    new = dict(old)
    carry = (new, state.count, jnp.zeros(S, bool), jnp.zeros(S, bool),
             jnp.full((L,), -1, jnp.int32))

    def body(i, carry):
        new, count, modified, new_flags, slots = carry
        d = {k: v[i] for k, v in _frame_seg_dicts(segs).items()}
        dvalid = segs.valid[i]
        sim, fused = _similarity_one(cfg, d, old)   # match vs frame-start world
        sim = sim & old_valid
        found = sim.any() & dvalid
        j = jnp.argmax(sim).astype(jnp.int32)

        # fuse in place at j
        def write_fused(arr, val):
            return jnp.where(found, arr.at[j].set(val[j]), arr)

        # or append at `count`
        can_append = dvalid & ~found & (count < S)
        k = jnp.minimum(count, S - 1)

        def write_new(arr, val):
            return jnp.where(can_append, arr.at[k].set(val), arr)

        upd = {}
        for key in _FUSE_KEYS:
            arr = write_fused(new[key], fused[key])
            arr = write_new(arr, d[key])
            upd[key] = arr
        modified = modified.at[j].set(modified[j] | found)
        new_flags = new_flags.at[k].set(new_flags[k] | can_append)
        slot = jnp.where(found, j, jnp.where(can_append, k, -1))
        slots = slots.at[i].set(slot)
        count = count + can_append.astype(jnp.int32)
        return (upd, count, modified, new_flags, slots)

    for i in range(L):
        carry = body(i, carry)
    new, count, modified, new_flags, slots = carry
    valid = old_valid | new_flags
    return new, count, valid, modified, new_flags, slots


def update_intersections(state_fields: dict, valid, inter_old, touched,
                         cfg: PipelineConfig):
    """Batched checkConnections over touched pairs (node.cpp:519-537, 554-584).

    Pair (i, j), j < i: seg_i plays `drone_seg`, seg_j plays `world_seg`.

    Everything is computed on per-component (S, S) planes rather than
    (S, S, 3) / (S, S, 3, 3) stacks: a trailing minor dim of 3 (or (3, 3))
    pads badly on tiled device layouts, so the stacked formulation moved
    many times the useful bytes.  The arithmetic (cross products, dots, Cramer solve) is
    written in exactly the stacked form's operation order, so results are
    bit-identical.
    """
    a, b = state_fields["a"], state_fields["b"]
    t_min, t_max = state_fields["t_min"], state_fields["t_max"]
    radius = state_fields["radius"]
    S = a.shape[0]

    p1 = t_min[:, None] * b + a                     # (S, 3)
    p1x, p1y, p1z = p1[:, 0], p1[:, 1], p1[:, 2]
    bx, by, bz = b[:, 0], b[:, 1], b[:, 2]

    def pair_planes(u):
        return u[:, None], u[None, :]               # value at seg_i / seg_j

    bix, bjx = pair_planes(bx)
    biy, bjy = pair_planes(by)
    biz, bjz = pair_planes(bz)

    # cross[i, j] = b_j x b_i
    cx = bjy * biz - bjz * biy
    cy = bjz * bix - bjx * biz
    cz = bjx * biy - bjy * bix
    cn = jnp.sqrt(jnp.maximum((cx * cx + cy * cy) + cz * cz, 0.0))
    parallel = cn < 1e-2
    cns = jnp.maximum(cn, 1e-30)
    nx, ny, nz = cx / cns, cy / cns, cz / cns       # nhat

    i_idx = jax.lax.broadcasted_iota(jnp.int32, (S, S), 0)
    j_idx = jax.lax.broadcasted_iota(jnp.int32, (S, S), 1)
    pair = (j_idx < i_idx) & valid[:, None] & valid[None, :] & (
        touched[:, None] | touched[None, :]) & ~parallel

    # Cramer solve of [b_i, -b_j, nhat] [t_i, t_j, d]^T = p1_j - p1_i
    # (columns per node.cpp:568), all on (S, S) planes.
    rx = p1x[None, :] - p1x[:, None]
    ry = p1y[None, :] - p1y[:, None]
    rz = p1z[None, :] - p1z[:, None]

    # cx12 = (-b_j) x nhat
    c12x = (-bjy) * nz - (-bjz) * ny
    c12y = (-bjz) * nx - (-bjx) * nz
    c12z = (-bjx) * ny - (-bjy) * nx
    det = (bix * c12x + biy * c12y) + biz * c12z
    ok = pair & (det != 0.0)
    inv = jnp.where(ok, 1.0, jnp.nan) / jnp.where(det != 0.0, det, 1.0)
    x0 = ((rx * c12x + ry * c12y) + rz * c12z) * inv
    # c20 = nhat x b_i
    c20x = ny * biz - nz * biy
    c20y = nz * bix - nx * biz
    c20z = nx * biy - ny * bix
    x1 = ((rx * c20x + ry * c20y) + rz * c20z) * inv
    # c01 = b_i x (-b_j)
    c01x = biy * (-bjz) - biz * (-bjy)
    c01y = biz * (-bjx) - bix * (-bjz)
    c01z = bix * (-bjy) - biy * (-bjx)
    x2 = ((rx * c01x + ry * c01y) + rz * c01z) * inv

    dist = jnp.abs(x2)
    tmin_i, tmax_i = t_min[:, None], t_max[:, None]
    tmin_j, tmax_j = t_min[None, :], t_max[None, :]
    eps = 2.0 * cfg.diag_voxel + radius[:, None] + radius[None, :]
    in_i = (x0 + tmin_i >= tmin_i) & (x0 + tmin_i <= tmax_i)
    in_j = (x1 + tmin_j >= tmin_j) & (x1 + tmin_j <= tmax_j)
    finite = jnp.isfinite(x0) & jnp.isfinite(x1) & jnp.isfinite(x2)
    conn = pair & in_i & in_j & (dist < eps) & finite

    vals = jnp.stack([tmin_i + x0, tmin_j + x1], axis=-1)
    # write only on connection; stale entries persist (node.cpp:531-534)
    return jnp.where(conn[..., None], vals, inter_old)


def world_step(state: WorldState, segs: SegmentBatch,
               cfg: PipelineConfig) -> tuple[WorldState, jnp.ndarray]:
    """One segFiltering pass: fuse the frame's segments, refresh intersections.

    Returns (state, slots) where slots (L,) gives each frame segment's world
    slot (-1 = dropped), for host-side visualization bookkeeping.
    """
    fields, count, valid, modified, new_flags, slots = fuse_frame(state, segs, cfg)
    touched = modified | new_flags
    inter = update_intersections(fields, valid, state.inter, touched, cfg)
    return WorldState(valid=valid, count=count, inter=inter, **fields), slots
