"""runtime/statepack.py: the bit-exact world-state snapshot that the
deferred-streaming flusher reads once per flush for live viz.  Device
pack/unpack and the host-side unpacker must round-trip every leaf bit for
bit, adversarial float patterns and 8-byte word pairing included.
"""

import time

import numpy as np

import jax
import jax.numpy as jnp

from pointcloud_segmentation_tpu.config import default_config, StaticShapes
from pointcloud_segmentation_tpu.runtime import SegmentationEngine
from pointcloud_segmentation_tpu.runtime import statepack
from pointcloud_segmentation_tpu.io.scene import (
    OBS_TESTS_SCENE, WP_TESTS, trajectory_poses)
from pointcloud_segmentation_tpu.io.simulator import simulate_trajectory, TofSpec
from pointcloud_segmentation_tpu.worldmap import WorldState, init_world

import pytest

CFG = default_config(
    granularity=2,
    shapes=StaticShapes(max_raw_points=4096, max_points=2048,
                        max_world_segments=32),
)


@pytest.fixture()
def frames():
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:8]
    return simulate_trajectory(OBS_TESTS_SCENE, poses,
                               TofSpec(noise_frac=0.002), seed=1)


def _rand_state(cfg, seed=7):
    """A WorldState with adversarial bit patterns (negative zeros, denormals,
    NaN payloads survive a BIT-exact snapshot; a value-level copy would not
    distinguish them)."""
    rng = np.random.default_rng(seed)
    S = cfg.shapes.max_world_segments
    f = np.float32
    a = rng.normal(size=(S, 3)).astype(f)
    a[0, 0] = np.float32(-0.0)
    a[1, 1] = np.float32(1e-42)            # denormal
    inter = rng.normal(size=(S, S, 2)).astype(f)
    inter[2, 3, 0] = np.nan
    return WorldState(
        a=jnp.asarray(a), b=jnp.asarray(rng.normal(size=(S, 3)).astype(f)),
        t_min=jnp.asarray(rng.normal(size=S).astype(f)),
        t_max=jnp.asarray(rng.normal(size=S).astype(f)),
        radius=jnp.asarray(rng.normal(size=S).astype(f)),
        points_size=jnp.asarray(
            rng.integers(-2**31, 2**31 - 1, size=S, dtype=np.int32)),
        pca_coeff=jnp.asarray(rng.normal(size=S).astype(f)),
        pca_eigenvalues=jnp.asarray(rng.normal(size=(S, 3)).astype(f)),
        valid=jnp.asarray(rng.integers(0, 2, size=S).astype(bool)),
        count=jnp.int32(17),
        inter=jnp.asarray(inter))


def _assert_state_bit_equal(x: WorldState, y: WorldState):
    for name in WorldState._fields:
        xa, ya = np.asarray(getattr(x, name)), np.asarray(getattr(y, name))
        assert xa.dtype == ya.dtype and xa.shape == ya.shape, name
        if xa.dtype.kind == "f":
            np.testing.assert_array_equal(
                xa.view(np.uint32 if xa.dtype.itemsize == 4 else np.uint64),
                ya.view(np.uint32 if xa.dtype.itemsize == 4 else np.uint64),
                err_msg=name)
        else:
            np.testing.assert_array_equal(xa, ya, err_msg=name)


def test_packer_roundtrip_bit_exact():
    st = _rand_state(CFG)
    pack, unpack = statepack.make_pytree_packer(st)
    vec = np.asarray(pack(st))
    assert vec.dtype == np.uint32 and vec.ndim == 1
    # the snapshot round-trips through HOST memory — include it
    _assert_state_bit_equal(st, unpack(jnp.asarray(vec)))


def test_packer_roundtrip_f64():
    """x64 leaves ride 2 uint32 words each; pairing must survive ravel."""
    with jax.enable_x64(True):
        st = init_world(CFG, dtype=jnp.float64)
        st = st._replace(
            a=st.a.at[0, 0].set(-0.0),
            t_min=st.t_min.at[1].set(np.nextafter(np.float64(1.0), 2.0)))
        pack, unpack = statepack.make_pytree_packer(st)
        vec = np.asarray(pack(st))
        back = unpack(jnp.asarray(vec))
        for name in WorldState._fields:
            xa, ya = np.asarray(getattr(st, name)), np.asarray(
                getattr(back, name))
            assert xa.dtype == ya.dtype, name
            if xa.dtype.kind == "f":
                np.testing.assert_array_equal(
                    xa.view(np.uint64), ya.view(np.uint64), err_msg=name)
            else:
                np.testing.assert_array_equal(xa, ya, err_msg=name)


def test_host_unpacker_bit_exact():
    """statepack.make_host_unpacker (flush-cadence viz decode) must agree with
    the device unpack bit-for-bit, adversarial float patterns included."""
    st = _rand_state(CFG)
    pack, _ = statepack.make_pytree_packer(st)
    unpack_host = statepack.make_host_unpacker(st)
    back = unpack_host(np.asarray(pack(st)))
    assert all(isinstance(np.asarray(getattr(back, n)), np.ndarray)
               for n in WorldState._fields)
    _assert_state_bit_equal(st, back)


def test_host_unpacker_f64_word_pairing():
    """8-byte leaves ride 2 uint32 words each; the host view() decode must
    pair them exactly like jax.lax.bitcast_convert_type's minor-dim layout."""
    with jax.enable_x64(True):
        st = init_world(CFG, dtype=jnp.float64)
        st = st._replace(
            a=st.a.at[0, 0].set(-0.0),
            t_min=st.t_min.at[1].set(np.nextafter(np.float64(1.0), 2.0)))
        pack, _ = statepack.make_pytree_packer(st)
        back = statepack.make_host_unpacker(st)(np.asarray(pack(st)))
        for name in WorldState._fields:
            xa, ya = np.asarray(getattr(st, name)), np.asarray(
                getattr(back, name))
            assert xa.dtype == ya.dtype, name
            if xa.dtype.kind == "f":
                np.testing.assert_array_equal(
                    xa.view(np.uint64), ya.view(np.uint64), err_msg=name)
            else:
                np.testing.assert_array_equal(xa, ya, err_msg=name)


def test_deferred_stream_matches_replay(frames):
    """The deferred-streaming worker backfills every record from its
    batched readbacks (no -1 sentinels survive stop()), and the final map
    is bit-identical to a synchronous replay of the same frames."""
    eng = SegmentationEngine(CFG, backend="jax", stream_sync_every=3)
    assert eng._stream_deferred
    eng.start()
    for fr in frames:
        target = (eng.frames_processed + eng.frames_skipped_no_pose
                  + eng.frames_failed + 1)
        eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
        eng.submit_cloud(fr.t, fr.points)
        deadline = time.time() + 60
        while (eng.frames_processed + eng.frames_skipped_no_pose
               + eng.frames_failed) < target and time.time() < deadline:
            time.sleep(0.002)
    eng.stop()
    assert eng.frames_processed == len(frames)
    assert all(r["seg_vec_size"] >= 0 and r["nblines"] >= 0
               for r in eng.records)
    ref = SegmentationEngine(CFG, backend="jax")
    recs_ref = ref.run_replay(frames)
    assert [r["seg_vec_size"] for r in eng.records] == \
        [r["seg_vec_size"] for r in recs_ref]
    _assert_state_bit_equal(ref._state, eng._state)
