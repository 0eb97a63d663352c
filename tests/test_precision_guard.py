"""Every f32 matrix product on the device step asks for full precision.

On a GPU an f32 dot at default precision may run in TF32 (about three
decimal digits), which would break oracle parity.  The packed per-frame
step, the batched step and the direction-tensor-parallel step are lowered
for granularities 1/4/6 in both voting modes, and every f32
``dot_general`` in the lowered module must name HIGHEST; the vote
histogram's bf16 0/1 one-hots (exact with f32 accumulation) are the only
products allowed without it.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pointcloud_segmentation_tpu.config import StaticShapes, default_config
from pointcloud_segmentation_tpu.pipeline import (
    init_world, make_batched_process, make_process_frame_packed)

SHAPES = StaticShapes(max_raw_points=512, max_points=256,
                      max_world_segments=8)
_SIG = re.compile(r":\s*\((tensor<[^>]*>),\s*(tensor<[^>]*>)\)\s*->")


def _elem(t: str) -> str:
    return t[len("tensor<"):-1].split("x")[-1]


def unpinned_f32_dots(hlo: str) -> list:
    """dot_general ops with an f32 operand and no HIGHEST precision."""
    bad = []
    for line in hlo.splitlines():
        if "dot_general" not in line:
            continue
        m = _SIG.search(line)
        assert m, f"unparsed dot_general: {line.strip()}"
        if "f32" not in (_elem(m.group(1)), _elem(m.group(2))):
            continue
        if "precision = [HIGHEST, HIGHEST]" not in line:
            bad.append(line.strip())
    return bad


def _args(cfg, frames=None):
    lead = () if frames is None else (frames,)
    raw = jnp.zeros(lead + (cfg.shapes.max_raw_points, 3), jnp.float32)
    pos = jnp.zeros(lead + (3,), jnp.float32)
    quat = jnp.broadcast_to(jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                            lead + (4,))
    return init_world(cfg), raw, pos, quat


def _lower(kind, cfg):
    if kind == "packed":
        return make_process_frame_packed(cfg).lower(*_args(cfg))
    if kind == "batched":
        return make_batched_process(cfg).lower(*_args(cfg, frames=2))
    from pointcloud_segmentation_tpu.parallel import (
        make_mesh, make_tp_process_frame)

    mesh = make_mesh(n_batch=1, n_dir=2, devices=jax.devices()[:2])
    return make_tp_process_frame(cfg, mesh).lower(*_args(cfg))


@pytest.mark.parametrize("voting", ["carry", "lazy"])
@pytest.mark.parametrize("granularity", [1, 4, 6])
@pytest.mark.parametrize("kind", ["packed", "batched", "tp"])
def test_f32_dots_pin_highest(kind, granularity, voting):
    cfg = default_config(granularity=granularity, voting=voting,
                         shapes=SHAPES)
    hlo = _lower(kind, cfg).as_text()
    assert "dot_general" in hlo          # the guard saw the products
    assert unpinned_f32_dots(hlo) == []


def test_guard_flags_default_precision_dot():
    """The detector itself: a default-precision f32 matmul is flagged, a
    HIGHEST one and a bf16 one are not."""
    x = jnp.ones((4, 4), jnp.float32)
    plain = jax.jit(lambda a: a @ a).lower(x).as_text()
    high = jax.jit(lambda a: jnp.matmul(
        a, a, precision=jax.lax.Precision.HIGHEST)).lower(x).as_text()
    bf16 = jax.jit(lambda a: jnp.matmul(
        a.astype(jnp.bfloat16), a.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32)).lower(x).as_text()
    assert len(unpinned_f32_dots(plain)) == 1
    assert unpinned_f32_dots(high) == []
    assert unpinned_f32_dots(bf16) == []


@pytest.mark.gpu
def test_transform_segments_full_precision_on_gpu(gpu_device):
    """On the card, the drone->world transform keeps f32 accuracy (a TF32
    product would drift by ~1e-3 relative)."""
    from pointcloud_segmentation_tpu.ops.hough import empty_segments
    from pointcloud_segmentation_tpu.pipeline import transform_segments

    rng = np.random.default_rng(0)
    segs = empty_segments(16, 8)
    a = rng.normal(size=(16, 3)).astype(np.float32)
    b = rng.normal(size=(16, 3)).astype(np.float32)
    segs = segs._replace(a=jnp.asarray(a), b=jnp.asarray(b))
    q = np.array([0.9, 0.1, -0.3, 0.3])
    q = (q / np.linalg.norm(q)).astype(np.float32)
    pos = np.array([1.0, -2.0, 0.5], np.float32)
    with jax.default_device(gpu_device):
        out = jax.jit(transform_segments)(segs, jnp.asarray(pos),
                                          jnp.asarray(q))
    from pointcloud_segmentation_tpu.geometry import quat_to_rot

    R = np.array(quat_to_rot(*q.astype(np.float64)))
    np.testing.assert_allclose(np.asarray(out.a), a @ R.T + pos, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.b), b @ R.T, atol=1e-5)
