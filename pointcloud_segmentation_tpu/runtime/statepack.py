"""Bit-exact packing of a fixed-shape pytree into one uint32 vector.

The streaming engine's flush-cadence viz snapshots the whole world state
with ONE device->host read: ``make_pytree_packer`` builds the jitted
pack/unpack pair, ``make_host_unpacker`` decodes the packed vector on the
host without touching the device.  Float bits ride a uint32 bitcast both
ways, so the round trip is bit-identical, not merely close.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def _leaf_specs(tree):
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return [(tuple(l.shape), np.dtype(l.dtype)) for l in leaves], treedef


def _n_words(shape, dt) -> Tuple[int, int]:
    """(elements, uint32 words) of one leaf: 8-byte dtypes take two words."""
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    return n, (n * 2 if dt.itemsize == 8 else n)


def make_pytree_packer(tree) -> Tuple[Callable, Callable]:
    """(pack, unpack) for a fixed-shape pytree.

    ``pack(tree) -> uint32[N]`` (jitted) bitcasts every leaf to uint32
    words and concatenates.  ``unpack(uint32[N]) -> tree`` (jitted) is its
    inverse on device.  Built from a template tree; every later call must
    match its shapes/dtypes (the world state is fixed-capacity SoA)."""
    import jax
    import jax.numpy as jnp

    specs, treedef = _leaf_specs(tree)

    def _to_words(x):
        flat = x.ravel()
        if flat.dtype == jnp.bool_:
            return flat.astype(jnp.uint32)
        if flat.dtype.itemsize == 4:
            return jax.lax.bitcast_convert_type(flat, jnp.uint32)
        if flat.dtype.itemsize == 8:
            # (n, 2) uint32 words, C-order ravel keeps the pairing
            return jax.lax.bitcast_convert_type(flat, jnp.uint32).ravel()
        # 1/2-byte dtypes: widen (exact for the integer/bool leaves used)
        return flat.astype(jnp.uint32)

    @jax.jit
    def pack(t):
        return jnp.concatenate(
            [_to_words(x) for x in jax.tree_util.tree_leaves(t)])

    @jax.jit
    def unpack(vec):
        out = []
        off = 0
        for shape, dt in specs:
            n, w = _n_words(shape, dt)
            chunk = vec[off:off + w]
            off += w
            if dt == np.bool_:
                leaf = chunk.astype(jnp.bool_)
            elif dt.itemsize == 8:
                leaf = jax.lax.bitcast_convert_type(
                    chunk.reshape(n, 2), jnp.dtype(dt))
            elif dt.itemsize == 4:
                leaf = jax.lax.bitcast_convert_type(chunk, jnp.dtype(dt))
            else:
                leaf = chunk.astype(jnp.dtype(dt))
            out.append(leaf.reshape(shape))
        return jax.tree_util.tree_unflatten(treedef, out)

    return pack, unpack


def make_host_unpacker(tree) -> Callable:
    """Numpy twin of ``make_pytree_packer``'s ``unpack``: decode the packed
    uint32 snapshot entirely on the host — no device dispatch or read.

    The deferred-streaming flusher renders flush-cadence live viz from the
    single packed read (runtime/engine._emit_viz_flush) instead of one read
    per field.  Bit-exactness vs the device unpack (word pairing for 8-byte
    dtypes included) is pinned by tests/test_statepack.py."""
    import jax

    specs, treedef = _leaf_specs(tree)

    def unpack_host(vec: np.ndarray):
        vec = np.ascontiguousarray(np.asarray(vec, dtype=np.uint32))
        out, off = [], 0
        for shape, dt in specs:
            n, w = _n_words(shape, dt)
            chunk = np.ascontiguousarray(vec[off:off + w])
            off += w
            if dt == np.bool_:
                leaf = chunk.astype(np.bool_)
            elif dt.itemsize == 8:
                # (n, 2) uint32 -> raw bytes -> dt: little-endian word order
                # matches jax.lax.bitcast_convert_type's minor-dim layout
                leaf = chunk.reshape(n, 2).view(dt).ravel()
            elif dt.itemsize == 4:
                leaf = chunk.view(dt)
            else:
                leaf = chunk.astype(dt)
            out.append(leaf.reshape(shape))
        return jax.tree_util.tree_unflatten(treedef, out)

    return unpack_host
