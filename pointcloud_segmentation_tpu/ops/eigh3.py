"""Closed-form symmetric 3x3 eigendecomposition (accelerator-friendly).

The reference leans on Eigen's SelfAdjointEigenSolver (hough_3d_lines.h:141)
and PCL's PCA (h:103) for 3x3 problems.  Inside a jit'd ``lax.while_loop`` an
iterative LAPACK-style factorization is the wrong tool on an accelerator; the
3x3 symmetric case has an analytic solution (trigonometric / Smith's method)
that maps to a handful of elementwise ops and vmaps freely.

Eigenvalues are returned in DESCENDING order (the convention of PCL's
``pca.getEigenValues``, h:106-107).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_TWO_PI_3 = 2.0943951023931953  # 2*pi/3


def eigvalsh3(A: jnp.ndarray) -> jnp.ndarray:
    """Eigenvalues of a symmetric (..., 3, 3) matrix, descending."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2, 0.0) / 6.0)

    safe_p = jnp.where(p > 0, p, 1.0)
    b00, b11, b22 = d0 / safe_p, d1 / safe_p, d2 / safe_p
    b01, b02, b12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0

    e1 = q + 2.0 * p * jnp.cos(phi)
    e3 = q + 2.0 * p * jnp.cos(phi + _TWO_PI_3)
    e2 = 3.0 * q - e1 - e3
    # p == 0 -> A = q*I
    e1 = jnp.where(p > 0, e1, q)
    e2 = jnp.where(p > 0, e2, q)
    e3 = jnp.where(p > 0, e3, q)
    return jnp.stack([e1, e2, e3], axis=-1)


def _eigvec_for(A: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of symmetric 3x3 A for (approximately) simple
    eigenvalue lam, via the largest cross product of rows of (A - lam I).

    Falls back to e_x for fully degenerate inputs (direction undefined).
    """
    M = A - lam[..., None, None] * jnp.eye(3, dtype=A.dtype)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c0 = jnp.cross(r0, r1)
    c1 = jnp.cross(r0, r2)
    c2 = jnp.cross(r1, r2)
    n0 = (c0 * c0).sum(-1)
    n1 = (c1 * c1).sum(-1)
    n2 = (c2 * c2).sum(-1)
    ns = jnp.stack([n0, n1, n2], axis=-1)
    cs = jnp.stack([c0, c1, c2], axis=-2)
    best = jnp.argmax(ns, axis=-1)
    v = jnp.take_along_axis(cs, best[..., None, None].repeat(3, -1), axis=-2)[..., 0, :]
    nbest = jnp.take_along_axis(ns, best[..., None], axis=-1)[..., 0]
    good = nbest > 0
    v = jnp.where(good[..., None], v, jnp.array([1.0, 0.0, 0.0], dtype=A.dtype))
    denom = jnp.sqrt(jnp.maximum((v * v).sum(-1), 1e-38))
    return v / denom[..., None]


def principal_eigenvector3(A: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(largest eigenvalue, its unit eigenvector) of a symmetric 3x3 batch."""
    w = eigvalsh3(A)
    lam = w[..., 0]
    return lam, _eigvec_for(A, lam)


def eigh3(A: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full decomposition: (eigenvalues descending (...,3), eigenvectors (...,3,3)
    with eigenvectors in rows, row k for eigenvalue k)."""
    w = eigvalsh3(A)
    v0 = _eigvec_for(A, w[..., 0])
    v2 = _eigvec_for(A, w[..., 2])
    # middle eigenvector: orthogonal completion (robust when w1 is between)
    v1 = jnp.cross(v2, v0)
    n1 = jnp.sqrt(jnp.maximum((v1 * v1).sum(-1), 1e-38))
    v1 = v1 / n1[..., None]
    V = jnp.stack([v0, v1, v2], axis=-2)
    return w, V
