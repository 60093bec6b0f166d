"""Math utilities (reference: ``/root/reference/src/util.py``).

All functions are batched: vectors are ``(..., 3)`` arrays and everything is
elementwise over the batch. No scalar loops.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# BT.601 luma weights; src/util.py:31-33.
_LUMA = (0.299, 0.587, 0.114)


def brightness(rgb: jax.Array) -> jax.Array:
    """Luma dot product; ``src/util.py:31-33``."""
    w = jnp.asarray(_LUMA, rgb.dtype)
    return jnp.sum(rgb * w, axis=-1)


def safe_norm(v: jax.Array, axis: int = -1) -> jax.Array:
    """Euclidean norm with a well-defined (zero) gradient at ``v = 0``.

    ``jnp.linalg.norm`` has a NaN gradient at the origin, which poisons
    ``jnp.where``-selected SDF branches under reverse-mode AD (the classic
    double-where problem) — every SDF distance formula routes through this.
    """
    sq = jnp.sum(v * v, axis=axis)
    pos = sq > 0
    safe = jnp.sqrt(jnp.where(pos, sq, 1.0))
    return jnp.where(pos, safe, 0.0)


def normalize(v: jax.Array, eps: float = 0.0) -> jax.Array:
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    if eps:
        n = jnp.maximum(n, eps)
    return v / n


def rotate_euler(angles: jax.Array) -> jax.Array:
    """Euler angles (radians, ``(..., 3)``) -> rotation matrix ``(..., 3, 3)``.

    Matches the reference composition Rz @ Ry @ Rx with its sign conventions
    (``src/util.py:36-42``): the resulting matrix is applied to
    *object-space-ify* a world point (``src/sdf.py:64-68``).

    Note: Taichi's ``mat3(a, b, c, ...)`` fills row-major, so
    ``mat3(c.z, s.z, 0, -s.z, c.z, 0, 0, 0, 1)`` has rows
    ``[cz, sz, 0], [-sz, cz, 0], [0, 0, 1]``.
    """
    s = jnp.sin(angles)
    c = jnp.cos(angles)
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    zero = jnp.zeros_like(sx)
    one = jnp.ones_like(sx)

    rz = jnp.stack([
        jnp.stack([cz, sz, zero], -1),
        jnp.stack([-sz, cz, zero], -1),
        jnp.stack([zero, zero, one], -1),
    ], -2)
    ry = jnp.stack([
        jnp.stack([cy, zero, -sy], -1),
        jnp.stack([zero, one, zero], -1),
        jnp.stack([sy, zero, cy], -1),
    ], -2)
    rx = jnp.stack([
        jnp.stack([one, zero, zero], -1),
        jnp.stack([zero, cx, sx], -1),
        jnp.stack([zero, -sx, cx], -1),
    ], -2)
    # full-precision 3x3 composition (DEFAULT f32 matmul precision may
    # round the inputs — TF32 on the GPU — and a 0.4% error in a rotation
    # matrix shears every object; see ops/sdf.to_object_space)
    hi = jax.lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(rz, ry, precision=hi), rx, precision=hi)


def sample_spherical_map(v: jax.Array) -> jax.Array:
    """Direction -> equirectangular uv in [0,1]^2; ``src/util.py:45-50``."""
    u = jnp.arctan2(v[..., 2], v[..., 0]) * (0.5 / jnp.pi) + 0.5
    w = jnp.arcsin(jnp.clip(v[..., 1], -1.0, 1.0)) * (1.0 / jnp.pi) + 0.5
    return jnp.stack([u, w], axis=-1)


def radians(deg):
    return jnp.asarray(deg) * (jnp.pi / 180.0)


def reflect(i: jax.Array, n: jax.Array) -> jax.Array:
    """GLSL reflect: i - 2*dot(n,i)*n."""
    return i - 2.0 * jnp.sum(n * i, axis=-1, keepdims=True) * n


def dot(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.sum(a * b, axis=-1)


def mix(a, b, t):
    """GLSL mix / lerp."""
    return a + (b - a) * t
