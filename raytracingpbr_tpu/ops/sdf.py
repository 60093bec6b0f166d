"""SDF primitive library.

Reference: ``/root/reference/src/sdf.py`` (distance functions after
iquilezles.org/articles/distfunctions) plus the neural-MLP bunny
(``/root/reference/examples/bunny/bunny_sdf_glass.py:150-203``).

Design (SURVEY.md §7.1): every ``sd_*`` takes ``p`` of shape ``(..., 3)`` and a
``(..., 3)`` parameter vector and returns ``(...,)`` distances — pure
``jax.numpy``, so they are batched, differentiable (analytic normals via
``jax.grad``) and fuse into the march loop under XLA/Pallas. Shape dispatch is
resolved at trace time (the scene's type list is static), mirroring the
reference's ``ti.static`` specialization (``src/scene.py:44-56``).
"""
from __future__ import annotations

import enum
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..core import struct
from ..core.math import radians, rotate_euler, safe_norm

MAX_DIS = 1e3  # src/config.py:23


class SHAPE(enum.IntEnum):
    """Shape ids; ``src/sdf.py:12-18`` plus the neural bunny."""

    NONE = 0
    SPHERE = 1
    BOX = 2
    CYLINDER = 3
    CONE = 4
    PLANE = 5
    BUNNY = 6


def sd_none(p, s):
    """Always-far dummy; ``src/sdf.py:21-23``."""
    return jnp.full(p.shape[:-1], MAX_DIS, p.dtype)


def sd_sphere(p, s):
    """Sphere of radius ``s.x``; ``src/sdf.py:26-28``."""
    return safe_norm(p) - s[..., 0]


def sd_round_box(p, s, round_radius=0.03):
    """Box with half-extents ``s``, rounded by ``round_radius``.

    The src/ engine bakes a 0.03 round radius into its box
    (``src/sdf.py:31-34``); examples use 0.01 (``cornell_box_v3/sdf.py:11``)
    or 0.0 (``cornell_box_shortest.py:45``) — see SURVEY.md §7.5. Use
    ``sd_box`` for the sharp variant.
    """
    q = jnp.abs(p) - s
    outside = safe_norm(jnp.maximum(q, 0.0))
    inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
    return outside + inside - round_radius


def sd_box(p, s):
    """Sharp box; ``cornell_box_shortest.py:43-46``."""
    return sd_round_box(p, s, 0.0)


def sd_cylinder(p, s):
    """Capped cylinder, radius ``s.x`` half-height ``s.y``; ``src/sdf.py:37-40``."""
    dxz = safe_norm(p[..., ::2])
    d = jnp.stack([dxz, p[..., 1]], -1)
    d = jnp.abs(d) - s[..., :2]
    return (jnp.minimum(jnp.max(d, axis=-1), 0.0)
            + safe_norm(jnp.maximum(d, 0.0)))


def sd_cone(p, s):
    """Infinite cone bound; ``src/sdf.py:43-46`` (rh.xz as axis params)."""
    q = safe_norm(p[..., ::2])
    d = s[..., 0] * q + s[..., 2] * p[..., 1]
    return jnp.maximum(d, -s[..., 1] - p[..., 1])


def sd_plane(p, s):
    """Horizontal plane at height ``s.y``; ``src/sdf.py:49-51``."""
    return p[..., 1] - s[..., 1]


# --- neural bunny -----------------------------------------------------------

_ASSET = os.path.join(os.path.dirname(__file__), "..", "..", "assets",
                      "bunny_mlp.npz")


@struct.dataclass
class BunnyMLP:
    """Sin-activated MLP encoding the Stanford bunny SDF.

    Weights extracted as data from the public shadertoy transcription in the
    reference (``bunny_sdf_glass.py:150-203``); see
    ``tools/extract_bunny_weights.py`` for the layout derivation. In the XLA
    path the two 16x16 layers are matmuls over the whole ray batch — the
    wavefront layout batches rays for free (SURVEY.md §7.4.6).
    """

    w_in: jax.Array   # (3, 16)
    b_in: jax.Array   # (16,)
    w_h1: jax.Array   # (16, 16)
    b_h1: jax.Array   # (16,)
    w_h2: jax.Array   # (16, 16)
    b_h2: jax.Array   # (16,)
    w_out: jax.Array  # (16,)
    bias_out: jax.Array  # ()


@functools.lru_cache(maxsize=1)
def _load_bunny_np():
    with np.load(os.path.normpath(_ASSET)) as z:
        return {k: np.array(z[k]) for k in z.files}


def load_bunny(dtype=jnp.float32) -> BunnyMLP:
    d = _load_bunny_np()
    return BunnyMLP(**{k: jnp.asarray(v, dtype) for k, v in d.items()})


def bunny_mlp_eval(mlp: BunnyMLP, p: jax.Array,
                   matmul_dtype=None) -> jax.Array:
    """Raw MLP distance (valid inside the unit sphere); ``(..., 3) -> (...)``.

    ``matmul_dtype`` optionally runs the two 16x16 contractions in bf16 with
    f32 accumulation; default keeps f32 for parity.
    """
    # f32 runs ask for full-precision contractions: DEFAULT f32 matmul
    # precision may round the inputs (TF32 on the GPU), which an SDF's
    # 1e-4 hit test cannot tolerate (see to_object_space). Explicit
    # matmul_dtype=bf16 opts into the single-pass path.
    prec = (jax.lax.Precision.HIGHEST if matmul_dtype is None
            else jax.lax.Precision.DEFAULT)
    w_h1, w_h2 = mlp.w_h1, mlp.w_h2
    if matmul_dtype is not None:
        w_h1 = w_h1.astype(matmul_dtype)
        w_h2 = w_h2.astype(matmul_dtype)
    f0 = jnp.sin(jnp.dot(p, mlp.w_in, precision=prec) + mlp.b_in)
    h1 = jnp.dot(f0.astype(w_h1.dtype), w_h1, precision=prec,
                 preferred_element_type=jnp.float32)
    f1 = jnp.sin(h1 + mlp.b_h1) + f0
    h2 = jnp.dot(f1.astype(w_h2.dtype), w_h2, precision=prec,
                 preferred_element_type=jnp.float32)
    f2 = jnp.sin(h2 + mlp.b_h2) / 1.4 + f1
    return jnp.dot(f2, mlp.w_out, precision=prec) + mlp.bias_out


def sd_bunny(p: jax.Array, mlp: BunnyMLP | None = None,
             matmul_dtype=None) -> jax.Array:
    """Bunny SDF with the unit-sphere guard; ``bunny_sdf_glass.py:151-155``:
    outside ``|p| > 1`` fall back to ``|p| - 0.8``."""
    if mlp is None:
        mlp = load_bunny(p.dtype)
    r = safe_norm(p)
    inner = bunny_mlp_eval(mlp, p, matmul_dtype)
    return jnp.where(r > 1.0, r - 0.8, inner)


# Dispatch table mirroring ``SHAPE_FUNC`` (src/sdf.py:54-61); used only at
# trace time (static unrolling), never with traced shape ids.
SHAPE_FUNC = {
    SHAPE.NONE: sd_none,
    SHAPE.SPHERE: sd_sphere,
    SHAPE.BOX: sd_round_box,
    SHAPE.CYLINDER: sd_cylinder,
    SHAPE.CONE: sd_cone,
    SHAPE.PLANE: sd_plane,
}


def to_object_space(p, position, matrix):
    """World point -> object frame: translate then rotate
    (``src/sdf.py:64-68`` — scale is an SDF parameter, never a space squeeze).

    ``p``: (..., 3); ``position``: (..., 3); ``matrix``: (..., 3, 3).

    Explicit multiply-add, NOT einsum: an f32 einsum at DEFAULT precision
    may round its inputs (TF32 on the GPU, bf16 elsewhere), which corrupts
    every SDF eval — a 0.4% relative error is enough to tunnel the XLA
    march through walls at hit_precision=1e-4. A length-3 contraction gains
    nothing from a matrix unit anyway.
    """
    q = p - position
    return jnp.sum(matrix * q[..., None, :], axis=-1)


def bake_matrices(rotation_deg: jax.Array) -> jax.Array:
    """Euler degrees (n, 3) -> baked rotation matrices (n, 3, 3);
    the reference's ``update_all_transform`` kernel (``src/scene.py:99-109``)."""
    return rotate_euler(radians(rotation_deg))


def tetrahedron_normal(sd_fn, p: jax.Array, h: float = 0.5773 * 0.005):
    """4-tap tetrahedron gradient estimate (``src/sdf.py:77-87``,
    iquilezles.org/articles/normalsSDF). Kept for parity tests; production
    normals are analytic ``jax.grad`` (SURVEY.md §7.2.2).

    ``sd_fn``: (..., 3) -> (...,) distance at a world/object point.
    """
    e = jnp.asarray(
        [[1.0, -1.0, -1.0], [-1.0, -1.0, 1.0], [-1.0, 1.0, -1.0],
         [1.0, 1.0, 1.0]], p.dtype)
    n = jnp.zeros_like(p)
    for k in range(4):
        ek = e[k]
        n = n + ek * sd_fn(p + ek * h)[..., None]
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)
