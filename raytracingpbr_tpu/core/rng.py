"""Deterministic counter-based RNG.

The reference uses Taichi's stateful per-thread RNG (``ti.random()``,
``src/util.py:53-62``) and leaves a ToDo for low-discrepancy sequences
(``src/util.py:64``). Under XLA we need an RNG that is

  * stateless (everything under ``jit`` is pure),
  * *shard-invariant*: pixel ``p`` draws the same numbers whether the image is
    rendered on 1 card or sharded over many (SURVEY.md §2.4, §7.4.4) — this
    is also what makes checkpoint/resume bit-exact,
  * vectorized: one elementwise pass produces randoms for the whole batch.

We use the pcg4d hash (Jarzynski & Olano, "Hash Functions for GPU Rendering",
JCGT 2020 — public domain construction): a 4-word counter
``(pixel_id, sample/frame, bounce/step, stream)`` hashes to 4 uniform words.
``jax.random`` threefry would also work but costs ~10x more per draw and
forces key plumbing through the scan carries; a counter hash is the standard
production-renderer design.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Python ints, cast at trace time — module import must not create device
# values (jax.distributed.initialize requires an uninitialized backend;
# see parallel/mesh.multihost_init).
_PCG_MULT = 1664525
_PCG_INC = 1013904223
# 1/2^24: map the top 24 bits of a uint32 to [0, 1).
_INV_2_24 = float(1.0 / (1 << 24))


def pcg4d(x: jax.Array, y: jax.Array, z: jax.Array, w: jax.Array):
    """pcg4d hash: 4 uint32 counters -> 4 uniform uint32 words."""
    x = x.astype(jnp.uint32)
    y = y.astype(jnp.uint32)
    z = z.astype(jnp.uint32)
    w = w.astype(jnp.uint32)

    mult = jnp.uint32(_PCG_MULT)
    inc = jnp.uint32(_PCG_INC)
    x = x * mult + inc
    y = y * mult + inc
    z = z * mult + inc
    w = w * mult + inc

    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z

    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)

    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return x, y, z, w


def _to_unit_float(u: jax.Array, dtype=jnp.float32) -> jax.Array:
    """uint32 -> [0, 1) float using the top 24 bits (exact in f32)."""
    return (u >> jnp.uint32(8)).astype(dtype) * jnp.asarray(_INV_2_24, dtype)


def uniform4(pixel_id: jax.Array, step, stream, seed=0, dtype=jnp.float32):
    """Four independent uniforms in [0,1) per counter.

    ``pixel_id``: int array (the batch); ``step``: scalar (sample/frame
    counter, may be traced); ``stream``: static int distinguishing use-sites
    within one step (roulette / jitter / lens / lobe / ...); ``seed``: global
    seed mixed into the 4th word.
    """
    step = jnp.asarray(step)
    a, b, c, d = pcg4d(
        pixel_id,
        jnp.broadcast_to(step, pixel_id.shape),
        jnp.full(pixel_id.shape, stream, jnp.uint32),
        jnp.full(pixel_id.shape, seed, jnp.uint32),
    )
    return (
        _to_unit_float(a, dtype),
        _to_unit_float(b, dtype),
        _to_unit_float(c, dtype),
        _to_unit_float(d, dtype),
    )


def uniform(pixel_id, step, stream, seed=0, dtype=jnp.float32):
    """One uniform per counter (first pcg4d word)."""
    return uniform4(pixel_id, step, stream, seed, dtype)[0]


# --- low-discrepancy sampler -------------------------------------------------
# Answers the reference's own ToDo (``src/util.py:64`` "Low Discrepancy
# Sequence"): the 4D R2 additive recurrence (Roberts 2018, "The Unreasonable
# Effectiveness of Quasirandom Sequences") in exact uint32 fixed-point
# arithmetic, randomized per (pixel, stream, seed) with a Cranley-Patterson
# rotation so every pixel sees an independent unbiased shift of the sequence.

# root of x^5 = x + 1 (generalized golden ratio for d=4)
_PHI4 = 1.1673039782614187
_R2_A = tuple(int(round(((1.0 / _PHI4) ** (k + 1) % 1.0) * 2.0**32))
              & 0xFFFFFFFF for k in range(4))
_R2_Y = 0x9E3779B9  # constant word for the rotation hash


def r2_uniform4(pixel_id: jax.Array, step, stream, seed=0,
                dtype=jnp.float32):
    """Four quasirandom uniforms in [0,1): the ``step``-th point of the 4D
    R2 sequence, Cranley-Patterson-rotated per (pixel, stream, seed).

    Drop-in signature-compatible with :func:`uniform4`; stratifies draws
    *across steps* for a fixed pixel (sub-pixel jitter, lens samples), so use
    it where the step index is a per-pixel sample counter. The wrap-around
    uint32 multiply-add is the exact fractional part, and the rotation hash
    does not consume ``step`` — shard- and checkpoint-invariance are
    inherited from the counter discipline.
    """
    step = jnp.asarray(step)
    n = jnp.broadcast_to(step, pixel_id.shape).astype(jnp.uint32)
    rot = pcg4d(
        pixel_id,
        jnp.full(pixel_id.shape, _R2_Y, jnp.uint32),
        jnp.full(pixel_id.shape, stream, jnp.uint32),
        jnp.full(pixel_id.shape, seed, jnp.uint32),
    )
    return tuple(_to_unit_float(rot[k] + n * jnp.uint32(_R2_A[k]), dtype)
                 for k in range(4))


def sampler4(low_discrepancy: bool):
    """Select the 4-uniform sampler for per-sample-indexed draws."""
    return r2_uniform4 if low_discrepancy else uniform4


# --- samplers (reference math: src/util.py) ---------------------------------


def in_unit_disk(u1: jax.Array, u2: jax.Array) -> jax.Array:
    """sqrt-radius concentric disk sample; ``src/util.py:13-18``.

    Returns (..., 2): ``sqrt(u1) * (sin a, cos a)`` with ``a = 2*pi*u2``.
    """
    a = u2 * (2.0 * jnp.pi)
    r = jnp.sqrt(u1)
    return jnp.stack([r * jnp.sin(a), r * jnp.cos(a)], axis=-1)


def in_unit_sphere(u1: jax.Array, u2: jax.Array) -> jax.Array:
    """Uniform direction on the unit sphere; ``src/util.py:21-28``.

    (The reference name says "in unit sphere" but the construction samples the
    *surface*: z uniform in [-1,1], azimuth uniform — we keep the behavior.)
    """
    z = 2.0 * u1 - 1.0
    a = u2 * (2.0 * jnp.pi)
    xy = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack([xy * jnp.sin(a), xy * jnp.cos(a), z], axis=-1)


def hemispheric(normal: jax.Array, u1: jax.Array, u2: jax.Array) -> jax.Array:
    """Cosine-weighted hemisphere about ``normal``; ``src/pbr.py:16-19``:
    normalize(normal + uniform_sphere_sample)."""
    v = in_unit_sphere(u1, u2)
    s = normal + v
    return s / jnp.linalg.norm(s, axis=-1, keepdims=True)
