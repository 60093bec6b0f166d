"""Frame-granularity adaptive compaction.

With ``cfg.adaptive_sampling``, a converged pixel skips march work only if
its whole kernel block of lanes is inactive (``ops/march.march`` ``active``
gate) — scattered actives keep nearly every block hot. The fix: keep the
persistent ``FrameState`` in an ACTIVES-FIRST lane order so inactive lanes
pool into fully-dense blocks that exit immediately.

Design:
  * the whole state is packed into ONE wide f32 block (ints bitcast) and
    permuted with a single gather + one (N,) gather for pixel ids;
  * the active set drifts slowly (noise estimates move per frame), so
    recompacting every N frames amortizes that cost to noise level.
  Whether this pays on the GPU is not measured yet.

Correctness: the wavefront is lane-order-invariant — every per-pixel draw
is keyed on ``pixel_id`` (data, not position), deposits land in the lane's
own accumulator row, and split-march consumption is min(residual, budget)
independent of tile composition — so a compacted render produces
BIT-IDENTICAL per-pixel results (tests/test_compact.py); only execution
time changes. Callers display/save by scattering ``pixels`` through the
returned ``pixel_id`` (``scatter_pixels``).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.types import FrameState

# (leaf getter, columns, dtype) — packing schema; frame (scalar) excluded
_F32 = jnp.float32


def _leaves(state: FrameState):
    r = state.rays
    return [
        (r.origin, 3), (r.direction, 3), (r.color, 3),
        (r.depth, 1), (state.accum, 4), (state.diff_accum, 2),
        (state.noise, 1), (state.pixels, 3), (state.respawn, 1),
        (state.hit_t, 1), (state.sky_w, 1), (state.march_state, 4),
        (state.march_cum, 1),
    ]


def _as_cols(x):
    v = x if x.ndim == 2 else x[:, None]
    if v.dtype != _F32:
        v = jax.lax.bitcast_convert_type(v, _F32)
    return v


def pack_state(state: FrameState) -> jax.Array:
    """All per-lane leaves as one (N, 28) f32 block (ints bitcast)."""
    return jnp.concatenate(
        [_as_cols(x) for x, _ in _leaves(state)], axis=1)


def unpack_state(block: jax.Array, like: FrameState) -> FrameState:
    out = []
    o = 0
    for x, k in _leaves(like):
        v = block[:, o:o + k]
        o += k
        if x.dtype != _F32:
            v = jax.lax.bitcast_convert_type(v, x.dtype)
        out.append(v if x.ndim == 2 else v[:, 0])
    (origin, direction, color, depth, accum, diff_accum, noise, pixels,
     respawn, hit_t, sky_w, march_state, march_cum) = out
    return like.replace(
        rays=like.rays.replace(origin=origin, direction=direction,
                               color=color, depth=depth),
        accum=accum, diff_accum=diff_accum, noise=noise, pixels=pixels,
        respawn=respawn, hit_t=hit_t, sky_w=sky_w,
        march_state=march_state, march_cum=march_cum)


def actives_first_perm(active: jax.Array) -> jax.Array:
    """Stable counting partition: active lanes first. ``perm[new] = old``."""
    act = active.astype(jnp.int32)
    n_act = jnp.sum(act)
    pos = jnp.where(act == 1,
                    jnp.cumsum(act) - 1,
                    n_act + jnp.cumsum(1 - act) - 1)
    return jnp.zeros_like(pos).at[pos].set(
        jnp.arange(act.shape[0], dtype=jnp.int32))


@functools.partial(jax.jit, static_argnames=("noise_threshold",))
def compact_frame_state(state: FrameState, pixel_id: jax.Array,
                        noise_threshold: float
                        ) -> Tuple[FrameState, jax.Array]:
    """Permute the persistent state so noisy (active) pixels lead.

    ``pixel_id`` is the current lane->pixel map (``jnp.arange`` for a
    fresh state); returns the permuted state and map. Scheduling-neutral:
    per-pixel results are unchanged, only tile occupancy improves."""
    perm = actives_first_perm(state.noise > noise_threshold)
    block = pack_state(state)[perm]
    return unpack_state(block, state), pixel_id[perm]


def uncompact_frame_state(state: FrameState, pixel_id: jax.Array
                          ) -> FrameState:
    """Return the state to raster lane order (lane i = pixel i) — the
    canonical order for checkpoints and non-compacting consumers."""
    block = pack_state(state)
    inv = jnp.zeros((block.shape[0],), jnp.int32).at[
        pixel_id.astype(jnp.int32)].set(
        jnp.arange(block.shape[0], dtype=jnp.int32))
    return unpack_state(block[inv], state)


def scatter_pixels(pixels, pixel_id, cfg):
    """Invert the lane->pixel map for display: flat raster-order (N, 3)."""
    import numpy as np
    out = np.empty((cfg.num_pixels, 3), np.asarray(pixels).dtype)
    out[np.asarray(pixel_id)] = np.asarray(pixels)
    return out
