"""Core pytree types.

XLA-native re-expression of the reference's Taichi structs
(``/root/reference/src/dataclass.py:5-46``). Where Taichi uses array-of-struct
fields (``Ray.field()``, ``src/fileds.py:7``), we use struct-of-arrays pytrees:
every field is a ``jax.Array`` with a leading batch dimension, so a "field of
rays" is just a ``Rays`` whose members have shape ``(N, 3)`` / ``(N,)``. This
is the layout XLA vectorizes and Pallas tiles (SURVEY.md §7.1).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import struct

# FrameState.hit_t sentinel: no surface recorded for this pixel yet
NO_HIT_T = 1e10


@struct.dataclass
class Rays:
    """Wavefront ray state; reference ``Ray`` struct (src/dataclass.py:5-10).

    ``depth`` carries the reference's sign convention: positive = alive path
    at that bounce depth, negative/zero = terminated path awaiting respawn
    (``src/pathtracer.py:29-36,53-62``).
    """

    origin: jax.Array     # (N, 3) f32
    direction: jax.Array  # (N, 3) f32
    color: jax.Array      # (N, 3) f32 — path throughput
    depth: jax.Array      # (N,)  i32

    @property
    def batch_shape(self):
        return self.depth.shape

    def at(self, t: jax.Array) -> jax.Array:
        """Point along the ray; ``src/util.py:8-10``."""
        return self.origin + t[..., None] * self.direction


def make_rays(n: int, dtype=jnp.float32) -> Rays:
    return Rays(
        origin=jnp.zeros((n, 3), dtype),
        direction=jnp.zeros((n, 3), dtype),
        color=jnp.zeros((n, 3), dtype),
        depth=jnp.zeros((n,), jnp.int32),
    )


@struct.dataclass
class Camera:
    """Thin-lens camera; reference ``Camera`` struct (src/dataclass.py:38-46).

    Scalar fields are 0-d arrays so the whole camera is a differentiable
    pytree (lookfrom/vfov/... gradients flow in inverse rendering).
    """

    lookfrom: jax.Array  # (3,)
    lookat: jax.Array    # (3,)
    vup: jax.Array       # (3,)
    vfov: jax.Array      # () degrees
    aspect: jax.Array    # ()
    aperture: jax.Array  # ()
    focus: jax.Array     # ()


def make_camera(
    lookfrom=(0.0, -0.2, 4.0),
    lookat=(0.0, -0.2, 3.0),
    vup=(0.0, 1.0, 0.0),
    vfov=35.0,
    aspect=16.0 / 9.0,
    aperture=0.01,
    focus=4.0,
    dtype=jnp.float32,
) -> Camera:
    """Defaults mirror the live app (src/camera.py:119-129, src/main.py:17)."""
    f = lambda v: jnp.asarray(v, dtype)
    return Camera(f(lookfrom), f(lookat), f(vup), f(vfov), f(aspect),
                  f(aperture), f(focus))


@struct.dataclass
class FrameState:
    """Persistent per-frame device state — the reference's field set
    (``src/fileds.py:7-25``) as one pytree.

    * ``rays``: wavefront ray state (ray_buffer).
    * ``accum``: (N, 4) rgb-sum + sample-count accumulator (image_buffer;
      alpha = number of completed samples, src/postprocessor.py:13-14).
    * ``frame``: u_frame counter (src/fileds.py:15).
    * ``diff_accum``/``noise``: adaptive-sampling noise estimate buffers
      (src/fileds.py:17-25); always allocated (cheap), only updated when
      ``cfg.adaptive_sampling``.
    * ``respawn``: per-pixel count of camera-ray respawns actually consumed —
      the sample index for the low-discrepancy camera sampler in the
      wavefront integrator (a pixel only advances its R2 sequence on the
      steps where its path finished, so the global step counter would not
      stratify). Counter-derived like everything else: shard- and
      checkpoint-invariant.
    """

    rays: Rays
    accum: jax.Array       # (N, 4)
    frame: jax.Array       # () i32
    diff_accum: jax.Array  # (N, 2)
    noise: jax.Array       # (N,)
    pixels: jax.Array      # (N, 3) last tonemapped output (for noise metric)
    respawn: jax.Array     # (N,) u32 per-pixel camera-sample counter
    # Primary-hit ray parameter per pixel (1e10 = miss/unknown), refreshed
    # every time the pixel's path respawns: the depth buffer that temporal
    # reprojection warps the accumulator with (ops/reproject.py — the
    # reference's own ToDo, src/renderer.py:22).
    hit_t: jax.Array       # (N,) f32
    # With cfg.env_sampling: MIS/partition weight applied to the path's sky
    # lookup this segment (1 = plain lookup). 0 after a diffuse bounce
    # (that radiance was banked exactly by NEE at the previous vertex —
    # ops/integrator._nee_env); the balance-heuristic complement after a
    # reflect bounce under cfg.mis_specular; 1 otherwise.
    sky_w: jax.Array       # (N,) f32
    # Split-march carry (cfg.march_split): packed (t, w, s, d) loop state
    # of an in-flight march segment, and the cumulative trips it has
    # consumed (0 = no segment in flight). Lets a wavefront step cap its
    # march at a small budget and resume deep segments next step instead
    # of stalling whole kernel blocks for up to max_raymarch iterations
    # (ops/integrator._trace_one_bounce).
    march_state: jax.Array  # (N, 4) f32
    march_cum: jax.Array    # (N,) i32


def make_frame_state(n: int, dtype=jnp.float32) -> FrameState:
    """Fresh state == the reference's ``refresh()`` (src/renderer.py:12-22)."""
    return FrameState(
        rays=make_rays(n, dtype),
        accum=jnp.zeros((n, 4), dtype),
        frame=jnp.zeros((), jnp.int32),
        diff_accum=jnp.ones((n, 2), dtype),
        noise=jnp.full((n,), 1e32, dtype),
        pixels=jnp.zeros((n, 3), dtype),
        respawn=jnp.zeros((n,), jnp.uint32),
        hit_t=jnp.full((n,), NO_HIT_T, dtype),
        sky_w=jnp.ones((n,), dtype),
        march_state=jnp.zeros((n, 4), dtype),
        march_cum=jnp.zeros((n,), jnp.int32),
    )


def refresh(state: FrameState) -> FrameState:
    """Reset accumulation after camera motion (src/renderer.py:12-22).

    Zeroes the accumulator, re-arms the wavefront (depth=0 forces respawn on
    the next step) and the adaptive-sampling buffers (diff=1, noise=1e32).
    ``respawn`` restarts at 0 so a fresh accumulation replays the R2 camera
    sequence from its best-stratified prefix (the pre-refresh estimate is
    discarded, so the reuse is harmless)."""
    return state.replace(
        rays=state.rays.replace(depth=jnp.zeros_like(state.rays.depth)),
        accum=jnp.zeros_like(state.accum),
        diff_accum=jnp.ones_like(state.diff_accum),
        noise=jnp.full_like(state.noise, 1e32),
        respawn=jnp.zeros_like(state.respawn),
        hit_t=jnp.full_like(state.hit_t, NO_HIT_T),
        sky_w=jnp.ones_like(state.sky_w),
        march_state=jnp.zeros_like(state.march_state),
        march_cum=jnp.zeros_like(state.march_cum),
    )
