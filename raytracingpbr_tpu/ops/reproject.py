"""Temporal reprojection of the progressive accumulator.

Implements the reference's own ToDo (``src/renderer.py:22`` "# ToDo:
Reprojection"): when the camera moves, the reference zeroes the accumulator
and restarts from one sample per pixel (``src/renderer.py:12-27``). Here the
old accumulation is forward-warped into the new view instead:

1. reconstruct each pixel's primary surface point from the OLD camera's
   pixel-center ray and the per-pixel primary-hit depth recorded by the
   wavefront integrator (``FrameState.hit_t``);
2. project it through the NEW camera (pinhole inverse of
   ``ops/camera.get_ray``);
3. scatter-add the (rgb-sum, count) history into the target pixels, after
   clamping the sample count to ``cfg.reproject_history_cap`` and scaling by
   ``cfg.reproject_confidence``.

The warped history is an approximation (view-dependent shading, newly
disoccluded regions carry no history, several sources may land in one
target) — exactly the TAA-style trade: a slightly stale image immediately
instead of noise from scratch. Fresh samples keep accumulating on top and
dominate quickly because the history count is clamped.

Notes: the only irregular op is one scatter-add per refresh — frame-rate
work, not per-sample; everything else is elementwise. Single-device path
(the scatter crosses pixel tiles; under ``shard_map`` use a gather-based
variant or render_frame's plain refresh).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..core.math import normalize, radians
from ..core.types import NO_HIT_T, Camera, FrameState, refresh


def camera_basis(cam: Camera):
    """Look-at basis of ``ops/camera.get_ray``: returns (x, y, z) rows."""
    z = normalize(cam.lookfrom - cam.lookat)
    x = normalize(jnp.cross(cam.vup, z))
    y = jnp.cross(z, x)
    return x, y, z


def pixel_center_rays(cam: Camera, cfg: RenderConfig):
    """Pinhole (aperture=0) rays through every pixel center; the
    deterministic stand-in for the jittered thin-lens primaries whose depths
    were recorded. Returns (origin (3,), directions (N, 3))."""
    theta = radians(cam.vfov)
    half_height = jnp.tan(theta * 0.5)
    half_width = cam.aspect * half_height
    x, y, z = camera_basis(cam)
    pid = jnp.arange(cfg.num_pixels, dtype=jnp.float32)
    u = ((pid // cfg.height) + 0.5) / cfg.width
    v = ((pid % cfg.height) + 0.5) / cfg.height
    d = ((2.0 * u - 1.0)[:, None] * (half_width * x)
         + (2.0 * v - 1.0)[:, None] * (half_height * y) - z)
    return cam.lookfrom, normalize(d)


def project(cam: Camera, cfg: RenderConfig, points: jax.Array):
    """World points (N, 3) -> (flat pixel index (N,), valid (N,)) under the
    NEW camera — the exact inverse of the film-plane mapping in
    ``ops/camera.get_ray`` (aperture 0)."""
    theta = radians(cam.vfov)
    half_height = jnp.tan(theta * 0.5)
    half_width = cam.aspect * half_height
    x, y, z = camera_basis(cam)
    d = points - cam.lookfrom
    # explicit elementwise dot — an (N,3)@(3,) matmul at DEFAULT precision
    # may round its inputs and shift warped pixels (see
    # ops/sdf.to_object_space)
    dx = jnp.sum(d * x, -1)
    dy = jnp.sum(d * y, -1)
    dz = jnp.sum(d * z, -1)
    in_front = dz < -1e-6
    denom = jnp.where(in_front, -dz, 1.0)
    u = (dx / denom / half_width + 1.0) * 0.5
    v = (dy / denom / half_height + 1.0) * 0.5
    i = jnp.floor(u * cfg.width).astype(jnp.int32)
    j = jnp.floor(v * cfg.height).astype(jnp.int32)
    valid = (in_front & (i >= 0) & (i < cfg.width)
             & (j >= 0) & (j < cfg.height))
    flat = jnp.clip(i, 0, cfg.width - 1) * cfg.height \
        + jnp.clip(j, 0, cfg.height - 1)
    return flat, valid


def reproject(state: FrameState, old_cam: Camera, new_cam: Camera,
              cfg: RenderConfig) -> FrameState:
    """Warp ``state``'s accumulator from ``old_cam``'s view into
    ``new_cam``'s and re-arm the wavefront — the reprojection-aware
    replacement for ``refresh()``. Jit-safe; single device."""
    ro, rd = pixel_center_rays(old_cam, cfg)
    # sky/miss history rides at the far plane: direction-dominated, so
    # parallax from camera translation is negligible, rotation is exact
    t = jnp.minimum(state.hit_t, cfg.max_dis)
    points = ro + t[:, None] * rd

    target, valid = project(new_cam, cfg, points)
    valid = valid & (state.accum[:, 3] > 0.0)

    # clamp history weight, down-weight by confidence
    count = state.accum[:, 3]
    cap = jnp.asarray(cfg.reproject_history_cap, count.dtype)
    scale = jnp.where(count > 0.0, jnp.minimum(count, cap)
                      / jnp.maximum(count, 1e-8), 0.0)
    scale = scale * cfg.reproject_confidence * valid.astype(count.dtype)
    history = state.accum * scale[:, None]

    new_accum = jnp.zeros_like(state.accum).at[target].add(history)

    fresh = refresh(state)
    # keep hit_t: the warped depths seed the NEXT reprojection until the
    # first fresh primaries overwrite them (one wavefront step later);
    # re-parameterize to distance along the NEW camera's rays (directions
    # are normalized, so ray t == metric distance)
    t_new = jnp.linalg.norm(points - new_cam.lookfrom, axis=-1)
    hit_t = jnp.full_like(state.hit_t, NO_HIT_T).at[target].min(
        jnp.where(valid, t_new, NO_HIT_T))
    return fresh.replace(accum=new_accum, hit_t=hit_t)
