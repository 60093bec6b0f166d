"""Thin-lens camera.

Reference: ``/root/reference/src/camera.py:11-36`` (``get_ray``: look-at
basis, vfov/aspect film plane, aperture disk sample, focus plane) and the
damped fly-cam ``SmoothCamera`` (``src/camera.py:39-115``), re-expressed as a
pure function over a batch of pixel uvs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import struct
from ..core import rng as rnglib
from ..core.math import normalize, radians
from ..core.types import Camera, Rays


def get_ray(cam: Camera, uv: jax.Array, u1: jax.Array, u2: jax.Array,
            color: jax.Array | None = None) -> Rays:
    """Generate primary rays for pixel coords ``uv`` (N, 2) in [0,1]^2.

    Faithful to ``src/camera.py:11-36``: thin-lens origin jitter on an
    aperture disk, film plane at the focus distance.
    ``u1``/``u2``: per-ray uniforms for the lens sample.
    """
    theta = radians(cam.vfov)
    half_height = jnp.tan(theta * 0.5)
    half_width = cam.aspect * half_height

    z = normalize(cam.lookfrom - cam.lookat)
    x = normalize(jnp.cross(cam.vup, z))
    y = jnp.cross(z, x)

    lens_radius = cam.aperture * 0.5
    rud = lens_radius * rnglib.in_unit_disk(u1, u2)  # (N, 2)
    offset = rud[:, :1] * x + rud[:, 1:2] * y

    hwfx = half_width * cam.focus * x
    hhfy = half_height * cam.focus * y
    lower_left = cam.lookfrom - hwfx - hhfy - cam.focus * z

    ro = cam.lookfrom + offset
    po = (lower_left + uv[:, :1] * 2.0 * hwfx + uv[:, 1:2] * 2.0 * hhfy)
    rd = normalize(po - ro)

    if color is None:
        # derive from uv (not a fresh constant) so the throughput carries
        # the same varying-axis type as the ray data under shard_map
        color = jnp.tile(uv[:, :1] * 0.0 + 1.0, (1, 3))
    return Rays(origin=ro, direction=rd, color=color,
                depth=(uv[:, 0] * 0.0).astype(jnp.int32))


def pixel_uv(pixel_id: jax.Array, width: int, height: int,
             jx: jax.Array, jy: jax.Array) -> jax.Array:
    """Flat pixel id -> jittered film uv.

    Matches ``track_once`` (``src/pathtracer.py:57-59``):
    ``uv = (coord + jitter) * SCREEN_PIXEL_SIZE`` with coord = (i, j), i the
    x/width index — our flat id is ``i * height + j`` (x-major, like the
    Taichi ``ij`` field layout).
    """
    i = (pixel_id // height).astype(jx.dtype)
    j = (pixel_id % height).astype(jx.dtype)
    u = (i + jx) / width
    v = (j + jy) / height
    return jnp.stack([u, v], axis=-1)


def vec_to_euler(front: jax.Array):
    """Unit direction -> (yaw, pitch); the ti.ui convention used by the
    fly-cam (``src/camera.py:66-80``): yaw about +y measured from +z,
    pitch = asin(y)."""
    yaw = jnp.arctan2(front[..., 0], front[..., 2])
    pitch = jnp.arcsin(jnp.clip(front[..., 1], -1.0, 1.0))
    return yaw, pitch


def euler_to_vec(yaw, pitch):
    cp = jnp.cos(pitch)
    return jnp.stack([cp * jnp.sin(yaw), jnp.sin(pitch), cp * jnp.cos(yaw)],
                     axis=-1)


def fly_rotate(position: jax.Array, lookat: jax.Array, d_yaw, d_pitch):
    """Arrow-key camera rotation with gimbal clamp
    (``src/camera.py:66-80``): rotate the view direction by (d_yaw, d_pitch),
    clamping pitch to +-0.999 * pi/2. Returns the new lookat."""
    front = normalize(lookat - position)
    yaw, pitch = vec_to_euler(front)
    yaw = yaw - d_yaw
    pitch = jnp.clip(pitch + d_pitch,
                     -jnp.pi * 0.5 * 0.999, jnp.pi * 0.5 * 0.999)
    return position + euler_to_vec(yaw, pitch)


@struct.dataclass
class SmoothCameraState:
    """Damped camera interpolation state (``src/camera.py:39-115``).

    The live app integrates toward a target with velocity 10/s and reports a
    ``moving`` flag that triggers accumulation reset (SURVEY.md §2.3.16).
    """

    position: jax.Array  # (3,)
    lookat: jax.Array    # (3,)
    up: jax.Array        # (3,)
    velocity: jax.Array  # () units of 1/s; reference default 10

    moving: jax.Array    # () bool


def make_smooth_camera(position, lookat, up=(0.0, 1.0, 0.0),
                       velocity=10.0, dtype=jnp.float32) -> SmoothCameraState:
    f = lambda v: jnp.asarray(v, dtype)
    return SmoothCameraState(f(position), f(lookat), f(up), f(velocity),
                             jnp.asarray(False))


def smooth_update(state: SmoothCameraState, dt, target_position,
                  target_lookat, target_up) -> SmoothCameraState:
    """One damping step (``src/camera.py:82-112``): exponential approach with
    per-field clamp(v*dt, 0, 1); ``moving`` = any residual > 1e-3."""
    a = jnp.clip(state.velocity * dt, 0.0, 1.0)
    dp = target_position - state.position
    dl = target_lookat - state.lookat
    du = target_up - state.up
    moving = jnp.maximum(
        jnp.max(jnp.abs(dp)),
        jnp.maximum(jnp.max(jnp.abs(dl)), jnp.max(jnp.abs(du)))) > 1e-3
    return state.replace(
        position=state.position + dp * a,
        lookat=state.lookat + dl * a,
        up=state.up + du * a,
        moving=moving,
    )
