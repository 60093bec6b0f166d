"""Sharded rendering: ray-tile data parallelism over a device mesh.

New component with no reference analog (SURVEY.md §2.4): the reference's one
parallelism strategy — per-pixel threads on one GPU — scaled out with
``shard_map`` over a ``Mesh``. The framebuffer lives sharded in HBM; the
counter RNG makes every layout bit-identical to the single-chip render
(tests assert this), and the forward path needs *zero* collectives — the
only communication is the final framebuffer assembly (``all_gather`` or host
fetch) and, on the sample axis, one ``psum`` of the accumulators.

The shard_maps here (and in ``parallel/train.py``) run with
``check_vma=False``: the Pallas march kernel mixes per-tile rays with
replicated scene scalars inside its body, which the varying-axis type check
does not accept inside a kernel. Every collective here reduces per-device
values, so the check guards nothing these paths need.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RenderConfig
from ..core.types import Camera, FrameState
from ..ops import integrator as integ
from ..ops.ibl import Environment
from ..ops.scene import Scene
from .mesh import SAMPLE_AXIS, TILE_AXIS


def _tile_counts(mesh: Mesh):
    return mesh.shape[TILE_AXIS], mesh.shape.get(SAMPLE_AXIS, 1)


def tile_pixel_ids(ti, n: int, tiles: int, layout: str):
    """Global pixel ids owned by tile ``ti``.

    ``contiguous``: block ``[ti*n/tiles, (ti+1)*n/tiles)`` — image-order
    shards, no permutation on gather. ``strided``: ``ti, ti+tiles, ...`` —
    interleaves scanlines across devices, which evens out the march-depth
    load (sky vs deep geometry; measured ~35% -> ~2% tile imbalance on
    cornell, parallel/scaling.py). The counter RNG is keyed on the GLOBAL
    pixel id, so every layout renders bit-identical pixels.
    """
    per = n // tiles
    k = jnp.arange(per, dtype=jnp.uint32)
    if layout == "strided":
        return jnp.uint32(ti) + k * jnp.uint32(tiles)
    return jnp.uint32(ti) * jnp.uint32(per) + k


def unshard_pixels(flat: jax.Array, tiles: int, layout: str) -> jax.Array:
    """Invert the tile layout: rows of ``flat`` are ordered (tile, slot);
    return image-flat (pixel-id) order."""
    if layout != "strided":
        return flat
    n = flat.shape[0]
    per = n // tiles
    return jnp.swapaxes(flat.reshape(tiles, per, *flat.shape[1:]), 0, 1
                        ).reshape(flat.shape)


def shard_pixels(flat: jax.Array, tiles: int, layout: str) -> jax.Array:
    """Inverse of :func:`unshard_pixels`: image-flat (pixel-id) order ->
    (tile, slot) order, so ``out[ti*per + k] = flat[ti + k*tiles]``."""
    if layout != "strided":
        return flat
    n = flat.shape[0]
    per = n // tiles
    return jnp.swapaxes(flat.reshape(per, tiles, *flat.shape[1:]), 0, 1
                        ).reshape(flat.shape)


def render_image_sharded(scene: Scene, env: Environment, cam: Camera,
                         cfg: RenderConfig, mesh: Mesh,
                         spp: Optional[int] = None,
                         tonemapped: bool = True,
                         layout: str = "contiguous",
                         **trace_kw) -> jax.Array:
    """Offline still sharded over (tiles, samples).

    Pixels are split over the tile axis (``layout``: contiguous blocks or
    load-balancing stride — see ``tile_pixel_ids``); the spp budget is split
    over the sample axis, whose partial sums are ``psum``-combined. Output
    is the full (H, W, 3) image (gathered — display/save time only,
    SURVEY.md §5 "Distributed")."""
    n = cfg.num_pixels
    spp = spp if spp is not None else cfg.samples_per_pixel
    tiles, samples = _tile_counts(mesh)
    assert n % tiles == 0, (n, tiles)
    assert spp % samples == 0, (spp, samples)
    spp_local = spp // samples

    @partial(jax.shard_map, mesh=mesh, in_specs=P(),
             out_specs=P(TILE_AXIS, None), check_vma=False)
    def tile_render(_):
        ti = jax.lax.axis_index(TILE_AXIS)
        si = jax.lax.axis_index(SAMPLE_AXIS)
        # global pixel ids keep the RNG shard-invariant under any layout
        pixel_id = tile_pixel_ids(ti, n, tiles, layout)
        acc = jax.lax.pcast(jnp.zeros((n // tiles, 3), jnp.float32),
                            (TILE_AXIS, SAMPLE_AXIS), to="varying")

        def one_sample(acc, s):
            from ..core import rng as rnglib
            from ..ops import camera as cameralib
            u_cam = rnglib.uniform4(pixel_id, s, 1, cfg.seed)
            uv = cameralib.pixel_uv(pixel_id, cfg.width, cfg.height,
                                    u_cam[0], u_cam[1])
            rays = cameralib.get_ray(cam, uv, u_cam[2], u_cam[3])
            out = integ.megakernel_trace(scene, env, rays, pixel_id, s, cfg,
                                         **trace_kw)
            return acc + out.color, None

        # sample-rank s gets the global sample indices si*spp_local + k
        acc, _ = jax.lax.scan(
            one_sample, acc,
            si * spp_local + jnp.arange(spp_local, dtype=jnp.uint32))
        return jax.lax.psum(acc, SAMPLE_AXIS)

    flat = unshard_pixels(tile_render(jnp.zeros(())), tiles, layout) / spp
    if tonemapped:
        from ..ops import post as postlib
        flat = postlib.tonemap(flat, cfg)
    return jnp.transpose(flat.reshape(cfg.width, cfg.height, 3),
                         (1, 0, 2))[::-1]


def shard_frame_state(state: FrameState, mesh: Mesh) -> FrameState:
    """Place a FrameState with pixel-major leaves sharded over the tile axis
    (framebuffer shards resident in per-device HBM)."""
    def put(x):
        if x.ndim >= 1 and x.shape[0] % mesh.shape[TILE_AXIS] == 0:
            spec = P(TILE_AXIS, *([None] * (x.ndim - 1)))
        else:
            spec = P(*([None] * x.ndim))
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree.map(put, state)


def render_frame_sharded(scene: Scene, env: Environment, cam: Camera,
                         state: FrameState, cfg: RenderConfig, mesh: Mesh,
                         refreshing=False, exposure=1.0,
                         prev_cam: Optional[Camera] = None,
                         layout: str = "contiguous"):
    """Progressive wavefront frame under ``shard_map``: per-device tile of
    the persistent ray state advances independently; pixels and new state
    come back sharded (gather only when displaying).

    Mirrors ``render_frame`` exactly — the counter RNG guarantees the pixels
    equal the single-device render bit-for-bit (tested). With
    ``cfg.reprojection`` and ``prev_cam``, a refresh forward-warps the
    accumulator into the new view (``ops/reproject.py``); the warp's
    scatter-add crosses pixel tiles, so it runs as a plain ``jit`` over the
    sharded arrays and GSPMD inserts the cross-device communication — the
    idiomatic XLA answer for a once-per-refresh op (hand-rolled halo
    exchange inside ``shard_map`` would buy nothing at frame rate).
    ``refreshing`` must be a Python bool for that path (host-side camera
    motion, as in the interactive app).

    ``layout``: pixel-to-tile assignment (``tile_pixel_ids``). With
    ``strided``, the state leaves live in (tile, slot) order — pixels come
    back in that order too; invert with ``unshard_pixels`` (or
    ``gather_image(layout=...)``) at display time."""
    n = cfg.num_pixels
    tiles, _ = _tile_counts(mesh)
    assert n % tiles == 0

    if (cfg.reprojection and prev_cam is not None
            and isinstance(refreshing, bool)):
        if refreshing:
            # The warp is written against image-order arrays; under the
            # strided layout the state leaves live in (tile, slot) order, so
            # permute to image order, warp, permute back — refresh-rate work
            # only, and under jit over sharded arrays GSPMD turns the
            # permutes into the same class of cross-device gather the warp's
            # scatter-add already is (VERDICT r3 item 8: the two features
            # now compose; invariance-tested on the 8-device mesh).
            from ..ops import reproject as reprojectlib
            warp = jax.jit(reprojectlib.reproject, static_argnums=3)
            if layout == "strided":
                def persh(f):
                    return lambda x: (f(x, tiles, layout)
                                      if x.ndim >= 1 and x.shape[0] == n
                                      else x)
                state = jax.tree.map(persh(unshard_pixels), state)
                state = warp(state, prev_cam, cam, cfg)
                state = jax.tree.map(persh(shard_pixels), state)
            else:
                state = warp(state, prev_cam, cam, cfg)
        refreshing = False  # the warp already re-armed the state

    state_spec = jax.tree.map(
        lambda x: P(TILE_AXIS, *([None] * (max(x.ndim, 1) - 1)))
        if x.ndim >= 1 and x.shape[0] == n else P(*([None] * x.ndim)),
        state)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(state_spec,),
             out_specs=(P(TILE_AXIS, None), state_spec), check_vma=False)
    def tile_frame(st: FrameState):
        ti = jax.lax.axis_index(TILE_AXIS)
        pixel_id = tile_pixel_ids(ti, n, tiles, layout)
        return integ.render_frame_tile(
            scene, env, cam, st, cfg, pixel_id,
            refreshing=refreshing, exposure=exposure)

    return tile_frame(state)


def gather_image(pixels_flat: jax.Array, cfg: RenderConfig,
                 tiles: int = 1, layout: str = "contiguous") -> jax.Array:
    """Assemble the (H, W, 3) image from the flat sharded framebuffer —
    the one cross-device data movement of the forward path."""
    img = jax.device_get(unshard_pixels(pixels_flat, tiles, layout))
    return img.reshape(cfg.width, cfg.height, 3).transpose(1, 0, 2)[::-1]
