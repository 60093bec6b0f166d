"""Distributed inverse rendering (differentiable path) over the mesh.

New component with no reference analog (SURVEY.md §2.4): pixel-loss gradients
flow through the differentiable megakernel (implicit-function march VJP,
``ops/march.py``) to scene parameters (albedo, emission, roughness, SDF
shape/transform) and are ``psum``-all-reduced across cards inside ``shard_map``
— each device backprops its own ray tile, then the parameter gradient is
combined (the "gradient all-reduce overlapped with backward replay" row of
SURVEY.md §2.4's component table).

On per-segment overlap (SURVEY's "psum scheduled per-bounce-segment",
resolved round 4): the ENTIRE scene-gradient payload is 992 bytes (11 SoA
leaves, cornell full-PBR — measured; a differentiable-scene path tracer's
parameters are per-object scalars, not network weights). One collective
moves that in microseconds, a negligible share of a backward step that
takes tens of milliseconds; splitting it into 128 per-bounce psums would
ADD 128 collective latencies to hide one. A single psum after the backward
is the right schedule at this payload scale. (Overlap becomes relevant only if the parameter
space grows to ~MBs — e.g. optimizing a large neural SDF or the full env
map — at which point XLA's async collectives overlap automatically when
the psum is issued per-leaf as gradients retire.)
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from ..core import rng as rnglib
from ..core.types import Camera
from ..ops import camera as cameralib
from ..ops import integrator as integ
from ..ops.ibl import Environment
from ..ops.scene import Scene
from .mesh import SAMPLE_AXIS, TILE_AXIS


def render_pixels(scene: Scene, env: Environment, cam: Camera,
                  pixel_id: jax.Array, cfg: RenderConfig, spp: int,
                  sample_offset: int | jax.Array = 0,
                  differentiable: bool | str = True) -> jax.Array:
    """Differentiable linear-radiance estimate for a pixel-id batch.

    ``differentiable``: ``True`` = scan-AD (attached, incl. geometry params,
    memory O(bounces)); ``"replay"`` = path-replay backward (material/env
    params at reference bounce budgets, memory O(rays); ``ops/replay.py``).
    """
    dtype = cam.lookfrom.dtype  # follow the data (f32 prod, f64 FD oracles)
    acc = jnp.zeros((pixel_id.shape[0], 3), dtype)
    for k in range(spp):
        s = jnp.asarray(sample_offset) + jnp.uint32(k)
        u_cam = rnglib.uniform4(pixel_id, s, 1, cfg.seed, dtype)
        uv = cameralib.pixel_uv(pixel_id, cfg.width, cfg.height,
                                u_cam[0], u_cam[1])
        rays = cameralib.get_ray(cam, uv, u_cam[2], u_cam[3])
        out = integ.megakernel_trace(scene, env, rays, pixel_id, s, cfg,
                                     differentiable=differentiable)
        acc = acc + out.color
    return acc / spp


class TrainState(NamedTuple):
    scene: Scene
    opt_state: Any
    step: jax.Array


def make_train_state(scene: Scene, optimizer) -> TrainState:
    return TrainState(scene, optimizer.init(scene), jnp.zeros((), jnp.int32))


def make_sharded_train_step(
    env: Environment, cam: Camera, cfg: RenderConfig, mesh: Mesh,
    optimizer, spp: int = 1,
    param_filter: Optional[Callable[[Scene], Scene]] = None,
    dual_buffer: bool = True,
) -> Callable[[TrainState, jax.Array], Tuple[TrainState, jax.Array]]:
    """Build the jitted distributed train step.

    target: flat (N, 3) linear-radiance target image, sharded over tiles.
    Each device renders + backprops its pixel tile and its sample slice;
    scene-parameter grads are ``psum``'d over both mesh axes. ``param_filter``
    zeroes grads of frozen fields (e.g. keep geometry, fit materials).

    ``dual_buffer`` (default on) uses two *independent* sample sets A/B and
    the surrogate ``2·(A − target)·B`` whose gradient ``2·E[(A−t)]·∇E[B]`` is
    an unbiased estimator of ``∇‖E[render]−t‖²``. A naive single-buffer MSE
    also differentiates the per-sample *variance* (``E[MSE] = bias² + Var``)
    and converges to contrast-shrunk parameters — a standard differentiable-
    rendering failure mode the framework handles for you.
    """
    n = cfg.num_pixels
    tiles = mesh.shape[TILE_AXIS]
    samples = mesh.shape.get(SAMPLE_AXIS, 1)
    assert n % tiles == 0

    target_spec = P(TILE_AXIS, None)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), target_spec, P()),
             out_specs=(P(), P()), check_vma=False)
    def grad_tile(scene: Scene, target_tile: jax.Array, step):
        ti = jax.lax.axis_index(TILE_AXIS)
        si = jax.lax.axis_index(SAMPLE_AXIS)
        pixel_id = (ti * (n // tiles)
                    + jnp.arange(n // tiles, dtype=jnp.uint32))
        # disjoint sample-id blocks per step and sample-rank; the B buffer
        # (and A, when dual) take adjacent blocks
        base = (step * samples + si) * jnp.uint32(2 * spp)

        def loss_fn(sc):
            img_b = render_pixels(sc, env, cam, pixel_id, cfg, spp=spp,
                                  sample_offset=base)
            if dual_buffer:
                img_a = render_pixels(
                    jax.lax.stop_gradient(sc), env, cam, pixel_id, cfg,
                    spp=spp, sample_offset=base + jnp.uint32(spp),
                    differentiable=False)
                resid = jax.lax.stop_gradient(img_a) - target_tile
                surrogate = jnp.mean(2.0 * resid * img_b)
                # report the unbiased squared-bias estimate, not the
                # variance-inflated MSE
                metric = jnp.mean(resid * (img_b - target_tile))
                return surrogate, metric
            mse = jnp.mean((img_b - target_tile) ** 2)
            return mse, mse

        (_, loss), g = jax.value_and_grad(loss_fn, has_aux=True)(scene)
        # all-reduce: mean over tiles and sample ranks (across cards)
        g = jax.lax.pmean(jax.lax.pmean(g, TILE_AXIS), SAMPLE_AXIS)
        loss = jax.lax.pmean(jax.lax.pmean(loss, TILE_AXIS), SAMPLE_AXIS)
        return loss, g

    @jax.jit
    def train_step(ts: TrainState, target_flat: jax.Array):
        loss, g = grad_tile(ts.scene, target_flat, ts.step)
        if param_filter is not None:
            g = param_filter(g)
        updates, opt_state = optimizer.update(g, ts.opt_state, ts.scene)
        scene = optax.apply_updates(ts.scene, updates)
        return TrainState(scene, opt_state, ts.step + 1), loss

    return train_step


def param_mask(keep: frozenset | set) -> Callable[[Scene], Scene]:
    """Gradient filter keeping only the named Scene fields trainable.

    Restricting the trainable set matters beyond convenience: materials are
    mutually compensating (e.g. emission x albedo), so fitting one property
    from images requires freezing the others or the optimizer finds a
    different, image-equivalent parameterization."""
    def filt(g: Scene) -> Scene:
        out = g
        for name in ("position", "rotation", "scale", "matrix",
                     "local_offset", "albedo", "emission", "roughness",
                     "metallic", "transmission", "ior"):
            if name not in keep:
                out = out.replace(**{name: jnp.zeros_like(getattr(g, name))})
        return out
    return filt


def material_only_filter(g: Scene) -> Scene:
    """Zero gradients on geometry/transform leaves — fit materials only."""
    return param_mask({"albedo", "emission", "roughness", "metallic",
                       "transmission", "ior"})(g)


albedo_only_filter = param_mask({"albedo"})
