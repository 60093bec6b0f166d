"""Enhanced sphere tracing (ray march).

Reference: ``/root/reference/src/scene.py:59-84`` (over-relaxation w=1.6 with
rollback, after erleuchtet.org "enhanced sphere tracing"; cone hit criterion
``distance < t * PIXEL_RADIUS``), plus the variants catalogued in SURVEY.md
§2.3.4: the relative-error criterion with cerr tracking
(``cornell_box_v3/pathtracer.py:52-78``), the ``w -> 0.5 + 0.5*w`` rollback
(``tokyo_ibl.py:256``), fixed-w marches (``bunny_sdf_glass.py:251``,
``cornell_box_shortest.py:63-72``) and the absolute-precision hit test
(``cornell_box.py:214-223``).

Two paths with one contract (SURVEY.md §7.2.3). The XLA loop here (the CPU
path) is one ``lax.while_loop`` that advances the *whole flat ray batch* in
lock-step with per-lane active masks; it exits when every lane has hit or
escaped, or at ``max_raymarch``. On the GPU the fused Pallas kernel
(``pallas/march_kernel.py``) marches each block of rays in its own loop and
exits per block (:func:`_use_kernel` chooses). Bookkeeping keeps the ray
origin fixed and tracks the scalar ``t`` per lane (the v3 form); for the src/
engine the shading point is ``origin + t*direction``, identical to its
in-place advanced origin.

Gradients: reverse-mode AD through a 512-iteration march is hopeless
(SURVEY.md §7.4.3); instead ``march`` detaches the loop and re-attaches
gradients at the hit point via the implicit function theorem:
``dt*/dθ = -(∂sdf/∂θ) / (∂sdf/∂t)`` — see ``_hit_t``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import HitCriterion, OmegaPolicy, RenderConfig
from . import scene as scenelib
from .scene import Scene


class MarchResult(NamedTuple):
    t: jax.Array         # (N,) hit parameter along the ray
    position: jax.Array  # (N, 3) shading point (= at(t))
    index: jax.Array     # (N,) i32 nearest-object index
    hit: jax.Array       # (N,) bool
    iters: jax.Array     # () i32 — loop trip count actually executed


def _march_loop(scene: Scene, origin, direction, cfg: RenderConfig,
                active=None, init=None):
    n = origin.shape[0]
    dtype = origin.dtype
    # Derive loop-carry inits from the ray arrays (not fresh constants) so
    # they inherit the sharding/varying-axis type under shard_map — a fresh
    # jnp.full would be "unvarying" and trip the scan/while vma check.
    zero = origin[:, 0] * 0.0
    f = lambda v: zero + dtype.type(v)
    done0 = (zero > 1.0) if active is None else ~active

    class S(NamedTuple):
        i: jax.Array
        t: jax.Array
        w: jax.Array
        s: jax.Array
        d: jax.Array
        index: jax.Array
        hit: jax.Array
        done: jax.Array
        fin: jax.Array  # per-lane 1-based convergence trip count

    if init is not None:
        # resume a budget-limited prior run (split march): carry the exact
        # loop state — per lane the iteration sequence is identical to one
        # uninterrupted march (mirrors the Pallas kernel's has_init path)
        t0v, w0v, s0v, d0v = (zero + v for v in init)
    else:
        t0v, w0v, s0v, d0v = (f(cfg.march_t0), f(cfg.omega), f(0.0),
                              f(scenelib.MAX_DIS))

    state = S(
        i=jnp.zeros((), jnp.int32),
        t=t0v,
        w=w0v,
        s=s0v,
        d=d0v,
        index=zero.astype(jnp.int32),
        hit=zero > 1.0,
        done=done0,
        fin=jnp.where(done0, 0, cfg.max_raymarch).astype(jnp.int32),
    )

    bound2 = None
    if cfg.escape_bound:
        bound = scenelib.bounding_radius(scene)
        if bound is not None:
            bound2 = bound * bound

    pixel_radius = dtype.type(cfg.pixel_radius) if hasattr(dtype, "type") \
        else cfg.pixel_radius

    def cond(st: S):
        return (st.i < cfg.max_raymarch) & (~jnp.all(st.done))

    def body(st: S) -> S:
        pos = origin + st.t[:, None] * direction
        index, d = scenelib.nearest(scene, pos)
        ld = st.d

        # Over-relaxation overstep detection: the two sphere bounds no longer
        # overlap (src/scene.py:67: ``ld + distance < s``). The reference's
        # strict ``<`` tunnels when the bounds touch EXACTLY (ld + d == s):
        # with snapped axis-aligned planes (cornell walls) a perpendicular
        # ray reaches that knife edge in exact f32 arithmetic — e.g. from
        # height 2 at w=1.6: ld=2, d=1.2, s=3.2, 2+1.2==3.2 — and the march
        # then strides through the surface forever. A relative epsilon makes
        # the touching case roll back (costs at most one extra iteration).
        if cfg.omega_policy == OmegaPolicy.CONSTANT:
            rollback = jnp.zeros_like(st.hit)
            w_next = st.w
        else:
            rollback = (ld + d < st.s * (1.0 + 1e-6))
            if cfg.omega_policy == OmegaPolicy.ROLLBACK_TO_ONE:
                # src/scene.py:66-73 gates on w > 1.0
                rollback = rollback & (st.w > 1.0)
                w_next = jnp.where(rollback, 1.0, st.w)
            else:  # ROLLBACK_HALF_UP; tokyo_ibl.py:253-256
                w_next = jnp.where(rollback, 0.5 + 0.5 * st.w, st.w)

        # rollback lane: step back by s*(w-1) and retry without a hit test
        s_rb = st.s * (1.0 - st.w)
        # normal lane: step forward by w*d
        s_fwd = w_next * d

        if cfg.hit_criterion == HitCriterion.CONE:
            # src/scene.py:79 — t in the test includes the step just taken
            hit_now = d < (st.t + s_fwd) * pixel_radius
        elif cfg.hit_criterion == HitCriterion.RELATIVE:
            # cornell_box_v3/pathtracer.py:68-74 — err against pre-step t
            hit_now = d / jnp.maximum(st.t, 1e-12) < pixel_radius
        else:  # ABSOLUTE; cornell_box.py:221, cornell_box_shortest.py:70
            hit_now = d < cfg.hit_precision

        active = ~st.done
        step = jnp.where(rollback, s_rb, s_fwd)
        t_new = jnp.where(active, st.t + step, st.t)
        hit_new = jnp.where(active & ~rollback, hit_now, st.hit)
        escaped = (t_new >= cfg.max_dis)
        if bound2 is not None:
            # outside the scene bound and receding: no hit is reachable
            escaped = escaped | ((jnp.sum(pos * pos, -1) > bound2)
                                 & (jnp.sum(pos * direction, -1) > 0.0))
        done_new = st.done | (active & ~rollback & (hit_now | escaped))

        return S(
            i=st.i + 1,
            t=t_new,
            w=jnp.where(active, w_next, st.w),
            s=jnp.where(active, jnp.where(rollback, s_rb, s_fwd), st.s),
            d=jnp.where(active, d, st.d),
            index=jnp.where(active, index, st.index),
            hit=hit_new,
            done=done_new,
            fin=jnp.where(active & done_new, st.i + 1, st.fin),
        )

    st = jax.lax.while_loop(cond, body, state)
    position = origin + st.t[:, None] * direction
    return MarchResult(st.t, position, st.index, st.hit, st.i), st


@jax.custom_vjp
def _hit_t(scene: Scene, origin, direction, t, index, hit):
    """Identity on ``t`` with implicit-function gradients at the hit point.

    For a hit lane, ``t*`` satisfies ``sdf(θ, origin + t* direction) ≈ 0``, so
    ``dt*/dθ = -(∂f/∂θ)/(∂f/∂t)`` with ``∂f/∂t = ∇_p f · direction``
    (SURVEY.md §7.4.3). Miss lanes get zero gradient.
    """
    return t


def _hit_t_fwd(scene, origin, direction, t, index, hit):
    return t, (scene, origin, direction, t, index, hit)


def _hit_t_bwd(res, g):
    scene, origin, direction, t, index, hit = res
    p = origin + t[:, None] * direction

    def f_scene(sc):
        return scenelib.sd_object(sc, index, p)

    grad_p = jax.grad(
        lambda q: jnp.sum(scenelib.sd_object(scene, index, q)))(p)
    dfdt = jnp.sum(grad_p * direction, axis=-1)
    # Guard: a valid hit has |∂f/∂t| bounded away from 0 for non-grazing rays.
    safe = jnp.where(jnp.abs(dfdt) > 1e-6, dfdt, jnp.sign(dfdt) * 1e-6 + 1e-12)
    coeff = jnp.where(hit, -g / safe, 0.0)

    _, vjp_scene = jax.vjp(f_scene, scene)
    (d_scene,) = vjp_scene(coeff)
    d_origin = coeff[:, None] * grad_p
    d_direction = (coeff * t)[:, None] * grad_p
    return d_scene, d_origin, d_direction, jnp.zeros_like(t), None, None


_hit_t.defvjp(_hit_t_fwd, _hit_t_bwd)


class ResumableResult(NamedTuple):
    """Full per-lane march loop state (split / budget-capped marching)."""
    t: jax.Array      # (N,) f32
    index: jax.Array  # (N,) i32
    hit: jax.Array    # (N,) bool
    fin: jax.Array    # (N,) i32 — trips consumed this call (budget if
    #                   unconverged, 0 if gated inactive)
    w: jax.Array      # (N,) f32 — over-relaxation state
    s: jax.Array      # (N,) f32 — last step length
    d: jax.Array      # (N,) f32 — last distance
    done: jax.Array   # (N,) i32 — 1 if hit/escaped (or gated inactive)


def march_resumable(scene: Scene, origin: jax.Array, direction: jax.Array,
                    cfg: RenderConfig, active: Optional[jax.Array] = None,
                    init=None, backend: str = "auto") -> ResumableResult:
    """Budget-capped march exposing the full resumable loop state.

    ``cfg.max_raymarch`` is the per-call trip budget; ``init`` is an
    optional ``(t, w, s, d)`` tuple of (N,) arrays carrying a prior call's
    loop state — per lane, the iteration sequence across resumed calls is
    bit-identical to one uninterrupted march (the Pallas kernel's
    ``has_init`` path; same contract in the XLA loop). Per-lane consumption
    is ``min(residual need, budget)`` regardless of block composition, so
    split marching is sharding-invariant. Forward-only (callers attach
    ``_hit_t`` at segment completion)."""
    scene = jax.lax.stop_gradient(scene)
    origin = jax.lax.stop_gradient(origin)
    direction = jax.lax.stop_gradient(direction)
    active = None if active is None else jax.lax.stop_gradient(active)
    init = None if init is None else tuple(
        jax.lax.stop_gradient(v) for v in init)
    if _use_kernel(backend):
        from ..pallas.march_kernel import march_kernel_state
        return ResumableResult(*march_kernel_state(
            scene, origin, direction, cfg, active=active, init=init))
    _, st = _march_loop(scene, origin, direction, cfg, active=active,
                        init=init)
    # fin for unconverged-but-active lanes is the full budget (they ran to
    # the cap); gated-inactive lanes report 0 — matches the kernel contract
    return ResumableResult(st.t, st.index, st.hit, st.fin, st.w, st.s,
                           st.d, st.done.astype(jnp.int32))


def _use_kernel(backend: str) -> bool:
    """Which march path runs: ``backend`` "pallas" or "xla" forces one;
    "auto" takes the Pallas kernel on the GPU and the XLA loop on the CPU.
    Any other platform has no march path."""
    if backend == "xla":
        return False
    if backend == "pallas":
        return True
    if backend != "auto":
        raise ValueError(f"unknown march backend {backend!r}")
    platform = jax.default_backend()
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise ValueError(f"no march path for platform {platform!r} "
                     "(supported: gpu, cpu)")


def march(scene: Scene, origin: jax.Array, direction: jax.Array,
          cfg: RenderConfig, differentiable: bool = True,
          backend: str = "auto", active: Optional[jax.Array] = None
          ) -> MarchResult:
    """Sphere-trace a flat ray batch against the scene.

    Returns the hit parameter/point/object per lane. When ``differentiable``,
    gradients flow to scene parameters and ray origin/direction through the
    implicit hit-point relation (the loop itself is detached) — gradient
    correctness is independent of which forward backend found the hit.

    ``backend``: "auto" (Pallas fused kernel on the GPU, XLA loop on the
    CPU, an error elsewhere), "pallas", or "xla".

    ``active``: optional (N,) bool — lanes marked False are done before the
    first iteration (their t/index/hit outputs are the inits and must be
    ignored by the caller). This is what makes adaptive sampling
    (``src/pathtracer.py:97-101``) and megakernel dead lanes actually SAVE
    march work: a fully-inactive kernel block exits its loop immediately.
    """
    if _use_kernel(backend):
        from ..pallas.march_kernel import march_pallas
        t, index, hit, lane_iters = march_pallas(
            jax.lax.stop_gradient(scene),
            jax.lax.stop_gradient(origin),
            jax.lax.stop_gradient(direction), cfg,
            active=(None if active is None
                    else jax.lax.stop_gradient(active)))
        # iters: batch-max lane need, same meaning as the XLA loop's counter
        res = MarchResult(t, origin + t[:, None] * direction, index, hit,
                          jnp.max(lane_iters))
    else:
        res, _ = _march_loop(
            jax.lax.stop_gradient(scene),
            jax.lax.stop_gradient(origin),
            jax.lax.stop_gradient(direction), cfg,
            active=(None if active is None
                    else jax.lax.stop_gradient(active)))
    if differentiable:
        t = _hit_t(scene, origin, direction, res.t, res.index, res.hit)
        position = origin + t[:, None] * direction
        return MarchResult(t, position, res.index, res.hit, res.iters)
    return res
