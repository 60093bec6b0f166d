"""Path-tracing integrators.

Two integrators, mirroring the reference's two engine generations
(SURVEY.md §3.2 — "the single most important design divergence"):

* ``wavefront_step`` / ``render_frame`` — the src/ engine's progressive
  wavefront scheme (``src/pathtracer.py``): persistent per-pixel ray state,
  each call advances every pixel's path by ~one bounce-segment, finished
  paths deposit into the accumulator and respawn. This is the
  performance-canonical form: fixed-trip work per call, no divergence, state
  carried through ``lax.scan`` (SURVEY.md §7.1).

* ``megakernel_trace`` / ``render_image`` — the examples' megakernel
  (``cornell_box.py:296-379``, ``cornell_box_shortest.py:81-129``): the full
  bounce loop per sample as a ``lax.scan`` with an active mask. Simpler,
  differentiable end-to-end, used as the test oracle and for offline stills.

RNG discipline (SURVEY.md §2.4): every draw is counter-derived from
``(pixel_id, step_or_sample, stream)`` — bit-identical across sharding
layouts and across checkpoint/resume.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import RenderConfig, Roulette
from ..core import rng as rnglib
from ..core.math import brightness
from ..core.types import (Camera, FrameState, Rays, make_frame_state,
                          refresh)
from . import camera as cameralib
from . import march as marchlib
from . import post as postlib
from . import scene as scenelib
from . import shade as shadelib
from .ibl import Environment, sample_env_baked, sky_color
from .scene import Scene

# RNG stream ids (use-sites within one wavefront step / bounce)
_S_ROULETTE = 0
_S_CAMERA = 1   # jitter x/y + lens u/v
_S_SHADE = 2    # hemisphere u/v + lobe u/v
_S_NEE = 3      # env alias-table draw


def _where(mask, a, b):
    return jnp.where(mask[:, None] if a.ndim == 2 else mask, a, b)


def shadow_march(scene: Scene, origin, direction, cfg: RenderConfig,
                 gate) -> jax.Array:
    """Occlusion test for NEE shadow rays: returns an (N,) bool ``occluded``.

    With ``cfg.shadow_diet`` the march runs in an occlusion-tuned mode
    (see the ``shadow_diet`` config docstring): absolute hit criterion at
    ``min_dis/2``, a reduced iteration budget. Without it,
    the scene's own march settings are used (round-4 behavior). Either way
    ``escape_bound`` is on — exact for a binary visibility query."""
    from ..config import HitCriterion
    sc = cfg.replace(escape_bound=True)
    if cfg.shadow_diet:
        sc = sc.replace(
            max_raymarch=(cfg.shadow_max_raymarch
                          or min(128, cfg.max_raymarch)),
            hit_criterion=HitCriterion.ABSOLUTE,
            hit_precision=(cfg.shadow_hit_precision or 0.5 * cfg.min_dis))
    res = marchlib.march(scene, origin, direction, sc,
                         differentiable=False, active=gate)
    return res.hit


def _nee_env(scene: Scene, env: Environment, index, position, direction,
             normal, outer, albedo, gate, pixel_id, counter,
             cfg: RenderConfig, roughness_fresnel: bool = False,
             lobe_prob: bool = True, visible_rec=None,
             reflect_kill: Optional[bool] = None):
    """One next-event sample toward the environment at a surface vertex.

    Estimates the diffuse-lobe env integral
    ``∫ L_env(ω) P_diffuse(ω) (albedo/π) cosθ dω`` with one alias-table draw
    (``ops/ibl.sample_env_baked``) and a shadow march, where ``P_diffuse(ω)``
    is the lobe-roulette's conditional probability of scattering diffusely
    INTO ω (``shade.diffuse_lobe_prob`` — the roulette is correlated with the
    scatter direction, so a plain diffuse-selected gate would be biased).
    Lanes outside ``gate`` do no march work. The paired sky-zeroing in
    ``_trace_one_bounce`` removes exactly this integral from the continuation
    estimator, so the partition is exact (cfg.env_sampling docstring).
    ``lobe_prob=False`` skips the probability weight (diffuse-only shading,
    where every bounce is diffuse).

    ``visible_rec``: a recorded visibility mask — skips the shadow march
    entirely (path-replay backward: the forward's visibility bit is
    checkpointed, and a detached {0,1} factor needs no re-march).

    Returns ``(bank, visible)``: the banked radiance (N, 3) — multiply by
    the arriving throughput — and the (N,) visibility mask (for recording).
    """
    if env.s_prob is None:
        raise ValueError(
            "cfg.env_sampling requires an environment with a baked alias "
            "table — build it with ops.ibl.with_env_sampler(env)")
    dtype = position.dtype
    # four independent uniforms: alias cell + accept test (one-uniform
    # reuse quantizes the accept branch on large HDR maps — ADVICE r3) +
    # in-texel jitter (an atomic center-point sampler biases the specular
    # MIS weights by the texel midpoint-quadrature error; see
    # ops/ibl.sample_env_baked)
    u = rnglib.uniform4(pixel_id, counter, _S_NEE, cfg.seed, dtype)
    d_l, radiance, pdf = sample_env_baked(env, u[0], u[1],
                                          u_jitter=(u[2], u[3]))
    cos = jnp.sum(d_l * normal, -1)
    gate = gate & (cos > 0.0)
    if visible_rec is None:
        origin = position + normal * cfg.min_dis
        # Visibility only — escape_bound is exact for a binary occlusion
        # test (bounding_radius returns None for unbounded scenes; then
        # it's a no-op).
        visible = gate & ~shadow_march(scene, origin, d_l, cfg, gate)
    else:
        visible = visible_rec
    pdf_safe = jnp.maximum(pdf, 1e-12)
    scale = jnp.where(visible, cos / (jnp.pi * pdf_safe),
                      jnp.zeros_like(cos))
    if lobe_prob:
        scale = scale * shadelib.diffuse_lobe_prob(
            scene, index, direction, normal, outer, d_l, cfg,
            roughness_fresnel=roughness_fresnel)
        if cfg.mis_specular:
            # one-sample balance-heuristic MIS for the reflect lobe
            # (cfg.mis_specular docstring): term
            # w_l * (P_refl * p_spec)/p_env with w_l = p_env/(p_env + ps) —
            # the 1/p_env cancels, leaving the bounded ps/(p_env + ps). The
            # weight is detached (sums to 1 with the continuation's, so the
            # derivative terms cancel in expectation; keeps scan-AD ==
            # replay); the density ps stays attached (part of the
            # integrand).
            ps = shadelib.specular_env_density(
                scene, index, direction, normal, outer, d_l, cfg,
                roughness_fresnel=roughness_fresnel,
                reflect_kill=reflect_kill)
            w_l = jax.lax.stop_gradient(
                pdf_safe / (pdf_safe + jnp.maximum(ps, 0.0)))
            scale = scale + jnp.where(visible, w_l * ps / pdf_safe,
                                      jnp.zeros_like(cos))
    return albedo * radiance * scale[:, None], visible


def _trace_one_bounce(scene: Scene, env: Environment, rays: Rays,
                      pixel_id: jax.Array, counter, cfg: RenderConfig,
                      differentiable: bool = False,
                      roughness_fresnel: bool = False,
                      restart_at_hit: bool = False,
                      active: Optional[jax.Array] = None,
                      prev_sky_w: Optional[jax.Array] = None,
                      resume=None):
    """One ``raytrace`` bounce (``src/pathtracer.py:16-36``): march, then
    surface interaction or sky, emission multiply, brightness termination.
    ``counter`` is the RNG step counter for this bounce's draws. ``active``
    lanes marked False skip march work (their outputs are discarded by the
    caller). ``prev_sky_w``: with ``cfg.env_sampling``, the MIS/partition
    weight on this segment's sky lookup — 0 after a diffuse bounce (that
    radiance was banked exactly by NEE at the previous vertex), the
    balance-heuristic complement after a reflect bounce
    (``cfg.mis_specular``), 1 otherwise.

    ``resume``: with ``cfg.march_split`` (budget-capped split march), the
    ``(march_state (N,4), march_cum (N,))`` carry from FrameState. The
    march runs at most ``march_split`` trips this call; lanes that neither
    hit nor escape within the per-segment budget remaining carry their
    exact loop state to the next wavefront step and are returned
    UNCHANGED in ``traced`` (no shading, no depth advance — their segment
    is still in flight). Per lane the iteration sequence equals one
    uninterrupted march, and per-lane consumption is min(residual, budget)
    regardless of block composition, so results stay sharding-invariant
    (the deep-march tail otherwise stalls whole kernel blocks for up to
    max_raymarch iterations).

    Returns ``(traced, t, hit, nee, next_sky_w, completed, resume_out)``;
    ``completed``/``resume_out`` are None without ``resume``.
    """
    completed = None
    resume_out = None
    if resume is not None:
        mstate, mcum = resume
        marching = mcum > 0
        mcfg = cfg.replace(max_raymarch=cfg.march_split)
        defaults = (cfg.march_t0, cfg.omega, 0.0, scenelib.MAX_DIS)
        init = tuple(jnp.where(marching, mstate[:, k], dflt)
                     for k, dflt in enumerate(defaults))
        rr = marchlib.march_resumable(scene, rays.origin, rays.direction,
                                      mcfg, active=active, init=init)
        act = (active if active is not None
               else jnp.ones_like(marching))
        cum_new = mcum + rr.fin
        completed = act & ((rr.done > 0) | (cum_new >= cfg.max_raymarch))
        t = rr.t
        if differentiable:
            t = marchlib._hit_t(scene, rays.origin, rays.direction, rr.t,
                                rr.index, rr.hit & completed)
        res = marchlib.MarchResult(
            t, rays.origin + t[:, None] * rays.direction, rr.index,
            rr.hit, jnp.max(rr.fin))
        # completed lanes re-arm for a fresh segment next step; in-flight
        # lanes carry the exact loop state (gated-inactive lanes: fin=0 and
        # the kernel echoes its init state back, so they pause unchanged)
        resume_out = (
            jnp.where(completed[:, None], 0.0,
                      jnp.stack([rr.t, rr.w, rr.s, rr.d], axis=-1)),
            jnp.where(completed, 0, cum_new).astype(mcum.dtype),
        )
    else:
        res = marchlib.march(scene, rays.origin, rays.direction, cfg,
                             differentiable=differentiable, active=active)
    depth = rays.depth + 1  # raycast increments depth (src/scene.py:83)

    u4 = rnglib.uniform4(pixel_id, counter, _S_SHADE, cfg.seed,
                         rays.color.dtype)
    inter = shadelib.ray_surface_interaction(
        scene, res.index, res.position, rays.direction, u4, cfg,
        roughness_fresnel=roughness_fresnel, restart_at_hit=restart_at_hit)

    # --- hit branch (src/pathtracer.py:20-28) ---
    color_hit = rays.color * inter.color_scale
    intensity = brightness(color_hit)
    # one-hot contraction, not a per-ray gather (see scene.materials_at);
    # XLA CSEs this with the interaction's own material fetch
    color_hit = color_hit * scenelib.materials_at(scene, res.index).emission
    visible = brightness(color_hit)
    stop = ((intensity < visible)
            | (visible < cfg.visibility[0])
            | (visible > cfg.visibility[1]))
    depth_hit = jnp.where(stop, -depth, depth)

    # --- miss branch (src/pathtracer.py:29-34) ---
    color_miss = rays.color * sky_color(env, rays.direction)
    depth_miss = -depth
    if cfg.black_background:
        # kill primary-miss only: after negation, depth < -1 means the path
        # had bounced at least once (src/pathtracer.py:33-34)
        color_miss = color_miss * (depth_miss < -1).astype(color_miss.dtype)[:, None]

    hit = res.hit
    nee = None
    next_sky_w = None
    if cfg.env_sampling:
        if prev_sky_w is not None:
            # env radiance banked at the previous vertex: weight the
            # continuation's sky lookup by the complement (0 after a
            # diffuse bounce = exact partition; balance-heuristic weight
            # after a reflect bounce under cfg.mis_specular)
            color_miss = color_miss * prev_sky_w[:, None]
        # NEE at vertices whose path continues (``stop`` lanes end here in
        # the reference's brightness-termination sense — their diffuse
        # continuation never samples the sky, so NEE would add radiance the
        # plain estimator truncates; gate it off to keep the same mean). The
        # P_diffuse(ω_l) weight inside _nee_env carries the lobe-selection
        # probability, so the bank applies at EVERY continuing hit. A lane
        # reaching the bounce cap deposits next step WITHOUT a sky lookup,
        # so its bank would be unpaired — gate it off too. DEPTH_LINEAR
        # roulette needs no death compensation (survivors are 1/prob
        # scaled, so the continuation estimator is unbiased; contrast the
        # EXP compensation in megakernel_trace).
        gate = hit & ~stop & (depth <= cfg.max_raytrace)
        if active is not None:
            gate = gate & active
        if completed is not None:
            # split march: NEE banks only at completed surface vertices
            gate = gate & completed
        # Raw material albedo, NOT inter.color_scale: with reflect_kill the
        # scale carries a {0,1} factor correlated with this vertex's lobe
        # draw, which would bias E[bank] dark by the kill probability
        # (ADVICE r3). The NEE bank must be independent of the vertex's own
        # lobe outcome.
        nee, _ = _nee_env(scene, env, res.index, res.position,
                          rays.direction, inter.normal, inter.outer,
                          scenelib.materials_at(scene, res.index).albedo,
                          gate, pixel_id, counter, cfg,
                          roughness_fresnel=roughness_fresnel)
        nee = rays.color * nee
        next_sky_w = jnp.ones_like(res.t)
        if cfg.mis_specular:
            from .ibl import env_pdf
            ps_b = shadelib.specular_env_density(
                scene, res.index, rays.direction, inter.normal, inter.outer,
                inter.direction, cfg, roughness_fresnel=roughness_fresnel)
            w_b = jax.lax.stop_gradient(
                ps_b / jnp.maximum(env_pdf(env, inter.direction) + ps_b,
                                   1e-20))
            next_sky_w = jnp.where(inter.reflect, w_b, next_sky_w)
        next_sky_w = jnp.where(inter.diffuse,
                               jnp.zeros_like(next_sky_w), next_sky_w)
        next_sky_w = jnp.where(gate, next_sky_w,
                               jnp.ones_like(next_sky_w))

    traced = Rays(
        origin=_where(hit, inter.origin, res.position),
        direction=_where(hit, inter.direction, rays.direction),
        color=_where(hit, color_hit, color_miss),
        depth=jnp.where(hit, depth_hit, depth_miss),
    )
    if completed is not None:
        # in-flight split-march lanes: segment not finished — no shading,
        # no depth advance; the ray is returned unchanged
        traced = jax.tree.map(
            lambda new, old: _where(completed, new, old), traced, rays)
        if next_sky_w is not None:
            keepw = (prev_sky_w if prev_sky_w is not None
                     else jnp.ones_like(next_sky_w))
            next_sky_w = jnp.where(completed, next_sky_w, keepw)
    # march t/hit surface to the caller: for lanes whose segment was a
    # primary camera ray this is the depth buffer (reprojection)
    return traced, res.t, hit, nee, next_sky_w, completed, resume_out


# ---------------------------------------------------------------------------
# Wavefront (src/ engine)
# ---------------------------------------------------------------------------


def wavefront_step(scene: Scene, env: Environment, cam: Camera,
                   rays: Rays, accum: jax.Array, pixel_id: jax.Array,
                   step: jax.Array, cfg: RenderConfig,
                   active: Optional[jax.Array] = None,
                   differentiable: bool = False,
                   respawn: Optional[jax.Array] = None,
                   hit_t: Optional[jax.Array] = None,
                   sky_w: Optional[jax.Array] = None,
                   march_state: Optional[jax.Array] = None,
                   march_cum: Optional[jax.Array] = None):
    """One russian-roulette wavefront step per pixel
    (``src/pathtracer.py:65-77`` -> ``track_once`` -> ``raytrace``).

    ``step`` is the global roulette-step counter (RNG uniqueness).
    ``active``: optional per-pixel gate (adaptive sampling,
    ``src/pathtracer.py:97-101``). ``respawn``: optional (N,) u32 per-pixel
    camera-sample counter; with ``cfg.low_discrepancy`` it indexes the R2
    sequence for the camera draws (a pixel consumes a camera sample only on
    the steps where its path finished — an irregular subsequence of steps —
    so indexing R2 by the global step would destroy the stratification and
    correlate sample selection with the per-pixel rotation).
    ``hit_t``: optional (N,) primary-hit depth buffer — updated on lanes
    that traced a fresh camera ray this step (reprojection input).
    ``sky_w``: optional (N,) f32 — the MIS/partition weight on the path's
    next sky lookup (``cfg.env_sampling``; see ``FrameState.sky_w``).
    ``march_state``/``march_cum``: with ``cfg.march_split``, the (N,4)/(N,)
    split-march carry (``FrameState.march_state``) — a lane whose segment
    is still marching (cum > 0) skips roulette, deposit and respawn until
    the segment completes (the reference rolls roulette once per bounce
    segment, src/pathtracer.py:80-91; split marching keeps that schedule).
    Returns ``(rays, accum, respawn, hit_t, sky_w, march_state,
    march_cum)``.
    """
    depth = rays.depth
    dtype = rays.color.dtype
    # Split applies only when the budget divides max_raymarch: an
    # unconverged lane always consumes exactly the budget per step, so its
    # cumulative count stays a multiple of it and the final step lands
    # exactly on max_raymarch — no lane ever marches past the reference's
    # iteration cap. With a non-dividing budget the step runs unsplit.
    split = (cfg.march_split is not None and march_cum is not None
             and cfg.max_raymarch > cfg.march_split
             and cfg.max_raymarch % cfg.march_split == 0)
    marching = (march_cum > 0) if split else None

    # Russian roulette (src/pathtracer.py:65-77). Depth-linear survival:
    # 1 at depth 0, else quality - depth/max (negative depths from terminated
    # paths intentionally boost survival — faithful to the reference).
    u_r = rnglib.uniform(pixel_id, step, _S_ROULETTE, cfg.seed, dtype)
    prob = jnp.where(depth == 0, 1.0,
                     cfg.quality_per_sample
                     - depth.astype(dtype) * (1.0 / cfg.max_raytrace))
    kill = u_r > prob
    if split:
        # mid-segment lanes already survived their segment's roulette
        kill = kill & ~marching
    survive = ~kill
    color_surv = rays.color / jnp.maximum(prob, 1e-8)[:, None]
    if split:
        color_surv = _where(marching, rays.color, color_surv)

    # track_once (src/pathtracer.py:53-62): finished paths deposit and
    # respawn a camera ray with sub-pixel jitter.
    finished = (depth < 1) | (depth > cfg.max_raytrace)
    if split:
        # a marching lane's depth is its SEGMENT-START depth (0 while its
        # primary is in flight) — it is not awaiting respawn
        finished = finished & ~marching
    deposit = finished & survive
    if active is not None:
        deposit = deposit & active
    accum = accum + jnp.where(
        deposit[:, None],
        jnp.concatenate([color_surv, jnp.ones_like(u_r)[:, None]], -1),
        0.0)

    if cfg.low_discrepancy and respawn is not None:
        # R2 indexed by the per-pixel camera-sample counter (see docstring).
        u_cam = rnglib.r2_uniform4(pixel_id, respawn, _S_CAMERA, cfg.seed,
                                   dtype)
    else:
        u_cam = rnglib.uniform4(pixel_id, step, _S_CAMERA, cfg.seed, dtype)
    uv = cameralib.pixel_uv(pixel_id, cfg.width, cfg.height,
                            u_cam[0], u_cam[1])
    fresh = cameralib.get_ray(cam, uv, u_cam[2], u_cam[3])

    pre = Rays(
        origin=_where(finished, fresh.origin, rays.origin),
        direction=_where(finished, fresh.direction, rays.direction),
        color=_where(finished, fresh.color, color_surv),
        depth=jnp.where(finished, 0, depth),
    )

    prev_sky_w = None
    if cfg.env_sampling and sky_w is not None:
        # a respawned lane starts a fresh path: plain sky lookup
        prev_sky_w = jnp.where(finished, jnp.ones_like(sky_w), sky_w)
    traced, march_t, march_hit, nee, next_sky_w, completed, resume_out = \
        _trace_one_bounce(
            scene, env, pre, pixel_id, step, cfg,
            differentiable=differentiable, active=active,
            prev_sky_w=prev_sky_w,
            resume=(march_state, march_cum) if split else None)

    # kill lane (src/pathtracer.py:70-72): zero the contribution, mark
    # terminated; the zero sample deposits on the next step's respawn.
    new_rays = Rays(
        origin=_where(survive, traced.origin, rays.origin),
        direction=_where(survive, traced.direction, rays.direction),
        color=_where(survive, traced.color, jnp.zeros_like(rays.color)),
        depth=jnp.where(survive, traced.depth, -depth),
    )
    if active is not None:
        new_rays = jax.tree.map(
            lambda new, old: _where(active, new, old), new_rays, rays)
    used = finished & survive
    if active is not None:
        used = used & active
    if respawn is not None:
        # advance the camera-sample counter only where the fresh camera ray
        # was actually kept (finished path that survived roulette, and not
        # gated off by adaptive sampling) — a discarded draw is reused on the
        # pixel's next respawn, keeping the R2 prefix contiguous.
        respawn = respawn + used.astype(jnp.uint32)
    if hit_t is not None:
        from ..core.types import NO_HIT_T
        # lanes that traced a fresh primary ray this step record its depth;
        # under split marching the primary segment may span several steps,
        # so record at its COMPLETION (segment-start depth 0)
        rec = used if not split else (
            completed & (pre.depth == 0) & survive
            & (active if active is not None else True))
        hit_t = jnp.where(rec,
                          jnp.where(march_hit, march_t, NO_HIT_T),
                          hit_t)
    if nee is not None:
        # bank the NEE radiance additively (no sample-count increment — it is
        # part of the in-flight path's estimate; alpha ticks at its deposit)
        bank = survive if active is None else (survive & active)
        accum = accum + jnp.concatenate(
            [jnp.where(bank[:, None], nee, 0.0),
             jnp.zeros_like(u_r)[:, None]], -1)
    if sky_w is not None and next_sky_w is not None:
        keep = survive if active is None else (survive & active)
        sky_w = jnp.where(keep, next_sky_w,
                          prev_sky_w if prev_sky_w is not None else sky_w)
    if split:
        ms_new, mc_new = resume_out
        # a roulette-killed lane's in-flight segment is abandoned with it
        # (its zero sample deposits on the respawn step, as in the
        # reference); gated-inactive lanes keep their carry unchanged
        mc_new = jnp.where(survive, mc_new, 0)
        if active is not None:
            ms_new = _where(active, ms_new, march_state)
            mc_new = jnp.where(active, mc_new, march_cum)
        march_state, march_cum = ms_new, mc_new
    return new_rays, accum, respawn, hit_t, sky_w, march_state, march_cum


def render_frame(scene: Scene, env: Environment, cam: Camera,
                 state: FrameState, cfg: RenderConfig,
                 refreshing=False, exposure=1.0,
                 prev_cam: Optional[Camera] = None):
    """One display frame = ``render()`` (``src/renderer.py:25-32``):
    optional refresh, ``samples_per_frame x samples_per_pixel`` wavefront
    steps, then postprocess. Returns ``(pixels (N,3), new_state)``.

    ``refreshing`` may be a Python or traced bool (camera moved). With
    ``cfg.reprojection`` and ``prev_cam``, a refresh warps the accumulator
    into the new view (``ops/reproject.py``) instead of zeroing it —
    requires ``refreshing`` to be a Python bool (host-side camera motion,
    as in the interactive app).
    """
    if (cfg.reprojection and prev_cam is not None
            and isinstance(refreshing, bool)):
        if refreshing:
            from . import reproject as reprojectlib
            state = reprojectlib.reproject(state, prev_cam, cam, cfg)
        refreshing = False  # reproject already re-armed the state
    pixel_id = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
    return render_frame_tile(scene, env, cam, state, cfg, pixel_id,
                             refreshing=refreshing, exposure=exposure)


def render_frame_tile(scene: Scene, env: Environment, cam: Camera,
                      state: FrameState, cfg: RenderConfig,
                      pixel_id: jax.Array, refreshing=False, exposure=1.0):
    """``render_frame`` over an explicit pixel tile: ``state`` leaves are
    sized to ``pixel_id`` (a shard of the global pixel ids). This is the
    per-device body of the sharded renderer — global pixel ids keep the
    counter RNG identical to the single-device render (SURVEY.md §7.4.4)."""
    refreshed = refresh(state)
    is_r = jnp.asarray(refreshing)
    state = jax.tree.map(
        lambda a, b: jnp.where(
            jnp.reshape(is_r, (1,) * a.ndim) if a.ndim else is_r, a, b),
        refreshed, state)

    rays, accum = state.rays, state.accum
    # Monotone RNG counter: the frame index times steps-per-frame. ``frame``
    # is never reset by refresh() (src/camera.py:112 increments it
    # unconditionally), so draws never repeat after an accumulation reset.
    steps_per_frame = cfg.samples_per_frame * cfg.samples_per_pixel
    base = state.frame * steps_per_frame

    active = None
    if cfg.adaptive_sampling:
        active = state.noise > cfg.noise_threshold

    respawn, hit_t = state.respawn, state.hit_t
    sky_w = state.sky_w
    march_state, march_cum = state.march_state, state.march_cum
    k = 0
    for _ in range(cfg.samples_per_frame):
        for _ in range(cfg.samples_per_pixel):
            (rays, accum, respawn, hit_t, sky_w, march_state,
             march_cum) = wavefront_step(
                scene, env, cam, rays, accum, pixel_id, base + k, cfg,
                active=active, respawn=respawn, hit_t=hit_t,
                sky_w=sky_w, march_state=march_state, march_cum=march_cum)
            k += 1

    pixels, diff_accum, noise = postlib.post_process(
        accum, cfg, exposure, last_pixels=state.pixels,
        diff_accum=state.diff_accum)
    new_state = state.replace(
        rays=rays, accum=accum, frame=state.frame + 1,
        pixels=pixels, respawn=respawn, hit_t=hit_t, sky_w=sky_w,
        march_state=march_state, march_cum=march_cum,
        diff_accum=diff_accum if diff_accum is not None else state.diff_accum,
        noise=noise if noise is not None else state.noise,
    )
    return pixels, new_state


@functools.lru_cache(maxsize=32)
def _progressive_frame_jit(cfg: RenderConfig):
    """One compiled wavefront frame with scene/env/cam/exposure as ARGUMENTS
    (one compilation per cfg, reused across animation frames and scenes —
    closure capture would retrace per call AND embed device constants)."""
    return jax.jit(lambda scene, env, cam, st, exposure: render_frame(
        scene, env, cam, st, cfg, exposure=exposure))


def render_image_progressive(scene: Scene, env: Environment, cam: Camera,
                             cfg: RenderConfig, spp: int,
                             exposure=1.0, tonemapped: bool = True,
                             max_frames: Optional[int] = None,
                             state: Optional[FrameState] = None,
                             steps_per_frame: int = 8):
    """Offline still via the *wavefront* integrator: run progressive frames
    until every pixel has deposited at least ``spp`` completed paths, then
    return the (H, W, 3) image (tonemapped mean by actual per-pixel counts).

    NOTE: ``cfg.samples_per_frame``/``samples_per_pixel`` are OVERRIDDEN by
    ``steps_per_frame`` here (they control the per-call unroll of the
    compiled frame, NOT the spp budget — that is the ``spp`` argument, met
    by the host loop). A workload spec like bunny-glass (spp=512) must not
    become a 512-step XLA program; 8 steps/frame keeps compiles small while
    completing ~quality_per_sample*8 paths per pixel per frame. Pass a
    different ``steps_per_frame`` to trade compile size against host-loop
    overhead (VERDICT r3 weak 7: the override is part of the contract, not
    a silent normalization).

    Same estimator family as the reference's progressive src/ engine
    (``src/renderer.py:25-32`` looped); faster than ``render_image``'s
    megakernel because every lane does useful work every step (no dead
    lanes waiting for the longest path; SURVEY.md §3.2). Use
    ``render_image`` when exact example-megakernel parity or end-to-end
    differentiability is required.
    """
    state = state if state is not None else make_frame_state(cfg.num_pixels)
    cfg = cfg.replace(samples_per_frame=steps_per_frame,
                      samples_per_pixel=1)
    frame = _progressive_frame_jit(cfg)
    # a frame completes >= ~quality_per_sample*steps paths per pixel in
    # expectation; bound the host loop for pathological configs.
    limit = max_frames if max_frames is not None else (
        spp * 4 // max(steps_per_frame, 1) + 64)
    pixels = None
    exposure = jnp.asarray(exposure, state.accum.dtype)
    for _ in range(limit):
        pixels, state = frame(scene, env, cam, state, exposure)
        if float(state.accum[:, 3].min()) >= spp:
            break
    if tonemapped:
        img = pixels
    else:
        img = state.accum[:, :3] / jnp.maximum(state.accum[:, 3:4], 1.0)
    return (jnp.transpose(img.reshape(cfg.width, cfg.height, 3),
                          (1, 0, 2))[::-1], state)


# ---------------------------------------------------------------------------
# Megakernel (examples / test oracle / differentiable stills)
# ---------------------------------------------------------------------------


class TraceResult(NamedTuple):
    color: jax.Array   # (N, 3) radiance estimate per ray
    bounces: jax.Array  # (N,) i32 bounce count (diagnostics)


def megakernel_trace(scene: Scene, env: Environment, rays: Rays,
                     pixel_id: jax.Array, sample_idx, cfg: RenderConfig,
                     diffuse_only: bool = False,
                     differentiable: bool = False,
                     roughness_fresnel: bool = True,
                     restart_at_hit: bool = True,
                     reflect_kill: Optional[bool] = None) -> TraceResult:
    """Full bounce loop per sample (``cornell_box.py:296-319``): EXP
    russian roulette (``1 - 1/exp(i/light_quality)``), march, interaction,
    brightness termination; miss multiplies the sky color and stops.

    ``diffuse_only`` reproduces the minimal cornell box's shading
    (``cornell_box_shortest.py:88-99``): pure cosine-hemisphere bounce.

    ``differentiable``: ``False`` (early-exit forward), ``True`` (scan-AD —
    attached gradients incl. geometry, memory O(bounces)), or ``"replay"``
    (path-replay backward via the counter RNG — material/environment
    gradients at the reference's 128-512 bounce budgets in O(rays) memory;
    see ``ops/replay.py``).

    ``reflect_kill`` (``None`` default): forward renders follow the example
    megakernels and ZERO a below-surface reflection (``cornell_box.py:280``);
    differentiable estimators fold it back above like the src/ engine
    (``src/pbr.py:49-51``) — the kill factor is a step function of geometry,
    so its AD gradient is 0 a.e. while FD straddles the jump, and an
    optimizer gets no signal from killed paths. Pass an explicit bool to
    override either way (e.g. exact forward parity inside a loss).
    """
    if reflect_kill is None:
        reflect_kill = roughness_fresnel and not differentiable
    if differentiable == "replay":
        from .replay import trace_replay
        color = trace_replay(scene, env, rays, pixel_id, sample_idx, cfg,
                             diffuse_only=diffuse_only,
                             roughness_fresnel=roughness_fresnel,
                             restart_at_hit=restart_at_hit,
                             reflect_kill=reflect_kill)
        return TraceResult(color, jnp.zeros_like(rays.depth))

    n = rays.depth.shape[0]
    dtype = rays.color.dtype
    max_bounce = cfg.max_raytrace

    def body(carry, i):
        if cfg.env_sampling:
            origin, direction, color, alive, bounces, radiance, sky_w \
                = carry
        else:
            origin, direction, color, alive, bounces = carry
        i = jnp.asarray(i, jnp.int32)
        counter = jnp.asarray(sample_idx, jnp.uint32) * jnp.uint32(
            max_bounce) + i.astype(jnp.uint32)

        if cfg.roulette == Roulette.EXP:
            inv_pdf = jnp.exp(i.astype(dtype) / cfg.light_quality)
            roulette_prob = 1.0 - 1.0 / inv_pdf
            u = rnglib.uniform(pixel_id, counter, _S_ROULETTE, cfg.seed,
                               dtype)
            die = u < roulette_prob
            color = jnp.where((alive & die)[:, None],
                              color * roulette_prob, color)
            alive = alive & ~die
        # (DEPTH_LINEAR roulette belongs to the wavefront path.)

        res = marchlib.march(scene, origin, direction, cfg,
                             differentiable=differentiable, active=alive)

        u4 = rnglib.uniform4(pixel_id, counter, _S_SHADE, cfg.seed, dtype)
        if diffuse_only:
            normal = scenelib.calc_normal(scene, res.index, res.position)
            outer = jnp.sum(direction * normal, -1) < 0.0
            normal = jnp.where(outer[:, None], normal, -normal)
            new_dir = rnglib.hemispheric(normal, u4[0], u4[1])
            new_origin = res.position
            color_scale = scenelib.materials_at(scene, res.index).albedo
            diff_lobe = jnp.ones_like(res.hit)
        else:
            inter = shadelib.ray_surface_interaction(
                scene, res.index, res.position, direction, u4, cfg,
                roughness_fresnel=roughness_fresnel,
                restart_at_hit=restart_at_hit,
                reflect_kill=reflect_kill)
            new_dir, new_origin, color_scale = inter[:3]
            normal, diff_lobe = inter.normal, inter.diffuse

        # hit: update throughput, test brightness termination
        color_hit = color * color_scale
        intensity = brightness(color_hit)
        color_hit = color_hit * scenelib.materials_at(scene,
                                                      res.index).emission
        visible = brightness(color_hit)
        stop_hit = (intensity < visible) | (visible < cfg.visibility[0]) \
            | (visible > cfg.visibility[1])

        # miss: sky and stop
        color_miss = color * sky_color(env, direction)

        upd = alive
        hit = res.hit
        if cfg.env_sampling:
            # sky weighting: radiance through the previous bounce's sampled
            # lobe was (partially) credited by NEE at that vertex — weight
            # the continuation's lookup by the complement (0 = diffuse
            # exact partition; balance-heuristic under cfg.mis_specular)
            color_miss = color_miss * sky_w[:, None]
            # The bank at vertex i stands in for the sky lookup the
            # continuation would make at segment i+1; skip it on the final
            # iteration (the loop ends before that lookup could happen), and
            # under EXP roulette scale it by the continuation's survival
            # probability exp(-(i+1)/lq) — the plain estimator only realizes
            # the sky sample when the path survives that roulette (and gets
            # no 1/prob upscale; cornell_box.py:297-303), so an
            # uncompensated bank drifts bright at realistic light_quality
            # (ADVICE r3). Residual deviation: a roulette-killed lane's
            # in-flight-throughput heuristic contribution is unchanged by
            # the partition and cancels in the difference of means.
            gate = upd & hit & ~stop_hit & (i < max_bounce - 1)
            # NEE uses the raw albedo, not color_scale (reflect_kill bias —
            # see _trace_one_bounce).
            nee_albedo = scenelib.materials_at(scene, res.index).albedo
            if diffuse_only:
                side = jnp.ones_like(gate)
                nee, _ = _nee_env(scene, env, res.index, res.position,
                                  direction, normal, side, nee_albedo, gate,
                                  pixel_id, counter, cfg, lobe_prob=False)
            else:
                nee, _ = _nee_env(scene, env, res.index, res.position,
                                  direction, normal, inter.outer, nee_albedo,
                                  gate, pixel_id, counter, cfg,
                                  roughness_fresnel=roughness_fresnel,
                                  reflect_kill=reflect_kill)
            if cfg.roulette == Roulette.EXP:
                nee = nee * jnp.exp(-(i.astype(dtype) + 1.0)
                                    / cfg.light_quality)
            radiance = radiance + jnp.where(gate[:, None], color * nee, 0.0)
            nsw = jnp.ones_like(sky_w)
            if cfg.mis_specular and not diffuse_only:
                from .ibl import env_pdf
                ps_b = shadelib.specular_env_density(
                    scene, res.index, direction, inter.normal, inter.outer,
                    new_dir, cfg, roughness_fresnel=roughness_fresnel,
                    reflect_kill=reflect_kill)
                w_b = jax.lax.stop_gradient(
                    ps_b / jnp.maximum(env_pdf(env, new_dir) + ps_b, 1e-20))
                nsw = jnp.where(inter.reflect, w_b, nsw)
            nsw = jnp.where(diff_lobe, jnp.zeros_like(nsw), nsw)
            sky_w = jnp.where(upd, jnp.where(gate, nsw, jnp.ones_like(nsw)),
                              sky_w)
        color = jnp.where((upd & hit)[:, None], color_hit,
                          jnp.where((upd & ~hit)[:, None], color_miss, color))
        origin = _where(upd & hit, new_origin, origin)
        direction = _where(upd & hit, new_dir, direction)
        bounces = bounces + (upd & hit).astype(jnp.int32)
        alive = alive & hit & ~stop_hit
        if cfg.env_sampling:
            return (origin, direction, color, alive, bounces,
                    radiance, sky_w), None
        return (origin, direction, color, alive, bounces), None

    # derive mask/counter inits from the ray arrays so they carry the same
    # varying-axis type under shard_map (see ops/march.py note)
    zero = rays.origin[:, 0] * 0.0
    init = (rays.origin, rays.direction, rays.color,
            zero < 1.0, zero.astype(jnp.int32))
    if cfg.env_sampling:
        # banked radiance accumulator + sky weight (1 = plain lookup)
        init = init + (jnp.zeros_like(rays.color), zero + 1.0)
    if differentiable:
        # reverse-mode AD needs a fixed-trip scan (while_loop has no
        # transpose); bounded bounce budgets keep this cheap
        out, _ = jax.lax.scan(body, init, jnp.arange(max_bounce))
    else:
        # forward renders exit as soon as every lane has terminated — with
        # roulette + brightness termination the whole batch usually dies
        # long before max_raytrace (the GPU megakernel's per-thread `break`,
        # SURVEY.md §3.2, recovered at batch granularity)
        def w_cond(c):
            i, carry = c
            return (i < max_bounce) & jnp.any(carry[3])

        def w_body(c):
            i, carry = c
            carry, _ = body(carry, i)
            return i + 1, carry

        _, out = jax.lax.while_loop(
            w_cond, w_body, (jnp.zeros((), jnp.int32), init))
    color, bounces = out[2], out[4]
    if cfg.env_sampling:
        color = color + out[5]  # banked NEE radiance
    # paths still alive after max bounces contribute their current color
    # (reference loop simply ends; throughput*emission already accumulated)
    return TraceResult(color, bounces)


def render_image(scene: Scene, env: Environment, cam: Camera,
                 cfg: RenderConfig, spp: Optional[int] = None,
                 sample_offset: int = 0, exposure=1.0,
                 diffuse_only: bool = False, differentiable: bool = False,
                 tonemapped: bool = True,
                 roughness_fresnel: bool = True,
                 restart_at_hit: bool = True,
                 reflect_kill: Optional[bool] = None) -> jax.Array:
    """Offline still: average ``spp`` megakernel samples per pixel and
    tonemap. The per-frame loop of ``bunny_sdf_glass.py:437-451`` /
    ``cornell_box.py:346-379`` as one pure function. Returns (H, W, 3)
    (row-major image; internal layout is x-major flat like the reference's
    ``ij`` fields)."""
    n = cfg.num_pixels
    spp = spp if spp is not None else cfg.samples_per_pixel
    pixel_id = jnp.arange(n, dtype=jnp.uint32)

    def one_sample(accum, s):
        u_cam = rnglib.sampler4(cfg.low_discrepancy)(
            pixel_id, s, _S_CAMERA, cfg.seed)
        uv = cameralib.pixel_uv(pixel_id, cfg.width, cfg.height,
                                u_cam[0], u_cam[1])
        rays = cameralib.get_ray(cam, uv, u_cam[2], u_cam[3])
        out = megakernel_trace(scene, env, rays, pixel_id, s, cfg,
                               diffuse_only=diffuse_only,
                               differentiable=differentiable,
                               roughness_fresnel=roughness_fresnel,
                               restart_at_hit=restart_at_hit,
                               reflect_kill=reflect_kill)
        return accum + out.color, None

    if differentiable:
        # unrolled python loop (scan-of-custom-vjp is fine, but unrolling
        # keeps backward memory proportional to spp only via rematerialization)
        accum = jnp.zeros((n, 3))
        for s in range(spp):
            accum, _ = one_sample(accum, jnp.asarray(sample_offset + s))
    else:
        accum, _ = jax.lax.scan(
            one_sample, jnp.zeros((n, 3)),
            jnp.asarray(sample_offset, jnp.uint32)
            + jnp.arange(spp, dtype=jnp.uint32))
    mean = accum / spp
    img = postlib.tonemap(mean, cfg, exposure) if tonemapped else mean
    # flat x-major (W*H) -> (H, W, 3) with row 0 at top for PNG output
    return jnp.transpose(img.reshape(cfg.width, cfg.height, 3),
                         (1, 0, 2))[::-1]
