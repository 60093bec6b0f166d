"""Materials / BSDF shading.

Reference: ``/root/reference/src/pbr.py`` — one fused stochastic interaction:
roughness-lerped microfacet normal, Schlick Fresnel, stochastic lobe selection
(reflect / refract / diffuse) and throughput update. The reference leaves
``# ToDo: Removing if statements?`` (``src/pbr.py:47``); this implementation
answers it: all three lobe outcomes are computed for the batch and selected
with ``jnp.where`` — branchless, divergence-free code (SURVEY.md §7.1).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..core import rng as rnglib
from ..core.math import dot, mix, normalize
from . import scene as scenelib
from .scene import Scene


def fresnel_schlick(no_i: jax.Array, f0: jax.Array) -> jax.Array:
    """Schlick approximation; ``src/pbr.py:12-13``:
    ``mix(|1 + NoI|^5, 1, F0)``."""
    return mix(jnp.abs(1.0 + no_i) ** 5, 1.0, f0)


def fresnel_schlick_roughness(no_i, f0, roughness):
    """Roughness-remapped Schlick used by the example megakernels
    (``cornell_box.py:237-238``): ``mix(schlick, F0, roughness)``."""
    return mix(fresnel_schlick(no_i, f0), f0, roughness)


class Interaction(NamedTuple):
    direction: jax.Array  # (N, 3) new ray direction
    origin: jax.Array     # (N, 3) new ray origin (restart offset applied)
    color_scale: jax.Array  # (N, 3) multiplicative throughput update (albedo)
    normal: jax.Array     # (N, 3) true surface normal, faced to the incident
    diffuse: jax.Array    # (N,) bool — the diffuse lobe was selected (NEE)
    outer: jax.Array      # (N,) bool — ray arrived from the outside
    killed: jax.Array     # (N,) bool — reflect_kill zeroed the throughput
    #                       (all-False unless reflect_kill; the path-replay
    #                       backward needs the mask separate from color_scale
    #                       so its local-factor VJP sees d(scale)/d(albedo)=0
    #                       on killed lanes)
    reflect: jax.Array    # (N,) bool — the reflect lobe was selected
    #                       (specular MIS sky weighting)


def diffuse_lobe_prob(scene: Scene, index: jax.Array, direction: jax.Array,
                      normal: jax.Array, outer: jax.Array,
                      omega_l: jax.Array, cfg: RenderConfig,
                      roughness_fresnel: bool = False) -> jax.Array:
    """P(diffuse lobe selected | the hemispheric draw landed on ``omega_l``).

    The lobe roulette in :func:`ray_surface_interaction` is CORRELATED with
    the scatter direction: ``fr`` is evaluated at ``rough_n(ω_h)`` which is a
    deterministic function of the hemispheric draw (at roughness 1,
    ``rough_n`` IS the draw). An NEE estimator of the diffuse-lobe env
    integral must therefore carry this conditional probability at the light
    direction — gating on "the lobe roulette picked diffuse" factorizes a
    correlated product and biases sun-lit surfaces bright by up to ~2x
    (measured; see tests/test_nee.py). ``u2``/``u3`` marginalize to
    ``P_reflect = min(1, fr + metallic)`` (1 under TIR) and
    ``P(refract | ¬reflect) = clip(transmission, 0, 1)``.

    ``normal`` is the incident-faced surface normal and ``outer`` the
    original sidedness bit, both from the Interaction.
    """
    mat = scenelib.materials_at(scene, index)
    roughness, metallic = mat.roughness, mat.metallic
    transmission, ior = mat.transmission, mat.ior
    alpha = (roughness * roughness)[:, None]
    rough_n = normalize(mix(normal, omega_l, alpha))
    no_i = dot(rough_n, direction)
    env_ior = cfg.env_ior
    eta = jnp.where(outer, env_ior / ior, ior / env_ior)
    k = 1.0 - eta * eta * (1.0 - no_i * no_i)
    f0 = 2.0 * (eta - 1.0) / (eta + 1.0)
    f0 = f0 * f0
    if roughness_fresnel and cfg.f0_half:
        f0 = 0.5 * f0  # example F0 variant — see ray_surface_interaction
    if roughness_fresnel:
        fr = fresnel_schlick_roughness(no_i, f0, roughness)
    else:
        fr = fresnel_schlick(no_i, f0)
    p_reflect = jnp.where(k < 0.0, 1.0, jnp.clip(fr + metallic, 0.0, 1.0))
    return (1.0 - p_reflect) * (1.0 - jnp.clip(transmission, 0.0, 1.0))


def _halfway(omega, direction, normal):
    """Admissible reflect-lobe halfway vector of ``omega``: the unit vector
    along ``omega - i`` with positive normal component (guarded at the
    ``omega == i`` caustic and the horizontal sign boundary)."""
    diff = omega - direction
    nrm = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, -1, keepdims=True),
                               1e-24))
    m = diff / nrm
    s = jnp.sign(dot(m, normal))
    return m * jnp.where(s == 0.0, 1.0, s)[:, None]


def _reflect_density_raw(direction, normal, alpha, omega):
    """Solid-angle density of the RAW reflect-lobe map at direction ``omega``.

    The sampler draws ``h`` ~ cosine hemisphere around ``normal``, forms the
    microfacet proxy ``m = normalize((1-a)n + a h)`` (``a = roughness^2``)
    and reflects: ``w = i - 2(m.i)m``. The map w -> m is the halfway
    inversion ``m = normalize(w - i)`` (Jacobian ``dw = 4|m.i| dm``); the
    map m -> h inverts the blend: ``h = (k m - (1-a) n)/a`` with
    ``k = c(m.n) + sqrt(c^2((m.n)^2 - 1) + a^2)``, ``c = 1-a`` (the affine
    image of the hemisphere is the radius-``a`` sphere centred at ``c n``,
    whose outward normal at ``v = k m`` is ``h``, giving the projection
    Jacobian ``dw_m = a^2 (m.h)/|v|^2 dw_h``). Altogether

        p(w) = (h.n) k^2 / (pi a^2 (m.h) 4 |m.i|)

    and p = 0 where the inversion has no solution (outside the lobe's
    reach). Used by the one-sample MIS between env and BSDF sampling
    (cfg.env_sampling): both the bank's density ratio and the balance
    weights. ``alpha`` is clamped away from 0; the weight formulas remain
    bounded as p -> inf (mirror limit: pure BSDF sampling).
    """
    dtype = direction.dtype
    a = jnp.maximum(alpha, 1e-6)
    c = 1.0 - a
    # branch selection: w - i = -2(m.i) m, and m.i can be EITHER sign (the
    # reference's Schlick |1+NoI|^5 exceeds 1 for backward-facing proxies,
    # forcing "reflections" off the back of the microfacet) — the admissible
    # preimage is the sign with m.n > 0 (m is a blend of n and an
    # upper-hemisphere h, so m.n > 0 structurally). Guarded normalize:
    # w == i (retroreflection, a genuine fold caustic where the density
    # diverges integrably) would otherwise produce NaN.
    m = _halfway(omega, direction, normal)
    mn = dot(m, normal)
    disc = c * c * (mn * mn - 1.0) + a * a
    ok = disc > 0.0
    k = c * mn + jnp.sqrt(jnp.maximum(disc, 1e-20))
    h = (k[:, None] * m - c[:, None] * normal) / a[:, None]
    hn = dot(h, normal)
    mh = dot(m, h)
    mi = dot(m, direction)
    ok = ok & (hn > 0.0) & (mh > 1e-6) & (k > 0.0) & (jnp.abs(mi) > 1e-6)
    p = (hn * k * k) / (jnp.pi * a * a * jnp.maximum(mh, 1e-6)
                       * 4.0 * jnp.maximum(jnp.abs(mi), 1e-6))
    return jnp.where(ok, p, jnp.zeros_like(p)).astype(dtype)


def specular_env_density(scene: Scene, index: jax.Array,
                         direction: jax.Array, normal: jax.Array,
                         outer: jax.Array, omega_l: jax.Array,
                         cfg: RenderConfig,
                         roughness_fresnel: bool = False,
                         reflect_kill: Optional[bool] = None) -> jax.Array:
    """``P(reflect lobe) * p_spec(omega_l)`` — the joint density of the
    stochastic interaction selecting the reflect lobe AND scattering into
    ``omega_l`` (the reflect-lobe analog of :func:`diffuse_lobe_prob`, which
    returns a probability because the diffuse density cos/pi is factored
    into the NEE estimator separately; here the full density is returned).

    The lobe roulette is correlated with the draw through ``fr(m)``, so
    ``P_reflect`` is evaluated at the halfway vector of ``omega_l``. Under
    the src-variant fold (``reflect_kill=False``) a below-surface raw
    reflection is mapped to ``-w``, so the density at an above-surface
    ``omega_l`` gains the folded preimage ``p_raw(-omega_l)``; under the
    example-variant kill that mass carries zero throughput and is excluded.
    """
    if reflect_kill is None:
        reflect_kill = roughness_fresnel
    mat = scenelib.materials_at(scene, index)
    roughness, metallic, ior = mat.roughness, mat.metallic, mat.ior
    alpha = roughness * roughness

    def p_with_sel(w):
        # same branch selection as _reflect_density_raw: the admissible
        # halfway vector has m.n > 0 (backward-facing proxies flip the
        # sign of w - i) — the roulette's fr must be evaluated on it
        m = _halfway(w, direction, normal)
        no_i = dot(m, direction)
        env_ior = cfg.env_ior
        eta = jnp.where(outer, env_ior / ior, ior / env_ior)
        k_tir = 1.0 - eta * eta * (1.0 - no_i * no_i)
        f0 = 2.0 * (eta - 1.0) / (eta + 1.0)
        f0 = f0 * f0
        if roughness_fresnel and cfg.f0_half:
            f0 = 0.5 * f0
        if roughness_fresnel:
            fr = fresnel_schlick_roughness(no_i, f0, roughness)
        else:
            fr = fresnel_schlick(no_i, f0)
        p_sel = jnp.where(k_tir < 0.0, 1.0,
                          jnp.clip(fr + metallic, 0.0, 1.0))
        return p_sel * _reflect_density_raw(direction, normal, alpha, w)

    p = p_with_sel(omega_l)
    if not reflect_kill:
        # folded preimage: raw reflections landing at -omega_l (below the
        # surface whenever omega_l is above) are folded onto omega_l
        p = p + p_with_sel(-omega_l)
    # energy-carrying reflections are supported above the faced normal only
    # (fold moves the below mass up; kill zeroes its throughput) — the
    # density consulted by the MIS weights is that of energy-carrying
    # continuations
    return jnp.where(dot(omega_l, normal) > 0.0, p, jnp.zeros_like(p))


def ray_surface_interaction(
    scene: Scene,
    index: jax.Array,      # (N,) hit object per lane
    position: jax.Array,   # (N, 3) shading point
    direction: jax.Array,  # (N, 3) incident direction
    u: tuple,              # 4 uniforms: (hemi1, hemi2, lobe1, lobe2)
    cfg: RenderConfig,
    roughness_fresnel: bool = False,
    restart_at_hit: bool = False,
    reflect_kill: Optional[bool] = None,
) -> Interaction:
    """Branchless port of ``ray_surface_interaction`` (``src/pbr.py:23-62``).

    ``roughness_fresnel`` switches to the example-variant Fresnel
    (SURVEY.md §7.5); ``restart_at_hit`` uses the examples' restart policy
    (``origin = hit position``, ``cornell_box.py:287``) instead of the src/
    engine's normal offset (``src/pbr.py:60``).

    ``reflect_kill``: what happens when the sampled reflection lands below
    the true surface. The src/ engine folds it back above
    (``src/pbr.py:49-51``); EVERY example megakernel instead zeroes the
    throughput (``cornell_box.py:280`` ``ray.color *= float(dot(...) > 0)``)
    — the path continues below the surface carrying no energy. ``None``
    (default) follows the variant split: kill iff ``roughness_fresnel``.
    NOTE the kill factor is a step function of geometry — differentiable
    estimators should fold (``ops/integrator.megakernel_trace`` resolves
    the default to fold whenever ``differentiable`` is set).

    ``cfg.f0_half`` (applied only in the example variant): the cornell/bunny
    megakernels compute ``F0 = (eta-1)/(eta+1); F0 *= 2*F0`` = 2a²
    (``cornell_box.py:275``), HALF the src/scene_demo/tokyo value
    ``(2a)²`` (``src/pbr.py:44-45``, ``scene_demo/main.py:289``) — on an
    ior-1.53 wall the reflect probability is 8.8% vs 17.6%.
    """
    if reflect_kill is None:
        reflect_kill = roughness_fresnel
    mat = scenelib.materials_at(scene, index)
    albedo, roughness = mat.albedo, mat.roughness
    metallic, transmission, ior = mat.metallic, mat.transmission, mat.ior

    # Normal from the SDF gradient, flipped to face the incident ray
    # (two-sided surfaces; src/pbr.py:30-32).
    normal = scenelib.calc_normal(scene, index, position)
    outer = dot(direction, normal) < 0.0
    normal = jnp.where(outer[:, None], normal, -normal)

    # Microfacet proxy: lerp the normal toward a cosine-hemisphere sample by
    # alpha = roughness^2 (src/pbr.py:34-36).
    alpha = (roughness * roughness)[:, None]
    hemispheric = rnglib.hemispheric(normal, u[0], u[1])
    rough_n = normalize(mix(normal, hemispheric, alpha))

    i = direction
    no_i = dot(rough_n, i)

    env_ior = cfg.env_ior
    eta = jnp.where(outer, env_ior / ior, ior / env_ior)
    k = 1.0 - eta * eta * (1.0 - no_i * no_i)  # TIR when k < 0
    f0 = 2.0 * (eta - 1.0) / (eta + 1.0)
    f0 = f0 * f0
    if roughness_fresnel and cfg.f0_half:
        f0 = 0.5 * f0  # example F0 = 2a^2 (see docstring)
    if roughness_fresnel:
        fr = fresnel_schlick_roughness(no_i, f0, roughness)
    else:
        fr = fresnel_schlick(no_i, f0)

    # --- all three lobe outcomes (branchless) ---
    refl = i - 2.0 * no_i[:, None] * rough_n
    refl_outer = dot(refl, normal) < 0.0
    if not reflect_kill:
        # src/pbr.py:49-51 folds the reflected ray back above the surface
        refl = jnp.where(refl_outer[:, None], -refl, refl)

    # TIR lanes never take the refract lobe, but sqrt(0)'s backward is inf
    # and 0-cotangent * inf = NaN poisons the whole VJP (visible only in the
    # f64 gradient oracle; f32 draws happened to miss exact-TIR lanes) —
    # clamp to a tiny positive floor instead of 0.
    k_safe = jnp.maximum(k, 1e-12)
    refr = eta[:, None] * i - (jnp.sqrt(k_safe) + eta * no_i)[:, None] * rough_n

    # --- stochastic lobe selection (src/pbr.py:48-55) ---
    take_reflect = (u[2] < fr + metallic) | (k < 0.0)
    take_refract = (~take_reflect) & (u[3] < transmission)
    new_dir = jnp.where(
        take_reflect[:, None], refl,
        jnp.where(take_refract[:, None], refr, hemispheric))
    color_scale = albedo
    if reflect_kill:
        # example megakernels: a below-surface reflection carries no energy
        # (cornell_box.py:280) — multiply the throughput by the {0,1} factor
        killed = take_reflect & refl_outer
        color_scale = color_scale * (~killed).astype(albedo.dtype)[:, None]
    else:
        killed = jnp.zeros_like(take_reflect)

    # Restart origin (src/pbr.py:58-60): offset along the true normal to
    # whichever side the new direction leaves on.
    if restart_at_hit:
        new_origin = position
    else:
        leave_outer = dot(new_dir, normal) < 0.0
        offs = jnp.where(leave_outer, -cfg.min_dis, cfg.min_dis)
        new_origin = position + normal * offs[:, None]

    return Interaction(new_dir, new_origin, color_scale, normal,
                       ~take_reflect & ~take_refract, outer, killed,
                       take_reflect)
