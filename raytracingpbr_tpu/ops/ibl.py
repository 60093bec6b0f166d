"""Environment lighting (IBL + procedural skies).

Reference: ``/root/reference/src/ibl.py`` (equirectangular HDR lookup with
pre-baked exposure/gamma), the procedural gradient sky
(``examples/scene_demo/main.py:246-248``), and the black/white backgrounds
(``src/pathtracer.py:33-34``, ``bunny_sdf.py:352``,
``bunny_sdf_v2.py:355-358``).

Design: the environment is a small pytree with a *static* kind;
``sky_color`` dispatches at trace time. HDR maps are replicated device arrays
and the lookup is a gather (SURVEY.md §7.1). Beyond reference parity we add a
bilinear filter and a luminance-CDF importance sampler (the reference's own
ToDo list points this direction; see ``EnvImportanceSampler``).
"""
from __future__ import annotations

import enum
from typing import Optional

import jax
import jax.numpy as jnp

from ..core import struct
from ..core.math import brightness, mix, sample_spherical_map


class SkyKind(str, enum.Enum):
    HDR = "hdr"              # equirect texture (src/ibl.py:37-40)
    GRADIENT = "gradient"    # scene_demo/main.py:246-248
    BLACK = "black"          # cornell megakernels (cornell_box.py:232-234)
    WHITE = "white"          # bunny_sdf_v2.py:355-358
    CONSTANT = "constant"


@struct.dataclass
class Environment:
    kind: str = struct.field(pytree_node=False)
    bilinear: bool = struct.field(pytree_node=False)
    image: Optional[jax.Array] = None   # (W, H, 3) img[x, y] like ti fields
    scale: jax.Array = 1.0              # post-lookup multiplier
    color_a: Optional[jax.Array] = None  # gradient horizon / constant color
    color_b: Optional[jax.Array] = None  # gradient zenith
    # Optional NEE alias table (with_env_sampler); consumed by the
    # integrators when cfg.env_sampling is on. None = no table baked.
    s_prob: Optional[jax.Array] = None   # (W*H,) acceptance prob per texel
    s_alias: Optional[jax.Array] = None  # (W*H,) i32 alias texel
    s_pdf: Optional[jax.Array] = None    # (W, H) solid-angle pdf per texel


def black_sky(dtype=jnp.float32) -> Environment:
    return Environment(kind=SkyKind.BLACK.value, bilinear=False,
                       scale=jnp.asarray(1.0, dtype))


def white_sky(dtype=jnp.float32) -> Environment:
    return Environment(kind=SkyKind.WHITE.value, bilinear=False,
                       scale=jnp.asarray(1.0, dtype))


def constant_sky(color, dtype=jnp.float32) -> Environment:
    return Environment(kind=SkyKind.CONSTANT.value, bilinear=False,
                       scale=jnp.asarray(1.0, dtype),
                       color_a=jnp.asarray(color, dtype))


def gradient_sky(scale: float = 1.8, dtype=jnp.float32) -> Environment:
    """Procedural gradient sky; colors from ``scene_demo/main.py:246-248``,
    the 1.8 multiplier from its use site (``main.py:322``)."""
    return Environment(
        kind=SkyKind.GRADIENT.value, bilinear=False,
        scale=jnp.asarray(scale, dtype),
        color_a=jnp.asarray([1.0, 1.0, 0.5], dtype),
        color_b=jnp.asarray([0.25, 0.35, 1.0], dtype),  # (0.5,0.7,2)*0.5
    )


def adjust(rgb: jax.Array, exposure, gamma) -> jax.Array:
    """Exposure multiply + power curve; ``src/postprocessor.py:17-21``.

    Note: the IBL pipeline calls this with gamma = 2.2 (not 1/2.2) to pre-bake
    the decode into the texture (``src/ibl.py:19-23,32-33``).
    """
    return (rgb * exposure) ** gamma


def hdr_environment(image: jax.Array, exposure: float = 1.4,
                    gamma: float = 2.2, bilinear: bool = False,
                    prebake: bool = True, scale: float = 1.0) -> Environment:
    """Build an HDR equirect environment.

    ``image`` is (W, H, 3) linear data, indexed ``img[x, y]`` like the
    reference's Taichi field (``src/ibl.py:14-17``). With ``prebake`` the
    exposure/gamma adjust is applied once here, exactly like
    ``Image.process`` (``src/ibl.py:19-23``).
    """
    img = jnp.asarray(image)
    if prebake:
        img = adjust(img, exposure, gamma)
    return Environment(kind=SkyKind.HDR.value, bilinear=bilinear, image=img,
                       scale=jnp.asarray(scale, img.dtype))


def fetch_rows(table: jax.Array, idx: jax.Array) -> jax.Array:
    """``table[idx]`` for (m, ...) tables and integer indices: a plain
    gather, exact at any table size (the GPU gathers natively)."""
    return table[idx]


def _texture_nearest(img: jax.Array, uv: jax.Array) -> jax.Array:
    """Nearest-neighbor fetch; ``src/ibl.py:25-29`` (int truncation)."""
    w, h = img.shape[0], img.shape[1]
    x = jnp.clip((uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
    return img[x, y]


def _texture_bilinear(img: jax.Array, uv: jax.Array) -> jax.Array:
    """Bilinear fetch with horizontal wrap (quality upgrade; not in ref)."""
    w, h = img.shape[0], img.shape[1]
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0w = jnp.mod(x0, w)
    x1w = jnp.mod(x0 + 1, w)
    y0c = jnp.clip(y0, 0, h - 1)
    y1c = jnp.clip(y0 + 1, 0, h - 1)
    c00 = img[x0w, y0c]
    c10 = img[x1w, y0c]
    c01 = img[x0w, y1c]
    c11 = img[x1w, y1c]
    return mix(mix(c00, c10, tx), mix(c01, c11, tx), ty)


def sky_color(env: Environment, direction: jax.Array) -> jax.Array:
    """Environment radiance along ``direction`` (N, 3) -> (N, 3).

    Static dispatch over ``env.kind`` — the branch resolves at trace time,
    like ``ti.static`` flags (SURVEY.md §5 "Config").
    """
    kind = SkyKind(env.kind)
    if kind == SkyKind.BLACK:
        return jnp.zeros_like(direction)
    if kind == SkyKind.WHITE:
        return jnp.ones_like(direction) * env.scale
    if kind == SkyKind.CONSTANT:
        return jnp.broadcast_to(env.color_a, direction.shape) * env.scale
    if kind == SkyKind.GRADIENT:
        t = 0.5 * direction[..., 1:2] + 0.5
        return mix(env.color_a, env.color_b, t) * env.scale
    # HDR equirect (src/ibl.py:37-40)
    uv = sample_spherical_map(direction)
    tex = _texture_bilinear if env.bilinear else _texture_nearest
    return tex(env.image, uv) * env.scale


@struct.dataclass
class EnvImportanceSampler:
    """Luminance-CDF importance sampler over an equirect map.

    Not present in the reference (its ToDo hints at low-discrepancy sampling,
    ``src/util.py:64``); provided as the standard IBL variance reduction for
    this build. Sampling is two searchsorted gathers.
    """

    env: Environment
    row_cdf: jax.Array      # (W,)   marginal CDF over x (longitude)
    cond_cdf: jax.Array     # (W, H) conditional CDF over y per column
    pdf_map: jax.Array      # (W, H) solid-angle pdf of each texel


def build_env_sampler(env: Environment) -> EnvImportanceSampler:
    img = env.image
    w, h = img.shape[0], img.shape[1]
    # Solid-angle weight: sin(theta), theta in (0, pi) over the y axis — the
    # reference maps uv.y = asin(dir.y)/pi + 0.5, i.e. y is latitude.
    y = (jnp.arange(h) + 0.5) / h
    sin_theta = jnp.cos(jnp.pi * (y - 0.5))  # cos(lat) weight
    lum = brightness(img) * sin_theta[None, :]
    lum = jnp.maximum(lum, 1e-12)
    col_mass = jnp.sum(lum, axis=1)
    row_cdf = jnp.cumsum(col_mass) / jnp.sum(col_mass)
    cond = jnp.cumsum(lum, axis=1)
    cond_cdf = cond / cond[:, -1:]
    # pdf over the sphere: texel mass / total / texel solid angle
    texel_sa = (2 * jnp.pi / w) * (jnp.pi / h) * sin_theta[None, :]
    pdf = lum / jnp.sum(lum) / jnp.maximum(texel_sa, 1e-12)
    return EnvImportanceSampler(env=env, row_cdf=row_cdf, cond_cdf=cond_cdf,
                                pdf_map=pdf)


@struct.dataclass
class EnvAliasSampler:
    """Alias-method (Walker/Vose) importance sampler over an equirect map.

    Same distribution as :class:`EnvImportanceSampler` but O(1) per draw —
    two gathers (prob, alias) instead of a ~22-step binary search per lane —
    the right trade inside a per-bounce NEE loop. Table build is one
    host-side O(W*H) pass at scene setup.
    """

    env: Environment
    prob: jax.Array       # (W*H,) acceptance probability per texel
    alias: jax.Array      # (W*H,) i32 alias texel
    pdf_map: jax.Array    # (W, H) solid-angle pdf of each texel


def build_env_alias_sampler(env: Environment) -> EnvAliasSampler:
    import numpy as np

    img = env.image
    w, h = img.shape[0], img.shape[1]
    y = (jnp.arange(h) + 0.5) / h
    sin_theta = jnp.cos(jnp.pi * (y - 0.5))
    lum = brightness(img) * sin_theta[None, :]
    lum = jnp.maximum(lum, 1e-12)
    texel_sa = (2 * jnp.pi / w) * (jnp.pi / h) * sin_theta[None, :]
    pdf = lum / jnp.sum(lum) / jnp.maximum(texel_sa, 1e-12)

    # Vose alias construction (host-side numpy; stacks, not vectorizable)
    p = np.asarray(lum, np.float64).reshape(-1)
    n = p.size
    p = p / p.sum() * n
    alias = np.zeros(n, np.int32)
    prob = np.ones(n, np.float64)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = p[l] - (1.0 - p[s])
        (small if p[l] < 1.0 else large).append(l)
    for i in large + small:
        prob[i] = 1.0
    return EnvAliasSampler(env=env, prob=jnp.asarray(prob, jnp.float32),
                           alias=jnp.asarray(alias), pdf_map=pdf)


def sample_env_alias(sampler: EnvAliasSampler, u1: jax.Array,
                     u2: jax.Array):
    """Draw directions ~ envmap luminance via the alias table: ``u1`` picks
    the cell, ``u2`` the accept/alias branch (independent uniforms — see
    :func:`sample_env_baked` on why reusing ``u1``'s fraction quantizes the
    accept test on large maps). Returns (direction (N,3), radiance (N,3),
    pdf (N,)) — the same distribution and return contract as
    :func:`sample_env`."""
    img = sampler.env.image
    w, h = img.shape[0], img.shape[1]
    n = w * h
    scaled = u1 * n
    cell = jnp.clip(scaled.astype(jnp.int32), 0, n - 1)
    take_alias = u2 >= sampler.prob[cell]
    texel = jnp.where(take_alias, sampler.alias[cell], cell)
    x = texel // h
    y = texel % h
    uu = (x.astype(img.dtype) + 0.5) / w
    vv = (y.astype(img.dtype) + 0.5) / h
    phi = (uu - 0.5) * (2 * jnp.pi)
    lat = (vv - 0.5) * jnp.pi
    cl = jnp.cos(lat)
    direction = jnp.stack(
        [cl * jnp.cos(phi), jnp.sin(lat), cl * jnp.sin(phi)], axis=-1)
    radiance = img[x, y] * sampler.env.scale
    pdf = sampler.pdf_map[x, y]
    return direction, radiance, pdf


def with_env_sampler(env: Environment) -> Environment:
    """Bake the alias-method importance table into the Environment so NEE
    (``cfg.env_sampling``) needs no side-channel sampler object — the table
    rides the env pytree through jit/shard_map unchanged. HDR maps only."""
    if SkyKind(env.kind) != SkyKind.HDR:
        raise ValueError("env_sampling requires an HDR environment; got "
                         f"{env.kind}")
    s = build_env_alias_sampler(env)
    return env.replace(s_prob=s.prob, s_alias=s.alias,
                       s_pdf=s.pdf_map.astype(env.image.dtype))


def _texel_center_cl(y, h, dtype):
    """cos(latitude) at the center of texel row ``y`` — the weight baked
    into ``s_pdf`` (texel mass / texel solid angle at the center sin)."""
    vv = (y.astype(dtype) + 0.5) / h
    return jnp.cos((vv - 0.5) * jnp.pi)


def sample_env_baked(env: Environment, u: jax.Array,
                     u_accept: "jax.Array" = None,
                     u_jitter: tuple = None):
    """Draw directions ~ envmap luminance from the table baked by
    :func:`with_env_sampler` (alias method: ``u`` picks the cell,
    ``u_accept`` the accept/alias branch). Pass a SECOND independent
    uniform as ``u_accept``: reusing ``u``'s fractional part quantizes the
    accept test to steps of ``n / 2^24`` — fine for small synthetic envs
    but ~0.28 steps for a 3k HDR map (n ~ 4.7M texels), silently skewing
    the sampled distribution away from the pdf the estimator divides by
    (ADVICE r3). The fractional fallback remains for single-uniform
    callers.

    ``u_jitter=(ux, uy)``: jitter the draw uniformly WITHIN the chosen
    texel instead of returning its center. Without it the sampler is
    atomic (512 discrete directions on a 32x16 map), and any estimator
    pairing a center-point draw against a continuous competitor — the
    specular MIS balance weights — inherits a midpoint-quadrature bias of
    order (texel size)^2 x curvature (measured ~2-5% bright on the 11-deg
    texels of the test envs). The jittered pdf is EXACT:
    ``s_pdf[k] * cos(lat_center_k) / cos(lat(w))`` (uv uniform in the
    texel => solid-angle density ~ 1/cos(lat)).

    Returns (direction (N, 3), radiance (N, 3), pdf (N,))."""
    img = env.image
    w, h = img.shape[0], img.shape[1]
    n = w * h
    scaled = u * n
    cell = jnp.clip(scaled.astype(jnp.int32), 0, n - 1)
    if u_accept is None:
        u_accept = scaled - cell.astype(scaled.dtype)
    take_alias = u_accept >= fetch_rows(env.s_prob, cell)
    texel = jnp.where(take_alias, fetch_rows(env.s_alias, cell), cell)
    x = texel // h
    y = texel % h
    if u_jitter is None:
        off_u = off_v = 0.5
    else:
        off_u, off_v = u_jitter
    uu = (x.astype(img.dtype) + off_u) / w
    vv = (y.astype(img.dtype) + off_v) / h
    phi = (uu - 0.5) * (2 * jnp.pi)
    lat = (vv - 0.5) * jnp.pi
    cl = jnp.cos(lat)
    direction = jnp.stack(
        [cl * jnp.cos(phi), jnp.sin(lat), cl * jnp.sin(phi)], axis=-1)
    radiance = img[x, y] * env.scale
    pdf = env.s_pdf[x, y]
    if u_jitter is not None:
        pdf = pdf * _texel_center_cl(y, h, img.dtype) \
            / jnp.maximum(cl, 1e-4)
    return direction, radiance, pdf


def env_pdf(env: Environment, direction: jax.Array) -> jax.Array:
    """Solid-angle pdf of the baked JITTERED env sampler AT an arbitrary
    direction — the balance-heuristic MIS weights need the competing
    sampler's density at the BSDF-sampled direction. Matches
    :func:`sample_env_baked` with ``u_jitter``:
    ``s_pdf[texel] * cos(lat_center)/cos(lat)``. Requires a baked table
    (:func:`with_env_sampler`)."""
    img = env.image
    w, h = img.shape[0], img.shape[1]
    uv = sample_spherical_map(direction)
    x = jnp.clip((uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
    cl = jnp.sqrt(jnp.maximum(1.0 - direction[..., 1] ** 2, 1e-8))
    spdf = env.s_pdf[x, y]
    return spdf * _texel_center_cl(y, h, img.dtype) \
        / jnp.maximum(cl, 1e-4)


def sample_env(sampler: EnvImportanceSampler, u1: jax.Array, u2: jax.Array):
    """Draw directions ~ envmap luminance. Returns (direction, radiance, pdf)."""
    img = sampler.env.image
    w, h = img.shape[0], img.shape[1]
    x = jnp.clip(jnp.searchsorted(sampler.row_cdf, u1), 0, w - 1)
    cdf_x = sampler.cond_cdf[x]
    y = jnp.clip(
        jax.vmap(jnp.searchsorted)(cdf_x, u2), 0, h - 1)
    # uv center -> direction (inverse of sample_spherical_map)
    uu = (x.astype(img.dtype) + 0.5) / w
    vv = (y.astype(img.dtype) + 0.5) / h
    phi = (uu - 0.5) * (2 * jnp.pi)
    lat = (vv - 0.5) * jnp.pi
    cl = jnp.cos(lat)
    direction = jnp.stack(
        [cl * jnp.cos(phi), jnp.sin(lat), cl * jnp.sin(phi)], axis=-1)
    radiance = img[x, y] * sampler.env.scale
    pdf = sampler.pdf_map[x, y]
    return direction, radiance, pdf
