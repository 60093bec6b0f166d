"""Postprocess pipeline: accumulation mean, exposure/gamma, ACES tonemap,
adaptive-sampling noise metric, denoiser.

Reference: ``/root/reference/src/postprocessor.py``, ``src/aces.py`` (fitted
ACES after Stephen Hill), ``examples/denoise/denoise_test_1.py``. Both
pipeline orderings from the reference are supported (SURVEY.md §2.3.12).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import RenderConfig, Tonemap
from ..core.math import brightness

import numpy as np

# Stephen-Hill fitted ACES matrices; src/aces.py:5-15. Taichi mat3 fills
# row-major, and the reference applies them as M @ rgb (column vector).
# numpy (host) constants: module import must not create device values
# (see parallel/mesh.multihost_init); jnp ops cast them at trace time.
ACES_INPUT = np.array([
    [0.59719, 0.35458, 0.04823],
    [0.07600, 0.90834, 0.01566],
    [0.02840, 0.13383, 0.83777],
], dtype=np.float32)
ACES_OUTPUT = np.array([
    [1.60475, -0.53108, -0.07367],
    [-0.10208, 1.10813, -0.00605],
    [-0.00327, -0.07276, 1.07602],
], dtype=np.float32)


def rrt_and_odt_fit(v: jax.Array) -> jax.Array:
    """Rational fit; ``src/aces.py:18-22``."""
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return a / b


def _mat3_apply(m: np.ndarray, rgb: jax.Array) -> jax.Array:
    """``rgb @ m.T`` as explicit elementwise FMAs.

    Nine scalar-coefficient FMAs on the (N,) channel arrays are exact f32
    at any matmul precision setting, and a 3-wide contraction gains nothing
    from a matrix unit."""
    c = [rgb[..., k] for k in range(3)]
    rows = [sum(float(m[i][k]) * c[k] for k in range(3)) for i in range(3)]
    return jnp.stack(rows, axis=-1)


def aces_fitted(rgb: jax.Array) -> jax.Array:
    """Fitted ACES RRT+ODT; ``src/aces.py:26-30`` (rgb (..., 3))."""
    v = _mat3_apply(ACES_INPUT, rgb)
    v = rrt_and_odt_fit(v)
    return _mat3_apply(ACES_OUTPUT, v)


def average(accum: jax.Array) -> jax.Array:
    """Progressive mean = rgb / sample-count (alpha);
    ``src/postprocessor.py:13-14``. Zero-sample pixels stay black."""
    count = accum[..., 3:4]
    return jnp.where(count > 0, accum[..., :3] / jnp.maximum(count, 1e-12),
                     0.0)


def adjust(rgb: jax.Array, exposure, gamma) -> jax.Array:
    """Exposure multiply + power; ``src/postprocessor.py:17-21``."""
    return (rgb * exposure) ** gamma


def tonemap(rgb: jax.Array, cfg: RenderConfig, exposure=1.0) -> jax.Array:
    """Full tonemap in the configured ordering (SURVEY.md §2.3.12).

    * GAMMA_THEN_ACES (src/postprocessor.py:24-38):
        exposure -> pow(1/gamma) -> ACES -> clamp
    * ACES_THEN_GAMMA (cornell_box.py:374-377):
        exposure -> ACES -> pow(1/gamma)
    """
    inv_gamma = 1.0 / cfg.gamma
    if cfg.tonemap == Tonemap.GAMMA_THEN_ACES:
        out = aces_fitted(adjust(rgb, exposure, inv_gamma))
    elif cfg.tonemap == Tonemap.ACES_THEN_GAMMA:
        out = jnp.maximum(aces_fitted(rgb * exposure), 0.0) ** inv_gamma
    else:
        out = rgb * exposure
    if cfg.clamp_output:
        out = jnp.clip(out, 0.0, 1.0)
    return out


def post_process(accum: jax.Array, cfg: RenderConfig, exposure=1.0,
                 last_pixels=None, diff_accum=None):
    """The full ``post_process`` kernel (``src/postprocessor.py:24-43``).

    Returns ``(pixels, diff_accum, noise)``; the latter two implement the
    adaptive-sampling noise estimate (running mean of per-update luma deltas,
    ``src/postprocessor.py:40-43``) and are passed through unchanged when
    ``cfg.adaptive_sampling`` is off.
    """
    pixels = tonemap(average(accum), cfg, exposure)
    if not cfg.adaptive_sampling or last_pixels is None:
        return pixels, diff_accum, None
    diff = jnp.abs(pixels - last_pixels)
    diff_accum = diff_accum + jnp.stack(
        [brightness(diff), jnp.ones_like(diff[..., 0])], axis=-1)
    noise = diff_accum[..., 0] / diff_accum[..., 1]
    return pixels, diff_accum, noise


def denoise(pixels_in: jax.Array, pixels_out: jax.Array,
            threshold: float = 0.2, blend: float = 0.2) -> jax.Array:
    """Temporal/spatial hole-filling denoiser prototype
    (``examples/denoise/denoise_test_1.py:86-118``, after shadertoy 7tKGzD).

    ``pixels_in``/``pixels_out``: (H, W, 3) current frame and feedback buffer.
    Blend ``mix(in, out, blend)``; pixels darker than ``threshold`` are
    replaced with the mean of their above-threshold 4-neighborhood.

    The reference has a latent bug (``sur3`` re-reads the ``j+1`` neighbor,
    ``denoise_test_1.py:96-97``, SURVEY.md §7.5); we implement the intended
    4-neighborhood and note the divergence here rather than replicate it.
    """
    col = pixels_in + (pixels_out - pixels_in) * blend

    def shift(img, di, dj):
        # clamp-to-edge neighbor fetch, vectorized over the image
        h, w = img.shape[0], img.shape[1]
        ii = jnp.clip(jnp.arange(h) + di, 0, h - 1)
        jj = jnp.clip(jnp.arange(w) + dj, 0, w - 1)
        return img[ii][:, jj]

    neighbors = [shift(pixels_out, 1, 0), shift(pixels_out, -1, 0),
                 shift(pixels_out, 0, 1), shift(pixels_out, 0, -1)]
    acc = jnp.zeros_like(pixels_in)
    cnt = jnp.zeros(pixels_in.shape[:-1] + (1,), pixels_in.dtype)
    for nb in neighbors:
        good = (brightness(nb) > threshold)[..., None]
        acc = acc + jnp.where(good, nb, 0.0)
        cnt = cnt + good.astype(cnt.dtype)
    filled = acc / jnp.maximum(cnt, 1.0)
    dark = (brightness(pixels_in) < threshold)[..., None] & (cnt > 0)
    return jnp.where(dark, filled, col)


def inject_dropout_noise(pixels: jax.Array, u: jax.Array,
                         keep: float = 0.5) -> jax.Array:
    """Unbiased multiplicative dropout used to exercise the denoiser
    (``denoise_test_1.py:75-83``): x -> 0 w.p. (1-keep) else x/keep."""
    mask = (u < keep).astype(pixels.dtype)[..., None]
    return pixels * mask / keep
