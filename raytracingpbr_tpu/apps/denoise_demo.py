"""Denoiser demo pipeline: the reference's prototype
(``examples/denoise/denoise_test_1.py``, SURVEY.md §3.5) re-expressed —
sample an HDR texture with jitter, inject unbiased dropout noise, accumulate,
and run the hole-filling denoiser against a feedback buffer.

Usage:
    python -m raytracingpbr_tpu.apps.denoise_demo --steps 100 --out out/dn
"""
from __future__ import annotations

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..core import rng as rnglib
from ..io import image as imageio
from ..models.demo import synthetic_hdr
from ..ops import post as postlib
from ..ops.ibl import hdr_environment, _texture_nearest


def run(steps: int = 100, keep: float = 0.5, threshold: float = 0.2,
        resolution=(768, 432), out_dir: str | None = None):
    w, h = resolution
    n = w * h
    env = hdr_environment(jnp.asarray(synthetic_hdr(w // 4, h // 4)),
                          prebake=False)
    pid = jnp.arange(n, dtype=jnp.uint32)

    @jax.jit
    def step(accum, feedback, k):
        # jittered texture sample (denoise_test_1.py:61-66)
        jx = rnglib.uniform(pid, k, 0)
        jy = rnglib.uniform(pid, k, 1)
        i = (pid // h).astype(jnp.float32)
        j = (pid % h).astype(jnp.float32)
        uv = jnp.stack([(i + jx) / w, (j + jy) / h], -1)
        sample = _texture_nearest(env.image, uv)
        # unbiased dropout noise (:75-83)
        u = rnglib.uniform(pid, k, 2)
        sample = postlib.inject_dropout_noise(sample, u, keep)
        accum = accum + jnp.concatenate(
            [sample, jnp.ones((n, 1))], -1)
        mean = postlib.average(accum)
        img = mean.reshape(w, h, 3).transpose(1, 0, 2)[::-1]
        feedback = postlib.denoise(img, feedback, threshold)
        return accum, feedback

    accum = jnp.zeros((n, 4))
    feedback = jnp.zeros((h, w, 3))
    for k in range(steps):
        accum, feedback = step(accum, feedback, jnp.uint32(k))
    noisy = np.asarray(postlib.average(accum)).reshape(
        w, h, 3).transpose(1, 0, 2)[::-1]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        imageio.write_png(os.path.join(out_dir, "noisy.png"),
                          np.clip(noisy, 0, 1))
        imageio.write_png(os.path.join(out_dir, "denoised.png"),
                          np.clip(np.asarray(feedback), 0, 1))
    return noisy, np.asarray(feedback)


def main(argv=None):
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--out", default="out/denoise")
    args = p.parse_args(argv)
    run(steps=args.steps, out_dir=args.out)


if __name__ == "__main__":
    main()
