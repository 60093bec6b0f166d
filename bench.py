"""Benchmark harness — runs on one NVIDIA GPU and fails on anything else.

Prints, on earlier lines, the device as JAX reports it (platform, kind,
count) and the card's name and power limit from ``nvidia-smi``; then ONE
JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Primary metric: megasamples/s/chip on the Cornell-box full-PBR workload
(480x480, 512-march, 512-bounce budget; BASELINE.md) using the progressive
wavefront integrator (the src/-engine hot path, SURVEY.md §3.2). A "sample"
is one completed per-pixel path deposited into the accumulator — the same
unit as the reference's progressive spp.

vs_baseline: BASELINE.json sets the bar at >= 5x CPU-Taichi samples/s.
Taichi is not installable in this image, so the documented stand-in is this
framework's own JAX-CPU wavefront throughput on the dev host
(CPU_MSPS_REF below, measured 2026-08-17, single-socket CPU, 480x480
cornell: 0.0073 Msamples/s). vs_baseline = value / (5 * CPU_MSPS_REF);
>= 1.0 means the target is met.

Extras: megakernel forward Msamples/s and forward+backward (grad step)
Msamples/s at an 8-bounce budget and at 128 bounces through path replay,
with and without NEE. A failing phase fails the run.
"""
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

CPU_MSPS_REF = 0.0073  # see module docstring


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cornell_wavefront(samples_per_frame=4):
    """Jitted cornell full-PBR wavefront frame and a fresh state."""
    from raytracingpbr_tpu.core.types import make_frame_state
    from raytracingpbr_tpu.models import cornell
    from raytracingpbr_tpu.ops import integrator as integ

    scene = cornell.full_scene()
    cfg = cornell.full_config().replace(samples_per_frame=samples_per_frame,
                                        max_raytrace=512,
                                        quality_per_sample=0.8)
    cam = cornell.full_camera()
    env = cornell.sky()
    frame = jax.jit(lambda st: integ.render_frame(scene, env, cam, st, cfg))
    return frame, make_frame_state(cfg.num_pixels)


def time_frames(frame, state, k):
    """Run ``k`` frames; returns (state, pixels, s/frame, deposits)."""
    c0 = float(state.accum[:, 3].sum())
    t0 = time.perf_counter()
    for _ in range(k):
        px, state = frame(state)
    jax.block_until_ready(px)
    dt = (time.perf_counter() - t0) / k
    return state, px, dt, float(state.accum[:, 3].sum()) - c0


def bench_wavefront():
    frame, state = cornell_wavefront()
    t0 = time.perf_counter()
    state, _, _, _ = time_frames(frame, state, 1)
    log(f"wavefront compile+first: {time.perf_counter()-t0:.1f}s")
    state, _, _, _ = time_frames(frame, state, 3)
    k = 10
    state, _, dt, deposits = time_frames(frame, state, k)
    msps = deposits / (dt * k) / 1e6
    log(f"wavefront: {dt:.4f}s/frame, {msps:.4f} Msamples/s")
    return msps


def bench_megakernel():
    import raytracingpbr_tpu as rt
    from raytracingpbr_tpu.models import cornell

    scene = cornell.full_scene()
    cfg = cornell.full_config()
    cam = cornell.full_camera()
    env = cornell.sky()
    f = jax.jit(lambda s: rt.render_image(scene, env, cam, cfg, spp=1,
                                          sample_offset=s, tonemapped=False))
    jax.block_until_ready(f(jnp.uint32(0)))
    k = 6
    t0 = time.perf_counter()
    for i in range(1, k + 1):
        img = f(jnp.uint32(i))
    jax.block_until_ready(img)
    dt = (time.perf_counter() - t0) / k
    msps = cfg.num_pixels / dt / 1e6
    log(f"megakernel fwd: {dt:.4f}s/pass, {msps:.4f} Msamples/s")
    return msps


def grad_step_setup(max_raytrace=8, differentiable=True, env_sampling=False):
    """Jitted albedo-gradient step on the cornell full-PBR scene.

    Returns ``(grad_step, scene, n_pixels)``; ``grad_step(scene, s)`` is the
    gradient of an image MSE w.r.t. the albedos at sample offset ``s``."""
    from raytracingpbr_tpu.models import cornell
    from raytracingpbr_tpu.parallel import train as ptrain

    scene = cornell.full_scene()
    cfg = cornell.full_config().replace(max_raytrace=max_raytrace)
    cam = cornell.full_camera()
    env = cornell.sky()
    if env_sampling:
        # variance-reduced estimator: NEE + specular MIS against a small
        # synthetic HDR sky (cornell's own sky is black — no table to bake)
        import raytracingpbr_tpu as rt
        from raytracingpbr_tpu.ops import ibl as ibllib
        img = np.full((64, 32, 3), 0.05, np.float32)
        img[40:44, 24:28] = 25.0
        env = ibllib.with_env_sampler(
            rt.hdr_environment(jnp.asarray(img), prebake=False))
        cfg = cfg.replace(env_sampling=True)
    n = cfg.num_pixels
    pid = jnp.arange(n, dtype=jnp.uint32)
    target = jnp.zeros((n, 3))

    @jax.jit
    def grad_step(sc, s):
        def loss(sc):
            img = ptrain.render_pixels(sc, env, cam, pid, cfg, spp=1,
                                       sample_offset=s,
                                       differentiable=differentiable)
            return jnp.mean((img - target) ** 2)
        return jax.grad(loss)(sc).albedo

    return grad_step, scene, n


def bench_fwd_bwd(max_raytrace=8, differentiable=True, label="8 bounces",
                  env_sampling=False):
    grad_step, scene, n = grad_step_setup(max_raytrace, differentiable,
                                          env_sampling)
    jax.block_until_ready(grad_step(scene, jnp.uint32(0)))
    k = 4
    t0 = time.perf_counter()
    for i in range(1, k + 1):
        g = grad_step(scene, jnp.uint32(i))
    jax.block_until_ready(g)
    dt = (time.perf_counter() - t0) / k
    msps = n / dt / 1e6
    log(f"fwd+bwd ({label}): {dt:.4f}s/step, {msps:.4f} Msamples/s")
    return msps


def main():
    from raytracingpbr_tpu.utils.compile_cache import enable_compile_cache
    from raytracingpbr_tpu.utils.device import (nvidia_smi_name_power,
                                                require_gpu)

    device = require_gpu()
    print(f"device: platform={device['platform']} kind={device['kind']} "
          f"count={device['count']}", flush=True)
    print(f"nvidia-smi: {nvidia_smi_name_power()}", flush=True)
    enable_compile_cache()

    value = bench_wavefront()
    extras = {
        "megakernel_fwd_msps": round(bench_megakernel(), 4),
        "fwd_bwd_msps_8bounce": round(bench_fwd_bwd(), 4),
        # the reference's own cornell bounce budget (cornell_box.py:19),
        # via path-replay backward (ops/replay.py) — O(rays) memory
        "fwd_bwd_msps_128bounce_replay": round(bench_fwd_bwd(
            max_raytrace=128, differentiable="replay",
            label="128 bounces, path replay"), 4),
        # the variance-reduced estimator and the deep-bounce gradient
        # path together
        "fwd_bwd_msps_128bounce_replay_nee": round(bench_fwd_bwd(
            max_raytrace=128, differentiable="replay", env_sampling=True,
            label="128 bounces, replay + NEE"), 4),
    }
    out = {
        "metric": "cornell_fullpbr_wavefront_megasamples_per_s_per_chip",
        "value": round(value, 4),
        "unit": "Msamples/s",
        "vs_baseline": round(value / (5 * CPU_MSPS_REF), 3),
        "device": device,
        **extras,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
