"""Throughput across the ENTIRE reference workload matrix (BASELINE.md) on
one NVIDIA GPU: wavefront deposits/s at each workload's native resolution
and march/bounce budgets. Writes a markdown table to stdout, after the
device and the card's name and power limit.

Each workload renders with 4 wavefront steps per compiled frame (the unroll
is batching, not semantics — spp budgets are met by running more frames).

Run: python tools/bench_workloads.py
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import time

import jax
import jax.numpy as jnp

from raytracingpbr_tpu.utils.compile_cache import enable_compile_cache
from raytracingpbr_tpu.utils.device import nvidia_smi_name_power, require_gpu

print(require_gpu(), nvidia_smi_name_power(), flush=True)
enable_compile_cache()

import numpy as np

from raytracingpbr_tpu.core.types import make_frame_state
from raytracingpbr_tpu.models import bunny, cornell, demo
from raytracingpbr_tpu.ops import integrator as integ



def workloads():
    yield ("cornell minimal 512x512 (3 bounce/256 march)",
           cornell.minimal_scene(), cornell.sky(), cornell.minimal_camera(),
           cornell.minimal_config().replace(resolution=(512, 512)))
    yield ("cornell full-PBR 480x480 (128/512)",
           cornell.full_scene(), cornell.sky(), cornell.full_camera(),
           cornell.full_config())
    yield ("engine default 768x432 (512/512)",
           demo.engine_scene(), demo.engine_environment(),
           demo.engine_camera(), demo.engine_config())
    yield ("tokyo IBL 2880x1620 (512/512)",
           demo.scene_demo_scene(), demo.tokyo_environment(),
           demo.engine_camera(), demo.tokyo_config())
    yield ("bunny metal 4K 3840x2160 (128/512)",
           bunny.metal_scene(), bunny.glass_environment(),
           bunny.camera(3840 / 2160), bunny.metal_config())
    yield ("bunny glass 1920x1080 (512/2048)",
           bunny.glass_scene(), bunny.glass_environment(),
           bunny.camera(1920 / 1080), bunny.glass_config())


rows = []
for name, scene, env, cam, cfg in workloads():
    cfg = cfg.replace(samples_per_frame=4, samples_per_pixel=1)
    state = make_frame_state(cfg.num_pixels)
    frame = jax.jit(lambda st, sc=scene, e=env, c=cam, f=cfg:
                    integ.render_frame(sc, e, c, st, f))
    t0 = time.time()
    px, state = frame(state)
    jax.block_until_ready(px)
    compile_s = time.time() - t0
    for _ in range(2):
        px, state = frame(state)
    jax.block_until_ready(px)
    c0 = float(state.accum[:, 3].sum())
    k = 5
    t0 = time.time()
    for _ in range(k):
        px, state = frame(state)
    jax.block_until_ready(px)
    dt = time.time() - t0
    msps = (float(state.accum[:, 3].sum()) - c0) / dt / 1e6
    rows.append((name, msps, dt / k, compile_s))
    print(f"{name}: {msps:.3f} Msamples/s, {dt/k*1e3:.0f} ms/frame "
          f"(compile {compile_s:.0f}s)", flush=True)

print("\n| workload | Msamples/s/chip | ms/frame (4 steps) |")
print("|---|---|---|")
for name, msps, spf, _ in rows:
    print(f"| {name} | {msps:.2f} | {spf*1e3:.0f} |")
