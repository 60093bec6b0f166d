"""Equal-time value of env importance sampling (NEE + specular MIS) on one
NVIDIA GPU.

Renders a sun-lit scene with the wavefront integrator for a fixed wall-time
budget with cfg.env_sampling off/on, and reports throughput plus PSNR
against a converged NEE truth — the honest "what does the variance
reduction buy per second" number (Msamples/s alone hides that an NEE
sample is worth many plain samples under a sparse bright sky).
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import time

import jax
import jax.numpy as jnp
import numpy as np

from raytracingpbr_tpu.utils.compile_cache import enable_compile_cache
from raytracingpbr_tpu.utils.device import nvidia_smi_name_power, require_gpu

print(require_gpu(), nvidia_smi_name_power(), flush=True)
enable_compile_cache()

import raytracingpbr_tpu as rt
from raytracingpbr_tpu.core.types import make_frame_state
from raytracingpbr_tpu.ops import ibl as ibllib
from raytracingpbr_tpu.ops import integrator as integ
from raytracingpbr_tpu.ops.scene import ObjectSpec
from raytracingpbr_tpu.ops.sdf import SHAPE
from raytracingpbr_tpu.utils.metrics import psnr

W = H = 160
img = np.full((64, 32, 3), 0.05, np.float32)
img[40:44, 24:28] = 25.0  # small sun in front of the camera, high
env = rt.hdr_environment(jnp.asarray(img), prebake=False)
env_s = ibllib.with_env_sampler(env)
scene = rt.make_scene([
    ObjectSpec(SHAPE.SPHERE, position=(0, -101, 0), scale=(100,) * 3,
               albedo=(0.7, 0.7, 0.7), roughness=1.0),
    ObjectSpec(SHAPE.SPHERE, position=(-1.1, 0, 0), scale=(1.0,) * 3,
               albedo=(0.6, 0.4, 0.3), roughness=1.0),
    ObjectSpec(SHAPE.SPHERE, position=(1.1, 0, 0), scale=(1.0,) * 3,
               albedo=(0.9, 0.9, 0.9), roughness=0.5, metallic=1.0),
])
cam = rt.make_camera(lookfrom=(0, 1.2, 5.0), lookat=(0, 0, 0), vfov=40.0,
                     aspect=1.0, aperture=0.0, focus=1.0)
cfg = rt.RenderConfig(resolution=(W, H), max_raymarch=64, max_raytrace=64,
                      omega=1.0, omega_policy=rt.OmegaPolicy.CONSTANT,
                      hit_criterion=rt.HitCriterion.ABSOLUTE,
                      hit_precision=1e-4, march_t0=0.005, max_dis=300.0,
                      samples_per_frame=4)


FRAMES = {}


def run(cfg, env, seconds, state=None):
    state = state or make_frame_state(cfg.num_pixels)
    key = (cfg.env_sampling,)
    if key not in FRAMES:
        t0 = time.perf_counter()
        FRAMES[key] = jax.jit(
            lambda st: integ.render_frame(scene, env, cam, st, cfg))
        px, state = FRAMES[key](state)
        jax.block_until_ready(px)
        print(f"compile env_sampling={cfg.env_sampling}: "
              f"{time.perf_counter()-t0:.0f}s", flush=True)
        state = make_frame_state(cfg.num_pixels)
    frame = FRAMES[key]
    px, state = frame(state)
    jax.block_until_ready(px)  # warm outside the budget
    t0 = time.perf_counter()
    frames = 0
    # block every frame: async dispatch on the remote backend enqueues far
    # faster than execution, so an unsynced wall-clock loop would enqueue
    # minutes of work past the budget (measured the hard way)
    while time.perf_counter() - t0 < seconds:
        px, state = frame(state)
        jax.block_until_ready(px)
        frames += 1
    dt = time.perf_counter() - t0
    spp = float(state.accum[:, 3].mean())
    lin = state.accum[:, :3] / jnp.maximum(state.accum[:, 3:4], 1.0)
    msps = float(state.accum[:, 3].sum()) / dt / 1e6
    return np.asarray(lin), msps, spp, dt


# converged truth via the NEE estimator (it converges far faster)
truth, _, tspp, _ = run(cfg.replace(env_sampling=True), env_s, 60.0)
print(f"truth: NEE {tspp:.0f} spp", flush=True)

for seconds in (3.0, 10.0):
    a, msps_a, spp_a, _ = run(cfg, env, seconds)
    b, msps_b, spp_b, _ = run(cfg.replace(env_sampling=True), env_s, seconds)
    pa, pb = psnr(a, truth), psnr(b, truth)
    print(f"{seconds:.0f}s  plain: {msps_a:6.2f} Msps {spp_a:6.0f} spp "
          f"PSNR {pa:5.2f} dB   |   NEE+MIS: {msps_b:6.2f} Msps "
          f"{spp_b:6.0f} spp PSNR {pb:5.2f} dB", flush=True)

# --- shadow-march diet A/B (round 5, cfg.shadow_diet) ---
# Bias: the diet changes the NEE visibility test (absolute criterion at
# min_dis/2, min(128, max_raymarch) budget) — measure the converged mean
# shift against the exact scene-march visibility, and the speed delta.
t_d, msps_d, spp_d, _ = run(cfg.replace(env_sampling=True), env_s, 30.0)
t_x, msps_x, spp_x, _ = run(
    cfg.replace(env_sampling=True, shadow_diet=False), env_s, 30.0)
shift = float(np.abs(t_d.mean(0) - t_x.mean(0)).max())
rel = shift / float(t_x.mean() + 1e-9)
print(f"shadow diet ON : {msps_d:6.2f} Msps ({spp_d:.0f} spp)", flush=True)
print(f"shadow diet OFF: {msps_x:6.2f} Msps ({spp_x:.0f} spp)", flush=True)
print(f"diet mean shift: {shift:.2e} abs ({rel*100:.3f}% of mean) "
      f"[converged means over {spp_d:.0f}/{spp_x:.0f} spp]", flush=True)
