"""March kernel vs the XLA march loop on one NVIDIA GPU.

    python tools/bench_march.py            # march alone + end to end
    python tools/bench_march.py --sweep    # also sweep march_block

March alone (``ops/march.march``, jitted, device time by the host clock
around ``block_until_ready``): cornell full-PBR primary rays 480x480, a
mixed wavefront state of that scene (two frames in), and bunny-glass primary
rays 1920x1080. End to end: wavefront ms/frame on cornell full-PBR (480x480,
512 bounces, 4 samples/frame) and on the engine default scene (768x432, HDR
IBL), and the megakernel forward on cornell full (1 spp). Each end-to-end
case runs through the normal entry points twice per path, in the order
XLA, kernel, kernel, XLA, with the march path forced by patching
``ops.march._use_kernel``.

Prints the device and ``nvidia-smi`` name and power limit first, then one
JSON line per measurement.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytracingpbr_tpu.ops import march as ml  # noqa: E402
from raytracingpbr_tpu.utils.compile_cache import \
    enable_compile_cache  # noqa: E402
from raytracingpbr_tpu.utils.device import (  # noqa: E402
    nvidia_smi_name_power, require_gpu)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def time_call(f, *args, reps=10):
    jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


class forced_path:
    """Force ``backend="auto"`` marches onto one path for a with-block."""

    def __init__(self, kernel: bool):
        self.kernel = kernel

    def __enter__(self):
        self.orig = ml._use_kernel
        ml._use_kernel = lambda backend: (
            backend == "pallas" or (backend == "auto" and self.kernel))

    def __exit__(self, *exc):
        ml._use_kernel = self.orig


def march_cases():
    import chip_smoke as cs
    from raytracingpbr_tpu.models import bunny, cornell
    scene = cornell.full_scene()
    cfg = cornell.full_config()
    cam = cornell.full_camera()
    o, d = cs.primary_rays(cfg, cam)
    with forced_path(kernel=True):
        mo, md = cs.mixed_state_rays(scene, cornell.sky(), cam, cfg)
    bcfg = bunny.glass_config(scale=1)
    bo, bd = cs.primary_rays(bcfg, bunny.camera(bcfg.width / bcfg.height))
    return (("cornell_primary_480", scene, cfg, o, d),
            ("cornell_mixed_state_480", scene, cfg, mo, md),
            ("bunny_glass_primary_1080p", bunny.glass_scene(), bcfg, bo, bd))


def bench_march_alone(sweep):
    blocks = [None] + ([32, 64, 128, 256] if sweep else [])
    for name, scene, cfg, o, d in march_cases():
        f = jax.jit(lambda o, d, cfg=cfg, scene=scene: ml.march(
            scene, o, d, cfg, differentiable=False, backend="xla").t)
        emit(case=name, path="xla", rays=int(o.shape[0]),
             ms=time_call(f, o, d) * 1e3)
        for block in blocks:
            c = cfg.replace(march_block=block)
            f = jax.jit(lambda o, d, c=c, scene=scene: ml.march(
                scene, o, d, c, differentiable=False, backend="pallas").t)
            emit(case=name, path="kernel", block=block,
                 rays=int(o.shape[0]), ms=time_call(f, o, d) * 1e3)


def bench_end_to_end(frames=10):
    import __graft_entry__
    import bench
    import raytracingpbr_tpu as rt
    from raytracingpbr_tpu.models import cornell

    def wavefront(kind):
        if kind == "cornell":
            frame, state = bench.cornell_wavefront()
        else:
            step, (state,) = __graft_entry__.entry()
            frame = jax.jit(step)
        state, _, _, _ = bench.time_frames(frame, state, 2)
        _, _, dt, deposits = bench.time_frames(frame, state, frames)
        return dt, deposits / (dt * frames) / 1e6

    def megakernel():
        cfg = cornell.full_config()
        scene, env, cam = (cornell.full_scene(), cornell.sky(),
                           cornell.full_camera())
        f = jax.jit(lambda s: rt.render_image(
            scene, env, cam, cfg, spp=1, sample_offset=s, tonemapped=False))
        dt = time_call(f, jnp.uint32(1), reps=3)
        return dt, cfg.num_pixels / dt / 1e6

    cases = (("wavefront_cornell_fullpbr_480", lambda: wavefront("cornell")),
             ("wavefront_engine_default_768x432",
              lambda: wavefront("engine")),
             ("megakernel_cornell_full_480", megakernel))
    for name, run in cases:
        for kernel in (False, True, True, False):
            with forced_path(kernel):
                dt, msps = run()
            emit(case=name, path="kernel" if kernel else "xla",
                 ms=dt * 1e3, msamples_per_s=msps)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--skip-e2e", action="store_true")
    args = p.parse_args()
    device = require_gpu()
    print(f"device: {device}", flush=True)
    print(f"nvidia-smi: {nvidia_smi_name_power()}", flush=True)
    enable_compile_cache()
    bench_march_alone(args.sweep)
    if not args.skip_e2e:
        bench_end_to_end()


if __name__ == "__main__":
    main()
