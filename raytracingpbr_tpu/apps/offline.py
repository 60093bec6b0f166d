"""Offline batch renderer: the reference's animation loop
(``bunny_sdf_glass.py:437-451``: refresh -> N sample passes -> tonemap ->
PNG per frame) as a checkpointable pipeline.

Usage:
    python -m raytracingpbr_tpu.apps.offline --scene bunny_glass \
        --frames 240 --spp 64 --out out/ --scale 4
"""
from __future__ import annotations

import argparse
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..core.types import Camera
from ..io import image as imageio
from ..ops import integrator as integ
from ..ops.ibl import Environment
from ..ops.scene import Scene
from ..utils.profiling import MetricsLogger


def render_animation(scene_fn, env: Environment, cam: Camera,
                     cfg: RenderConfig, frames: int, spp: int,
                     out_dir: str, start_frame: int = 0,
                     metrics_path: str | None = None,
                     integrator: str = "megakernel",
                     **trace_kw) -> None:
    """Render ``frames`` stills; ``scene_fn(frame) -> Scene`` supplies the
    per-frame animated scene (``ops.scene.animate``).

    ``integrator``: "megakernel" (exact example-variant parity,
    ``render_image``) or "wavefront" (the src/-engine progressive scheme run
    to >= spp deposits per pixel — same estimator family, faster because
    no lane idles behind the longest path)."""
    os.makedirs(out_dir, exist_ok=True)
    log = MetricsLogger(metrics_path)

    @jax.jit
    def one_frame(scene, frame_idx):
        return integ.render_image(
            scene, env, cam, cfg, spp=spp,
            sample_offset=frame_idx * jnp.uint32(spp), **trace_kw)

    if start_frame < 0:
        # auto-resume: skip frames already rendered (preemption recovery
        # for the 240-frame offline loops, SURVEY.md §5 "Failure detection")
        start_frame = 0
        while os.path.exists(
                os.path.join(out_dir, f"frame_{start_frame:05d}.png")):
            start_frame += 1
        if start_frame:
            print(f"resuming at frame {start_frame}", flush=True)
    exposure = trace_kw.get("exposure", 1.0)
    if integrator == "wavefront":
        unsupported = sorted(set(trace_kw) - {"exposure"})
        if unsupported:
            print(f"wavefront integrator ignores {unsupported} "
                  "(src/-engine shading variants apply)", flush=True)
    for f in range(start_frame, frames):
        t0 = time.time()
        scene = scene_fn(f)
        if integrator == "wavefront":
            # fresh accumulation per frame; the fixed per-frame sample
            # pattern (counters restart at 0) is deliberate — temporally
            # stable noise across animation frames
            img, _ = integ.render_image_progressive(
                scene, env, cam, cfg, spp, exposure=exposure)
            img = np.asarray(img)
        else:
            img = np.asarray(one_frame(scene, jnp.uint32(f)))
        dt = time.time() - t0
        path = os.path.join(out_dir, f"frame_{f:05d}.png")
        imageio.write_png(path, img)
        log.log(frame=f, dt=round(dt, 4),
                samples_per_s=cfg.num_pixels * spp / max(dt, 1e-9))
        print(f"frame {f}/{frames}: {dt:.2f}s -> {path}", flush=True)
    log.close()


def main(argv=None):
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from ..models import bunny, cornell, demo

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="bunny_glass",
                   choices=["bunny_glass", "bunny_metal", "cornell",
                            "cornell_minimal", "demo"])
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--scale", type=int, default=4,
                   help="resolution divisor vs the reference workload")
    p.add_argument("--out", default="out")
    p.add_argument("--metrics", default=None)
    p.add_argument("--start-frame", type=int, default=-1,
                   help="first frame to render; -1 = auto-resume past "
                        "frames already present in --out")
    p.add_argument("--integrator", default="megakernel",
                   choices=["megakernel", "wavefront"],
                   help="megakernel = exact example parity; wavefront = "
                        "same estimator family, no lane idles")
    p.add_argument("--nee", action="store_true",
                   help="env importance sampling + specular MIS "
                        "(cfg.env_sampling; HDR-sky scenes only — bakes "
                        "the alias table; same mean, far lower variance "
                        "under sparse bright skies)")
    args = p.parse_args(argv)

    if args.scene == "bunny_glass":
        base = bunny.glass_scene()
        cfg = bunny.glass_config(scale=args.scale)
        cam = bunny.camera(cfg.width / cfg.height)
        env = bunny.glass_environment()
        scene_fn = lambda f: bunny.animated_scene(base, f)
        kw = {}
    elif args.scene == "bunny_metal":
        base = bunny.metal_scene()
        cfg = bunny.metal_config(scale=args.scale)
        cam = bunny.camera(cfg.width / cfg.height)
        env = bunny.glass_environment()
        scene_fn = lambda f: bunny.animated_scene(base, f)
        kw = {}
    elif args.scene == "cornell":
        s = cornell.full_scene()
        cfg = cornell.full_config()
        cam = cornell.full_camera()
        env = cornell.sky()
        scene_fn = lambda f: s
        kw = dict(exposure=0.6)
    elif args.scene == "cornell_minimal":
        s = cornell.minimal_scene()
        cfg = cornell.minimal_config()
        cam = cornell.minimal_camera()
        env = cornell.sky()
        scene_fn = lambda f: s
        kw = dict(diffuse_only=True)
    else:
        s = demo.engine_scene()
        cfg = demo.engine_config()
        cam = demo.engine_camera()
        env = demo.engine_environment()
        scene_fn = lambda f: s
        kw = {}
    if args.scale > 1 and not args.scene.startswith("bunny"):
        # bunny configs take scale natively; divide the rest here
        cfg = cfg.replace(resolution=(cfg.width // args.scale,
                                      cfg.height // args.scale))
    if args.nee:
        from ..ops.ibl import with_env_sampler
        env = with_env_sampler(env)  # raises for non-HDR skies
        cfg = cfg.replace(env_sampling=True)

    render_animation(scene_fn, env, cam, cfg, args.frames, args.spp,
                     args.out, metrics_path=args.metrics,
                     start_frame=args.start_frame,
                     integrator=args.integrator, **kw)


if __name__ == "__main__":
    main()
