"""Progressive renderer daemon: the reference's live loop
(``src/main.py:24-68`` / ``src/renderer.py:25-32``) without the GUI — on a
GPU server the primary UX is headless (SURVEY.md §7.1 "ti.ui"): accumulate
wavefront samples, periodically write the tonemapped framebuffer + a
checkpoint, resume bit-exactly after preemption.

Usage:
    python -m raytracingpbr_tpu.apps.progressive --scene demo \
        --minutes 2 --out out/progressive
"""
from __future__ import annotations

import argparse
import os
import time

import jax
import numpy as np

from ..core.types import make_frame_state
from ..io import checkpoint as ckpt
from ..io import image as imageio
from ..ops import integrator as integ
from ..utils.profiling import MetricsLogger


def _save_debug_views(state, cfg, out_dir):
    """Debug render targets — the live app's commented-out channels
    (``src/main.py:65-66``): adaptive-sampling noise map and ray-depth heat
    map, as first-class outputs (SURVEY.md §5 'Metrics')."""
    def to_img(flat):
        return np.asarray(flat).reshape(
            cfg.width, cfg.height).transpose(1, 0)[::-1]

    noise = np.clip(to_img(state.noise) * 1e3, 0, 1)
    depth = np.clip(np.abs(to_img(state.rays.depth)) / 3.0, 0, 1)
    imageio.write_png(os.path.join(out_dir, "debug_noise.png"),
                      np.repeat(noise[..., None], 3, -1))
    imageio.write_png(os.path.join(out_dir, "debug_depth.png"),
                      np.repeat(depth[..., None], 3, -1))


def run(scene, env, cam, cfg, out_dir: str, minutes: float = 1.0,
        save_every: int = 50, exposure: float = 1.0,
        metrics_path: str | None = None, debug_views: bool = False,
        validate: bool = False, serve: int | None = None,
        serve_host: str = "127.0.0.1", compact_every: int = 0) -> None:
    os.makedirs(out_dir, exist_ok=True)
    server = None
    if serve is not None:
        # live preview endpoint (the reference's canvas.set_image,
        # src/main.py:64, as HTTP — apps/preview.py)
        from .preview import PreviewServer
        server = PreviewServer(serve, host=serve_host).start()
    ckpt_path = os.path.join(out_dir, "state.npz")
    if os.path.exists(ckpt_path):
        state, meta = ckpt.load(ckpt_path)
        state = jax.tree.map(jax.numpy.asarray, state)
        print(f"resumed from frame {int(state.frame)}", flush=True)
    else:
        state = make_frame_state(cfg.num_pixels)

    # Adaptive compaction (ops/compact.py): keep the persistent state in
    # actives-first lane order so converged pixels pool into dense tiles
    # the march skips whole. The lane->pixel map is data; display scatters
    # through it. Off unless requested (needs cfg.adaptive_sampling).
    compacting = compact_every > 0 and cfg.adaptive_sampling
    pixel_id = jax.numpy.arange(cfg.num_pixels, dtype=jax.numpy.uint32)
    if compacting:
        from ..ops import compact as compactlib
        tile_fn = jax.jit(lambda st, pid: integ.render_frame_tile(
            scene, env, cam, st, cfg, pid, exposure=exposure))
        frame = lambda st: tile_fn(st, pixel_id)
    else:
        frame = jax.jit(lambda st: integ.render_frame(
            scene, env, cam, st, cfg, exposure=exposure))

    def raster(pixels_flat):
        flat = np.asarray(pixels_flat)
        if compacting:
            from ..ops import compact as compactlib
            flat = compactlib.scatter_pixels(flat, pixel_id, cfg)
        return flat.reshape(cfg.width, cfg.height, 3).transpose(1, 0, 2)[::-1]

    def to_raster(st):
        # checkpoints/debug views are always raster lane order
        if not compacting:
            return st
        from ..ops import compact as compactlib
        return compactlib.uncompact_frame_state(st, pixel_id)

    log = MetricsLogger(metrics_path)
    deadline = time.time() + minutes * 60
    pixels = None
    while time.time() < deadline:
        t0 = time.time()
        pixels, state = frame(state)
        jax.block_until_ready(pixels)
        dt = time.time() - t0
        f = int(state.frame)
        if compacting and f % compact_every == 0:
            from ..ops import compact as compactlib
            state, pixel_id = compactlib.compact_frame_state(
                state, pixel_id, cfg.noise_threshold)
        stats = log.frame_stats(np.asarray(pixels), np.asarray(state.accum),
                                dt, frame=f)
        if server is not None:
            server.update(raster(pixels), **stats)
        if validate:
            from ..utils.validate import assert_state_finite
            assert_state_finite(state)
        if f % save_every == 0:
            imageio.write_png(os.path.join(out_dir, "latest.png"),
                              raster(pixels))
            ckpt.save(ckpt_path, to_raster(state), meta={"frame": f})
            if debug_views:
                _save_debug_views(to_raster(state), cfg, out_dir)
    if pixels is not None:
        imageio.write_png(os.path.join(out_dir, "final.png"), raster(pixels))
        ckpt.save(ckpt_path, to_raster(state),
                  meta={"frame": int(state.frame)})
        if debug_views:
            _save_debug_views(to_raster(state), cfg, out_dir)
    log.close()
    if server is not None:
        server.stop()


def main(argv=None):
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from ..models import cornell, demo

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="demo", choices=["demo", "cornell"])
    p.add_argument("--minutes", type=float, default=1.0)
    p.add_argument("--scale", type=int, default=1,
                   help="resolution divisor vs the reference workload")
    p.add_argument("--out", default="out/progressive")
    p.add_argument("--metrics", default=None)
    p.add_argument("--validate", action="store_true",
                   help="assert FrameState finiteness every frame "
                        "(NaN/Inf debugging, utils/validate.py)")
    p.add_argument("--debug-views", action="store_true",
                   help="also write the adaptive-noise map and ray-depth "
                        "heat map (the live app's commented-out channels, "
                        "src/main.py:65-66)")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve a live browser preview of the converging "
                        "framebuffer on this port (/, /frame.png, /stream, "
                        "/stats; 0 = pick a free port)")
    p.add_argument("--serve-host", default="127.0.0.1", metavar="HOST",
                   help="preview bind address (loopback by default; the "
                        "endpoints are unauthenticated — pass 0.0.0.0 "
                        "explicitly to expose them)")
    p.add_argument("--nee", action="store_true",
                   help="env importance sampling + specular MIS "
                        "(cfg.env_sampling; HDR-sky scenes only)")
    p.add_argument("--adaptive", action="store_true",
                   help="adaptive sampling (cfg.adaptive_sampling)")
    p.add_argument("--compact-every", type=int, default=0, metavar="N",
                   help="with --adaptive: every N frames, repack the "
                        "persistent state actives-first so converged "
                        "pixels pool into dense tiles the march skips "
                        "whole (ops/compact.py; 0 = off)")
    args = p.parse_args(argv)

    if args.scene == "demo":
        scene, cfg = demo.engine_scene(), demo.engine_config()
        cam, env = demo.engine_camera(), demo.engine_environment()
        exposure = 1.0
    else:
        scene, cfg = cornell.full_scene(), cornell.full_config()
        cam, env = cornell.full_camera(), cornell.sky()
        exposure = 0.6
    if args.scale > 1:
        cfg = cfg.replace(resolution=(cfg.width // args.scale,
                                      cfg.height // args.scale))
    if args.nee:
        from ..ops.ibl import with_env_sampler
        env = with_env_sampler(env)  # raises for non-HDR skies
        cfg = cfg.replace(env_sampling=True)
    if args.adaptive:
        cfg = cfg.replace(adaptive_sampling=True)
    run(scene, env, cam, cfg, args.out, minutes=args.minutes,
        exposure=exposure, metrics_path=args.metrics,
        validate=args.validate, debug_views=args.debug_views,
        serve=args.serve, serve_host=args.serve_host,
        compact_every=args.compact_every)


if __name__ == "__main__":
    main()
