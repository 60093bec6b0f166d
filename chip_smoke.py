"""Smoke test of the whole system on one NVIDIA GPU (or four with --multi).

    python chip_smoke.py           # one card, every phase below
    python chip_smoke.py --multi   # four cards: the sharded paths only

Phases (one card), each printing one result line; any failure exits
non-zero and prints no final result:

1. device: JAX's platform must be "gpu"; prints kind, count and the card's
   name and power limit from nvidia-smi.
2. kernel: the Pallas march kernel, compiled for the card, against the XLA
   march loop at real widths (cornell full-PBR primary rays 480x480, a mixed
   wavefront state of that scene, bunny-glass primary rays 1920x1080), plus
   a split-march resume chain that must equal one uninterrupted kernel march
   bit for bit; prints the wavefront step's memory analysis.
3. wavefront: ``integrator.render_frame`` on the engine default scene
   (768x432, HDR IBL) and on cornell full-PBR (480x480, 512 bounces).
4. megakernel: ``render_image`` on cornell full, 1 spp.
5. inverse: one 128-bounce path-replay + NEE albedo-gradient step.
6. goldens: four reference families against the CPU-rendered goldens.
7. offline: ``apps.offline.main`` renders one 1920x1080 bunny-glass frame.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import bench
from raytracingpbr_tpu.utils.compile_cache import enable_compile_cache
from raytracingpbr_tpu.utils.device import nvidia_smi_name_power, require_gpu

REPO = os.path.dirname(os.path.abspath(__file__))

# Kernel vs XLA loop (tests/test_pallas.py's tolerances): f32 reassociation
# flips the hit decision of a few boundary lanes in long marches.
HIT_AGREE = 0.999
HIT_AGREE_BUNNY = 0.99
T_TOL = 1e-3
GOLDEN_DB = 30.0   # march boundary flips between backends cost a few pixels
SHARD_ATOL, SHARD_RTOL = 1e-5, 1e-4   # tests/test_parallel.py


def report(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def primary_rays(cfg, cam):
    from raytracingpbr_tpu.core import rng as rnglib
    from raytracingpbr_tpu.ops import camera as cameralib
    pid = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
    u = rnglib.uniform4(pid, 0, 1, cfg.seed)
    uv = cameralib.pixel_uv(pid, cfg.width, cfg.height, u[0], u[1])
    rays = cameralib.get_ray(cam, uv, u[2], u[3])
    return rays.origin, rays.direction


def mixed_state_rays(scene, env, cam, cfg):
    """A realistically divergent wavefront state: two frames in."""
    from raytracingpbr_tpu.core.types import make_frame_state
    from raytracingpbr_tpu.ops import integrator as integ
    step = jax.jit(lambda st: integ.render_frame(
        scene, env, cam, st, cfg.replace(samples_per_frame=3)))
    state = make_frame_state(cfg.num_pixels)
    _, state = step(state)
    _, state = step(state)
    return state.rays.origin, state.rays.direction


def compare_march(label, scene, cfg, o, d, min_agree):
    from raytracingpbr_tpu.ops import march as ml
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda o, d: ml.march(
            scene, o, d, cfg, differentiable=False, backend="xla"))(o, d)
        got = jax.jit(lambda o, d: ml.march(
            scene, o, d, cfg, differentiable=False, backend="pallas"))(o, d)
    h_ref, h_k = np.asarray(ref.hit), np.asarray(got.hit)
    t_ref, t_k = np.asarray(ref.t), np.asarray(got.t)
    agree = h_ref == h_k
    check(agree.mean() >= min_agree,
          f"{label}: hit agreement {agree.mean():.5f} < {min_agree}")
    # A lane that escaped past max_dis in both paths agrees: its t only
    # says "beyond max_dis" (the last step lands anywhere past it).
    esc = (t_ref >= cfg.max_dis) & (t_k >= cfg.max_dis)
    cmp = agree & ~esc
    dt = np.abs(t_k - t_ref)[cmp]
    check(np.allclose(t_k[cmp], t_ref[cmp], rtol=T_TOL, atol=T_TOL),
          f"{label}: t differs on {(dt > T_TOL).sum()} agreeing lanes, "
          f"max |dt| {dt.max():.3g}")
    both = h_ref & h_k
    check((np.asarray(ref.index)[both] == np.asarray(got.index)[both]).all(),
          f"{label}: index differs on lanes both paths hit")
    report("kernel", f"{label}: {o.shape[0]} rays, hit agreement "
           f"{agree.mean():.6f}, hit rate {h_k.mean():.4f}, escaped "
           f"{esc.mean():.4f}, max |dt| {dt.max():.3g} on the other "
           "agreeing lanes")


def split_resume_equal(scene, cfg, o, d, budget=32):
    """Chained budget-capped kernel marches == one uninterrupted kernel
    march, bit for bit (the property cfg.march_split rests on)."""
    from raytracingpbr_tpu.ops import march as ml
    c = cfg.replace(max_raymarch=128)
    ref = jax.jit(lambda o, d: ml.march(scene, o, d, c, differentiable=False,
                                        backend="pallas"))(o, d)
    mcfg = c.replace(max_raymarch=budget)

    @jax.jit
    def chain(o, d):
        n = o.shape[0]
        t = jnp.full((n,), c.march_t0)
        w = jnp.full((n,), c.omega)
        s = jnp.zeros((n,))
        dd = jnp.full((n,), 1e3)
        cum = jnp.zeros((n,), jnp.int32)
        idx = jnp.zeros((n,), jnp.int32)
        hit = jnp.zeros((n,), bool)
        live = jnp.ones((n,), bool)
        for _ in range(c.max_raymarch // budget):
            rr = ml.march_resumable(scene, o, d, mcfg, active=live,
                                    init=(t, w, s, dd), backend="pallas")
            cum = cum + rr.fin
            done_now = live & ((rr.done > 0) | (cum >= c.max_raymarch))
            idx = jnp.where(live, rr.index, idx)
            hit = jnp.where(live, rr.hit, hit)
            t = jnp.where(live, rr.t, t)
            w = jnp.where(live, rr.w, w)
            s = jnp.where(live, rr.s, s)
            dd = jnp.where(live, rr.d, dd)
            live = live & ~done_now
        return t, idx, hit

    t, idx, hit = (np.asarray(v) for v in chain(o, d))
    check((t == np.asarray(ref.t)).all(), "split resume: t not bit-equal")
    check((hit == np.asarray(ref.hit)).all(), "split resume: hit differs")
    both = hit & np.asarray(ref.hit)
    check((idx[both] == np.asarray(ref.index)[both]).all(),
          "split resume: index differs")
    report("kernel", f"split resume ({c.max_raymarch // budget} x {budget} "
           f"trips) bit-equal to one kernel march on {o.shape[0]} rays")


def phase_kernel():
    from raytracingpbr_tpu.models import bunny, cornell
    scene = cornell.full_scene()
    cfg = cornell.full_config()
    cam = cornell.full_camera()
    env = cornell.sky()
    o, d = primary_rays(cfg, cam)
    compare_march(f"cornell full-PBR primary {cfg.width}x{cfg.height}",
                  scene, cfg, o, d, HIT_AGREE)
    mo, md = mixed_state_rays(scene, env, cam, cfg)
    compare_march("cornell full-PBR mixed wavefront state", scene, cfg,
                  mo, md, HIT_AGREE)
    split_resume_equal(scene, cfg, o, d)
    bcfg = bunny.glass_config(scale=1)
    bo, bd = primary_rays(bcfg, bunny.camera(bcfg.width / bcfg.height))
    compare_march(f"bunny glass primary {bcfg.width}x{bcfg.height}",
                  bunny.glass_scene(), bcfg, bo, bd, HIT_AGREE_BUNNY)

    frame, state = bench.cornell_wavefront()
    mem = frame.lower(state).compile().memory_analysis()
    report("kernel", f"wavefront step memory_analysis: {mem}")


def run_wavefront(label, frame, state, card, frames=3):
    state, px, _, _ = bench.time_frames(frame, state, 1)   # compile
    state, px, dt, deposits = bench.time_frames(frame, state, frames)
    check(deposits > 0, f"{label}: no deposits in {frames} frames")
    check(bool(jnp.isfinite(px).all()), f"{label}: non-finite pixels")
    report("wavefront", f"{label}: {dt * 1e3:.2f} ms/frame, "
           f"{deposits:.0f} deposits in {frames} frames ({card})")


def phase_wavefront(card):
    import __graft_entry__
    step, (state,) = __graft_entry__.entry()
    run_wavefront(f"engine default {state.accum.shape[0]} px HDR IBL",
                  jax.jit(step), state, card)
    frame, state = bench.cornell_wavefront()
    run_wavefront(f"cornell full-PBR {state.accum.shape[0]} px", frame,
                  state, card)


def phase_megakernel(card):
    import raytracingpbr_tpu as rt
    from raytracingpbr_tpu.models import cornell
    cfg = cornell.full_config()
    scene, env, cam = (cornell.full_scene(), cornell.sky(),
                       cornell.full_camera())
    f = jax.jit(lambda: rt.render_image(scene, env, cam, cfg, spp=1,
                                        tonemapped=False))
    jax.block_until_ready(f())
    t0 = time.perf_counter()
    img = jax.block_until_ready(f())
    dt = time.perf_counter() - t0
    check(img.shape == (cfg.height, cfg.width, 3),
          f"megakernel: image shape {img.shape}")
    check(bool(jnp.isfinite(img).all()), "megakernel: non-finite image")
    report("megakernel", f"cornell full {cfg.width}x{cfg.height} 1 spp: "
           f"{dt * 1e3:.2f} ms/pass ({card})")


def phase_inverse():
    grad_step, scene, _ = bench.grad_step_setup(
        max_raytrace=128, differentiable="replay", env_sampling=True)
    g = np.asarray(grad_step(scene, jnp.uint32(0)))
    check(np.isfinite(g).all(), "inverse: non-finite albedo gradient")
    check(np.abs(g).max() > 0, "inverse: albedo gradient is all zero")
    report("inverse", f"128-bounce replay + NEE grad step: albedo grad "
           f"{g.shape}, max |g| {np.abs(g).max():.4g}")


def phase_goldens():
    from raytracingpbr_tpu.io import image as imageio
    from raytracingpbr_tpu.utils.metrics import psnr
    from tests.golden_specs import render_golden
    for name in ("cornell_full", "bunny_metal", "bunny_glass_anim",
                 "tokyo"):
        gold = imageio.read_png(os.path.join(
            REPO, "assets", "goldens", f"{name}.png"))[..., :3]
        img = np.asarray(render_golden(name))
        got = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
        check(got.shape == gold.shape, f"golden {name}: shape {got.shape}")
        db = psnr(got, gold)
        check(db >= GOLDEN_DB, f"golden {name}: PSNR {db:.2f} dB")
        report("goldens", f"{name}: PSNR {db:.2f} dB vs CPU golden")


def phase_offline():
    from raytracingpbr_tpu.apps import offline
    from raytracingpbr_tpu.io import image as imageio
    out = os.path.join(REPO, "out", "chip_smoke_offline")
    path = os.path.join(out, "frame_00000.png")
    if os.path.exists(path):
        os.remove(path)
    t0 = time.perf_counter()
    offline.main(["--scene", "bunny_glass", "--scale", "1", "--frames", "1",
                  "--spp", "4", "--integrator", "wavefront", "--nee",
                  "--out", out])
    img = imageio.read_png(path)
    check(img.shape[:2] == (1080, 1920), f"offline: PNG shape {img.shape}")
    report("offline", f"bunny glass 1920x1080 4 spp wavefront+NEE frame "
           f"written and read back {img.shape} in "
           f"{time.perf_counter() - t0:.1f}s incl. compile")


def phase_multi(n_dev=4, frames=3):
    """The four-card paths, each against the same work on one card."""
    import optax

    import raytracingpbr_tpu as rt
    from raytracingpbr_tpu.core.types import make_frame_state
    from raytracingpbr_tpu.models import cornell
    from raytracingpbr_tpu.ops import integrator as integ
    from raytracingpbr_tpu.parallel import mesh as meshlib
    from raytracingpbr_tpu.parallel import render as prender
    from raytracingpbr_tpu.parallel import train as ptrain

    devs = jax.devices()
    check(len(devs) == n_dev, f"--multi needs {n_dev} devices, "
          f"found {len(devs)}")
    mesh = meshlib.make_mesh(devs[:n_dev], tiles=n_dev, samples=1)
    one = meshlib.make_mesh(devs[:1], tiles=1, samples=1)
    scene = cornell.full_scene()
    cam = cornell.full_camera()
    env = cornell.sky()
    cfg = cornell.full_config().replace(samples_per_frame=2,
                                        max_raytrace=512,
                                        quality_per_sample=0.8)
    n = cfg.num_pixels

    def close(label, a, b):
        a, b = np.asarray(a), np.asarray(b)
        diff = np.abs(a - b)
        at = np.unravel_index(diff.argmax(), diff.shape)
        check(np.allclose(a, b, atol=SHARD_ATOL, rtol=SHARD_RTOL),
              f"{label}: max |diff| {diff.max():.3g} at index {at} "
              f"(four cards {a[at]:.6g}, one card {b[at]:.6g}); "
              f"{(~np.isclose(a, b, atol=SHARD_ATOL, rtol=SHARD_RTOL)).sum()}"
              f" of {a.size} entries outside tolerance")
        return diff.max()

    f1 = jax.jit(lambda st: integ.render_frame(scene, env, cam, st, cfg))
    s1 = jax.device_put(make_frame_state(n), devs[0])
    f4 = jax.jit(lambda st: prender.render_frame_sharded(
        scene, env, cam, st, cfg, mesh, layout="strided"))
    s4 = prender.shard_frame_state(make_frame_state(n), mesh)
    for _ in range(frames):
        px1, s1 = f1(s1)
        px4, s4 = f4(s4)
    px4 = prender.unshard_pixels(px4, n_dev, "strided")
    acc4 = prender.unshard_pixels(s4.accum, n_dev, "strided")
    m = max(close("sharded wavefront pixels", px4, px1),
            close("sharded wavefront accum", acc4, s1.accum))
    report("multi", f"render_frame_sharded strided (4,1), cornell full-PBR "
           f"{cfg.width}x{cfg.height}, {frames} frames: max |diff| {m:.3g} "
           f"vs one card")

    icfg = cornell.full_config().replace(max_raytrace=64)
    img4 = prender.render_image_sharded(scene, env, cam, icfg, mesh, spp=2,
                                        tonemapped=False, layout="strided")
    img1 = prender.render_image_sharded(scene, env, cam, icfg, one, spp=2,
                                        tonemapped=False)
    m = close("render_image_sharded", img4, img1)
    report("multi", f"render_image_sharded strided (4,1), cornell full "
           f"{icfg.width}x{icfg.height} 2 spp: max |diff| {m:.3g} vs one "
           "card")

    # plain SGD at rate 1: the step moves the albedos by exactly minus the
    # psum'd gradient (Adam's sign-like first step would amplify
    # reassociation noise in near-zero gradient entries)
    tcfg = cornell.full_config().replace(max_raytrace=8)
    opt = optax.sgd(1.0)
    target = jnp.zeros((tcfg.num_pixels, 3))
    results = []
    for mm in (mesh, one):
        step = ptrain.make_sharded_train_step(
            env, cam, tcfg, mm, opt, spp=1,
            param_filter=ptrain.material_only_filter)
        ts, loss = step(ptrain.make_train_state(scene, opt), target)
        results.append((scene.albedo - ts.scene.albedo, loss))
    m = max(close("train step albedo gradient", results[0][0],
                  results[1][0]),
            close("train step loss", results[0][1], results[1][1]))
    report("multi", f"make_sharded_train_step (4,1), cornell full "
           f"{tcfg.width}x{tcfg.height} 8 bounces: loss "
           f"{float(results[0][1]):.6g}, max |diff| {m:.3g} vs one card")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-card sharded paths")
    args = p.parse_args(argv)

    device = require_gpu()
    smi = nvidia_smi_name_power()
    report("device", f"platform={device['platform']} kind={device['kind']} "
           f"count={device['count']}")
    print(f"nvidia-smi: {smi}", flush=True)
    card = smi.splitlines()[0]
    enable_compile_cache()

    if args.multi:
        phases = [("multi", phase_multi)]
    else:
        phases = [("kernel", phase_kernel),
                  ("wavefront", lambda: phase_wavefront(card)),
                  ("megakernel", lambda: phase_megakernel(card)),
                  ("inverse", phase_inverse), ("goldens", phase_goldens),
                  ("offline", phase_offline)]
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        report(name, f"ok in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
