"""Hardware gate: the march kernel as compiled for the card, on the card.

Every other test in this suite runs on the CPU (8 virtual devices, Pallas
in interpret mode). This subset needs an NVIDIA GPU and skips without one;
it fails if:

* the compiled kernel's numerics drift from the XLA march loop,
* a split-march resume chain stops being bit-equal to one kernel march,
* an end-to-end render drifts from its CPU-rendered golden, or
* the equal-time advantage of NEE collapses.

Run on the card: ``JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py
-m gpu -v``.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingpbr_tpu.core import rng as rnglib
from raytracingpbr_tpu.core.types import make_frame_state
from raytracingpbr_tpu.models import cornell
from raytracingpbr_tpu.ops import camera as cameralib
from raytracingpbr_tpu.ops import integrator as integ
from raytracingpbr_tpu.ops import march as ml

pytestmark = pytest.mark.gpu


@pytest.fixture
def cornell_setup(gpu):
    scene = cornell.full_scene()
    cfg = cornell.full_config()
    cam = cornell.full_camera()
    env = cornell.sky()
    n = cfg.num_pixels
    pid = jnp.arange(n, dtype=jnp.uint32)
    u = rnglib.uniform4(pid, 0, 1, cfg.seed)
    uv = cameralib.pixel_uv(pid, cfg.width, cfg.height, u[0], u[1])
    primary = cameralib.get_ray(cam, uv, u[2], u[3])
    return scene, cfg, cam, env, primary


def test_pallas_march_matches_xla_on_chip(cornell_setup):
    """Compiled kernel numerics vs the XLA march (the CPU suite only ever
    checks the interpreter; this asserts the card)."""
    scene, cfg, cam, env, primary = cornell_setup
    o, d = primary.origin, primary.direction
    with jax.default_matmul_precision("highest"):
        ref = ml.march(scene, o, d, cfg, differentiable=False, backend="xla")
        res = jax.jit(lambda o, d: ml.march(
            scene, o, d, cfg, differentiable=False, backend="pallas"))(o, d)
    h_ref, h_pl = np.asarray(ref.hit), np.asarray(res.hit)
    agree = h_ref == h_pl
    assert agree.mean() > 0.999, f"hit mismatch {1 - agree.mean():.4%}"
    np.testing.assert_allclose(np.asarray(res.t)[agree],
                               np.asarray(ref.t)[agree],
                               rtol=1e-3, atol=1e-3)
    both = h_ref & h_pl
    np.testing.assert_array_equal(np.asarray(res.index)[both],
                                  np.asarray(ref.index)[both])


@pytest.mark.parametrize("name", ["cornell_full", "bunny_metal"])
def test_gpu_render_matches_cpu_golden(gpu, name):
    """End-to-end image on the card vs the CPU-rendered golden.

    Covers the GPU numerics stack — the compiled march kernel (incl. the
    bunny MLP), XLA shading/post — against the same deterministic render
    on the CPU. Gate 30 dB (vs the CPU suite's 35: the kernel-vs-XLA march
    boundary flips a few boundary pixels)."""
    import os

    from raytracingpbr_tpu.io import image as imageio
    from raytracingpbr_tpu.utils.metrics import psnr

    from .golden_specs import render_golden

    golden_dir = os.path.join(os.path.dirname(__file__), "..", "assets",
                              "goldens")
    path = os.path.join(golden_dir, f"{name}.png")
    assert os.path.exists(path), f"golden {path} missing"
    img = render_golden(name)
    gold = imageio.read_png(path)[..., :3]
    got = (np.clip(np.asarray(img), 0, 1) * 255 + 0.5).astype(np.uint8)
    assert got.shape == gold.shape
    db = psnr(got, gold)
    assert db >= 30.0, f"{name} on the GPU: PSNR {db:.2f} dB vs CPU golden"


def test_split_march_resume_bit_equal_on_chip(cornell_setup):
    """Kernel init path: chained budget-capped marches reproduce the single
    uninterrupted march bit-for-bit on the card (the property
    cfg.march_split rests on; interpret-mode version in
    tests/test_pallas.py)."""
    scene, cfg, cam, env, primary = cornell_setup
    c = cfg.replace(max_raymarch=128)
    o, d = primary.origin, primary.direction
    ref = ml.march(scene, o, d, c, differentiable=False, backend="pallas")
    B = 32
    n = o.shape[0]
    t = jnp.full((n,), c.march_t0)
    w = jnp.full((n,), c.omega)
    s = jnp.zeros((n,))
    dd = jnp.full((n,), 1e3)
    cum = jnp.zeros((n,), jnp.int32)
    idx = jnp.zeros((n,), jnp.int32)
    hit = jnp.zeros((n,), bool)
    live = jnp.ones((n,), bool)
    mcfg = c.replace(max_raymarch=B)
    for _ in range(c.max_raymarch // B):
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
    np.testing.assert_array_equal(np.asarray(t), np.asarray(ref.t))
    np.testing.assert_array_equal(np.asarray(hit), np.asarray(ref.hit))
    both = np.asarray(hit) & np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(idx)[both],
                                  np.asarray(ref.index)[both])


# Equal-time NEE advantage on the sun-lit bench_nee scene: a broken alias
# sampler, MIS weight or shadow march drops it to ~0.
NEE_EQUAL_TIME_DB_FLOOR = 8.0


def _nee_quality_setup():
    import raytracingpbr_tpu as rt
    from raytracingpbr_tpu.ops import ibl as ibllib
    from raytracingpbr_tpu.ops.scene import ObjectSpec
    from raytracingpbr_tpu.ops.sdf import SHAPE

    img = np.full((64, 32, 3), 0.05, np.float32)
    img[40:44, 24:28] = 25.0
    env = ibllib.with_env_sampler(
        rt.hdr_environment(jnp.asarray(img), prebake=False))
    scene = rt.make_scene([
        ObjectSpec(SHAPE.SPHERE, position=(0, -101, 0), scale=(100,) * 3,
                   albedo=(0.7, 0.7, 0.7), roughness=1.0),
        ObjectSpec(SHAPE.SPHERE, position=(-1.1, 0, 0), scale=(1.0,) * 3,
                   albedo=(0.6, 0.4, 0.3), roughness=1.0),
        ObjectSpec(SHAPE.SPHERE, position=(1.1, 0, 0), scale=(1.0,) * 3,
                   albedo=(0.9, 0.9, 0.9), roughness=0.5, metallic=1.0),
    ])
    cam = rt.make_camera(lookfrom=(0, 1.2, 5.0), lookat=(0, 0, 0),
                         vfov=40.0, aspect=1.0, aperture=0.0, focus=1.0)
    cfg = rt.RenderConfig(
        resolution=(160, 160), max_raymarch=64, max_raytrace=64,
        omega=1.0, omega_policy=rt.OmegaPolicy.CONSTANT,
        hit_criterion=rt.HitCriterion.ABSOLUTE, hit_precision=1e-4,
        march_t0=0.005, max_dis=300.0, samples_per_frame=4)
    return scene, env, cam, cfg


def _mean_image(state):
    a = np.asarray(state.accum)
    return a[:, :3] / np.maximum(a[:, 3:4], 1.0)


def test_nee_equal_time_quality_floor(gpu):
    """Same wall-time, env_sampling off vs on, PSNR against a converged
    NEE truth: the variance-reduction advantage must stay >= 8 dB
    (tools/bench_nee.py methodology)."""
    from raytracingpbr_tpu.utils.metrics import psnr

    scene, env, cam, cfg = _nee_quality_setup()
    budget_s = 2.0

    def run(c, seconds):
        state = make_frame_state(c.num_pixels)
        frame = jax.jit(lambda st: integ.render_frame(scene, env, cam, st,
                                                      c))
        px, state = frame(state)
        jax.block_until_ready(px)
        state = make_frame_state(c.num_pixels)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            px, state = frame(state)
            jax.block_until_ready(px)
        return state

    truth = _mean_image(run(cfg.replace(env_sampling=True), 8 * budget_s))
    plain = _mean_image(run(cfg, budget_s))
    nee = _mean_image(run(cfg.replace(env_sampling=True), budget_s))
    db_plain = psnr(np.clip(plain, 0, 4), np.clip(truth, 0, 4), peak=4.0)
    db_nee = psnr(np.clip(nee, 0, 4), np.clip(truth, 0, 4), peak=4.0)
    assert db_nee - db_plain >= NEE_EQUAL_TIME_DB_FLOOR, (
        f"equal-time NEE advantage {db_nee - db_plain:.1f} dB "
        f"(nee {db_nee:.1f} vs plain {db_plain:.1f}) below floor")
