"""Budget-capped split march (cfg.march_split; round 5).

The wavefront answer to the march divergence tax (SCALING.md): cap each
step's march and carry unconverged lanes' exact loop state to the next
step. Properties tested here:

1. Resumed marching is BIT-IDENTICAL to one uninterrupted march, per lane,
   on the XLA path (the Pallas kernel's init path is checked in interpret
   mode in tests/test_pallas.py and on the card in tests/test_gpu.py).
2. The split wavefront computes the same estimator: equal-sample means
   match the unsplit wavefront statistically.
3. Sharding invariance: the split wavefront renders bit-identically on the
   8-device mesh and single-device (per-lane consumption is
   min(residual, budget) — independent of tile composition).
4. Checkpoint round-trip carries in-flight segments bit-exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingpbr_tpu.core import rng as rnglib
from raytracingpbr_tpu.core.types import make_frame_state
from raytracingpbr_tpu.models import cornell
from raytracingpbr_tpu.ops import camera as cameralib
from raytracingpbr_tpu.ops import integrator as integ
from raytracingpbr_tpu.ops import march as marchlib


def primary_rays(cfg, cam, n=None, seed=3):
    total = cfg.num_pixels
    pid = jnp.arange(total, dtype=jnp.uint32)
    if n is not None:
        rng = np.random.default_rng(seed)
        pid = jnp.asarray(rng.choice(total, size=n,
                                     replace=False).astype(np.uint32))
    u = rnglib.uniform4(pid, 0, 1, cfg.seed)
    uv = cameralib.pixel_uv(pid, cfg.width, cfg.height, u[0], u[1])
    return pid, cameralib.get_ray(cam, uv, u[2], u[3])


@pytest.mark.parametrize("omega_policy", ["default", "constant"])
def test_resumed_march_bit_identical(omega_policy):
    """Chained budget-B march_resumable calls == one uninterrupted march,
    per lane, bit-for-bit (t, index, hit) — the property split marching
    rests on."""
    scene = cornell.full_scene()
    cfg = cornell.full_config().replace(max_raymarch=64)
    if omega_policy == "constant":
        from raytracingpbr_tpu.config import OmegaPolicy
        cfg = cfg.replace(omega=1.0, omega_policy=OmegaPolicy.CONSTANT)
    cam = cornell.full_camera()
    _, rays = primary_rays(cfg, cam, n=512)
    o, d = rays.origin, rays.direction

    ref = marchlib.march(scene, o, d, cfg, differentiable=False)

    B = 16
    n = o.shape[0]
    t = jnp.full((n,), cfg.march_t0)
    w = jnp.full((n,), cfg.omega)
    s = jnp.zeros((n,))
    dd = jnp.full((n,), 1e3)
    cum = jnp.zeros((n,), jnp.int32)
    idx = jnp.zeros((n,), jnp.int32)
    hit = jnp.zeros((n,), bool)
    live = jnp.ones((n,), bool)
    mcfg = cfg.replace(max_raymarch=B)
    for _ in range(cfg.max_raymarch // B):
        rr = marchlib.march_resumable(scene, o, d, mcfg, active=live,
                                      init=(t, w, s, dd))
        cum = cum + rr.fin
        done_now = live & ((rr.done > 0) | (cum >= cfg.max_raymarch))
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


def _accumulate(cfg, frames):
    scene = cornell.full_scene()
    cam = cornell.full_camera()
    env = cornell.sky()
    state = make_frame_state(cfg.num_pixels)
    frame = jax.jit(lambda st: integ.render_frame(scene, env, cam, st, cfg))
    for _ in range(frames):
        _, state = frame(state)
    return state


def test_split_wavefront_same_estimator():
    """Split and unsplit wavefronts estimate the same image: per-channel
    means agree statistically, and the split run deposits samples at a
    comparable rate (>= 60% per step on this workload).

    Comparison note: each pixel's deposited samples are unbiased under
    either schedule, so the PER-PIXEL mean image is the comparable
    quantity. Pooling sum(rgb)/sum(alpha) across pixels would instead
    weight every pixel by its deposit rate — which legitimately differs
    between the schedules (a deep-march pixel completes fewer samples per
    step under a budget cap), making the pooled ratio differ even with a
    perfect estimator."""
    base = cornell.full_config().replace(
        resolution=(48, 48), max_raymarch=64, max_raytrace=16,
        samples_per_frame=4)
    st_a = _accumulate(base, 72)
    st_b = _accumulate(base.replace(march_split=16), 72)
    a = np.asarray(st_a.accum)
    b = np.asarray(st_b.accum)
    # deposits happen (alpha grows) at a comparable rate
    assert b[:, 3].sum() > 0.6 * a[:, 3].sum()
    assert float(b[:, 3].min()) > 8  # every pixel has samples
    img_a = a[:, :3] / np.maximum(a[:, 3:4], 1.0)
    img_b = b[:, :3] / np.maximum(b[:, 3:4], 1.0)
    # average of per-pixel means, uniform pixel weighting (measured
    # agreement ~0.4%)
    np.testing.assert_allclose(img_b.mean(0), img_a.mean(0), rtol=0.05)
    # and the images agree pixel-wise in aggregate. Median, not mean: at
    # ~50-150 samples/pixel the tinted-wall->light firefly tail puts
    # single pixels at [4,0,0]-vs-[0,0,0] in one run or the other, which
    # dominates any mean-relative-error metric without indicating bias.
    rel = np.abs(img_b - img_a).max(1) / (img_a.max(1) + 0.05)
    assert np.median(rel) < 0.25, np.median(rel)


def test_split_wavefront_sharding_invariant():
    """The split wavefront is bit-identical on the 8-device mesh vs a
    single device (consumption per lane is min(residual, budget))."""
    from raytracingpbr_tpu.parallel import mesh as meshlib
    from raytracingpbr_tpu.parallel import render as prender
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    cfg = cornell.full_config().replace(
        resolution=(32, 24), max_raymarch=64, max_raytrace=8,
        samples_per_frame=2, march_split=16)
    scene = cornell.full_scene()
    cam = cornell.full_camera()
    env = cornell.sky()

    state1 = make_frame_state(cfg.num_pixels)
    px1 = None
    frame1 = jax.jit(lambda st: integ.render_frame(scene, env, cam, st,
                                                   cfg))
    for _ in range(3):
        px1, state1 = frame1(state1)

    mesh = meshlib.make_mesh(jax.devices()[:8], tiles=4, samples=2)
    stateN = prender.shard_frame_state(make_frame_state(cfg.num_pixels),
                                       mesh)
    pxN = None
    for _ in range(3):
        pxN, stateN = prender.render_frame_sharded(scene, env, cam, stateN,
                                                   cfg, mesh)
    # Deposited results and segment scheduling are bit-identical. The
    # in-flight (t, w, s, d) carry and displayed pixels may differ at
    # reassociation level ONLY on this CPU stand-in: XLA-CPU forms FMAs
    # differently for different shard SIZES on the split graph (per-lane
    # math is identical; the Pallas kernel is block-quantized and has one
    # codegen regardless of batch size).
    np.testing.assert_array_equal(np.asarray(state1.accum),
                                  np.asarray(stateN.accum))
    np.testing.assert_array_equal(np.asarray(state1.march_cum),
                                  np.asarray(stateN.march_cum))
    np.testing.assert_allclose(np.asarray(state1.march_state),
                               np.asarray(stateN.march_state),
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(px1), np.asarray(pxN),
                               rtol=0, atol=2e-7)


def test_split_checkpoint_roundtrip(tmp_path):
    """In-flight split segments survive checkpoint/resume bit-exactly."""
    from raytracingpbr_tpu.io import checkpoint as ckpt
    cfg = cornell.full_config().replace(
        resolution=(32, 24), max_raymarch=64, max_raytrace=8,
        march_split=16)
    scene = cornell.full_scene()
    cam = cornell.full_camera()
    env = cornell.sky()
    state = make_frame_state(cfg.num_pixels)
    frame = jax.jit(lambda st: integ.render_frame(scene, env, cam, st, cfg))
    _, state = frame(state)
    assert int(np.asarray(state.march_cum).max()) > 0  # something in flight
    p = str(tmp_path / "ck.npz")
    ckpt.save(p, state, {"frame": 1})
    loaded, meta = ckpt.load(p)
    _, after_a = frame(state)
    _, after_b = frame(jax.tree.map(jnp.asarray, loaded))
    for x, y in zip(jax.tree.leaves(after_a), jax.tree.leaves(after_b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
