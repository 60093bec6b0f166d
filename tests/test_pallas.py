"""Pallas fused-march kernel (Triton route) vs the XLA march, in interpret
mode on the CPU; the compiled kernel is checked on the card by
tests/test_gpu.py and chip_smoke.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingpbr_tpu.models import cornell, demo
from raytracingpbr_tpu.ops import march as ml
from raytracingpbr_tpu.pallas import march_kernel as mk

N_RAYS = 1024


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """Run pallas_call in interpret mode (no GPU on the CPU suite)."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def rays_for(cfg, n=N_RAYS, seed=0):
    rng = np.random.default_rng(seed)
    o = np.tile([[0.0, 0.0, 3.5]], (n, 1)) + rng.normal(0, 0.2, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def bunny_rays(n=N_RAYS, seed=3):
    rng = np.random.default_rng(seed)
    o = np.tile([[0.0, 0.0, 2.5]], (n, 1)) + rng.normal(0, 0.1, (n, 3))
    d = -o + rng.normal(0, 0.35, (n, 3))  # aim at the bunny, with spread
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def assert_matches_xla(t, idx, hit, ref, min_agree=0.999, tol=1e-3):
    h_ref, h_pl = np.array(ref.hit), np.array(hit)
    agree = h_ref == h_pl
    assert agree.mean() >= min_agree, f"hit mismatch {1-agree.mean():.4%}"
    # f32 accumulation-order differences flip boundary decisions on a few
    # lanes of long marches; allow small relative slack
    np.testing.assert_allclose(np.array(t)[agree], np.array(ref.t)[agree],
                               rtol=tol, atol=tol)
    both = h_ref & h_pl
    np.testing.assert_array_equal(np.array(idx)[both],
                                  np.array(ref.index)[both])


@pytest.mark.parametrize("scene_fn,cfg", [
    (cornell.minimal_scene, cornell.minimal_config()),
    (demo.engine_scene, demo.engine_config().replace(max_raymarch=128)),
])
def test_pallas_march_matches_xla(scene_fn, cfg):
    scene = scene_fn()
    o, d = rays_for(cfg)
    ref = ml.march(scene, o, d, cfg, differentiable=False, backend="xla")
    t, idx, hit, _ = mk.march_pallas(scene, o, d, cfg)
    assert_matches_xla(t, idx, hit, ref)


def test_pallas_march_padding():
    """Non-multiple-of-block batches are padded and unpadded correctly."""
    scene = cornell.minimal_scene()
    cfg = cornell.minimal_config()
    o, d = rays_for(cfg, n=777)
    t, idx, hit, _ = mk.march_pallas(scene, o, d, cfg)
    assert t.shape == (777,)
    ref = ml.march(scene, o, d, cfg, differentiable=False, backend="xla")
    agree = np.array(hit) == np.array(ref.hit)
    assert agree.mean() > 0.995


def _five_object_scene():
    import raytracingpbr_tpu as rt
    from raytracingpbr_tpu.ops.scene import ObjectSpec
    from raytracingpbr_tpu.ops.sdf import SHAPE
    return rt.make_scene([
        ObjectSpec(SHAPE.SPHERE, position=(0, -101, 0), scale=(100,) * 3),
        ObjectSpec(SHAPE.SPHERE, position=(-1.1, 0, 0), scale=(1.0,) * 3),
        ObjectSpec(SHAPE.BOX, position=(1.1, 0, 0), rotation=(0, 30, 0),
                   scale=(0.6,) * 3),
        ObjectSpec(SHAPE.CYLINDER, position=(0, 0, -1.5), scale=(0.4, 1, 0.4)),
        ObjectSpec(SHAPE.CONE, position=(0, 1.5, 0), scale=(0.8, 0.6, 0.5)),
    ])


@pytest.mark.parametrize("n", [1, 129, 4097])
def test_pallas_padding_odd_sizes(n):
    """Ray counts that leave a partial block, against a scene whose object
    count (5) is not a power of two: the parameter block is padded to 8
    rows and the padding lanes never march."""
    scene = _five_object_scene()
    assert scene.num_objects == 5
    cfg = demo.engine_config().replace(max_raymarch=64)
    o, d = rays_for(cfg, n=n, seed=n)
    t, idx, hit, fin = mk.march_pallas(scene, o, d, cfg)
    assert t.shape == idx.shape == hit.shape == fin.shape == (n,)
    ref = ml.march(scene, o, d, cfg, differentiable=False, backend="xla")
    assert_matches_xla(t, idx, hit, ref, min_agree=1.0 if n < 200 else 0.999)


def test_pallas_escape_bound_matches_xla():
    """The escape-bound early exit (cfg.escape_bound; bound carried in the
    packed parameter block) agrees with the XLA loop's bound test."""
    scene = demo.engine_scene()
    cfg = demo.engine_config().replace(max_raymarch=128, escape_bound=True)
    o, d = rays_for(cfg)
    ref = ml.march(scene, o, d, cfg, differentiable=False, backend="xla")
    t, idx, hit, fin = mk.march_pallas(scene, o, d, cfg)
    assert_matches_xla(t, idx, hit, ref)
    # the bound exits misses early: fewer trips than without it
    full = mk.march_pallas(scene, o, d, cfg.replace(escape_bound=False))
    assert int(np.array(fin).sum()) < int(np.array(full[3]).sum())


def test_pallas_bunny_matches_xla():
    """Neural-bunny MLP path in the kernel vs the XLA sd_bunny march."""
    from raytracingpbr_tpu.models import bunny as bunny_models
    scene = bunny_models.glass_scene()
    cfg = bunny_models.glass_config(scale=8).replace(max_raymarch=256)
    o, d = bunny_rays()
    ref = ml.march(scene, o, d, cfg, differentiable=False, backend="xla")
    t, idx, hit, _ = mk.march_pallas(scene, o, d, cfg)
    h_ref, h_pl = np.array(ref.hit), np.array(hit)
    agree = h_ref == h_pl
    assert h_ref.mean() > 0.2  # sanity: a decent fraction hits the bunny
    assert agree.mean() > 0.99
    both = h_ref & h_pl
    np.testing.assert_allclose(np.array(t)[both], np.array(ref.t)[both],
                               rtol=2e-3, atol=2e-3)


def test_pallas_animated_scene_offset():
    """local_offset (animation) is honored by the packed kernel params."""
    from raytracingpbr_tpu.models import bunny as bunny_models
    from raytracingpbr_tpu.ops import scene as sc
    base = bunny_models.glass_scene()
    scene = sc.animate(base, jnp.asarray(60))
    cfg = bunny_models.glass_config(scale=8).replace(max_raymarch=256)
    o = jnp.tile(jnp.array([[0.0, 0.0, 2.5]]), (128, 1))
    d = jnp.tile(jnp.array([[0.0, 0.0, -1.0]]), (128, 1))
    ref = ml.march(scene, o, d, cfg, differentiable=False, backend="xla")
    t, idx, hit, _ = mk.march_pallas(scene, o, d, cfg)
    assert bool(np.array(hit)[0]) == bool(np.array(ref.hit)[0])
    np.testing.assert_allclose(float(t[0]), float(ref.t[0]), rtol=2e-3)


def test_pallas_march_active_gate():
    """Inactive lanes exit at iteration 0 and keep init outputs; active
    lanes match the ungated kernel exactly."""
    scene = cornell.minimal_scene()
    cfg = cornell.minimal_config()
    o, d = rays_for(cfg)
    full = mk.march_pallas(scene, o, d, cfg)
    active = jnp.asarray(np.arange(N_RAYS) % 3 != 0)
    t, idx, hit, _ = mk.march_pallas(scene, o, d, cfg, active=active)
    a = np.array(active)
    np.testing.assert_array_equal(np.array(hit)[a], np.array(full[2])[a])
    np.testing.assert_array_equal(np.array(t)[a], np.array(full[0])[a])
    assert not np.array(hit)[~a].any()
    np.testing.assert_allclose(np.array(t)[~a], cfg.march_t0)


def _resume_chain(scene, o, d, cfg, budget, backend):
    """Chained budget-capped march_resumable calls, as the split-march
    wavefront runs them."""
    n = o.shape[0]
    t = jnp.full((n,), cfg.march_t0)
    w = jnp.full((n,), cfg.omega)
    s = jnp.zeros((n,))
    dd = jnp.full((n,), 1e3)
    cum = jnp.zeros((n,), jnp.int32)
    idx = jnp.zeros((n,), jnp.int32)
    hit = jnp.zeros((n,), bool)
    live = jnp.ones((n,), bool)
    mcfg = cfg.replace(max_raymarch=budget)
    for _ in range(cfg.max_raymarch // budget):
        rr = ml.march_resumable(scene, o, d, mcfg, active=live,
                                init=(t, w, s, dd), backend=backend)
        cum = cum + rr.fin
        done_now = live & ((rr.done > 0) | (cum >= cfg.max_raymarch))
        idx = jnp.where(live, rr.index, idx)
        hit = jnp.where(live, rr.hit, hit)
        t = jnp.where(live, rr.t, t)
        w = jnp.where(live, rr.w, w)
        s = jnp.where(live, rr.s, s)
        dd = jnp.where(live, rr.d, dd)
        live = live & ~done_now
    return ml.MarchResult(t, None, idx, hit, None), cum


@pytest.mark.parametrize("family", ["cornell", "engine", "bunny"])
def test_pallas_split_resume_matches_xla(family):
    """The kernel's init (resume) path: a chain of budget-capped kernel
    marches equals one uninterrupted kernel march bit for bit, and agrees
    with the XLA loop's own chain (per-lane trips consumed included)."""
    from raytracingpbr_tpu.models import bunny as bunny_models
    if family == "cornell":
        scene = cornell.full_scene()
        cfg = cornell.full_config().replace(max_raymarch=64)
        o, d = rays_for(cfg, n=512)
    elif family == "engine":
        scene = demo.engine_scene()
        cfg = demo.engine_config().replace(max_raymarch=64)
        o, d = rays_for(cfg, n=512)
    else:
        scene = bunny_models.glass_scene()
        cfg = bunny_models.glass_config(scale=8).replace(max_raymarch=64)
        o, d = bunny_rays(n=512)
    chain_k, cum_k = _resume_chain(scene, o, d, cfg, 16, "pallas")
    chain_x, cum_x = _resume_chain(scene, o, d, cfg, 16, "xla")
    single = ml.march(scene, o, d, cfg, differentiable=False,
                      backend="pallas")
    np.testing.assert_array_equal(np.array(chain_k.t), np.array(single.t))
    np.testing.assert_array_equal(np.array(chain_k.hit),
                                  np.array(single.hit))
    assert_matches_xla(chain_k.t, chain_k.index, chain_k.hit, chain_x,
                       min_agree=0.99 if family == "bunny" else 0.999)
    agree = np.array(chain_k.hit) == np.array(chain_x.hit)
    assert (np.array(cum_k) == np.array(cum_x))[agree].mean() > 0.99


@pytest.mark.parametrize("platform,expected", [
    ("gpu", True), ("cpu", False), ("rocm", ValueError)])
def test_march_path_per_platform(monkeypatch, platform, expected):
    """backend="auto": the kernel on the GPU, the XLA loop on the CPU, and
    no silent fallback anywhere else."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if expected is ValueError:
        with pytest.raises(ValueError, match=platform):
            ml._use_kernel("auto")
        return
    assert ml._use_kernel("auto") is expected
    # the forced choices ignore the platform
    assert ml._use_kernel("pallas") and not ml._use_kernel("xla")
    scene = cornell.minimal_scene()
    cfg = cornell.minimal_config().replace(max_raymarch=64)
    o, d = rays_for(cfg, n=64)
    res = ml.march(scene, o, d, cfg, differentiable=False)
    want = ml.march(scene, o, d, cfg, differentiable=False,
                    backend="pallas" if expected else "xla")
    np.testing.assert_array_equal(np.array(res.t), np.array(want.t))
