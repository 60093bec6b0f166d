"""Environment lighting tests (reference: src/ibl.py, scene_demo skies)."""
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingpbr_tpu.core import rng as rnglib
from raytracingpbr_tpu.ops import ibl


def test_black_white_constant():
    d = jnp.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    np.testing.assert_allclose(
        np.array(ibl.sky_color(ibl.black_sky(), d)), 0.0)
    np.testing.assert_allclose(
        np.array(ibl.sky_color(ibl.white_sky(), d)), 1.0)
    np.testing.assert_allclose(
        np.array(ibl.sky_color(ibl.constant_sky((0.5, 0.25, 0.125)), d)),
        np.tile([0.5, 0.25, 0.125], (2, 1)))


def test_gradient_sky_reference_values():
    env = ibl.gradient_sky(scale=1.8)
    up = jnp.array([[0.0, 1.0, 0.0]])
    down = jnp.array([[0.0, -1.0, 0.0]])
    # t=1 at up -> color_b * 1.8; t=0 at down -> color_a * 1.8
    np.testing.assert_allclose(np.array(ibl.sky_color(env, up))[0],
                               np.array([0.25, 0.35, 1.0]) * 1.8, rtol=1e-5)
    np.testing.assert_allclose(np.array(ibl.sky_color(env, down))[0],
                               np.array([1.0, 1.0, 0.5]) * 1.8, rtol=1e-5)


def _delta_map(w=16, h=8, x=12, y=6, value=(5.0, 3.0, 1.0)):
    img = np.zeros((w, h, 3), np.float32)
    img[x, y] = value
    return img


def test_hdr_nearest_lookup():
    img = _delta_map()
    env = ibl.hdr_environment(jnp.asarray(img), prebake=False)
    # uv center of texel (12, 6): u=(12.5)/16, v=(6.5)/8
    u, v = 12.5 / 16, 6.5 / 8
    # direction from inverse equirect: phi=(u-0.5)*2pi, lat=(v-0.5)*pi
    phi = (u - 0.5) * 2 * np.pi
    lat = (v - 0.5) * np.pi
    d = jnp.array([[np.cos(lat) * np.cos(phi), np.sin(lat),
                    np.cos(lat) * np.sin(phi)]], dtype=jnp.float32)
    out = np.array(ibl.sky_color(env, d))[0]
    np.testing.assert_allclose(out, [5.0, 3.0, 1.0], rtol=1e-4)


def test_prebake_applies_exposure_gamma():
    img = np.full((4, 2, 3), 0.5, np.float32)
    env = ibl.hdr_environment(jnp.asarray(img), exposure=2.0, gamma=2.0)
    # adjust: (0.5 * 2)^2 = 1
    np.testing.assert_allclose(np.array(env.image), 1.0, rtol=1e-6)


def test_bilinear_interpolates():
    img = np.zeros((8, 4, 3), np.float32)
    img[:, :] = 1.0
    img[4, 2] = 3.0
    env_n = ibl.hdr_environment(jnp.asarray(img), prebake=False,
                                bilinear=False)
    env_b = ibl.hdr_environment(jnp.asarray(img), prebake=False,
                                bilinear=True)
    # u=0.55: nearest snaps to texel x=4 (int(4.4)); bilinear blends
    # x=3 (1.0) and x=4 (3.0) at tx=0.9. v=0.625 centers row y=2 exactly.
    u, v = 0.55, 0.625
    phi = (u - 0.5) * 2 * np.pi
    lat = (v - 0.5) * np.pi
    d = jnp.array([[np.cos(lat) * np.cos(phi), np.sin(lat),
                    np.cos(lat) * np.sin(phi)]], dtype=jnp.float32)
    out_n = float(np.array(ibl.sky_color(env_n, d))[0, 0])
    out_b = float(np.array(ibl.sky_color(env_b, d))[0, 0])
    assert out_n == pytest.approx(3.0, rel=1e-3)  # nearest snaps
    assert 1.0 < out_b < 3.0                       # bilinear blends


def test_importance_sampler_prefers_bright_texels():
    img = np.full((32, 16, 3), 0.01, np.float32)
    img[20, 10] = 100.0  # bright sun texel
    env = ibl.hdr_environment(jnp.asarray(img), prebake=False)
    sampler = ibl.build_env_sampler(env)
    n = 4096
    pid = jnp.arange(n, dtype=jnp.uint32)
    u1 = rnglib.uniform(pid, 0, 0)
    u2 = rnglib.uniform(pid, 0, 1)
    d, radiance, pdf = ibl.sample_env(sampler, u1, u2)
    frac_sun = float((np.array(radiance)[:, 0] > 50).mean())
    assert frac_sun > 0.5  # most samples land on the sun
    assert (np.array(pdf) > 0).all()


def test_importance_sampler_pdf_integrates_to_one():
    img = np.asarray(
        np.random.default_rng(0).uniform(0.1, 2.0, (16, 8, 3)), np.float32)
    env = ibl.hdr_environment(jnp.asarray(img), prebake=False)
    s = ibl.build_env_sampler(env)
    w, h = 16, 8
    y = (np.arange(h) + 0.5) / h
    sin_theta = np.cos(np.pi * (y - 0.5))
    texel_sa = (2 * np.pi / w) * (np.pi / h) * sin_theta[None, :]
    total = float((np.array(s.pdf_map) * texel_sa).sum())
    assert total == pytest.approx(1.0, rel=1e-3)


def test_alias_sampler_matches_luminance_distribution():
    """EnvAliasSampler draws texels with the same luminance-proportional
    distribution as the CDF sampler (exact alias construction)."""
    rng = np.random.default_rng(1)
    img = np.asarray(rng.uniform(0.05, 1.0, (8, 4, 3)), np.float32)
    img[5, 2] = 40.0
    env = ibl.hdr_environment(jnp.asarray(img), prebake=False)
    s = ibl.build_env_alias_sampler(env)
    np.testing.assert_allclose(np.asarray(s.pdf_map),
                               np.asarray(ibl.build_env_sampler(env).pdf_map),
                               rtol=1e-5)
    n = 200_000
    u1 = jnp.asarray(rng.uniform(size=n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(size=n), jnp.float32)
    d, radiance, pdf = ibl.sample_env_alias(s, u1, u2)
    # empirical texel frequency ~ luminance mass
    w, h = 8, 4
    y = (np.arange(h) + 0.5) / h
    sin_theta = np.cos(np.pi * (y - 0.5))
    lum = (np.asarray(img) * [0.299, 0.587, 0.114]).sum(-1) * sin_theta[None]
    mass = (lum / lum.sum()).reshape(-1)
    # recover texel from radiance identity: compare sun-texel frequency
    sun_frac = float((np.asarray(radiance)[:, 0] > 20.0).mean())
    assert sun_frac == pytest.approx(mass[5 * 4 + 2], rel=0.05)
    # unit-norm directions and positive pdfs everywhere
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d), axis=-1), 1.0,
                               atol=1e-5)
    assert (np.asarray(pdf) > 0).all()


@pytest.mark.parametrize("m", [512, 4096, 16384])
def test_fetch_rows_exact(m):
    """Per-lane table fetches are exact at every table size, ids above
    2048 included (a TF32 one-hot matmul would round both the payload and
    the integer ids)."""
    rng = np.random.default_rng(m)
    table = rng.random((m, 4)).astype(np.float32)
    ids = rng.integers(0, m, 4096).astype(np.int32)
    ids[:16] = np.arange(m - 16, m)  # the highest ids
    assert (ids > 2048).any() or m <= 2048
    got = np.asarray(ibl.fetch_rows(jnp.asarray(table), jnp.asarray(ids)))
    np.testing.assert_array_equal(got, table[ids])
    alias = np.arange(m, dtype=np.int32)[::-1].copy()
    got_i = np.asarray(ibl.fetch_rows(jnp.asarray(alias), jnp.asarray(ids)))
    np.testing.assert_array_equal(got_i, alias[ids])
