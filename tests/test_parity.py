"""Per-workload-family golden gating (VERDICT r2 item 7).

Every reference workload family re-renders deterministically and must match
its checked-in self-golden (assets/goldens/, generated by
tools/make_goldens.py on the same CPU platform) at high PSNR. The gate is
35 dB rather than bit-exact to tolerate XLA fusion/reassociation drift
across compiler versions; any actual rendering regression (march, shade,
IBL, RNG, post) lands far below it.

External-golden comparison (the reference's published
others/cornell_box_taichi.png) needs that image, which this repository does
not hold; PARITY.md records the numbers an earlier tool measured.
"""
import os

import numpy as np
import pytest

from raytracingpbr_tpu.io import image as imageio
from raytracingpbr_tpu.utils.metrics import psnr

from .golden_specs import (GOLDENS, WAVEFRONT_GOLDENS, render_golden,
                           render_wavefront_golden)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "assets",
                          "goldens")
GATE_DB = 35.0


def _check(name: str, img) -> float:
    path = os.path.join(GOLDEN_DIR, f"{name}.png")
    if not os.path.exists(path):
        pytest.fail(f"golden {path} missing — run tools/make_goldens.py")
    gold = imageio.read_png(path)[..., :3]
    got = (np.clip(np.asarray(img), 0, 1) * 255 + 0.5).astype(np.uint8)
    assert got.shape == gold.shape, (got.shape, gold.shape)
    db = psnr(got, gold)
    assert db >= GATE_DB, f"{name}: PSNR {db:.2f} dB < {GATE_DB}"
    return db


class TestMetrics:
    def test_identity_and_noise_ordering(self):
        rng = np.random.default_rng(0)
        from raytracingpbr_tpu.utils.metrics import block_corr, ssim
        a = rng.random((64, 64, 3))
        assert psnr(a, a) == float("inf")
        assert abs(ssim(a, a) - 1.0) < 1e-9
        small = np.clip(a + rng.normal(0, 0.01, a.shape), 0, 1)
        big = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1)
        assert psnr(a, small) > psnr(a, big)
        assert ssim(a, small) > ssim(a, big)
        assert block_corr(a, small) > block_corr(a, big)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_family_matches_golden(name):
    _check(name, render_golden(name))


@pytest.mark.parametrize("name", sorted(WAVEFRONT_GOLDENS))
def test_wavefront_matches_golden(name):
    _check(f"wavefront_{name}", render_wavefront_golden(name))
