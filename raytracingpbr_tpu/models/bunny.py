"""Neural-SDF bunny scene family.

Reference: ``examples/bunny/bunny_sdf.py`` (metal, 4K),
``bunny_sdf_v2.py`` (white background, headless) and
``bunny_sdf_glass.py`` (dielectric, HDR IBL, 240-frame animation) —
SURVEY.md §2.2. The bunny geometry is a sin-activated 16-wide MLP
(``bunny_sdf_glass.py:150-203``); the march kernel evaluates its two 16x16
layers as unrolled FMA chains per ray (SURVEY.md §7.4.6).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import HitCriterion, OmegaPolicy, RenderConfig, Tonemap
from ..core.types import Camera, make_camera
from ..ops.ibl import Environment, black_sky, hdr_environment, white_sky
from ..ops.scene import ObjectSpec, Scene, animate, make_scene
from ..ops.sdf import SHAPE
from .demo import synthetic_hdr


def _bunny_object(material_kw) -> ObjectSpec:
    # -90deg x rotation stands the bunny up (bunny_sdf_glass.py:221-224)
    return ObjectSpec(SHAPE.BUNNY, (0, 0, 0), (-90, 0, 0), (1, 1, 1),
                      **material_kw)


def metal_scene() -> Scene:
    """Metal bunny (``bunny_sdf.py``: metallic=1, roughness=0.2-ish)."""
    return make_scene([_bunny_object(dict(
        albedo=(1.0, 0.77, 0.34), roughness=0.2, metallic=1.0,
        transmission=0.0, ior=1.5))])


def glass_scene() -> Scene:
    """Dielectric bunny (``bunny_sdf_glass.py:224``: transmission=1,
    ior=1.5)."""
    return make_scene([_bunny_object(dict(
        albedo=(0.9, 0.9, 0.9), roughness=0.0, metallic=0.0,
        transmission=1.0, ior=1.5))])


def metal_config(scale: int = 1) -> RenderConfig:
    """Bunny metal 4K workload (``bunny_sdf.py:9,23-25``): 3840x2160, 4 spp,
    128 bounces / 512 march. ``scale`` divides the resolution for smoke
    runs."""
    return RenderConfig(
        resolution=(3840 // scale, 2160 // scale),
        samples_per_pixel=4,
        max_raytrace=128,
        max_raymarch=512,
        omega=0.9,
        omega_policy=OmegaPolicy.CONSTANT,
        hit_criterion=HitCriterion.RELATIVE,
        march_t0=0.005,
        black_background=True,
        f0_half=True,  # bunny_sdf.py:319 F0 variant (config.f0_half)
    )


def glass_config(scale: int = 1) -> RenderConfig:
    """Bunny glass animation workload (``bunny_sdf_glass.py:9,23-25``):
    1920x1080, 512 spp, 512 bounces / 2048 march, conservative w=0.5 for
    thin glass (``:251,258``)."""
    return RenderConfig(
        resolution=(1920 // scale, 1080 // scale),
        samples_per_pixel=512,
        max_raytrace=512,
        max_raymarch=2048,
        omega=0.5,
        omega_policy=OmegaPolicy.CONSTANT,
        hit_criterion=HitCriterion.RELATIVE,
        march_t0=0.005,
        f0_half=True,  # bunny_sdf_glass.py:322 F0 variant (config.f0_half)
    )


def camera(aspect: float) -> Camera:
    """Bunny viewpoint (``bunny_sdf_glass.py`` app section)."""
    return make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                       vfov=35.0, aspect=aspect, aperture=0.01, focus=3.0)


def v2_config(scale: int = 1) -> RenderConfig:
    """Bunny v2 headless workload (``bunny_sdf_v2.py:355-358,434,452``):
    white background for primary misses, 4K, 12 spp."""
    return metal_config(scale).replace(samples_per_pixel=12,
                                       black_background=False)


def v2_environment() -> Environment:
    """White background for primary-miss rays (``bunny_sdf_v2.py:355-358``)."""
    return white_sky()


def glass_environment(bilinear: bool = True) -> Environment:
    """HDR IBL with sky gamma boost (``bunny_sdf_glass.py:53``; the actual
    limpopo .hdr asset is missing upstream — synthetic stand-in)."""
    return hdr_environment(jnp.asarray(synthetic_hdr(seed=1)), exposure=1.0,
                           gamma=2.2, bilinear=bilinear)


def animated_scene(scene: Scene, frame) -> Scene:
    """Per-frame spin + z-bob (``bunny_sdf_glass.py:213-217``)."""
    return animate(scene, jnp.asarray(frame))
