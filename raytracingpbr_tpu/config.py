"""Render configuration.

Re-design of the reference's module-constant config
(``/root/reference/src/config.py:7-28``). Instead of import-time globals that
specialize Taichi kernels via ``ti.static``, we use a frozen dataclass passed
explicitly; every field is Python-static at ``jax.jit`` trace time, giving the
same kernel-specialization semantics idiomatically (SURVEY.md §5 "Config").
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class Tonemap(enum.Enum):
    """Postprocess pipeline ordering.

    The reference has two orderings (SURVEY.md §2.3.12):
      * ``GAMMA_THEN_ACES``: exposure -> gamma -> ACES -> clamp
        (``src/postprocessor.py:24-38``)
      * ``ACES_THEN_GAMMA``: exposure -> ACES -> gamma
        (``examples/cornell_box/cornell_box.py:374-377``)
    """

    GAMMA_THEN_ACES = "gamma_then_aces"
    ACES_THEN_GAMMA = "aces_then_gamma"
    NONE = "none"


class OmegaPolicy(enum.Enum):
    """Over-relaxation policies for enhanced sphere tracing (SURVEY.md §2.3.4).

    * ``ROLLBACK_TO_ONE``: w=1.6, on overstep w -> 1.0 (``src/scene.py:61-73``,
      ``cornell_box_v3/pathtracer.py:63-66``).
    * ``ROLLBACK_HALF_UP``: w -> 0.5 + 0.5*w on overstep
      (``examples/scene_demo/tokyo_ibl.py:256``).
    * ``CONSTANT``: no over-relaxation (w fixed), used by the glass bunny with
      w=0.5 (``examples/bunny/bunny_sdf_glass.py:251,258``) and the minimal
      cornell box with w=1.0 (``cornell_box_shortest.py:63-72``).
    """

    ROLLBACK_TO_ONE = "rollback_to_one"
    ROLLBACK_HALF_UP = "rollback_half_up"
    CONSTANT = "constant"


class HitCriterion(enum.Enum):
    """Sphere-tracing hit tests found in the reference (SURVEY.md §2.3.4).

    * ``CONE``: ``distance < t * pixel_radius`` — screen-space proportional
      (``src/scene.py:79``).
    * ``RELATIVE``: ``err = d / t < pixel_radius``
      (``cornell_box_v3/pathtracer.py:68-74``).
    * ``ABSOLUTE``: ``distance < precision`` — fixed epsilon
      (``cornell_box_shortest.py:70``, ``cornell_box.py:220``).
    """

    CONE = "cone"
    RELATIVE = "relative"
    ABSOLUTE = "absolute"


class Roulette(enum.Enum):
    """Russian-roulette flavors (SURVEY.md §2.3.8).

    * ``DEPTH_LINEAR``: survival ``(depth==0 ? 1 : quality) - depth/max_depth``
      (``src/pathtracer.py:65-77``).
    * ``EXP``: continue prob ``1/exp(i/quality)`` (``cornell_box.py:297-303``,
      ``cornell_box_shortest.py:83-85``).
    """

    DEPTH_LINEAR = "depth_linear"
    EXP = "exp"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters; defaults mirror ``src/config.py:7-28``."""

    resolution: Tuple[int, int] = (768, 432)  # (W, H); src/config.py:7

    samples_per_frame: int = 1       # src/config.py:9
    samples_per_pixel: int = 1       # src/config.py:10
    quality_per_sample: float = 0.8  # roulette survival base; src/config.py:11

    black_background: bool = False   # src/config.py:13
    adaptive_sampling: bool = False  # src/config.py:14

    visibility: Tuple[float, float] = (1e-4, 1e4)  # src/config.py:16
    noise_threshold: float = 1e-4    # src/config.py:17

    max_raymarch: int = 512          # src/config.py:25
    max_raytrace: int = 512          # src/config.py:26

    env_ior: float = 1.000277        # src/config.py:28

    # Example-megakernel Fresnel F0 variant (applies only with the example
    # shading, ray_surface_interaction(roughness_fresnel=True)): the
    # cornell/bunny megakernels compute ``F0 = (eta-1)/(eta+1); F0 *= 2*F0``
    # = 2a^2 (cornell_box.py:275, bunny_sdf_glass.py:322) — HALF the
    # src/scene_demo/tokyo value ``(2a)^2`` (src/pbr.py:44-45,
    # scene_demo/main.py:289). Set True in the cornell/bunny model configs.
    f0_half: bool = False

    # March policy (defaults = src/ engine; see enums above for example modes)
    omega: float = 1.6
    omega_policy: OmegaPolicy = OmegaPolicy.ROLLBACK_TO_ONE
    hit_criterion: HitCriterion = HitCriterion.CONE
    hit_precision: float = 1e-4      # only for HitCriterion.ABSOLUTE
    march_t0: float = 0.0            # initial t (v3/examples use MIN_DIS)
    max_dis: float = 1e3             # src/config.py:23

    # March kernel (pallas/march_kernel.py, the GPU march path): rays per
    # program, a power of two (None = the kernel's default); smaller blocks
    # localize divergence (a block exits at ITS max need), larger ones
    # amortize per-program cost.
    march_block: Optional[int] = None

    # Terminate miss lanes as soon as they are outside the scene's bounding
    # sphere and receding, instead of marching all the way to max_dis
    # (src/scene.py:82 bails only at MAX_DIS). Outside the bound of every
    # object and moving away, no hit is possible, and a miss's shading
    # depends only on the ray direction — images are identical; only the
    # (unused) final t/position of miss lanes differ from the reference
    # trace, so this is opt-in and off for the parity oracles. Ignored for
    # scenes containing unbounded objects (PLANE).
    escape_bound: bool = False

    # Next-event estimation against the environment map (no reference analog;
    # the reference's IBL is a plain lookup, src/ibl.py:37-40, so bright sky
    # features — the sun in a sun-lit HDR — converge only by chance BSDF
    # hits). When on, every diffuse bounce draws one direction from the
    # envmap-luminance alias table baked into the Environment
    # (ops/ibl.with_env_sampler), traces a shadow ray, and banks
    # throughput * albedo * cos/(pi*pdf) * L * visibility; the sky lookup at
    # the NEXT segment is zeroed for diffuse-sampled continuations so the two
    # estimators partition the integrand exactly (no MIS weights needed, no
    # double counting — ops/integrator._nee_env). Specular/refracted
    # continuations keep the plain lookup. Off for parity oracles.
    env_sampling: bool = False

    # One-sample balance-heuristic MIS between the env draw and the BSDF
    # draw for the REFLECT lobe (active only under env_sampling; no
    # reference analog). The NEE bank gains a term
    # ``albedo * L * V * P_refl * p_spec / (p_env + P_refl * p_spec)``
    # (one-sample balance heuristic with the 1/p_env cancelled) and a
    # reflect-sampled continuation's sky lookup is weighted by the
    # complementary ``P_refl * p_spec / (p_env + P_refl * p_spec)`` instead
    # of staying unweighted — so glossy surfaces under sparse bright skies
    # converge at env-sampling rates too (the diffuse lobe keeps its exact
    # partition; refracted continuations keep the plain lookup).
    # ``shade.specular_env_density`` inverts the hemispheric->rough-normal->
    # reflect map for the density; MIS weights are stop_gradient'ed (they
    # sum to 1 pointwise, so their derivative terms cancel in expectation —
    # keeps scan-AD and path-replay gradients identical).
    mis_specular: bool = True

    # Budget-capped SPLIT MARCH for the wavefront integrator (no reference
    # analog; the answer to the march divergence tax that reordering and
    # compaction could not give). Each wavefront step marches at most this
    # many trips; a lane that neither hits nor escapes carries its EXACT
    # loop state (FrameState.march_state) and resumes next step, so a deep
    # segment spreads over steps while its block-mates advance their own
    # fresh segments. Per lane the iteration sequence equals one
    # uninterrupted march and consumption is min(residual, budget)
    # independent of block composition — deposits/scheduling are
    # sharding- and checkpoint-invariant (tests/test_split_march.py; on
    # the CPU mesh stand-in the in-flight f32 carry can differ at
    # reassociation level because XLA-CPU forms FMAs differently per
    # shard size — per-lane math is identical). The sampling SCHEDULE
    # changes (a deep segment's shading draws happen at a later step
    # counter), so images differ from the unsplit wavefront in noise
    # realization only — each pixel's estimator is unchanged. The budget of
    # 32 was chosen on earlier hardware; its value on the GPU is not
    # measured yet. Applies to the wavefront integrator only
    # (megakernel/replay keep exact per-bounce scan semantics), and only
    # when the budget divides max_raymarch (see wavefront_step); None = off.
    march_split: Optional[int] = 32

    # Occlusion-only "diet" march for NEE shadow rays (cfg.env_sampling; no
    # reference analog — the reference has no NEE). A binary visibility
    # query needs neither the screen-space cone hit criterion nor the
    # primary march budget: the march only has to decide "does this ray
    # reach the sky". Diet mode marches shadow rays with an ABSOLUTE hit
    # test at half the surface-restart offset (a pass closer than min_dis/2
    # to any surface counts occluded), a reduced iteration budget
    # (auto: min(128, max_raymarch)), and the escape-bound early exit
    # (exact for visibility). Budget-exhausted lanes count visible.
    # tools/bench_nee.py measures its bias and speed.
    shadow_diet: bool = True
    shadow_max_raymarch: Optional[int] = None   # auto: min(128, max_raymarch)
    shadow_hit_precision: Optional[float] = None  # auto: 0.5 * min_dis

    # Path-replay backward (ops/replay.py): checkpoint the forward's march
    # results — (t, hit-index) per bounce, plus the NEE visibility bit under
    # env_sampling — so the backward replay skips re-marching entirely (the
    # march dominates bounce cost; the rest of a bounce is ~4 SDF evals for
    # the normal plus gathers). Memory: ~(8 + env_sampling) bytes *
    # max_raytrace * rays, e.g. 236 MB for the 480x480 cornell at 128
    # bounces. None (default) = auto: on when the buffers fit in 1 GiB.
    replay_march_checkpoint: Optional[bool] = None

    roulette: Roulette = Roulette.DEPTH_LINEAR
    light_quality: float = 128.0     # EXP-roulette divisor; cornell_box.py:31

    tonemap: Tonemap = Tonemap.GAMMA_THEN_ACES
    gamma: float = 2.2               # src/camera.py:117
    clamp_output: bool = True        # src/postprocessor.py:38

    # Precision note: the compute path is float32 (the reference is f32,
    # src/config.py:5). Dtype is a property of the DATA, not the config:
    # make_scene / load_bunny / make_frame_state / make_camera all take a
    # dtype argument (e.g. bf16 bunny weights) and the kernels follow the
    # array dtypes.

    # Low-discrepancy (R2) camera/lens sampling — the reference's ToDo at
    # src/util.py:64. Stratifies sub-pixel jitter and aperture samples per
    # pixel across a per-pixel sample counter: the megakernel's sample index
    # in render_image, the FrameState.respawn counter in the wavefront
    # integrator. Shading draws stay pcg4d (their index is a global step,
    # not a per-pixel sample counter).
    low_discrepancy: bool = False

    # Temporal reprojection on camera motion (the reference's ToDo at
    # src/renderer.py:22, implemented): instead of zeroing the progressive
    # accumulator, forward-warp it into the new view using the per-pixel
    # primary-hit depth (FrameState.hit_t). History is down-weighted by
    # `reproject_confidence` and its sample count clamped to
    # `reproject_history_cap` so stale shading washes out. Single-device
    # render_frame path; pass prev_cam to render_frame.
    reprojection: bool = False
    reproject_confidence: float = 0.5
    reproject_history_cap: float = 64.0

    seed: int = 0

    @property
    def width(self) -> int:
        return self.resolution[0]

    @property
    def height(self) -> int:
        return self.resolution[1]

    @property
    def num_pixels(self) -> int:
        return self.resolution[0] * self.resolution[1]

    @property
    def screen_pixel_size(self) -> Tuple[float, float]:
        # src/config.py:19
        return (1.0 / self.resolution[0], 1.0 / self.resolution[1])

    @property
    def pixel_radius(self) -> float:
        # src/config.py:20 — min screen pixel size
        return min(self.screen_pixel_size)

    @property
    def min_dis(self) -> float:
        # src/config.py:22 — surface restart offset
        return 2.5 * self.pixel_radius

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# The src/ engine default config (index.py entry point).
DEFAULT_CONFIG = RenderConfig()
