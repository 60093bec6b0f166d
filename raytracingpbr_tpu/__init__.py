"""raytracingpbr_tpu — a differentiable SDF path tracer in JAX for NVIDIA GPUs.

Brand-new framework with the capabilities of HK-SHAO/RayTracingPBR,
re-designed for XLA: struct-of-arrays scenes, wavefront ``lax.scan``
integration, counter-based shard-invariant RNG, implicit-function march
gradients, ``shard_map`` ray-tile parallelism and a Pallas kernel for the
hot march loop. See SURVEY.md for the
layer map this build follows.
"""

from .config import (DEFAULT_CONFIG, HitCriterion, OmegaPolicy, RenderConfig,
                     Roulette, Tonemap)
from .core.types import (Camera, FrameState, Rays, make_camera,
                         make_frame_state, make_rays, refresh)
from .ops.ibl import (Environment, black_sky, constant_sky, gradient_sky,
                      hdr_environment, white_sky)
from .ops.integrator import (megakernel_trace, render_frame, render_image,
                             render_image_progressive, wavefront_step)
from .ops.march import march
from .ops.scene import ObjectSpec, Scene, make_scene
from .ops.sdf import SHAPE

__version__ = "0.1.0"
