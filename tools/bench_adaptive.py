"""Adaptive-sampling payoff on one NVIDIA GPU (reference feature,
src/config.py:14): the per-pixel noise estimate gates wavefront work
(ops/integrator wavefront_step(active=...) -> the march kernel's per-block
early exit skips converged blocks). Measures frames/s before and after
convergence kicks in on the cornell full-PBR workload."""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import time

import jax
import jax.numpy as jnp

from raytracingpbr_tpu.utils.compile_cache import enable_compile_cache
from raytracingpbr_tpu.utils.device import nvidia_smi_name_power, require_gpu

print(require_gpu(), nvidia_smi_name_power(), flush=True)
enable_compile_cache()

from raytracingpbr_tpu.core.types import make_frame_state
from raytracingpbr_tpu.models import cornell
from raytracingpbr_tpu.ops import integrator as integ

scene = cornell.full_scene()
cam = cornell.full_camera()
env = cornell.sky()

for adaptive in (False, True):
    cfg = cornell.full_config().replace(
        samples_per_frame=4, quality_per_sample=0.8,
        adaptive_sampling=adaptive, noise_threshold=1e-2)
    st = make_frame_state(cfg.num_pixels)
    frame = jax.jit(lambda s: integ.render_frame(scene, env, cam, s, cfg))
    px, st = frame(st)
    jax.block_until_ready(px)

    def timed(n):
        global st, px
        t0 = time.perf_counter()
        for _ in range(n):
            px, st = frame(st)
        jax.block_until_ready(px)
        return (time.perf_counter() - t0) / n

    early = timed(10)          # noisy: every pixel active
    for _ in range(120):       # let the noise metric converge pixels
        px, st = frame(st)
    jax.block_until_ready(px)
    late = timed(10)
    act = float((st.noise > cfg.noise_threshold).mean())
    print(f"adaptive={adaptive}: early {early*1e3:.1f} ms/frame, "
          f"late {late*1e3:.1f} ms/frame ({act*100:.0f}% pixels active)",
          flush=True)

    if adaptive:
        # frame-granularity compaction (ops/compact.py): same converged
        # state, actives packed to the front so inactive tiles are dense
        from raytracingpbr_tpu.ops import compact as compactlib
        pid = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
        stc, pid = compactlib.compact_frame_state(st, pid,
                                                  cfg.noise_threshold)
        tile = jax.jit(lambda s, p: integ.render_frame_tile(
            scene, env, cam, s, cfg, p))
        px2, stc = tile(stc, pid)
        jax.block_until_ready(px2)
        t0 = time.perf_counter()
        for _ in range(10):
            px2, stc = tile(stc, pid)
        jax.block_until_ready(px2)
        late_c = (time.perf_counter() - t0) / 10
        t0 = time.perf_counter()
        stc, pid = compactlib.compact_frame_state(stc, pid,
                                                  cfg.noise_threshold)
        jax.block_until_ready(pid)
        tcomp = time.perf_counter() - t0
        print(f"  compacted: late {late_c*1e3:.1f} ms/frame "
              f"(recompaction itself {tcomp*1e3:.1f} ms)", flush=True)
