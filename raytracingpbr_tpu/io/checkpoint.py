"""Checkpoint / resume for progressive renders.

New component (SURVEY.md §5 "Failure detection"): cluster jobs preempt, so
multi-hour progressive/animation renders persist (framebuffer accumulator,
wavefront ray state, frame counter) and resume *bit-exactly* — possible
because every random draw derives from the (pixel, frame-counter) RNG
counters, never from hidden state (ops/core/rng.py).

Format: a single .npz per checkpoint with the FrameState leaves + metadata,
written atomically (tmp + rename). No orbax dependency — the state is a flat
handful of arrays and np.savez is robust and portable.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Optional, Tuple

import jax
import numpy as np

from ..core.types import FrameState, Rays


def save(path: str, state: FrameState, meta: Optional[dict] = None) -> None:
    """Atomically persist a FrameState (host-gathers sharded leaves)."""
    leaves = {
        "origin": state.rays.origin,
        "direction": state.rays.direction,
        "color": state.rays.color,
        "depth": state.rays.depth,
        "accum": state.accum,
        "frame": state.frame,
        "diff_accum": state.diff_accum,
        "noise": state.noise,
        "pixels": state.pixels,
        "respawn": state.respawn,
        "hit_t": state.hit_t,
        "sky_w": state.sky_w,
        "march_state": state.march_state,
        "march_cum": state.march_cum,
    }
    host = {k: np.asarray(jax.device_get(v)) for k, v in leaves.items()}
    host["_meta"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **host)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str) -> Tuple[FrameState, dict]:
    """Load a checkpoint; returns (state, meta)."""
    with np.load(path) as z:
        rays = Rays(origin=z["origin"], direction=z["direction"],
                    color=z["color"], depth=z["depth"])
        state = FrameState(
            rays=jax.tree.map(lambda x: x, rays),
            accum=z["accum"], frame=z["frame"],
            diff_accum=z["diff_accum"], noise=z["noise"],
            pixels=z["pixels"],
            respawn=(z["respawn"] if "respawn" in z else
                     np.zeros(z["noise"].shape, np.uint32)),
            hit_t=(z["hit_t"] if "hit_t" in z else
                   np.full(z["noise"].shape, 1e10, np.float32)),
            # sky weight (f32; older checkpoints stored the boolean
            # "previous bounce was diffuse" flag — weight = 1 - flag)
            sky_w=(z["sky_w"] if "sky_w" in z else
                   (1.0 - z["nee_flag"].astype(np.float32))
                   if "nee_flag" in z else
                   np.ones(z["noise"].shape, np.float32)),
            # split-march carry (older checkpoints: nothing in flight)
            march_state=(z["march_state"] if "march_state" in z else
                         np.zeros(z["noise"].shape + (4,), np.float32)),
            march_cum=(z["march_cum"] if "march_cum" in z else
                       np.zeros(z["noise"].shape, np.int32)))
        meta = json.loads(bytes(z["_meta"]).decode()) if "_meta" in z else {}
    return jax.tree.map(lambda x: np.asarray(x), state), meta
