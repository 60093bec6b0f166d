"""Device-mesh helpers.

New component with no reference analog (SURVEY.md §2.4): the reference is a
single-GPU app; this build scales its one parallelism axis — per-pixel
data parallelism — across the cards of a host (or several hosts), plus a
sample axis for spp batches. The cards of a host reach each other all to
all over NVLink at one rate, so the mesh shape follows the algorithm alone;
XLA hands the collectives to NCCL, and across hosts the same SPMD program
runs on every host after ``jax.distributed.initialize``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

# Canonical axis names for the renderer:
#   "tiles"   — pixel-tile data parallelism (the hot axis; zero communication
#               in the forward render, SURVEY.md §5 "Distributed")
#   "samples" — samples-per-pixel batch parallelism (accumulator psum)
TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None,
              tiles: Optional[int] = None,
              samples: int = 1) -> Mesh:
    """Build a (tiles, samples) mesh over the available devices.

    Defaults put every device on the tile axis — the forward render needs no
    inter-chip traffic, so more tile shards = linear scaling until tiles get
    too small to fill a chip.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if tiles is None:
        assert n % samples == 0, (n, samples)
        tiles = n // samples
    assert tiles * samples == n, (tiles, samples, n)
    arr = np.asarray(devices).reshape(tiles, samples)
    return Mesh(arr, (TILE_AXIS, SAMPLE_AXIS))


def multihost_init(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Initialize the multi-host runtime (no-op on a single process).

    On a multi-host cluster each host runs this same program;
    ``jax.distributed.initialize`` wires the coordination layer and
    ``jax.devices()`` then spans every host's cards (SURVEY.md §2.4
    "Multi-host runtime").

    Call BEFORE creating any device value (jax requires distributed init
    before the XLA backend initializes; package import is deliberately
    backend-init-free so this import itself is safe). End-to-end 2-process
    proof: ``tools/multihost_demo.py`` (bit-identical to single-process)."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address, num_processes,
                                   process_id)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
