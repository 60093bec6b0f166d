"""Generate the self-golden PNGs gated by tests/test_parity.py.

Run on CPU (the platform the test suite uses) so goldens and test renders
share numerics:

    JAX_PLATFORMS=cpu python tools/make_goldens.py [family ...]

Writes assets/goldens/<name>.png (+ wavefront_<name>.png for the wavefront
families). Re-run ONLY when an intentional rendering change lands; the diff
of the regenerated goldens is the review artifact for that change.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import jax

# goldens MUST be rendered on the platform the test suite uses (CPU)
if jax.devices()[0].platform != "cpu":
    raise SystemExit("render goldens on the CPU: JAX_PLATFORMS=cpu")

from golden_specs import (GOLDENS, WAVEFRONT_GOLDENS, render_golden,
                          render_wavefront_golden)  # noqa: E402

from raytracingpbr_tpu.io import image as imageio  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "assets", "goldens")


def main(argv):
    names = argv or list(GOLDENS)
    os.makedirs(OUT, exist_ok=True)
    for name in names:
        t0 = time.time()
        img = render_golden(name)
        imageio.write_png(os.path.join(OUT, f"{name}.png"), img)
        print(f"{name}: {time.time()-t0:.1f}s", flush=True)
        if name in WAVEFRONT_GOLDENS:
            t0 = time.time()
            img = render_wavefront_golden(name)
            imageio.write_png(os.path.join(OUT, f"wavefront_{name}.png"), img)
            print(f"wavefront_{name}: {time.time()-t0:.1f}s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
