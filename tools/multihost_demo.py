"""Two-process multi-host rendering demo (CPU processes, no cluster needed).

Proves the DCN/multi-host path end-to-end on one machine: each process is a
"host" with 4 virtual CPU devices, `jax.distributed.initialize` wires the
coordination layer (parallel/mesh.multihost_init), the tile axis spans both
processes, and each process renders ONLY its pixel shard. Process 0 gathers
the final image (the forward path's only cross-host communication,
SURVEY.md §5 "Distributed") and asserts it is bit-identical to a
single-process render — the counter-RNG shard-invariance guarantee.

Run:  python tools/multihost_demo.py
(It re-executes itself as two worker processes.)
"""
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TMP = tempfile.gettempdir()
if REPO not in sys.path:
    sys.path.insert(0, REPO)
PORT = 12357
NPROC = 2
DEV_PER_PROC = 4


def worker(pid: int) -> None:
    sys.path.insert(0, REPO)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={DEV_PER_PROC}").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    # multihost_init MUST come before any device value is created (package
    # import is deliberately backend-init-free to make this possible)
    from raytracingpbr_tpu.parallel.mesh import TILE_AXIS, multihost_init
    multihost_init(f"127.0.0.1:{PORT}", NPROC, pid)

    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from raytracingpbr_tpu.models import cornell
    from raytracingpbr_tpu.parallel import render as prender
    assert jax.process_count() == NPROC
    assert len(jax.devices()) == NPROC * DEV_PER_PROC

    scene = cornell.minimal_scene()
    cfg = cornell.minimal_config().replace(resolution=(32, 32),
                                           max_raymarch=96, max_raytrace=6)
    cam, env = cornell.minimal_camera(), cornell.sky()

    # tile axis spans both processes (first mesh dim varies slowest across
    # the global device list, so devices 0-3 = host 0, 4-7 = host 1)
    mesh = Mesh(np.array(jax.devices()).reshape(NPROC * DEV_PER_PROC, 1),
                (TILE_AXIS, "samples"))
    img = prender.render_image_sharded(scene, env, cam, cfg, mesh, spp=2,
                                       tonemapped=False)
    # cross-host gather (compiled all-gather over the tile axis): the ONE
    # cross-host data movement of the forward path — save/display time only
    gather = jax.jit(lambda x: x,
                     out_shardings=NamedSharding(mesh, P(None, None, None)))
    local = np.asarray(gather(img))

    if pid == 0:
        np.save(os.path.join(TMP, "multihost_img.npy"), local)
        print(f"[host {pid}] rendered {local.shape}, mean {local.mean():.5f}",
              flush=True)
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices("done")


def main() -> None:
    if "--worker" in sys.argv:
        worker(int(sys.argv[sys.argv.index("--worker") + 1]))
        return

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"  # the workers are CPU-only
    logs = [open(os.path.join(TMP, f"multihost_worker{i}.log"), "w")
            for i in range(NPROC)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(i)],
        env=env, stdout=logs[i], stderr=subprocess.STDOUT)
        for i in range(NPROC)]
    rcs = [p.wait(timeout=600) for p in procs]
    for f in logs:
        f.close()
    if rcs != [0] * NPROC:
        for i in range(NPROC):
            print(f"--- worker {i} log tail ---")
            print("\n".join(open(os.path.join(TMP, f"multihost_worker{i}.log"))
                            .read().splitlines()[-15:]))
        raise SystemExit(f"worker rcs: {rcs}")

    # single-process reference with the same global device count
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from jax.sharding import Mesh

    from raytracingpbr_tpu.models import cornell
    from raytracingpbr_tpu.parallel import render as prender
    from raytracingpbr_tpu.parallel.mesh import TILE_AXIS

    scene = cornell.minimal_scene()
    cfg = cornell.minimal_config().replace(resolution=(32, 32),
                                           max_raymarch=96, max_raytrace=6)
    cam, envr = cornell.minimal_camera(), cornell.sky()
    mesh = Mesh(np.array(jax.devices()).reshape(8, 1),
                (TILE_AXIS, "samples"))
    ref = np.asarray(prender.render_image_sharded(
        scene, envr, cam, cfg, mesh, spp=2, tonemapped=False))
    got = np.load(os.path.join(TMP, "multihost_img.npy"))
    np.testing.assert_array_equal(got, ref)
    print("MULTIHOST OK: 2-process render bit-identical to single-process",
          flush=True)


if __name__ == "__main__":
    main()
