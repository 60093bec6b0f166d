"""Headless interactive renderer: the reference live app's control protocol
(``src/main.py:24-68``) driven by a text command stream instead of a GUI
window (accelerator hosts are headless, SURVEY.md §7.1).

Protocol (one command per line on stdin, or scripted via ``run_commands``):
    w/a/s/d     move camera (fly-cam, damped like SmoothCamera)
    arrows as   u(p)/n(down)/l(eft)/r(ight): rotate view (gimbal-clamped)
    z+ / z-     vfov up/down       (src/main.py:33-37)
    x+ / x-     aperture up/down   (:38-41)
    c+ / c-     focus up/down      (:42-45)
    v+ / v-     exposure up/down   (:46-49)
    g           save a PNG screenshot (:53-56)
    q           quit

Each command advances the damped camera and renders one progressive frame;
camera motion triggers the accumulation refresh exactly like the reference
(``src/renderer.py:26-27``).
"""
from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import make_camera, make_frame_state
from ..io import image as imageio
from ..ops import camera as cameralib
from ..ops import integrator as integ


class InteractiveSession:
    def __init__(self, scene, env, cfg, out_dir: str = "out/interactive",
                 position=(0.0, -0.2, 4.0), lookat=(0.0, -0.2, 3.0),
                 dt: float = 1.0 / 30.0):
        self.scene, self.env, self.cfg = scene, env, cfg
        self.out_dir = out_dir
        self.dt = dt
        self.vfov, self.aperture, self.focus, self.exposure = \
            35.0, 0.01, 4.0, 1.0  # src/camera.py:119-129 defaults
        self.target_pos = np.asarray(position, np.float32)
        self.target_look = np.asarray(lookat, np.float32)
        self.smooth = cameralib.make_smooth_camera(position, lookat)
        self.state = make_frame_state(cfg.num_pixels)
        self._frame_fn = jax.jit(
            lambda cam, st, refreshing, exposure: integ.render_frame(
                self.scene, self.env, cam, st, self.cfg,
                refreshing=refreshing, exposure=exposure))
        # reprojection path (cfg.reprojection): refresh = warp history into
        # the new view instead of zeroing (ops/reproject.py)
        self._frame_reproj_fn = jax.jit(
            lambda cam, prev, st, exposure: integ.render_frame(
                self.scene, self.env, cam, st, self.cfg,
                refreshing=True, exposure=exposure, prev_cam=prev))
        self._prev_cam = None
        self.frames = 0

    def _camera(self):
        return make_camera(
            lookfrom=np.asarray(self.smooth.position),
            lookat=np.asarray(self.smooth.lookat),
            vfov=self.vfov, aspect=self.cfg.width / self.cfg.height,
            aperture=self.aperture, focus=self.focus)

    def handle(self, cmd: str) -> bool:
        """Apply one command; returns False on quit."""
        cmd = cmd.strip()
        refreshing = False
        speed = 5.0 * self.dt  # src/main.py:58 movement_speed
        front = self.target_look - self.target_pos
        front = front / (np.linalg.norm(front) + 1e-9)
        right = np.cross(front, [0.0, 1.0, 0.0])
        if cmd == "q":
            return False
        elif cmd == "w":
            self.target_pos += speed * front
            self.target_look += speed * front
        elif cmd == "s":
            self.target_pos -= speed * front
            self.target_look -= speed * front
        elif cmd == "a":
            self.target_pos -= speed * right
            self.target_look -= speed * right
        elif cmd == "d":
            self.target_pos += speed * right
            self.target_look += speed * right
        elif cmd in ("l", "r", "u", "n"):
            dyaw = {"l": -1.0, "r": 1.0}.get(cmd, 0.0) * self.dt
            dpitch = {"u": 1.0, "n": -1.0}.get(cmd, 0.0) * self.dt
            new_look = cameralib.fly_rotate(
                jnp.asarray(self.target_pos), jnp.asarray(self.target_look),
                dyaw, dpitch)
            self.target_look = np.asarray(new_look)
        elif cmd in ("z+", "z-"):
            self.vfov += (10 * self.dt) * (1 if cmd == "z+" else -1)
            refreshing = True   # src/main.py:33-37
        elif cmd in ("x+", "x-"):
            self.aperture += self.dt * (1 if cmd == "x+" else -1)
            refreshing = True
        elif cmd in ("c+", "c-"):
            self.focus += self.dt * (1 if cmd == "c+" else -1)
            refreshing = True
        elif cmd in ("v+", "v-"):
            self.exposure += self.dt * (1 if cmd == "v+" else -1)
            # exposure does NOT refresh (src/main.py:46-49)
        elif cmd == "g":
            self.screenshot()
        self.step(refreshing)
        return True

    def step(self, refreshing: bool = False):
        self.smooth = cameralib.smooth_update(
            self.smooth, self.dt, jnp.asarray(self.target_pos),
            jnp.asarray(self.target_look), jnp.asarray([0.0, 1.0, 0.0]))
        moving = bool(self.smooth.moving)
        cam = self._camera()
        exp = jnp.asarray(self.exposure, jnp.float32)
        if ((refreshing or moving) and self.cfg.reprojection
                and self._prev_cam is not None):
            self.pixels, self.state = self._frame_reproj_fn(
                cam, self._prev_cam, self.state, exp)
        else:
            self.pixels, self.state = self._frame_fn(
                cam, self.state, refreshing or moving, exp)
        self._prev_cam = cam
        self.frames += 1

    def screenshot(self, path: str | None = None):
        os.makedirs(self.out_dir, exist_ok=True)
        img = np.asarray(self.pixels).reshape(
            self.cfg.width, self.cfg.height, 3).transpose(1, 0, 2)[::-1]
        path = path or os.path.join(self.out_dir,
                                    f"shot_{self.frames:05d}.png")
        imageio.write_png(path, img)
        return path

    def run_commands(self, commands):
        for c in commands:
            if not self.handle(c):
                break


def main(argv=None):
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import argparse

    from ..models import demo
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scale", type=int, default=1,
                   help="resolution divisor vs the engine default")
    p.add_argument("--reproject", action="store_true",
                   help="warp accumulation on camera motion instead of "
                        "resetting it (temporal reprojection)")
    args = p.parse_args(argv)
    cfg = demo.engine_config()
    if args.scale > 1:
        cfg = cfg.replace(resolution=(cfg.width // args.scale,
                                      cfg.height // args.scale))
    if args.reproject:
        cfg = cfg.replace(reprojection=True)
    sess = InteractiveSession(demo.engine_scene(), demo.engine_environment(),
                              cfg)
    sess.step()
    print("interactive session ready; commands: w/a/s/d l/r/u/n z+ z- x+ "
          "x- c+ c- v+ v- g q", flush=True)
    for line in sys.stdin:
        if not sess.handle(line):
            break
        print(f"frame {sess.frames} spp~{float(np.asarray(sess.state.accum)[:, 3].mean()):.1f}",
              flush=True)


if __name__ == "__main__":
    main()
