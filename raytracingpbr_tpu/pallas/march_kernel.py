"""Pallas kernel (Triton route, NVIDIA GPUs): fused enhanced sphere tracing.

The XLA march (``ops/march.py``) advances the whole flat ray batch in
lock-step, so one straggler ray keeps every lane marching — batch-global
divergence — and every trip re-reads and re-writes the full ray state in
device memory. This kernel restores divergence *locality* (SURVEY.md §7.4.1,
§7.2.10): one program per flat block of ``BLOCK`` rays runs its own march
loop with its state in registers, and exits as soon as *its* rays are done.

Scene representation: the same static-type-bucket idea as
``ops/scene.all_distances`` — the object loop is unrolled in Python at trace
time over a packed (n_obj, 32) parameter block passed whole:
``[position(3), scale(3), rotation matrix rows(9), local offset(3), ...]``.
Shape types come from the static scene metadata; each object's parameters
are read as scalars once, before the loop. All math is elementwise on (BLOCK,)
vectors; the one cross-lane operations are the block-wide done test and the
bunny support guard.

The march semantics mirror ``ops/march.py`` exactly (same omega policies and
hit criteria, reference ``src/scene.py:59-84``); parity is asserted in
tests/test_pallas.py in interpret mode and in tests/test_gpu.py and
chip_smoke.py on the card.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..config import HitCriterion, OmegaPolicy, RenderConfig
from ..ops.scene import Scene
from ..ops.sdf import SHAPE

# Rays per program (a power of two, as Triton requires), one per thread:
# one warp per block measured fastest on the H100 (PERF.md).
DEFAULT_BLOCK = 32


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _pad_rows_pow2(x: jax.Array) -> jax.Array:
    pad = _next_pow2(x.shape[0]) - x.shape[0]
    return jnp.pad(x, ((0, pad), (0, 0))) if pad else x


def pack_scene(scene: Scene, escape_bound: bool = False) -> jax.Array:
    """Pack per-object transform params into an (n, 32) f32 block:
    [pos(3), scale(3), mat row-major (9), local_offset(3),
    bound^2 or 0 (1), pad(13)]. Column 18 carries the squared scene
    bounding radius when the escape-bound early exit is on (0 = disabled)."""
    n = scene.num_objects
    mat = scene.matrix.reshape(n, 9)
    bound = None
    if escape_bound:
        from ..ops.scene import bounding_radius
        bound = bounding_radius(scene)
    b2 = (jnp.zeros((n, 1), scene.position.dtype) if bound is None
          else jnp.full((n, 1), 1.0, scene.position.dtype) * (bound * bound))
    pad = jnp.zeros((n, 13), scene.position.dtype)
    return jnp.concatenate(
        [scene.position, scene.scale, mat, scene.local_offset, b2, pad],
        axis=-1)


def pack_bunny(scene: Scene) -> jax.Array:
    """Pack the bunny MLP weights into a (40, 16) f32 block for static
    in-kernel indexing: rows 0-2 w_in, 3 b_in, 4-19 w_h1, 20 b_h1,
    21-36 w_h2, 37 b_h2, 38 w_out, 39 [bias_out, 0...]."""
    b = scene.bunny
    last = jnp.zeros((1, 16), b.w_in.dtype).at[0, 0].set(b.bias_out)
    return jnp.concatenate([
        b.w_in, b.b_in[None], b.w_h1, b.b_h1[None], b.w_h2, b.b_h2[None],
        b.w_out[None], last], axis=0)


def _bunny_block(w, px, py, pz):
    """Sin-MLP bunny SDF on a block of points — the two 16-wide hidden
    layers unrolled as FMA chains on scalar weights ``w[row][col]`` (a 16x16
    layer is far below a tensor-core tile, and TF32 would break the SDF).
    Math identical to ops/sdf.bunny_mlp_eval (bunny_sdf_glass.py:150-203).
    """
    f0 = [jnp.sin(px * w[0][k] + py * w[1][k] + pz * w[2][k] + w[3][k])
          for k in range(16)]
    f1 = []
    for k in range(16):
        acc = f0[0] * w[4][k]
        for j in range(1, 16):
            acc = acc + f0[j] * w[4 + j][k]
        f1.append(jnp.sin(acc + w[20][k]) + f0[k])
    f2 = []
    for k in range(16):
        acc = f1[0] * w[21][k]
        for j in range(1, 16):
            acc = acc + f1[j] * w[21 + j][k]
        f2.append(jnp.sin(acc + w[37][k]) * (1.0 / 1.4) + f1[k])
    sd = f2[0] * w[38][0]
    for k in range(1, 16):
        sd = sd + f2[k] * w[38][k]
    sd = sd + w[39][0]
    r = jnp.sqrt(px * px + py * py + pz * pz)
    return jnp.where(r > 1.0, r - 0.8, sd)


def _sd_block(type_id: int, px, py, pz, sx, sy, sz, box_round: float):
    """Distance of one object type for a block of local points.

    Same formulas as ops/sdf.py (iquilezles), expressed on unpacked
    coordinates (scalars sx/sy/sz are this object's scale components).
    """
    t = SHAPE(type_id)
    if t == SHAPE.SPHERE:
        return jnp.sqrt(px * px + py * py + pz * pz) - sx
    if t == SHAPE.BOX:
        qx = jnp.abs(px) - sx
        qy = jnp.abs(py) - sy
        qz = jnp.abs(pz) - sz
        ox = jnp.maximum(qx, 0.0)
        oy = jnp.maximum(qy, 0.0)
        oz = jnp.maximum(qz, 0.0)
        outside = jnp.sqrt(ox * ox + oy * oy + oz * oz)
        inside = jnp.minimum(jnp.maximum(qx, jnp.maximum(qy, qz)), 0.0)
        return outside + inside - box_round
    if t == SHAPE.CYLINDER:
        dx = jnp.abs(jnp.sqrt(px * px + pz * pz)) - sx
        dy = jnp.abs(py) - sy
        mx = jnp.maximum(dx, 0.0)
        my = jnp.maximum(dy, 0.0)
        return (jnp.minimum(jnp.maximum(dx, dy), 0.0)
                + jnp.sqrt(mx * mx + my * my))
    if t == SHAPE.CONE:
        q = jnp.sqrt(px * px + pz * pz)
        return jnp.maximum(sx * q + sz * py, -sy - py)
    if t == SHAPE.PLANE:
        return py - sy
    # SHAPE.NONE
    return jnp.full_like(px, 1e3)


# Scale columns each shape's distance function reads (pack_scene layout).
_SCALE_COLS = {SHAPE.SPHERE: (3,), SHAPE.BOX: (3, 4, 5),
               SHAPE.CYLINDER: (3, 4), SHAPE.CONE: (3, 4, 5),
               SHAPE.PLANE: (4,), SHAPE.BUNNY: (), SHAPE.NONE: ()}


def _load_object_params(params_ref, scene_types, rot_perm):
    """Per-object scalar parameters, read once before the march loop: the
    translation, animation offset and the scale components the shape uses,
    plus the rotation rows only for objects that are not a signed axis
    permutation."""
    out = []
    for i, t in enumerate(scene_types):
        cols = [0, 1, 2, 15, 16, 17, *_SCALE_COLS[SHAPE(t)]]
        if rot_perm is None or rot_perm[i] is None:
            cols += list(range(6, 15))
        out.append({k: params_ref[i, k] for k in cols})
    return out


def _nearest_block(scene_types, obj_params, x, y, z, box_round,
                   bunny_w=None, rot_perm=None):
    """Unrolled min over |sd_i| for a block of world points. Returns
    (min_dis, index).

    ``rot_perm``: static per-object signed-permutation classification
    (Scene.rot_perm) — identity and 90-degree rotations (most objects in
    every reference scene) skip the 9-mul row matmuls."""
    best = jnp.full_like(x, 1e3)
    idx = jnp.zeros_like(x, dtype=jnp.int32)
    for i, t in enumerate(scene_types):
        pr = obj_params[i]
        # object space: translate, rotate, then animation offset
        # (src/sdf.py:64-68 + ops/scene._local)
        tx = x - pr[0]
        ty = y - pr[1]
        tz = z - pr[2]
        perm = rot_perm[i] if rot_perm is not None else None
        if perm is not None:
            tv = (tx, ty, tz)
            (p0, p1, p2), (s0, s1, s2) = perm
            px = (tv[p0] if s0 > 0 else -tv[p0]) + pr[15]
            py = (tv[p1] if s1 > 0 else -tv[p1]) + pr[16]
            pz = (tv[p2] if s2 > 0 else -tv[p2]) + pr[17]
        else:
            px = pr[6] * tx + pr[7] * ty + pr[8] * tz + pr[15]
            py = pr[9] * tx + pr[10] * ty + pr[11] * tz + pr[16]
            pz = pr[12] * tx + pr[13] * ty + pr[14] * tz + pr[17]
        if t == SHAPE.BUNNY:
            # Block-level support guard: the sin-MLP is only valid (and only
            # needed) inside the unit sphere; outside, sd_bunny falls back to
            # the analytic ``r - 0.8`` (bunny_sdf_glass.py:151-155). The MLP
            # is by far the most expensive SDF and a bunny covers a small
            # screen fraction, so most blocks have no lane inside the support
            # during most iterations. One block-wide min + lax.cond skips the
            # MLP for the whole block then (lanes are pixel-coherent).
            r2 = px * px + py * py + pz * pz
            d = jax.lax.cond(
                jnp.min(r2) <= 1.0,  # <= : at r == 1 _bunny_block uses the MLP
                lambda: jnp.abs(_bunny_block(bunny_w, px, py, pz)),
                lambda: jnp.sqrt(r2) - 0.8)  # r > 1 everywhere -> positive
        else:
            d = jnp.abs(_sd_block(t, px, py, pz, pr.get(3), pr.get(4),
                                  pr.get(5), box_round))
        take = d < best
        idx = jnp.where(take, i, idx)
        best = jnp.where(take, d, best)
    return best, idx


def resolve_block(cfg: RenderConfig) -> int:
    """Rays per program (``cfg.march_block``; a power of two)."""
    block = cfg.march_block or DEFAULT_BLOCK
    if block < 1 or block & (block - 1):
        raise ValueError(f"march_block={block} must be a power of two")
    return block


def _march_kernel(params_ref, *refs, scene_types: Tuple[int, ...], cfg,
                  box_round: float, has_bunny: bool, has_active: bool,
                  rot_perm: Tuple = None, has_bound: bool = False,
                  has_init: bool = False, n_valid: int = 0):
    refs = list(refs)
    bunny_ref = refs.pop(0) if has_bunny else None
    act_ref = refs.pop(0) if has_active else None
    init_refs = [refs.pop(0) for _ in range(4)] if has_init else None
    (ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
     t_ref, idx_ref, hit_ref, iters_ref,
     wout_ref, sout_ref, dout_ref, done_ref) = refs
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]

    # Every scalar the loop reads is loaded once, before it.
    obj_params = _load_object_params(params_ref, scene_types, rot_perm)
    bunny_w = ([[bunny_ref[r, c] for c in range(16)] for r in range(40)]
               if has_bunny else None)

    bound2 = params_ref[0, 18] if has_bound else None
    pixel_radius = cfg.pixel_radius
    w0 = cfg.omega
    rollback_allowed = cfg.omega_policy != OmegaPolicy.CONSTANT

    # Masks live in the loop carry as int32 (0/1).
    def cond(st):
        i, t, w, s, d, idx, hit, done, fin = st
        return (i < cfg.max_raymarch) & (jnp.min(done) < 1)

    def body(st):
        i, t, w, s, d, idx, hit, done, fin = st
        x = ox + t * dx
        y = oy + t * dy
        z = oz + t * dz
        dist, index = _nearest_block(scene_types, obj_params, x, y, z,
                                     box_round, bunny_w, rot_perm)
        ld = d

        if not rollback_allowed:
            rollback = jnp.zeros_like(t) > 1.0
            w_next = w
        else:
            # relative epsilon: exact bound-touching (ld + dist == s) must
            # roll back or the ray tunnels — see ops/march.py body()
            rollback = ld + dist < s * (1.0 + 1e-6)
            if cfg.omega_policy == OmegaPolicy.ROLLBACK_TO_ONE:
                rollback = rollback & (w > 1.0)
                w_next = jnp.where(rollback, 1.0, w)
            else:
                w_next = jnp.where(rollback, 0.5 + 0.5 * w, w)

        s_rb = s * (1.0 - w)
        s_fwd = w_next * dist

        if cfg.hit_criterion == HitCriterion.CONE:
            hit_now = dist < (t + s_fwd) * pixel_radius
        elif cfg.hit_criterion == HitCriterion.RELATIVE:
            hit_now = dist / jnp.maximum(t, 1e-12) < pixel_radius
        else:
            hit_now = dist < cfg.hit_precision

        active = done < 1
        upd = active & (~rollback)
        step = jnp.where(rollback, s_rb, s_fwd)
        t_new = jnp.where(active, t + step, t)
        hit_new = jnp.where(upd, hit_now.astype(jnp.int32), hit)
        escaped = t_new >= cfg.max_dis
        if bound2 is not None:
            # outside the scene bounding sphere and receding -> no hit ahead
            escaped = escaped | ((x * x + y * y + z * z > bound2)
                                 & (x * dx + y * dy + z * dz > 0.0))
        done_new = jnp.maximum(
            done, (upd & (hit_now | escaped)).astype(jnp.int32))
        # each lane's convergence iteration (1-based count of body
        # evaluations it actually needed; see march_pallas)
        fin = jnp.where((done < 1) & (done_new > 0), i + 1, fin)
        return (i + 1,
                t_new,
                jnp.where(active, w_next, w),
                jnp.where(active, step, s),
                jnp.where(active, dist, d),
                jnp.where(active, index, idx),
                hit_new,
                done_new,
                fin)

    shape = ox.shape
    zero_i = jnp.zeros(shape, jnp.int32)
    f = lambda v: jnp.full(shape, v, ox.dtype)
    # inactive and padding lanes start done: an all-inactive block exits
    # before its first nearest() evaluation (adaptive-sampling gate, dead
    # megakernel lanes)
    done0 = (1 - act_ref[...]) if has_active else zero_i
    if n_valid % shape[0]:
        lane = (pl.program_id(0) * shape[0]
                + jax.lax.iota(jnp.int32, shape[0]))
        done0 = jnp.where(lane < n_valid, done0, 1)
    fin0 = (1 - done0) * jnp.int32(cfg.max_raymarch)
    if has_init:
        # resumption (split march): carry the loop state of a prior
        # budget-limited run — per lane, the iteration sequence is identical
        # to one uninterrupted march
        t0v, w0v, s0v, d0v = (r[...] for r in init_refs)
    else:
        t0v, w0v, s0v, d0v = f(cfg.march_t0), f(w0), f(0.0), f(1e3)
    st = jax.lax.while_loop(cond, body, (
        jnp.int32(0),
        t0v,
        w0v,
        s0v,
        d0v,
        zero_i,
        zero_i,
        done0,
        fin0,
    ))
    _, t, w, s, d, idx, hit, done, fin = st
    t_ref[...] = t
    idx_ref[...] = idx
    hit_ref[...] = hit
    iters_ref[...] = fin
    wout_ref[...] = w
    sout_ref[...] = s
    dout_ref[...] = d
    done_ref[...] = done


def _pad_to_block(x: jax.Array, block: int) -> jax.Array:
    pad = (-x.shape[0]) % block
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
    return x


@functools.partial(jax.jit, static_argnames=("scene_types", "box_round",
                                             "cfg", "rot_perm", "has_bound"))
def _march_pallas_impl(params, bunny, origin, direction, active, scene_types,
                       box_round, cfg: RenderConfig, rot_perm=None,
                       has_bound=False, init=None):
    block = resolve_block(cfg)
    n = origin.shape[0]
    o_pad = _pad_to_block(origin, block)
    d_pad = _pad_to_block(direction, block)
    num = o_pad.shape[0]
    rays = [o_pad[:, k] for k in range(3)] + [d_pad[:, k] for k in range(3)]

    has_bunny = bunny is not None
    has_init = init is not None
    has_active = active is not None
    kernel = functools.partial(_march_kernel, scene_types=scene_types,
                               cfg=cfg, box_round=box_round,
                               has_bunny=has_bunny, has_active=has_active,
                               rot_perm=rot_perm, has_bound=has_bound,
                               has_init=has_init, n_valid=n)

    whole = [_pad_rows_pow2(params)]
    if has_bunny:
        whole.append(_pad_rows_pow2(bunny))
    lanes = []
    if has_active:
        lanes.append(_pad_to_block(active.astype(jnp.int32), block))
    if has_init:
        # (t, w, s, d) resumed loop state, (n,) f32 each
        lanes += [_pad_to_block(v, block) for v in init]
    lanes += rays

    lane_spec = pl.BlockSpec((block,), lambda i: (i,))
    whole_specs = [pl.BlockSpec(a.shape, lambda i: (0, 0)) for a in whole]
    f32 = jnp.float32
    i32 = jnp.int32
    outs = pl.pallas_call(
        kernel,
        grid=(num // block,),
        in_specs=whole_specs + [lane_spec] * len(lanes),
        out_specs=[lane_spec] * 8,
        out_shape=[jax.ShapeDtypeStruct((num,), dt)
                   for dt in (f32, i32, i32, i32, f32, f32, f32, i32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=max(1, min(block // 32, 8)), num_stages=1),
        name="sphere_march",
    )(*whole, *lanes)

    t, idx, hit, iters, w, s, d, done = (v[:n] for v in outs)
    return t, idx, hit.astype(bool), iters, w, s, d, done


def march_kernel_state(scene: Scene, origin: jax.Array, direction: jax.Array,
                       cfg: RenderConfig, active=None, init=None):
    """Run the kernel; returns the full per-lane loop state
    ``(t, index, hit, lane_iters, w, s, d, done)``."""
    has_bound = cfg.escape_bound and SHAPE.PLANE not in scene.shape_types
    params = pack_scene(scene, escape_bound=has_bound)
    bunny = pack_bunny(scene) if scene.bunny is not None else None
    return _march_pallas_impl(params, bunny, origin, direction, active,
                              tuple(scene.shape_types),
                              float(scene.box_round), cfg,
                              rot_perm=tuple(scene.rot_perm),
                              has_bound=has_bound, init=init)


def march_pallas(scene: Scene, origin: jax.Array, direction: jax.Array,
                 cfg: RenderConfig, active=None):
    """Fused-march entry: returns ``(t, index, hit, lane_iters)`` — the
    first three match ``ops.march._march_loop``; ``lane_iters`` is the (N,)
    per-lane convergence iteration (how many body evaluations each lane
    actually needed; ``max_raymarch`` if it never converged, 0 if gated
    inactive). Each block executes ``max(lane_iters in block)`` iterations
    in lock-step.
    ``active``: optional (N,) bool lane gate (see ``ops.march.march``)."""
    return march_kernel_state(scene, origin, direction, cfg,
                              active=active)[:4]
