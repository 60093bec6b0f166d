"""Scene representation and geometry queries.

Reference: ``/root/reference/src/scene.py`` (OBJECTS list, ``nearest``,
``calc_normal``, ``build_scene``). Re-designed for XLA (SURVEY.md §7.1):

* The scene is a **struct-of-arrays pytree** — every material/transform
  parameter is a stacked ``jax.Array`` over objects, so the whole scene is
  differentiable (inverse rendering) and queries vectorize over both rays and
  objects.
* Shape dispatch is **static**: objects are sorted by shape type at build time
  (like the reference, ``src/scene.py:11-33`` sorts, and ``SHAPE_SPLIT``
  prefix sums in ``examples/scene_demo/tokyo_ibl.py:125-131`` bucket) and the
  per-type loop unrolls at ``jit`` trace time — the exact ``ti.static``
  semantics (``src/scene.py:44-56``), idiomatically.
* Normals are **analytic** via ``jax.grad`` through the SDF (replacing the
  4-tap tetrahedron estimator ``src/sdf.py:77-87``, which we keep for parity
  tests).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import struct
from ..core.math import radians, rotate_euler
from . import sdf as sdflib
from .sdf import SHAPE, BunnyMLP

MAX_DIS = sdflib.MAX_DIS


@dataclasses.dataclass
class ObjectSpec:
    """Host-side object description; mirrors ``SDFObject``
    (src/dataclass.py:31-35) with the 6-parameter material
    (src/dataclass.py:13-20)."""

    shape: SHAPE
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # Euler degrees
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    albedo: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # Non-lights use emission == 1 so "color *= emission" is a no-op and the
    # brightness-increase termination test works (SURVEY.md §7.5).
    emission: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    roughness: float = 1.0
    metallic: float = 0.0
    transmission: float = 0.0
    ior: float = 1.0


@struct.dataclass
class Scene:
    """Differentiable SoA scene pytree.

    ``shape_types`` / ``type_splits`` / ``box_round`` are static (hashable)
    metadata driving trace-time specialization; everything else is data.
    """

    # --- static metadata (not pytree leaves) ---
    shape_types: Tuple[int, ...] = struct.field(pytree_node=False)
    # start index of each bucket of equal-typed objects; len == n_buckets+1
    type_splits: Tuple[int, ...] = struct.field(pytree_node=False)
    # per-bucket type id, same order as the splits
    bucket_types: Tuple[int, ...] = struct.field(pytree_node=False)
    box_round: float = struct.field(pytree_node=False)
    # Static rotation classification per object: None (general matrix) or
    # ((p0,p1,p2), (s0,s1,s2)) meaning row r of the baked matrix is
    # s_r * e_{p_r} — a signed permutation (identity and all 90-degree
    # Euler rotations). The Pallas march replaces the 9-mul matmul with
    # <= 3 negations for such objects. Cleared (all None) by bake()/
    # animate(), which can make rotations arbitrary.
    rot_perm: Tuple = struct.field(pytree_node=False)

    # --- transforms ---
    position: jax.Array      # (n, 3)
    rotation: jax.Array      # (n, 3) Euler degrees (src convention)
    scale: jax.Array         # (n, 3)
    matrix: jax.Array        # (n, 3, 3) baked object-space rotation
    local_offset: jax.Array  # (n, 3) post-rotation offset (animation hook)

    # --- material (SoA of src/dataclass.py:13-20) ---
    albedo: jax.Array        # (n, 3)
    emission: jax.Array      # (n, 3)
    roughness: jax.Array     # (n,)
    metallic: jax.Array      # (n,)
    transmission: jax.Array  # (n,)
    ior: jax.Array           # (n,)

    # optional neural SDF params (bunny scenes)
    bunny: Optional[BunnyMLP] = None

    @property
    def num_objects(self) -> int:
        return len(self.shape_types)

    @property
    def type_array(self) -> jax.Array:
        # Trace-time constant from the static type tuple — deliberately NOT a
        # pytree leaf so jax.grad over a Scene sees only inexact leaves.
        return jnp.asarray(self.shape_types, jnp.int32)


def _snap_and_classify(mats: np.ndarray, tol: float = 1e-6):
    """Snap near-{-1,0,1} rotation-matrix entries exactly (f32 cos/sin of
    90-degree multiples leave ~1e-8 crumbs) and classify each object's
    rotation as a signed permutation where possible.

    Returns ``(snapped matrices, rot_perm tuple)`` — see ``Scene.rot_perm``.
    Snapping keeps the XLA and Pallas paths numerically identical: both use
    the exact 0/±1 entries.
    """
    mats = mats.copy()
    near = np.abs(mats - np.round(mats)) < tol
    mats[near] = np.round(mats[near])
    perms = []
    for m in mats:
        perm = None
        if np.all(np.isin(m, (-1.0, 0.0, 1.0))) and \
                np.all((m != 0).sum(axis=1) == 1) and \
                np.all((m != 0).sum(axis=0) == 1):
            cols = np.argmax(m != 0, axis=1)
            signs = m[np.arange(3), cols]
            perm = (tuple(int(c) for c in cols),
                    tuple(int(s) for s in signs))
        perms.append(perm)
    return mats, tuple(perms)


def make_scene(objects: Sequence[ObjectSpec], box_round: float = 0.03,
               bunny: Optional[BunnyMLP] = None,
               dtype=jnp.float32) -> Scene:
    """Build a Scene from specs; sorts by shape type like the reference
    (``src/scene.py:11-33``) and bakes rotation matrices
    (``src/scene.py:99-113``)."""
    objs = sorted(objects, key=lambda o: int(o.shape))
    types = tuple(int(o.shape) for o in objs)
    if SHAPE.BUNNY in [o.shape for o in objs] and bunny is None:
        bunny = sdflib.load_bunny(dtype)

    # bucket boundaries over the sorted type list
    splits = [0]
    bucket_types = []
    for i, t in enumerate(types):
        if not bucket_types or t != bucket_types[-1]:
            if bucket_types:
                splits.append(i)
            bucket_types.append(t)
    splits.append(len(types))

    def stack(get, shape_tail=()):
        arr = np.array([get(o) for o in objs], dtype=np.float32)
        return jnp.asarray(arr.reshape((len(objs),) + shape_tail), dtype)

    rotation = stack(lambda o: o.rotation, (3,))
    mats = np.asarray(sdflib.bake_matrices(rotation))
    mats, rot_perm = _snap_and_classify(mats)
    return Scene(
        shape_types=types,
        type_splits=tuple(splits),
        bucket_types=tuple(bucket_types),
        box_round=float(box_round),
        rot_perm=rot_perm,
        position=stack(lambda o: o.position, (3,)),
        rotation=rotation,
        scale=stack(lambda o: o.scale, (3,)),
        matrix=jnp.asarray(mats, dtype),
        local_offset=jnp.zeros((len(objs), 3), dtype),
        albedo=stack(lambda o: o.albedo, (3,)),
        emission=stack(lambda o: o.emission, (3,)),
        roughness=stack(lambda o: o.roughness),
        metallic=stack(lambda o: o.metallic),
        transmission=stack(lambda o: o.transmission),
        ior=stack(lambda o: o.ior),
        bunny=bunny,
    )


def bake(scene: Scene) -> Scene:
    """Re-bake rotation matrices from Euler degrees — the reference's
    ``build_scene()`` / ``update_all_transform`` (src/scene.py:99-113).
    Call after mutating ``rotation``. The static signed-permutation
    classification is conservatively dropped (rotation is traced data
    here)."""
    return scene.replace(matrix=sdflib.bake_matrices(scene.rotation),
                         rot_perm=(None,) * scene.num_objects)


def _sd_typed(scene: Scene, type_id: int, p_local: jax.Array,
              scale: jax.Array) -> jax.Array:
    """Distance for one static shape type; ``p_local``/(...,3), scale/(...,3)."""
    if type_id == SHAPE.BOX:
        return sdflib.sd_round_box(p_local, scale, scene.box_round)
    if type_id == SHAPE.BUNNY:
        return sdflib.sd_bunny(p_local, scene.bunny)
    return sdflib.SHAPE_FUNC[SHAPE(type_id)](p_local, scale)


def _local(scene: Scene, idx, p: jax.Array) -> jax.Array:
    """World point(s) -> object space of object(s) ``idx``
    (``src/sdf.py:64-74`` + animation offset)."""
    pos = scene.position[idx]
    mat = scene.matrix[idx]
    off = scene.local_offset[idx]
    return sdflib.to_object_space(p, pos, mat) + off


def all_distances(scene: Scene, p: jax.Array) -> jax.Array:
    """Signed distance from points ``p`` (..., 3) to every object -> (..., n).

    The per-type loop below is a Python loop over static buckets, unrolled at
    trace time — same specialization as ``ti.static(range(...))`` in
    ``src/scene.py:48`` / ``tokyo_ibl.py:224-235``.
    """
    chunks = []
    for b, t in enumerate(scene.bucket_types):
        lo, hi = scene.type_splits[b], scene.type_splits[b + 1]
        idx = jnp.arange(lo, hi)
        # (..., k, 3): broadcast points against the bucket's objects
        pl = _local(scene, idx, p[..., None, :])
        d = _sd_typed(scene, t, pl, scene.scale[idx])
        chunks.append(d)
    return jnp.concatenate(chunks, axis=-1)


def nearest(scene: Scene, p: jax.Array):
    """Nearest object index and |distance| — min over two-sided ``|sd_i|``
    (``src/scene.py:44-56``; ``abs`` makes surfaces interior-traceable).

    Returns ``(index (...,) i32, min_dis (...,))``.
    """
    d = jnp.abs(all_distances(scene, p))
    idx = jnp.argmin(d, axis=-1).astype(jnp.int32)
    # The reference's running-min starts at MAX_DIS (src/scene.py:45), so
    # the returned distance is clamped there — relevant only to escaped
    # rays' step sizes, but kept for exact three-way parity (XLA / Pallas /
    # numpy oracle).
    return idx, jnp.minimum(jnp.min(d, axis=-1), MAX_DIS)


def sd_object(scene: Scene, idx: jax.Array, p: jax.Array) -> jax.Array:
    """Signed distance to the *selected* object per ray.

    ``idx`` (...,) int32 per ray. Computes every object's distance through
    the statically-unrolled bucket loop and hard-selects by index — NO
    per-ray gathers of the per-object transform/scale tables (scene tables
    are tiny, rays are not). Same trick as the Pallas march kernel and
    ``nearest``.
    """
    d = all_distances(scene, p)  # (..., n)
    sel = idx[..., None] == jnp.arange(scene.num_objects)
    return jnp.sum(jnp.where(sel, d, 0.0), axis=-1)


def bounding_radius(scene: Scene) -> Optional[jax.Array]:
    """Conservative origin-centered bounding-sphere radius of the whole
    scene: beyond it, every SDF is positive and increasing along any
    receding ray (the ``escape_bound`` march early-exit). Returns ``None``
    for scenes with unbounded objects (PLANE)."""
    if SHAPE.PLANE in scene.shape_types:
        return None
    # |center| + exact circumscribed radius per object (shape types are
    # static, so this is a host-side loop over per-shape formulas):
    #   SPHERE   r = s0
    #   BOX      r = |scale| + box_round (the round radius extends outward)
    #   CYLINDER r = sqrt(s0^2 + s1^2)
    #   CONE     cap rim at q = s1*s2/s0, y = -s1 -> r = s1*sqrt(s0^2+s2^2)/s0
    #   BUNNY    MLP support is the unit sphere in LOCAL coords regardless of
    #            scene.scale (ops/sdf.sd_bunny ignores scale) -> r = 1
    radii = []
    for i, t in enumerate(scene.shape_types):
        s0, s1, s2 = scene.scale[i, 0], scene.scale[i, 1], scene.scale[i, 2]
        if t == SHAPE.SPHERE:
            r = s0
        elif t == SHAPE.BOX:
            r = jnp.sqrt(s0 * s0 + s1 * s1 + s2 * s2) + scene.box_round
        elif t == SHAPE.CYLINDER:
            r = jnp.sqrt(s0 * s0 + s1 * s1)
        elif t == SHAPE.CONE:
            r = s1 * jnp.sqrt(s0 * s0 + s2 * s2) / jnp.maximum(s0, 1e-6)
        elif t == SHAPE.BUNNY:
            r = jnp.float32(1.0)
        else:  # SHAPE.NONE
            r = jnp.float32(0.0)
        radii.append(r)
    r_shape = jnp.stack(radii)
    r_obj = (jnp.linalg.norm(scene.position + 0.0, axis=-1)
             + jnp.linalg.norm(scene.local_offset, axis=-1)
             + r_shape)
    return jnp.max(r_obj) * 1.05 + 0.1


class Materials(NamedTuple):
    albedo: jax.Array        # (..., 3)
    emission: jax.Array      # (..., 3)
    roughness: jax.Array     # (...,)
    metallic: jax.Array      # (...,)
    transmission: jax.Array  # (...,)
    ior: jax.Array           # (...,)


def materials_at(scene: Scene, idx: jax.Array) -> Materials:
    """All six material parameters of the hit object per ray
    (``src/dataclass.py:13-20``), fetched as ONE one-hot contraction against
    the packed (n_obj, 10) table instead of six per-ray gathers (whether
    the gather or the one-hot is faster on the GPU is not measured yet)."""
    dtype = scene.albedo.dtype
    table = jnp.concatenate([
        scene.albedo, scene.emission,
        scene.roughness[:, None], scene.metallic[:, None],
        scene.transmission[:, None], scene.ior[:, None]], axis=-1)
    oh = (idx[..., None] == jnp.arange(scene.num_objects)).astype(dtype)
    # HIGHEST: the one-hot is exact, but DEFAULT f32 matmul precision may
    # round the table values (TF32 on the GPU keeps ~3 significant digits)
    m = jnp.matmul(oh, table,
                   precision=jax.lax.Precision.HIGHEST)  # (..., 10)
    return Materials(m[..., 0:3], m[..., 3:6], m[..., 6], m[..., 7],
                     m[..., 8], m[..., 9])


def calc_normal(scene: Scene, idx: jax.Array, p: jax.Array) -> jax.Array:
    """Analytic surface normal: normalized ``∂ sd_object/∂ p`` via ``jax.grad``
    (replaces the tetrahedron estimator ``src/sdf.py:77-87``; SURVEY §7.2.2)."""
    g = jax.grad(lambda q: jnp.sum(sd_object(scene, idx, q)))(p)
    return g / jnp.linalg.norm(g, axis=-1, keepdims=True)


def calc_normal_tetrahedron(scene: Scene, idx: jax.Array, p: jax.Array,
                            h: float = 0.5773 * 0.005) -> jax.Array:
    """Parity variant: 4-tap tetrahedron estimate (``src/sdf.py:77-87``)."""
    return sdflib.tetrahedron_normal(
        lambda q: sd_object(scene, idx, q), p, h)


def animate(scene: Scene, frame: jax.Array,
            spin_axis=(0.0, 0.0, 1.0), period: float = 120.0,
            bob: float = 0.1) -> Scene:
    """Programmatic animation of the bunny scenes
    (``bunny_sdf_glass.py:213-217``): after the object rotation, spin about z
    by ``t = pi*frame/period`` and bob along z by ``bob*sin(t)`` — folded into
    the baked matrix and the post-rotation ``local_offset``."""
    t = jnp.pi * frame.astype(scene.position.dtype) / period
    axis = jnp.asarray(spin_axis, scene.position.dtype)
    r_anim = rotate_euler(axis * t)
    new_matrix = jnp.einsum("ij,njk->nik", r_anim, scene.matrix,
                            precision=jax.lax.Precision.HIGHEST)
    offset = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 1.0], scene.position.dtype) * bob * jnp.sin(t),
        scene.local_offset.shape)
    return scene.replace(matrix=new_matrix, local_offset=offset,
                         rot_perm=(None,) * scene.num_objects)
