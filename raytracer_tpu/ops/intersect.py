"""Ray-triangle intersection and the brute-force scene tracer.

The scalar Moller-Trumbore path of the reference (src/Object.cpp:109-180) is
the behavioral spec; here it is vectorized over (ray x triangle) tiles on the
VPU — the TPU generalization of the reference's 4-wide SSE packets
(src/BVH.cpp:1297-1459).

Traversal/selection returns integer ids only; `refine_hit` recomputes (t,a,b)
differentiably for the selected triangle so gradients flow to vertex positions
(and instance transforms) without differentiating the search itself.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.types import Scene
from ..core.vecmath import MIRO_TMAX, transform_point, transform_vector
from ..shading import textures as tex


@struct.dataclass
class Hit:
    t: jax.Array      # (R,) f32 — MIRO_TMAX on miss
    tri: jax.Array    # (R,) i32 — -1 on miss
    inst: jax.Array   # (R,) i32 — instance id (0 for single-level scenes)
    a: jax.Array      # (R,) f32 barycentric (v1 weight)
    b: jax.Array      # (R,) f32 barycentric (v2 weight)

    @property
    def valid(self) -> jax.Array:
        return self.tri >= 0


def mt_intersect(o, d, p0, p1, p2):
    """Batched Moller-Trumbore (reference: src/Object.cpp:109-147).

    All args broadcastable with trailing (3,). Returns (t, a, b, ok) where ok
    encodes the barycentric validity tests only; callers apply t-range tests.
    """
    e0 = p1 - p0
    e1 = p2 - p0
    pvec = jnp.cross(d, e1)
    det = jnp.sum(e0 * pvec, axis=-1)
    inv_det = 1.0 / det  # det==0 -> inf; comparisons below then reject
    tvec = o - p0
    a = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e0)
    b = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e1 * qvec, axis=-1) * inv_det
    ok = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (a + b <= 1.0) & (det != 0.0)
    return t, a, b, ok


def gather_tri_verts(scene: Scene, tri, time):
    """Gather (lerped) triangle vertices -> (..., 3, 3) [corner, xyz].

    Motion blur lerps vertex positions by ray time (reference
    MBObject::intersect, src/MBObject.cpp:26-107). For non-MB triangles
    vertices_t1 == vertices so the lerp is a no-op.
    """
    f = scene.geom.face_v[tri]                       # (..., 3)
    v0 = scene.geom.vertices[f]                      # (..., 3, 3)
    if scene.has_motion_blur:
        v1 = scene.geom.vertices_t1[f]
        w = time[..., None, None]
        return v0 + w * (v1 - v0)
    return v0


def _alpha_of(scene: Scene, tri, a, b):
    """Alpha-map cutout test value at the hit point (reference does this
    inside the intersector, src/Object.cpp:150-166, src/BVH.cpp:1401-1435)."""
    mat = scene.geom.face_mat[tri]
    tex_id = scene.materials.tex_alpha[mat]
    has_uv = scene.geom.face_has_uv[tri]
    ft = scene.geom.face_t[tri]
    uvs = scene.geom.texcoords[ft]                   # (..., 3, 2)
    c = 1.0 - a - b
    w = jnp.stack([c, a, b], axis=-1)[..., None]
    uv = jnp.sum(uvs * w, axis=-2)
    u = jnp.where(has_uv, uv[..., 0], a)
    v = jnp.where(has_uv, uv[..., 1], b)
    alpha = tex.tex_lookup_alpha(scene.textures, tex_id, u, v)
    return jnp.where(tex_id >= 0, alpha, 1.0)


@partial(jax.jit, static_argnames=('any_hit', 'chunk'))
def brute_force_trace(scene: Scene, o, d, time, tmin, tmax,
                      any_hit: bool = False, chunk: int = 256) -> Hit:
    """Reference linear fallback (src/BVH.cpp:1114-1126), chunk-vectorized.

    o, d: (R, 3); time/tmin/tmax: scalar or (R,). Single-level scenes only.
    """
    R = o.shape[0]
    Tn = scene.num_tris
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    time = jax.lax.stop_gradient(time)
    tmin = jax.lax.stop_gradient(tmin)
    tmax = jax.lax.stop_gradient(tmax)
    geom = jax.lax.stop_gradient(scene.geom)
    scene_sg = jax.lax.stop_gradient(scene)
    tmin = jnp.broadcast_to(tmin, (R,))
    tmax = jnp.broadcast_to(tmax, (R,))
    time = jnp.broadcast_to(time, (R,))

    pad = (-Tn) % chunk
    nchunks = (Tn + pad) // chunk

    def body(carry, ci):
        best_t, best_tri, best_a, best_b = carry
        tid = ci * chunk + jnp.arange(chunk, dtype=jnp.int32)
        valid_tri = tid < Tn
        tid = jnp.minimum(tid, Tn - 1)
        f = geom.face_v[tid]                          # (C, 3)
        p0 = geom.vertices[f[:, 0]]
        p1 = geom.vertices[f[:, 1]]
        p2 = geom.vertices[f[:, 2]]
        if scene.has_motion_blur:
            q0 = geom.vertices_t1[f[:, 0]]
            q1 = geom.vertices_t1[f[:, 1]]
            q2 = geom.vertices_t1[f[:, 2]]
            w = time[:, None, None]                   # (R,1,1)
            p0 = p0[None] + w * (q0[None] - p0[None])  # (R,C,3)
            p1 = p1[None] + w * (q1[None] - p1[None])
            p2 = p2[None] + w * (q2[None] - p2[None])
        else:
            p0, p1, p2 = p0[None], p1[None], p2[None]
        t, a, b, ok = mt_intersect(o[:, None], d[:, None], p0, p1, p2)
        ok = ok & valid_tri[None] & (t >= tmin[:, None]) & (t < best_t[:, None]) \
               & (t < tmax[:, None])
        if scene.has_alpha_maps:
            alpha = _alpha_of(scene_sg, jnp.broadcast_to(tid[None], ok.shape),
                              a, b)
            ok = ok & (alpha >= 0.5)
        t = jnp.where(ok, t, jnp.inf)
        k = jnp.argmin(t, axis=-1)
        rows = jnp.arange(R)
        tk = t[rows, k]
        found = jnp.isfinite(tk)
        best_tri = jnp.where(found, tid[k], best_tri)
        best_a = jnp.where(found, a[rows, k], best_a)
        best_b = jnp.where(found, b[rows, k], best_b)
        best_t = jnp.where(found, tk, best_t)
        return (best_t, best_tri, best_a, best_b), None

    # derive the init from `o` so its sharding/varying type matches the loop
    # outputs under shard_map
    zero = jnp.zeros_like(o[:, 0])
    init = (jnp.minimum(jnp.asarray(tmax, jnp.float32), MIRO_TMAX) + zero,
            jnp.full((R,), -1, jnp.int32) + zero.astype(jnp.int32),
            zero, zero)
    (t, tri, a, b), _ = jax.lax.scan(body, init,
                                     jnp.arange(nchunks, dtype=jnp.int32))
    t = jnp.where(tri >= 0, t, MIRO_TMAX)
    return Hit(t=t, tri=tri, inst=jnp.zeros((R,), jnp.int32), a=a, b=b)


def refine_hit(scene: Scene, o, d, time, hit: Hit):
    """Differentiable (t, a, b) for the selected triangle.

    Forward values are pinned bit-exactly to the traversal's hit (the
    recomputed Moller-Trumbore is ill-conditioned at grazing/silhouette
    triangles — recomputing t there can land the shading point inside the
    surface and cause false self-shadowing); gradients flow through an
    object-space recomputation, so d(loss)/d(vertices) is exact at the hit.
    Instance transforms are treated as constants here (vertex gradients are
    the BASELINE target; transform gradients are future work).
    """
    tri = jnp.maximum(hit.tri, 0)
    p = gather_tri_verts(scene, tri, time)            # (..., 3, 3) object space
    if scene.instances is not None and not scene.single_level:
        mi = jax.lax.stop_gradient(
            scene.instances.m_inv[jnp.maximum(hit.inst, 0)])
        oo = transform_point(mi, o)
        dd = transform_vector(mi, d)
    else:
        oo, dd = o, d
    t, a, b, _ = mt_intersect(oo, dd, p[..., 0, :], p[..., 1, :], p[..., 2, :])
    sg = jax.lax.stop_gradient
    t = hit.t + (t - sg(t))
    a = hit.a + (a - sg(a))
    b = hit.b + (b - sg(b))
    v = hit.valid
    return (jnp.where(v, t, MIRO_TMAX),
            jnp.where(v, a, 0.0), jnp.where(v, b, 0.0))
