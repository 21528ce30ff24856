"""Host-side triangle clustering for the block-coherent wavefront tracer.

Instead of a deep per-ray pointer tree (the reference's QBVH,
src/BVH.cpp:100-389), the SAH build is cut into M flat *clusters* of <= C
triangles each (C = 128). Traversal then has two phases:

  1. cull: a ray slab-tests a cluster AABB (the reference's 4-wide QBVH
     box test, src/BVH.cpp:391-414, widened to a block of rays);
  2. sweep: Moller-Trumbore-test the cluster's *contiguous* (C,)-triangle
     slab (the reference's TriCache4 packets, src/BVH.cpp:1297-1459,
     widened 4 -> 128).

ops/cluster_trace.py runs this in plain XLA; ops/pallas/cluster_kernel.py is
the GPU kernel that keeps each ray block's best hit in registers across the
whole cluster walk.

Cluster triangle data is stored padded SoA (M, 3, C) per component so a
cluster is one contiguous row read. Padding slots hold degenerate triangles
(det == 0 -> always rejected) and tri id -1.

The build reuses the binned-SAH binary build (bvh.py) with leaf size C: every
binary leaf becomes one cluster, so cluster quality == SAH leaf quality.
"""
from __future__ import annotations

import numpy as np

from ..core import types as T
from ..core import struct
from typing import Any

Array = Any


@struct.dataclass
class Clusters:
    """Padded SoA cluster table. M clusters x C triangles.

    p0/e1/e2 are the Moller-Trumbore basis (p0, p1-p0, p2-p0) per component;
    *_t1 hold the t=1 motion pose (linear in the vertices, so lerping the
    basis == lerping the vertices). For static scenes *_t1 is p0/e1/e2 itself
    (zero extra memory — same buffer).
    """
    bb_min: Array     # (M, 3) f32 — union of both motion poses
    bb_max: Array     # (M, 3) f32
    p0: Array         # (M, 3, C) f32  [component, lane]
    e1: Array         # (M, 3, C)
    e2: Array         # (M, 3, C)
    p0_t1: Array      # (M, 3, C)
    e1_t1: Array      # (M, 3, C)
    e2_t1: Array      # (M, 3, C)
    tri: Array        # (M, C) i32 — original triangle id, -1 = padding
    cluster_size: int = struct.field(pytree_node=False, default=128)

    @property
    def num_clusters(self) -> int:
        return self.tri.shape[0]


def _basis(verts: np.ndarray, faces: np.ndarray):
    """(T, 3) faces -> MT basis arrays (T, 3) p0, e1, e2."""
    p0 = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - p0
    e2 = verts[faces[:, 2]] - p0
    return p0, e1, e2


def build_clusters(geom: T.Geometry, cluster_size: int = 128,
                   pad_clusters_to: int = 8,
                   tri_ids: np.ndarray | None = None) -> Clusters:
    """Cut the SAH tree into <=cluster_size-triangle clusters.

    tri_ids restricts the build to a triangle subset; the emitted tri table
    always holds GLOBAL triangle ids. Default (None) covers the whole
    geometry — the single-level table.
    """
    from .bvh import _build_binary, triangle_aabbs

    C = cluster_size
    if tri_ids is None:
        tri_ids = np.arange(geom.face_v.shape[0], dtype=np.int64)
    else:
        tri_ids = np.asarray(tri_ids, np.int64)

    # native fast path: binned-SAH + SoA pack in one C++ call
    # (native/rt_native.cpp rt_build_clusters); numpy below is the fallback
    from .. import native as native_mod
    has_mb_sub = bool(np.any(np.asarray(geom.face_mb)[tri_ids]))
    nat = native_mod.build_clusters_native(
        np.asarray(geom.vertices, np.float32),
        np.asarray(geom.vertices_t1, np.float32),
        np.asarray(geom.face_v, np.int32), tri_ids, C, has_mb_sub)
    if nat is not None:
        nb_min, nb_max, np0, ne1, ne2, nq0, nq1, nq2, ntri = nat
        M = max(len(ntri), 1)
        Mp = -(-M // pad_clusters_to) * pad_clusters_to
        pad = Mp - len(ntri)
        if pad:
            def padrow(x, fill):
                w = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
                return np.pad(x, w, constant_values=fill)
            # padding rows: far-away POINT boxes + degenerate triangles
            nb_min = padrow(nb_min, np.float32(3e37))
            nb_max = padrow(nb_max, np.float32(3e37))
            np0, ne1, ne2 = (padrow(x, 0.0) for x in (np0, ne1, ne2))
            if has_mb_sub:
                nq0, nq1, nq2 = (padrow(x, 0.0) for x in (nq0, nq1, nq2))
            else:
                nq0, nq1, nq2 = np0, ne1, ne2
            ntri = padrow(ntri, -1)
        return Clusters(bb_min=nb_min, bb_max=nb_max, p0=np0, e1=ne1,
                        e2=ne2, p0_t1=nq0, e1_t1=nq1, e2_t1=nq2,
                        tri=ntri, cluster_size=C)

    bmin, bmax = triangle_aabbs(geom, tri_ids)
    tree, order = _build_binary(bmin, bmax, leaf_size=C)  # subset positions

    # collect binary leaves -> (start, count) ranges over `order`
    leaves = np.flatnonzero(tree.left[:tree.n] < 0)
    starts = tree.start[leaves]
    counts = tree.count[leaves]
    M = max(len(leaves), 1)
    Mp = -(-M // pad_clusters_to) * pad_clusters_to

    v0 = np.asarray(geom.vertices, np.float32)
    v1 = np.asarray(geom.vertices_t1, np.float32)
    faces = np.asarray(geom.face_v)

    tri = np.full((Mp, C), -1, np.int32)
    # padding rows get a far-away POINT box (lo == hi == +3e37): an
    # inverted (lo > hi) box would still PASS the slab test because the
    # per-axis min/max swap un-inverts it into an infinite box
    cb_min = np.full((Mp, 3), np.float32(3e37))
    cb_max = np.full((Mp, 3), np.float32(3e37))
    p0 = np.zeros((Mp, 3, C), np.float32)
    e1 = np.zeros((Mp, 3, C), np.float32)
    e2 = np.zeros((Mp, 3, C), np.float32)
    has_mb = bool(np.any(np.asarray(geom.face_mb)[tri_ids]))
    if has_mb:
        q0 = np.zeros((Mp, 3, C), np.float32)
        q1 = np.zeros((Mp, 3, C), np.float32)
        q2 = np.zeros((Mp, 3, C), np.float32)

    b0_all, be1_all, be2_all = _basis(v0, faces)
    if has_mb:
        c0_all, ce1_all, ce2_all = _basis(v1, faces)

    for m in range(len(leaves)):
        pos = order[starts[m]:starts[m] + counts[m]]  # subset positions
        ids = tri_ids[pos]                            # global triangle ids
        k = len(ids)
        tri[m, :k] = ids
        cb_min[m] = bmin[pos].min(0)
        cb_max[m] = bmax[pos].max(0)
        p0[m, :, :k] = b0_all[ids].T
        e1[m, :, :k] = be1_all[ids].T
        e2[m, :, :k] = be2_all[ids].T
        if has_mb:
            q0[m, :, :k] = c0_all[ids].T
            q1[m, :, :k] = ce1_all[ids].T
            q2[m, :, :k] = ce2_all[ids].T

    if not has_mb:
        q0, q1, q2 = p0, e1, e2
    return Clusters(bb_min=cb_min, bb_max=cb_max,
                    p0=p0, e1=e1, e2=e2, p0_t1=q0, e1_t1=q1, e2_t1=q2,
                    tri=tri, cluster_size=C)


def refresh_clusters(clusters: Clusters, geom, mb: bool) -> Clusters:
    """Re-derive the cluster MT basis + AABBs from the CURRENT vertices.

    `build_clusters` bakes vertex positions into the SoA table host-side;
    differentiable vertex updates (parallel/sharding.apply_params) must
    refresh the table device-side or the tracer keeps intersecting the
    original geometry (forward values are pinned to the traversal's hit by
    intersect.refine_hit, so stale tables freeze the render w.r.t. vertex
    params). Topology (tri-to-cluster assignment) stays fixed: cluster AABBs
    are recomputed so traversal remains exact, only SAH quality degrades for
    large deformations.

    All ops are jnp gathers/reductions — callable under jit; cost is one
    rebuild of the (M, 3, C) tables per parameter update.
    """
    import jax.numpy as jnp

    tri = jnp.asarray(clusters.tri)                      # (M, C)
    valid = tri >= 0
    faces = jnp.asarray(geom.face_v)[jnp.maximum(tri, 0)]  # (M, C, 3)

    def basis(verts):
        p0 = verts[faces[..., 0]]                        # (M, C, 3)
        e1 = verts[faces[..., 1]] - p0
        e2 = verts[faces[..., 2]] - p0
        m = valid[..., None]
        # padding lanes -> degenerate (det == 0, always rejected)
        return (jnp.where(m, p0, 0.0), jnp.where(m, e1, 0.0),
                jnp.where(m, e2, 0.0))

    def corners(p0, e1, e2):
        return jnp.stack([p0, p0 + e1, p0 + e2], axis=2)  # (M, C, 3corner, 3)

    p0, e1, e2 = basis(jnp.asarray(geom.vertices))
    pts = corners(p0, e1, e2)
    if mb:
        q0, q1, q2 = basis(jnp.asarray(geom.vertices_t1))
        pts = jnp.concatenate([pts, corners(q0, q1, q2)], axis=2)
    else:
        q0, q1, q2 = p0, e1, e2

    m4 = valid[..., None, None]
    bb_min = jnp.min(jnp.where(m4, pts, jnp.inf), axis=(1, 2))    # (M, 3)
    bb_max = jnp.max(jnp.where(m4, pts, -jnp.inf), axis=(1, 2))
    # empty (all-padding) clusters keep a never-hit box
    any_valid = jnp.any(valid, axis=1)[:, None]
    bb_min = jnp.where(any_valid, bb_min, 3e37)
    bb_max = jnp.where(any_valid, bb_max, 3e37)  # point box: see build_clusters

    def soa(x):  # (M, C, 3) -> (M, 3, C)
        return x.transpose(0, 2, 1)

    return clusters.replace(
        bb_min=bb_min, bb_max=bb_max,
        p0=soa(p0), e1=soa(e1), e2=soa(e2),
        p0_t1=soa(q0), e1_t1=soa(q1), e2_t1=soa(q2))
