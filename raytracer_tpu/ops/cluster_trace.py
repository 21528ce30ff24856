"""Cluster wavefront tracer, pure-XLA implementation.

The dense-cull + near-ordered cluster sweep described in
geometry/clusters.py, expressed with standard XLA ops so it runs on any
backend (tests run it on CPU; the GPU kernel in ops/pallas/cluster_kernel
walks the same table and is validated against this).

Reference behavior mirrored: nearest-hit selection with t-pruning
(src/BVH.cpp:1112-1295), shadow any-hit early-out (src/BVH.cpp:1438),
motion-blur vertex lerp inside the intersector (src/MBObject.cpp:26-107).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.types import Scene
from ..core.vecmath import MIRO_TMAX
from .intersect import Hit, _alpha_of

BIG = jnp.float32(3e38)


def _safe_rcp(d):
    tiny = 1e-20
    return 1.0 / jnp.where(jnp.abs(d) < tiny,
                           jnp.where(d < 0, -tiny, tiny), d)


def _cull(cl, o, d, tmin, tmax):
    """Dense (R, M) slab test -> near-t keyed candidates (BIG = miss)."""
    inv = _safe_rcp(d)                                    # (R, 3)
    t0 = (cl.bb_min[None] - o[:, None]) * inv[:, None]    # (R, M, 3)
    t1 = (cl.bb_max[None] - o[:, None]) * inv[:, None]
    near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit = (near <= far) & (far >= tmin[:, None]) & (near <= tmax[:, None])
    return jnp.where(hit, jnp.maximum(near, 0.0), BIG)    # (R, M)


def _mt_cluster(cl, m, o, d, time, mb: bool):
    """MT-test rays against their per-ray cluster m -> (t, a, b, ok, tid).

    o, d: (R, 3); m: (R,) cluster ids. Gather is a contiguous row read per
    ray: (3, C) basis slabs.
    """
    p0 = cl.p0[m]                                         # (R, 3, C)
    e1 = cl.e1[m]
    e2 = cl.e2[m]
    if mb:
        w = time[:, None, None]
        p0 = p0 + w * (cl.p0_t1[m] - p0)
        e1 = e1 + w * (cl.e1_t1[m] - e1)
        e2 = e2 + w * (cl.e2_t1[m] - e2)
    tid = cl.tri[m]                                       # (R, C)

    o_ = o[:, :, None]                                    # (R, 3, 1)
    d_ = d[:, :, None]
    # cross/dot with component axis in the middle (lane axis = C)
    def cross(a, b):
        return jnp.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                          a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                          a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=1)

    pvec = cross(d_, e2)                                  # (R, 3, C)
    det = jnp.sum(e1 * pvec, axis=1)                      # (R, C)
    inv_det = 1.0 / det
    tvec = o_ - p0
    a = jnp.sum(tvec * pvec, axis=1) * inv_det
    qvec = cross(tvec, e1)
    b = jnp.sum(d_ * qvec, axis=1) * inv_det
    t = jnp.sum(e2 * qvec, axis=1) * inv_det
    ok = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (a + b <= 1.0) \
        & (det != 0.0) & (tid >= 0)
    return t, a, b, ok, tid


@partial(jax.jit, static_argnames=('any_hit', 'max_iters'))
def cluster_trace(scene: Scene, o, d, time, tmin, tmax,
                  any_hit: bool = False, max_iters: int = 0) -> Hit:
    """Trace a wavefront against the scene clusters -> Hit.

    o, d: (R, 3). Single-level scenes only (callers gate on
    scene.single_level). Nearest-hit visits candidate clusters in near-t
    order with per-ray termination when the next cluster's slab entry lies
    beyond the current best t.
    """
    cl = jax.lax.stop_gradient(scene.clusters)
    scene = jax.lax.stop_gradient(scene)
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    time = jax.lax.stop_gradient(time)
    tmin = jax.lax.stop_gradient(tmin)
    tmax = jax.lax.stop_gradient(tmax)
    R = o.shape[0]
    M = cl.num_clusters
    mb = scene.has_motion_blur
    f32 = o.dtype
    tmin = jnp.broadcast_to(jnp.asarray(tmin, f32), (R,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, f32), (R,))
    time = jnp.broadcast_to(jnp.asarray(time, f32), (R,))
    limit0 = jnp.minimum(tmax, MIRO_TMAX)

    near = _cull(cl, o, d, tmin, tmax)                    # (R, M)
    # per-ray candidate order, nearest first; misses (BIG) sort last
    order = jnp.argsort(near, axis=-1).astype(jnp.int32)  # (R, M)
    near_sorted = jnp.take_along_axis(near, order, axis=-1)

    iters = max_iters or M

    def cond(s):
        k, best_t, best_tri, _, _, found = s
        key_k = jax.lax.dynamic_index_in_dim(
            near_sorted, jnp.minimum(k, M - 1), axis=1, keepdims=False)
        viable = (key_k <= best_t) & (key_k < BIG)
        if any_hit:
            viable = viable & ~found
        return (k < iters) & jnp.any(viable)

    def body(s):
        k, best_t, best_tri, best_a, best_b, found = s
        kc = jnp.minimum(k, M - 1)
        m = jax.lax.dynamic_index_in_dim(order, kc, axis=1, keepdims=False)
        key_k = jax.lax.dynamic_index_in_dim(near_sorted, kc, axis=1,
                                             keepdims=False)
        active = (key_k <= best_t) & (key_k < BIG)
        if any_hit:
            active = active & ~found
        t, a, b, ok, tid = _mt_cluster(cl, m, o, d, time, mb)
        ok = ok & active[:, None] & (t >= tmin[:, None]) \
            & (t <= best_t[:, None])
        if scene.has_alpha_maps:
            alpha = _alpha_of(scene, jnp.maximum(tid, 0), a, b)
            ok = ok & (alpha >= 0.5)
        # nearest (t, triangle id): among equal t the smallest id wins, as
        # in brute_force_trace, so the hit does not depend on visit order
        t = jnp.where(ok, t, BIG)
        tj = jnp.min(t, axis=-1)
        cand = ok & (t == tj[:, None])
        tidj = jnp.min(jnp.where(cand, tid, jnp.iinfo(jnp.int32).max), -1)
        j = jnp.argmax(cand & (tid == tidj[:, None]), axis=-1)
        rows = jnp.arange(R)
        got = (tj < BIG) & ((tj < best_t) | ((tj == best_t) & (best_tri >= 0)
                                             & (tidj < best_tri)))
        best_t = jnp.where(got, tj, best_t)
        best_tri = jnp.where(got, tidj, best_tri)
        best_a = jnp.where(got, a[rows, j], best_a)
        best_b = jnp.where(got, b[rows, j], best_b)
        return (k + 1, best_t, best_tri, best_a, best_b, found | got)

    zero = jnp.zeros_like(o[:, 0])
    init = (jnp.int32(0), limit0 + zero,
            jnp.full((R,), -1, jnp.int32) + zero.astype(jnp.int32),
            zero, zero, zero > 1.0)
    _, t, tri, a, b, _ = jax.lax.while_loop(cond, body, init)
    t = jnp.where(tri >= 0, t, MIRO_TMAX)
    return Hit(t=t, tri=tri, inst=jnp.zeros((R,), jnp.int32) + zero.astype(jnp.int32),
               a=a, b=b)


def alpha_aware_trace(scene: Scene, trace_once, o, d, time, tmin, tmax,
                      any_hit: bool = False, max_passes: int = 12) -> Hit:
    """Alpha-cutout wrapper for tracers without in-kernel alpha tests.

    The reference re-tests cutout lanes inside intersect4
    (src/BVH.cpp:1401-1435); the wavefront equivalent re-traces past each
    transparent (alpha < 0.5) hit with an advanced per-ray tmin until every
    ray has an opaque hit or a miss. trace_once(o, d, time, tmin, tmax,
    any_hit) -> Hit must accept a per-ray tmin array. Pass count is bounded
    by max_passes: rays still live on exhaustion (more than max_passes
    stacked transparent surfaces) keep their LAST transparent hit rather
    than reporting a miss, so deep cutout stacks shade slightly wrong
    instead of leaking the background through geometry.

    Follow-up passes run on a SHRINKING STATIC PREFIX: live rays are
    stable-partitioned to the front (two cumsums + a scatter) and pass p
    traces/updates only the first max(4096, R >> (p+1)) rows — the forest
    canopy's live set decays 13%, 7%, 4%, ... per pass, while full-wavefront
    gathers/alpha lookups/state updates would cost a whole-wavefront pass
    each time. Live rays past
    a pass's budget simply wait (the partition is stable), consuming a
    pass of the budget — the same exhaustion fallback as before.
    """
    R = o.shape[0]
    f32 = o.dtype
    zero = jnp.zeros_like(o[:, 0])
    tmin0 = jnp.broadcast_to(jnp.asarray(tmin, f32), (R,)) + zero
    tmax_b = jnp.broadcast_to(jnp.asarray(tmax, f32), (R,)) + zero
    time_b = jnp.broadcast_to(jnp.asarray(time, f32), (R,)) + zero

    s = dict(
        tmin=tmin0,
        done=zero > 1.0,
        t=zero + MIRO_TMAX,
        tri=jnp.full((R,), -1, jnp.int32) + zero.astype(jnp.int32),
        inst=jnp.zeros((R,), jnp.int32) + zero.astype(jnp.int32),
        a=zero, b=zero,
    )

    def update(s, hit, sel):
        """Fold one pass's hits (rows `sel`, or all when sel is None)."""
        def read(x):
            return x if sel is None else x[sel]

        live = ~read(s['done'])
        valid = hit.valid
        alpha = _alpha_of(scene, jnp.maximum(hit.tri, 0), hit.a, hit.b)
        opaque = valid & (alpha >= 0.5)
        accept = live & opaque
        cutout = live & valid & ~opaque
        miss = live & ~valid
        # record cutout hits too: if the pass budget runs out the last
        # transparent hit stands in for the (never found) opaque one; a
        # subsequent miss clears it again (the ray exits through the hole)
        take = accept | cutout
        t = jnp.where(miss, MIRO_TMAX, jnp.where(take, hit.t, read(s['t'])))
        tri = jnp.where(miss, -1, jnp.where(take, hit.tri, read(s['tri'])))
        inst = jnp.where(take, hit.inst, read(s['inst']))
        a = jnp.where(take, hit.a, read(s['a']))
        b = jnp.where(take, hit.b, read(s['b']))
        # advance past the transparent hit (relative + absolute epsilon)
        tmin_new = jnp.where(cutout, hit.t * (1.0 + 1e-4) + 1e-4,
                             read(s['tmin']))
        done = read(s['done']) | accept | miss
        new = dict(tmin=tmin_new, done=done, t=t, tri=tri, inst=inst,
                   a=a, b=b)
        if sel is None:
            return new
        return {k: s[k].at[sel].set(v) for k, v in new.items()}

    # pass 0: everyone
    hit = trace_once(o, d, time_b, s['tmin'], tmax_b, any_hit)
    s = update(s, hit, None)

    def one_pass(s, Rp):
        # stable partition: live rays to the front
        live = (~s['done']).astype(jnp.int32)
        cl = jnp.cumsum(live)
        cd = jnp.cumsum(1 - live)
        pos = jnp.where(live > 0, cl - 1, cl[-1] + cd - 1)  # dest slot
        perm = jnp.zeros_like(pos).at[pos].set(
            jnp.arange(R, dtype=pos.dtype))
        sel = perm[:Rp]
        tmax_eff = jnp.where(s['done'][sel], jnp.float32(-1.0),
                             tmax_b[sel])
        hit = trace_once(o[sel], d[sel], time_b[sel], s['tmin'][sel],
                         tmax_eff, any_hit)
        return update(s, hit, sel)

    for p in range(1, max_passes):
        Rp = min(R, max(4096, R >> (p + 1)))
        Rp = -(-Rp // 256) * 256 if Rp < R else R
        # skip the whole pass once every ray is settled (e.g. shadow
        # wavefronts that finish in one or two passes)
        s = jax.lax.cond(jnp.any(~s['done']),
                         lambda s, Rp=Rp: one_pass(s, Rp),
                         lambda s: s, s)

    return Hit(t=s['t'], tri=s['tri'], inst=s['inst'],
               a=s['a'], b=s['b'])
