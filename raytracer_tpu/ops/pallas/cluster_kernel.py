"""Block-coherent cluster traversal as a Pallas kernel for the GPU (Triton).

The kernel form of ops/cluster_trace.py. One program owns a block of RB rays
and walks the whole cluster table (geometry/clusters.py) in SAH build order,
keeping each ray's best hit in registers from the first cluster to the last.
The walk goes G clusters at a time:

  1. slab-test the block's rays against the G cluster boxes at once, an
     (RB, G) tile read from SoA box rows (the reference's QBVH box test,
     src/BVH.cpp:391-414, widened to RB rays x G boxes);
  2. visit only the clusters that some ray enters; re-test each one's box
     with the rays' current best t and skip it when no ray can improve;
  3. otherwise Moller-Trumbore-test the cluster's 128 triangles against
     the block as (RB, TC) tiles (the reference's TriCache4 intersect4,
     src/BVH.cpp:1297-1459, widened 4 -> TC lanes) and keep the nearest
     (t, triangle id).

Any-hit rays (shadow rays) stop the walk once every ray of the block has a
hit; blocks whose rays are all disabled (tmax < 0: dead wavefront lanes,
finished alpha-march rays, padding) do no work. The table stays in device
memory and is read through the L2 cache; only the winning (t, tri, a, b)
per ray is written back.

Motion blur lerps the MT basis by per-ray time (linear in the vertices, so
identical to lerping vertices, reference src/MBObject.cpp:26-107).
Alpha-cutout scenes are handled outside the kernel: callers re-trace past
cutout hits (cluster_trace.alpha_aware_trace). Two-level scenes trace
through the BVH.

The kernel is compiled for the GPU only. Elsewhere it runs solely when the
caller asks for the Pallas interpreter (`interpret=True`, used by the CPU
tests); it never falls back to it on its own.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ...core.types import Scene
from ...core.vecmath import MIRO_TMAX
from ..intersect import Hit

BIG = np.float32(3e38)
INT_MAX = np.int32(2 ** 31 - 1)
DEF_RB = 16        # rays per program
DEF_TC = 32        # triangle lanes per MT tile (a cluster is C // TC tiles)
DEF_WARPS = 4
DEF_GROUP = 32     # clusters per group box test
NEVER = np.float32(3e37)   # padding clusters: a far-away point box


def _rcp(v):
    tiny = 1e-20
    return 1.0 / jnp.where(jnp.abs(v) < tiny,
                           jnp.where(v < 0, -tiny, tiny), v)


def _any(mask):
    """jnp.any for the Triton route, which lowers no boolean reduction."""
    return jnp.max(mask.astype(jnp.int32)) > 0


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmin_ref,
            tmax_ref, time_ref, bb_ref, p0_ref, e1_ref, e2_ref, q0_ref,
            q1_ref, q2_ref, tri_ref, t_out, tri_out, a_out, b_out,
            *, any_hit: bool, mb: bool, NG: int, G: int, C: int, TC: int):
    f32 = jnp.float32
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    tmin, tmax = tmin_ref[...], tmax_ref[...]
    ix, iy, iz = _rcp(dx), _rcp(dy), _rcp(dz)
    live = tmax > 0.0
    col = lambda v: v[:, None]                             # (RB,) -> (RB, 1)
    time = col(time_ref[...]) if mb else None
    glane = jnp.arange(G, dtype=jnp.int32)                 # (G,)

    rays = (ox, oy, oz, ix, iy, iz, tmin, tmax)

    def viable_rays(bounds, rays, best_t, best_tri):
        """Rays that enter the box(es) and could improve on their best hit.
        Rays and bounds broadcast: (RB,) rays against one cluster's scalar
        bounds, or (RB, 1) rays against a group's (1, G) bound rows."""
        ox, oy, oz, ix, iy, iz, tmin, tmax = rays
        lox, loy, loz, hix, hiy, hiz = bounds
        t0x, t1x = (lox - ox) * ix, (hix - ox) * ix
        t0y, t1y = (loy - oy) * iy, (hiy - oy) * iy
        t0z, t1z = (loz - oz) * iz, (hiz - oz) * iz
        near = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                       jnp.minimum(t0y, t1y)),
                           jnp.minimum(t0z, t1z))
        far = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                      jnp.maximum(t0y, t1y)),
                          jnp.maximum(t0z, t1z))
        ok = (near <= far) & (far >= tmin) & (near <= tmax) \
            & (jnp.maximum(near, 0.0) <= best_t)
        if any_hit:
            ok = ok & (best_tri < 0)
        return ok

    def basis(ref, ref_t1, c, comp, j0):
        v = ref[3 * c + comp, pl.ds(j0, TC)][None, :]       # (1, TC)
        if mb:
            v1 = ref_t1[3 * c + comp, pl.ds(j0, TC)][None, :]
            v = v + time * (v1 - v)                        # (RB, TC)
        return v

    def mt_cluster(c, viable, best):
        """MT-test cluster c's triangles against the block's viable rays."""
        for j0 in range(0, C, TC):
            best_t, best_tri, best_a, best_b = best
            p0x, p0y, p0z = (basis(p0_ref, q0_ref, c, k, j0) for k in range(3))
            e1x, e1y, e1z = (basis(e1_ref, q1_ref, c, k, j0) for k in range(3))
            e2x, e2y, e2z = (basis(e2_ref, q2_ref, c, k, j0) for k in range(3))
            tid = tri_ref[c, pl.ds(j0, TC)][None, :]       # (1, TC)
            # pvec = d x e2
            pvx = col(dy) * e2z - col(dz) * e2y
            pvy = col(dz) * e2x - col(dx) * e2z
            pvz = col(dx) * e2y - col(dy) * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            inv_det = 1.0 / det
            tvx = col(ox) - p0x
            tvy = col(oy) - p0y
            tvz = col(oz) - p0z
            a = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            # qvec = tvec x e1
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            b = (col(dx) * qvx + col(dy) * qvy + col(dz) * qvz) * inv_det
            t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            ok = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (a + b <= 1.0) \
                & (det != 0.0) & (tid >= 0) & col(viable) \
                & (t >= col(tmin)) & (t <= col(best_t))
            # nearest (t, triangle id): among equal t the smallest id wins,
            # so the hit does not depend on the cluster walk's order
            th = jnp.where(ok, t, BIG)
            t_c = jnp.min(th, axis=1)                      # (RB,)
            cand = ok & (th == col(t_c))
            tid_c = jnp.min(jnp.where(cand, tid, INT_MAX), axis=1)
            got = (t_c < best_t) | ((t_c == best_t) & (best_tri >= 0)
                                    & (tid_c < best_tri))
            got = got & (t_c < BIG)
            sel = cand & (tid == col(tid_c))               # (RB, TC)

            def pick(v, old):
                return jnp.where(got, jnp.sum(jnp.where(sel, v, 0.0),
                                              axis=1), old)

            best = (jnp.where(got, t_c, best_t),
                    jnp.where(got, tid_c, best_tri), pick(a, best_a),
                    pick(b, best_b))
        return best

    def pending(best_tri):
        return _any(live & (best_tri < 0) if any_hit else live)

    def cluster_step(c, best):
        """Re-test cluster c's box with the current best t, then MT-test
        its triangles if any ray of the block is still viable."""
        bounds = tuple(bb_ref[k, c] for k in (0, 1, 2, 4, 5, 6))
        viable = viable_rays(bounds, rays, best[0], best[1])
        return jax.lax.cond(_any(viable),
                            lambda bst: mt_cluster(c, viable, bst),
                            lambda bst: bst, best)

    def group_step(g, best):
        """Slab-test the block against the G cluster boxes of group g at
        once, then visit only the clusters that some ray can enter."""
        bounds = tuple(bb_ref[k, pl.ds(g * G, G)][None, :]
                       for k in (0, 1, 2, 4, 5, 6))        # (1, G) each
        hits = viable_rays(bounds, tuple(map(col, rays)), col(best[0]),
                           col(best[1]))                   # (RB, G)
        todo = jnp.max(hits.astype(jnp.int32), axis=0)     # (G,)

        def cond(s):
            todo, best = s
            return (jnp.max(todo) > 0) & pending(best[1])

        def body(s):
            todo, best = s
            j = jnp.argmax(todo).astype(jnp.int32)         # first viable
            best = cluster_step(g * G + j, best)
            return jnp.where(glane == j, 0, todo), best

        return jax.lax.while_loop(cond, body, (todo, best))[1]

    def cond(s):
        g, best = s
        return (g < NG) & pending(best[1])

    def body(s):
        g, best = s
        return g + 1, group_step(g, best)

    zero = jnp.zeros_like(ox)
    init = (jnp.minimum(tmax, f32(MIRO_TMAX)), zero.astype(jnp.int32) - 1,
            zero, zero)
    _, (best_t, best_tri, best_a, best_b) = jax.lax.while_loop(
        cond, body, (jnp.int32(0), init))
    t_out[...] = jnp.where(best_tri >= 0, best_t, f32(MIRO_TMAX))
    tri_out[...] = best_tri
    a_out[...] = best_a
    b_out[...] = best_b


def check_route(interpret: bool) -> None:
    """Raise unless the kernel can run as asked on the default backend:
    compiled on a GPU, or through the Pallas interpreter on the CPU."""
    backend = jax.default_backend()
    if interpret and backend != 'cpu':
        raise RuntimeError(
            f'interpret=True on the {backend} backend would run the kernel '
            'in the Pallas interpreter instead of on the device')
    if not interpret and backend != 'gpu':
        raise RuntimeError(
            f'the cluster kernel is compiled for the GPU (Pallas Triton); on '
            f"the {backend} backend pass interpret=True or use "
            "intersector='cluster' / 'bvh'")


def pallas_cluster_trace(scene: Scene, o, d, time, tmin, tmax,
                         any_hit: bool = False, rb: int = DEF_RB,
                         tc: int = DEF_TC, num_warps: int = DEF_WARPS,
                         group: int = DEF_GROUP,
                         interpret: bool = False) -> Hit:
    """Trace a wavefront with the cluster kernel -> Hit.

    o, d: (R, 3); time/tmin/tmax scalar or (R,). Single-level scenes
    (scene.clusters); callers gate on the scene (render.integrator.trace_fn).
    Gradients do not flow (ids + pinned floats; intersect.refine_hit
    recomputes differentiably). interpret=True runs the Pallas interpreter
    and is accepted only on the CPU backend.
    """
    check_route(interpret)
    if scene.clusters is None:
        raise ValueError('the cluster kernel needs a single-level scene '
                         'with a cluster table (scene.clusters)')
    return _trace(scene, o, d, time, tmin, tmax, any_hit=any_hit, rb=rb,
                  tc=tc, num_warps=num_warps, group=group,
                  interpret=interpret)


@partial(jax.jit, static_argnames=('any_hit', 'rb', 'tc', 'num_warps',
                                   'group', 'interpret'))
def _trace(scene: Scene, o, d, time, tmin, tmax, *, any_hit, rb, tc,
           num_warps, group, interpret) -> Hit:
    # pallas_call has no JVP rule: every operand must be tangent-free (a
    # shadow ray's tmax depends on the vertices, for one)
    sg = jax.lax.stop_gradient
    cl = sg(scene.clusters)
    o, d, time, tmin, tmax = (sg(x) for x in (o, d, time, tmin, tmax))
    f32 = jnp.float32
    R = o.shape[0]
    M, _, C = cl.p0.shape
    assert C % tc == 0, (C, tc)
    mb = scene.has_motion_blur
    tmin, tmax, time = (jnp.broadcast_to(jnp.asarray(x, f32), (R,))
                        for x in (tmin, tmax, time))

    pad = (-R) % rb
    Rp = R + pad

    def padded(v, fill=0.0):
        return jnp.pad(v, ((0, pad),), constant_values=fill)

    rays = [padded(o[:, 0]), padded(o[:, 1]), padded(o[:, 2]),
            padded(d[:, 0]), padded(d[:, 1]), padded(d[:, 2]),
            padded(tmin), padded(tmax, -1.0), padded(time)]

    # whole groups of clusters: padding clusters have point boxes that no
    # ray enters and no triangles
    mpad = (-M) % group
    Mp = M + mpad
    bb = jnp.full((8, Mp), NEVER, f32)                     # SoA box rows
    bb = bb.at[0:3, :M].set(cl.bb_min.T).at[4:7, :M].set(cl.bb_max.T)

    def table(x):
        x = jnp.pad(jnp.asarray(x, f32), ((0, mpad), (0, 0), (0, 0)))
        return x.reshape(Mp * 3, C)

    p0, e1, e2 = table(cl.p0), table(cl.e1), table(cl.e2)
    if mb:
        q0, q1, q2 = table(cl.p0_t1), table(cl.e1_t1), table(cl.e2_t1)
    else:
        # never read: a tiny placeholder instead of a second table copy
        q0 = q1 = q2 = jnp.zeros((3, C), f32)
    tri = jnp.pad(jnp.asarray(cl.tri, jnp.int32), ((0, mpad), (0, 0)),
                  constant_values=-1)

    whole = lambda x: pl.BlockSpec(x.shape, lambda i: (0,) * x.ndim)
    ray_spec = pl.BlockSpec((rb,), lambda i: (i,))
    tables = [bb, p0, e1, e2, q0, q1, q2, tri]

    # under shard_map outputs declare how they vary over mesh axes: like
    # the ray inputs (cluster tables are replicated)
    vma = jax.typeof(rays[0]).vma
    out = lambda dt: jax.ShapeDtypeStruct((Rp,), dt, vma=vma)
    t, tri_id, a, b = pl.pallas_call(
        partial(_kernel, any_hit=any_hit, mb=mb, NG=Mp // group, G=group,
                C=C, TC=tc),
        grid=(Rp // rb,),
        in_specs=[ray_spec] * 9 + [whole(x) for x in tables],
        out_specs=[ray_spec] * 4,
        out_shape=[out(f32), out(jnp.int32), out(f32), out(f32)],
        backend='triton',
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name='cluster_trace_kernel',
    )(*rays, *tables)
    return Hit(t=t[:R], tri=tri_id[:R], inst=jnp.zeros((R,), jnp.int32),
               a=a[:R], b=b[:R])
