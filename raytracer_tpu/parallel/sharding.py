"""Multi-chip scale-out: rays sharded over the device mesh via shard_map.

The reference's only parallelism is OpenMP dynamic scheduling of 32x32 pixel
buckets over CPU threads (src/Scene.cpp:111-201). The device equivalent
(SURVEY.md §2.2): shard the flattened ray/pixel dimension over a 1-D 'rays'
mesh axis (the GPUs of a host are joined all to all, so the mesh needs no
topology), replicate scene/BVH/materials per device, and let shard_map's
transpose insert the psum that all-reduces parameter gradients — the analogue
of the reference's post-render counter reduction (src/Scene.cpp:202-208), but
for gradients.

Scaling beyond replicated geometry: render_geometry_sharded shards the
cluster table instead and rotates ray state with ppermute rounds
(ops/ring_trace.py — the ring-attention analogue).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.types import Scene, Camera, RenderSettings
from ..render import camera as cam_mod
from ..render import integrator

AXIS = 'rays'


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (AXIS,))


def _render_local(scene, cam, settings: RenderSettings, spp: int,
                  px, py, key):
    """Per-device ray-chunk render (same estimator as renderer.render)."""
    n = px.shape[0]

    def body(acc, s):
        k = jax.random.fold_in(key, s)
        k1, k2 = jax.random.split(k)
        rands = jax.random.uniform(k1, (n, 5))
        o, d, t = cam_mod.eye_rays(cam, settings.width, settings.height,
                                   px, py, 0.0, 1.0, 0.0, 1.0, rands)
        L = integrator.radiance(scene, settings, o, d, t, k2)
        return acc + L, None

    init = jnp.zeros_like(px)[:, None] + jnp.zeros((n, 3), jnp.float32)
    acc, _ = jax.lax.scan(body, init, jnp.arange(spp, dtype=jnp.int32))
    return acc / spp


@partial(jax.jit, static_argnames=('settings', 'spp', 'mesh'))
def render_sharded(scene: Scene, cam: Camera, settings: RenderSettings,
                   key: jax.Array, mesh: Mesh, spp: int = 1) -> jax.Array:
    """Data-parallel render over the mesh -> (H, W, 3) on the host layout."""
    W, H = settings.width, settings.height
    R = W * H
    n_dev = mesh.devices.size
    pad = (-R) % n_dev
    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing='ij')
    px = jnp.concatenate([xs.reshape(-1), jnp.zeros(pad, jnp.float32)])
    py = jnp.concatenate([ys.reshape(-1), jnp.zeros(pad, jnp.float32)])

    def fn(scene, cam, px, py, key):
        # decorrelate RNG across shards
        key = jax.random.fold_in(key, jax.lax.axis_index(AXIS))
        return _render_local(scene, cam, settings, spp, px, py, key)

    out = jax.shard_map(fn, mesh=mesh,
                    in_specs=(P(), P(), P(AXIS), P(AXIS), P()),
                    out_specs=P(AXIS))(scene, cam, px, py, key)
    return out[:R].reshape(H, W, 3)


@partial(jax.jit, static_argnames=('settings', 'spp', 'mesh'))
def render_geometry_sharded(scene: Scene, cam: Camera,
                            settings: RenderSettings, key: jax.Array,
                            mesh: Mesh, spp: int = 1) -> jax.Array:
    """Primitive-sharded render: clusters sharded over the mesh, rays
    resident, ppermute ring rounds (ops/ring_trace.py — the ring-attention
    analogue, SURVEY §2.2). For scenes whose geometry exceeds per-chip HBM;
    forward rendering only in v1 (vertex-refresh of sharded tables is future
    work).
    """
    from ..ops.ring_trace import shard_clusters

    assert scene.clusters is not None, 'geometry sharding needs clusters'
    W, H = settings.width, settings.height
    R = W * H
    n_dev = mesh.devices.size
    cl = shard_clusters(scene.clusters, n_dev)
    scene_stripped = scene.replace(clusters=None)
    settings = settings.replace(intersector='ring')
    pad = (-R) % n_dev
    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing='ij')
    px = jnp.concatenate([xs.reshape(-1), jnp.zeros(pad, jnp.float32)])
    py = jnp.concatenate([ys.reshape(-1), jnp.zeros(pad, jnp.float32)])

    def fn(scene_s, cl_shard, px, py, key):
        s = scene_s.replace(clusters=cl_shard)
        key = jax.random.fold_in(key, jax.lax.axis_index(AXIS))
        return _render_local(s, cam, settings, spp, px, py, key)

    out = jax.shard_map(fn, mesh=mesh,
                    in_specs=(P(), P(AXIS), P(AXIS), P(AXIS), P()),
                    out_specs=P(AXIS))(scene_stripped, cl, px, py, key)
    return out[:R].reshape(H, W, 3)


# ---------------------------------------------------------------------------
# Differentiable multi-chip training step (inverse rendering)
# ---------------------------------------------------------------------------

def get_params(scene: Scene) -> dict:
    """The BASELINE-designated differentiable leaves: vertex positions,
    material albedo/shininess, light intensities, texture texels."""
    return dict(
        vertices=scene.geom.vertices,
        kd=scene.materials.kd,
        spec_exp=scene.materials.spec_exp,
        tex_data=scene.textures.data,
        point_power=scene.point_lights.power,
        rect_power=scene.rect_lights.power,
    )


def apply_params(scene: Scene, params: dict, refresh: bool = True) -> Scene:
    shift = params['vertices'] - scene.geom.vertices
    geom = scene.geom.replace(vertices=params['vertices'],
                              vertices_t1=scene.geom.vertices_t1 + shift)
    # the cluster tables bake vertex positions host-side; refresh them
    # device-side or the tracer intersects the ORIGINAL geometry and the
    # render is frozen w.r.t. vertex params (refine_hit pins forward values
    # to the traversal's hit). The refresh affects the FORWARD hit search
    # only — every tracer stop-gradients its tables and refine_hit
    # recomputes (t,a,b) from geom.vertices — so per-step callers hoist it
    # out of the tile loop (refresh=False after one refreshed base scene).
    clusters = scene.clusters
    if refresh and clusters is not None:
        from ..geometry.clusters import refresh_clusters
        clusters = refresh_clusters(clusters, geom, scene.has_motion_blur)
    return scene.replace(
        geom=geom, clusters=clusters,
        materials=scene.materials.replace(kd=params['kd'],
                                          spec_exp=params['spec_exp']),
        textures=scene.textures.replace(data=params['tex_data']),
        point_lights=scene.point_lights.replace(power=params['point_power']),
        rect_lights=scene.rect_lights.replace(power=params['rect_power']),
    )


@partial(jax.jit, static_argnames=('settings', 'spp', 'mesh'))
def loss_and_grads(params: dict, scene: Scene, cam: Camera,
                   settings: RenderSettings, target: jax.Array,
                   key: jax.Array, mesh: Mesh, spp: int = 1):
    """MSE inverse-rendering loss + grads, rays sharded over the mesh.

    Parameter gradients are automatically all-reduced by the shard_map
    transpose (replicated-in -> psum-of-cotangents), overlapping with the
    backward wavefront where XLA schedules it.
    """
    def loss_fn(p):
        s = apply_params(scene, p)
        img = render_sharded(s, cam, settings, key, mesh, spp)
        return jnp.mean((img - target) ** 2)

    return jax.value_and_grad(loss_fn)(params)


@partial(jax.jit, static_argnames=('settings', 'spp'))
def _tile_loss_grad(params, scene, cam, settings: RenderSettings,
                    target, px, py, msk, key, spp: int):
    """Sum-of-squares loss + grads for ONE ray tile (jitted once, reused).

    msk zeroes the padding lanes of the last tile (they alias pixel (0,0)
    against a zero target and would otherwise pollute loss AND grads).
    """
    def loss_fn(p):
        s = apply_params(scene, p)
        L = _render_local(s, cam, settings, spp, px, py, key)
        return jnp.sum(msk[:, None] * (L - target) ** 2)

    return jax.value_and_grad(loss_fn)(params)


@partial(jax.jit, static_argnames=('settings', 'spp', 'tile', 'mesh'))
def loss_and_grads_scanned(params: dict, scene: Scene, cam: Camera,
                           settings: RenderSettings, target: jax.Array,
                           key: jax.Array, spp: int = 1,
                           tile: int | None = None,
                           mesh: Mesh | None = None):
    """MSE loss + grads, tiles accumulated by lax.scan INSIDE one program —
    the production fwd+bwd step (bench.py), optionally sharded over a mesh.

    Same estimator as loss_and_grads_streamed (identical per-tile RNG:
    fold_in(key, global_tile_index)), but the tile loop runs on-device, so a
    full frame is ONE dispatch instead of n_tiles host round trips.
    Differentiation happens per tile inside the
    scan body (value_and_grad of the tile loss), so the pathological
    transpose-of-scan-of-traversal program that motivated streaming never
    forms; memory stays bounded by one tile's wavefront + one grad pytree.

    The cluster-table refresh (apply_params) is hoisted OUT of the tile
    loop: it shapes only the forward hit search (tracers stop-gradient the
    tables; refine_hit recomputes from the vertices), so one refresh per
    step replaces n_tiles redundant rebuilds.

    mesh: shard the TILE axis over the device mesh — each device scans its
    own tiles, loss and parameter grads are psum-reduced (the gradient
    all-reduce rides the shard_map transpose, overlapped with the backward
    wavefront where XLA schedules it). Identical estimator to the
    single-device scan (same per-tile keys; summation order differs only by
    the reduction tree).
    """
    W, H = settings.width, settings.height
    R = W * H
    tile = tile or settings.ray_tile
    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing='ij')
    px = xs.reshape(-1)
    py = ys.reshape(-1)
    tgt = target.astype(jnp.float32).reshape(-1, 3)
    msk = jnp.ones(R, jnp.float32)  # zero on padding lanes (they re-render
    pad = (-R) % tile               # pixel (0,0) vs a black target)
    if pad:
        px = jnp.concatenate([px, jnp.zeros(pad, jnp.float32)])
        py = jnp.concatenate([py, jnp.zeros(pad, jnp.float32)])
        tgt = jnp.concatenate([tgt, jnp.zeros((pad, 3), jnp.float32)])
        msk = jnp.concatenate([msk, jnp.zeros(pad, jnp.float32)])
    n_tiles = px.shape[0] // tile
    n_dev = mesh.devices.size if mesh is not None else 1
    tpad = (-n_tiles) % n_dev
    if tpad:  # whole padding tiles (mask 0) to divide tiles over devices
        zt = jnp.zeros(tpad * tile, jnp.float32)
        px = jnp.concatenate([px, zt])
        py = jnp.concatenate([py, zt])
        tgt = jnp.concatenate([tgt, jnp.zeros((tpad * tile, 3), jnp.float32)])
        msk = jnp.concatenate([msk, zt])
        n_tiles += tpad
    px = px.reshape(n_tiles, tile)
    py = py.reshape(n_tiles, tile)
    tgt = tgt.reshape(n_tiles, tile, 3)
    msk = msk.reshape(n_tiles, tile)
    tidx = jnp.arange(n_tiles, dtype=jnp.int32)

    # hoisted per-step refresh (forward-only, see docstring)
    scene_base = apply_params(scene, jax.lax.stop_gradient(params))

    def local_scan(p, s_base, cam_, tidx, px, py, tgt, msk, key):
        def tile_loss(p, pxt, pyt, tgt_t, msk_t, k):
            s = apply_params(s_base, p, refresh=False)
            L = _render_local(s, cam_, settings, spp, pxt, pyt, k)
            return jnp.sum(msk_t[:, None] * (L - tgt_t) ** 2)

        def body(carry, inp):
            total, grads = carry
            ti, pxt, pyt, tgt_t, msk_t = inp
            k = jax.random.fold_in(key, ti)
            l, g = jax.value_and_grad(tile_loss)(p, pxt, pyt, tgt_t,
                                                 msk_t, k)
            return (total + l,
                    jax.tree_util.tree_map(jnp.add, grads, g)), None

        # derive the init from the sharded tile arrays so the carry's
        # varying type matches the loop outputs under shard_map (vma)
        zero = px[0, 0] * 0.0
        init = (jnp.float32(0.0) + zero,
                jax.tree_util.tree_map(
                    lambda x: jnp.zeros_like(x) + zero.astype(x.dtype), p))
        (total, grads), _ = jax.lax.scan(body, init,
                                         (tidx, px, py, tgt, msk))
        return total, grads

    if mesh is None:
        total_loss, grads = local_scan(params, scene_base, cam, tidx, px,
                                       py, tgt, msk, key)
    else:
        def fn(p, s_base, cam_, tidx, px, py, tgt, msk, key):
            # make the replicated params VARYING before differentiating:
            # jax's vma-aware AD would otherwise auto-psum the cotangent of
            # an unvarying input (the per-device grad would already be the
            # global sum) and the explicit psum below would double it
            p = jax.tree_util.tree_map(
                lambda x: jax.lax.pcast(x, (AXIS,), to='varying'), p)
            total, grads = local_scan(p, s_base, cam_, tidx, px, py, tgt,
                                      msk, key)
            return jax.lax.psum(total, AXIS), jax.lax.psum(grads, AXIS)

        total_loss, grads = jax.shard_map(
            fn, mesh=mesh,
            in_specs=(P(), P(), P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                      P(AXIS), P()),
            out_specs=(P(), P()))(params, scene_base, cam, tidx, px, py,
                                  tgt, msk, key)
    scale = 1.0 / (R * 3)
    grads = jax.tree_util.tree_map(lambda x: x * scale, grads)
    return total_loss * scale, grads


def loss_and_grads_streamed(params: dict, scene: Scene, cam: Camera,
                            settings: RenderSettings, target: jax.Array,
                            key: jax.Array, spp: int = 1,
                            tile: int | None = None):
    """MSE loss + grads accumulated tile-by-tile with a host loop.

    The all-in-one-graph grad (`loss_and_grads`) asks the compiler to
    transpose a scan-over-tiles of scan-over-bounces of traversal loops,
    whose residuals grow with the whole frame at production ray counts.
    Streaming mirrors the reference's bucket farm (src/Scene.cpp:160-200):
    one compiled fwd+bwd per tile shape, host accumulation — identical
    gradients (sums commute), bounded memory, O(n_tiles) dispatches.
    """
    W, H = settings.width, settings.height
    R = W * H
    tile = tile or settings.ray_tile
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing='ij')
    px = xs.reshape(-1)
    py = ys.reshape(-1)
    tgt = np.asarray(target, np.float32).reshape(-1, 3)
    msk = np.ones(R, np.float32)
    pad = (-R) % tile
    if pad:
        px = np.concatenate([px, np.zeros(pad, np.float32)])
        py = np.concatenate([py, np.zeros(pad, np.float32)])
        tgt = np.concatenate([tgt, np.zeros((pad, 3), np.float32)])
        msk = np.concatenate([msk, np.zeros(pad, np.float32)])
    n_tiles = px.shape[0] // tile

    total_loss = 0.0
    grads = jax.tree_util.tree_map(jnp.zeros_like, params)
    for ti in range(n_tiles):
        sl = slice(ti * tile, (ti + 1) * tile)
        k = jax.random.fold_in(key, ti)
        l, g = _tile_loss_grad(params, scene, cam, settings,
                               jnp.asarray(tgt[sl]), jnp.asarray(px[sl]),
                               jnp.asarray(py[sl]), jnp.asarray(msk[sl]),
                               k, spp)
        total_loss = total_loss + l
        grads = jax.tree_util.tree_map(jnp.add, grads, g)
    scale = 1.0 / (R * 3)
    grads = jax.tree_util.tree_map(lambda x: x * scale, grads)
    return total_loss * scale, grads


@partial(jax.jit, static_argnames=('settings', 'spp', 'mesh'))
def loss_and_grads_geometry_sharded(params: dict, scene: Scene, cam: Camera,
                                    settings: RenderSettings,
                                    target: jax.Array, key: jax.Array,
                                    mesh: Mesh, spp: int = 1):
    """MSE loss + grads with the CLUSTER TABLE sharded over the mesh
    (beyond-HBM geometry): rays are also sharded; each device ring-traces
    its ray shard against the rotating cluster shards (ops/ring_trace.py)
    and the loss/grad partials psum.

    Differentiable-vertex support: each device refreshes ITS cluster shard
    from the current (replicated) vertex params inside shard_map — the
    refresh is row-local (a gather from the replicated vertex array), so no
    collective is needed and the sharded tables track vertex updates
    exactly like the replicated path (apply_params). The refresh shapes
    only the forward hit search (tracers stop-gradient their tables;
    refine_hit recomputes from the vertices), so it runs under
    stop_gradient.

    Same estimator and RNG as loss_and_grads (rays sharded,
    fold_in(axis_index) per shard): on an exact tracer the two agree to
    reduction order.
    """
    from ..ops.ring_trace import shard_clusters
    from ..geometry.clusters import refresh_clusters

    assert scene.clusters is not None, 'geometry sharding needs clusters'
    W, H = settings.width, settings.height
    R = W * H
    n_dev = mesh.devices.size
    cl = shard_clusters(scene.clusters, n_dev)
    scene_stripped = scene.replace(clusters=None)
    settings = settings.replace(intersector='ring')
    pad = (-R) % n_dev
    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing='ij')
    px = jnp.concatenate([xs.reshape(-1), jnp.zeros(pad, jnp.float32)])
    py = jnp.concatenate([ys.reshape(-1), jnp.zeros(pad, jnp.float32)])
    tgt = jnp.concatenate([target.astype(jnp.float32).reshape(-1, 3),
                           jnp.zeros((pad, 3), jnp.float32)])
    msk = jnp.concatenate([jnp.ones(R, jnp.float32),
                           jnp.zeros(pad, jnp.float32)])

    def fn(p, scene_s, cam_, cl_shard, px, py, tgt, msk, key):
        p = jax.tree_util.tree_map(
            lambda x: jax.lax.pcast(x, (AXIS,), to='varying'), p)
        key = jax.random.fold_in(key, jax.lax.axis_index(AXIS))

        # forward-only refresh of THIS device's cluster shard
        sg = jax.lax.stop_gradient
        shift = sg(p['vertices']) - scene_s.geom.vertices
        geom_f = scene_s.geom.replace(
            vertices=sg(p['vertices']),
            vertices_t1=scene_s.geom.vertices_t1 + shift)
        cl2 = refresh_clusters(cl_shard, geom_f, scene_s.has_motion_blur)
        s_base = scene_s.replace(clusters=cl2)

        def loss_fn(pp):
            s = apply_params(s_base, pp, refresh=False)
            L = _render_local(s, cam_, settings, spp, px, py, key)
            return jnp.sum(msk[:, None] * (L - tgt) ** 2)

        l, g = jax.value_and_grad(loss_fn)(p)
        return jax.lax.psum(l, AXIS), jax.lax.psum(g, AXIS)

    total, grads = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                  P(AXIS), P()),
        out_specs=(P(), P()))(params, scene_stripped, cam, cl, px, py,
                              tgt, msk, key)
    scale = 1.0 / (R * 3)
    grads = jax.tree_util.tree_map(lambda x: x * scale, grads)
    return total * scale, grads


def train_step(params, opt_state, optimizer, scene, cam, settings, target,
               key, mesh=None, spp: int = 1, tile: int | None = None):
    """One optimizer step of differentiable texture/light/geometry fitting
    (BASELINE config #5: "differentiable texture/light optimization").

    Uses the production scanned fwd+bwd (tiles sharded over `mesh` when
    given) — the same program bench.py measures."""
    loss, grads = loss_and_grads_scanned(params, scene, cam, settings,
                                         target, key, spp=spp, tile=tile,
                                         mesh=mesh)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    import optax
    params = optax.apply_updates(params, updates)
    return params, opt_state, loss
