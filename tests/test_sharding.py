"""Multi-chip sharding tests on the 8-virtual-CPU-device mesh.

VERDICT round-1 item 3: the sharding module had zero coverage. These tests
pin the shard_map plumbing against manually-computed per-shard references
(exact equality — sharding must only partition work, never change the
estimator) and exercise the full training loop on a BVH scene.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracer_tpu.parallel import sharding
from raytracer_tpu.scenes import registry

pytestmark = pytest.mark.slow  # multi-replica renders / FD sweeps

SIZE = 16


def _scene():
    return registry.make('cornell_pt', size=SIZE, bvh=True,
                         num_rect_samples=1, max_bounces=2)


def _scene_small():
    """8x8 variant for collective-heavy (psum-inside-shard_map) tests: XLA
    CPU's in-process collective watchdog aborts when virtual replicas of a
    heavy program straggle on this 2-core box."""
    return registry.make('cornell_pt', size=8, bvh=True,
                         num_rect_samples=1, max_bounces=2)


def _manual_sharded_render(scene, cam, settings, key, n_dev, spp=1):
    """Replica of render_sharded's estimator: per-shard fold_in(axis_index)
    then _render_local on that shard's pixel chunk."""
    W, H = settings.width, settings.height
    R = W * H
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing='ij')
    px = xs.reshape(-1)
    py = ys.reshape(-1)
    pad = (-R) % n_dev
    px = np.concatenate([px, np.zeros(pad, np.float32)])
    py = np.concatenate([py, np.zeros(pad, np.float32)])
    chunk = px.shape[0] // n_dev
    outs = []
    for i in range(n_dev):
        sl = slice(i * chunk, (i + 1) * chunk)
        k = jax.random.fold_in(key, i)
        outs.append(sharding._render_local(
            scene, cam, settings, spp,
            jnp.asarray(px[sl]), jnp.asarray(py[sl]), k))
    out = jnp.concatenate(outs)[:R]
    return out.reshape(H, W, 3)


def test_render_sharded_matches_manual():
    scene, cam, settings = _scene()
    key = jax.random.PRNGKey(7)
    mesh = sharding.make_mesh(8)
    img = sharding.render_sharded(scene, cam, settings, key, mesh, spp=1)
    ref = jax.jit(_manual_sharded_render,
                  static_argnames=('settings', 'n_dev', 'spp'))(
        scene, cam, settings, key, 8, 1)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    assert np.asarray(img).max() > 0.0


def test_loss_and_grads_matches_manual():
    """shard_map's transpose (psum of replicated-param cotangents) must give
    the same gradients as differentiating the manual per-shard replica.

    Runs in a FRESH subprocess (tests/check_loss_grads_manual.py): this
    8-replica whole-image gradient program reproducibly segfaults XLA's
    in-process CPU collectives when executed late in the full suite
    (accumulated executables on the 2-core box) while passing in
    isolation.
    """
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    r = subprocess.run(
        [sys.executable, '-u',
         os.path.join(repo, 'tests', 'check_loss_grads_manual.py')],
        env=env, cwd=repo, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert 'ok' in r.stdout


def test_train_step_decreases_loss():
    """BASELINE config: differentiable light/albedo fitting on cornell with
    BVH — loss must decrease over a few adam steps.

    2-device mesh: XLA CPU's in-process all-reduce aborts ("AwaitAndLogIfStuck")
    when 8 virtual replicas of a heavy program straggle on this 2-core box;
    the 8-way psum correctness is pinned by test_loss_and_grads_matches_manual.
    """
    import optax
    scene, cam, settings = _scene_small()
    key = jax.random.PRNGKey(0)
    mesh = sharding.make_mesh(2)

    # target: the scene itself rendered at higher light power
    bright = scene.replace(rect_lights=scene.rect_lights.replace(
        power=scene.rect_lights.power * 2.0))
    target = sharding.render_sharded(bright, cam, settings, key, mesh, spp=1)
    H = settings.height

    params = sharding.get_params(scene)
    # optimize only the smooth light-power params: adam-sized vertex steps
    # cause discontinuous visibility jumps that make a 3-step decrease
    # assertion meaningless (edge gradients are a separate work item)
    optimizer = optax.multi_transform(
        {'fit': optax.adam(0.5), 'freeze': optax.set_to_zero()},
        {k: ('fit' if k in ('rect_power', 'point_power') else 'freeze')
         for k in params})
    opt_state = optimizer.init(params)
    losses = []
    for i in range(4):
        params, opt_state, loss = sharding.train_step(
            params, opt_state, optimizer, scene, cam, settings, target,
            key, mesh, spp=1, tile=32)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    # the fitted power moved toward the 2x-bright target
    assert float(params['rect_power'][0]) > float(
        sharding.get_params(scene)['rect_power'][0])


def test_streamed_grads_match_unstreamed_estimator():
    """loss_and_grads_streamed accumulates per-tile sums; with a single tile
    covering the image and the same RNG key structure it must equal the
    direct jit'd tile grad."""
    scene, cam, settings = _scene()
    key = jax.random.PRNGKey(5)
    params = sharding.get_params(scene)
    target = jnp.zeros((SIZE, SIZE, 3), jnp.float32)
    R = SIZE * SIZE

    loss_s, grads_s = sharding.loss_and_grads_streamed(
        params, scene, cam, settings, target, key, spp=1, tile=R)

    ys, xs = np.meshgrid(np.arange(SIZE, dtype=np.float32),
                         np.arange(SIZE, dtype=np.float32), indexing='ij')
    l, g = sharding._tile_loss_grad(
        params, scene, cam, settings, target.reshape(-1, 3),
        jnp.asarray(xs.reshape(-1)), jnp.asarray(ys.reshape(-1)),
        jnp.ones(R, jnp.float32), jax.random.fold_in(key, 0), 1)
    scale = 1.0 / (R * 3)
    np.testing.assert_allclose(float(loss_s), float(l) * scale, rtol=1e-6)
    for k in grads_s:
        np.testing.assert_allclose(np.asarray(grads_s[k]),
                                   np.asarray(g[k]) * scale,
                                   rtol=1e-5, atol=1e-8)


def test_scanned_grads_match_streamed():
    """loss_and_grads_scanned (on-device tile scan, one dispatch) must equal
    loss_and_grads_streamed (host tile loop) — same per-tile RNG, same sums."""
    scene, cam, settings = _scene()
    key = jax.random.PRNGKey(9)
    params = sharding.get_params(scene)
    target = jnp.zeros((SIZE, SIZE, 3), jnp.float32)
    tile = SIZE * SIZE // 4

    l_sc, g_sc = sharding.loss_and_grads_scanned(
        params, scene, cam, settings, target, key, spp=1, tile=tile)
    l_st, g_st = sharding.loss_and_grads_streamed(
        params, scene, cam, settings, target, key, spp=1, tile=tile)
    np.testing.assert_allclose(float(l_sc), float(l_st), rtol=1e-6)
    for k in g_sc:
        np.testing.assert_allclose(np.asarray(g_sc[k]), np.asarray(g_st[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)


def test_scanned_sharded_matches_single_device():
    """loss_and_grads_scanned with a mesh (tiles sharded, psum of loss +
    grads) must reproduce the single-device scan: the per-tile RNG keys are
    global tile indices, so only the summation tree differs."""
    scene, cam, settings = _scene_small()
    key = jax.random.PRNGKey(11)
    params = sharding.get_params(scene)
    target = jnp.zeros((8, 8, 3), jnp.float32)
    tile = 16  # 4 tiles over a 2-device mesh

    l1, g1 = sharding.loss_and_grads_scanned(
        params, scene, cam, settings, target, key, spp=1, tile=tile)
    mesh = sharding.make_mesh(2)
    l2, g2 = sharding.loss_and_grads_scanned(
        params, scene, cam, settings, target, key, spp=1, tile=tile,
        mesh=mesh)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for k in g1:
        np.testing.assert_allclose(np.asarray(g1[k]), np.asarray(g2[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)


def test_scanned_sharded_pads_tile_count():
    """Tile count not divisible by the mesh: whole zero-mask padding tiles
    must not change loss or grads."""
    scene, cam, settings = _scene_small()
    key = jax.random.PRNGKey(12)
    params = sharding.get_params(scene)
    target = jnp.zeros((8, 8, 3), jnp.float32)
    tile = 8 * 8 // 3 + 1  # 3 tiles -> padded to 4 over 2 devices

    l1, g1 = sharding.loss_and_grads_scanned(
        params, scene, cam, settings, target, key, spp=1, tile=tile)
    mesh = sharding.make_mesh(2)
    l2, g2 = sharding.loss_and_grads_scanned(
        params, scene, cam, settings, target, key, spp=1, tile=tile,
        mesh=mesh)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for k in g1:
        np.testing.assert_allclose(np.asarray(g1[k]), np.asarray(g2[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)


def test_ring_trace_matches_replicated():
    """Geometry-sharded ring tracer (ppermute rounds over cluster shards)
    must find the same hits as the replicated cluster tracer."""
    from jax.sharding import PartitionSpec as P
    from raytracer_tpu.ops import cluster_trace, ring_trace

    scene, cam, settings = _scene()
    key = jax.random.PRNGKey(4)
    R = 64
    # random rays toward the box interior
    k1, k2 = jax.random.split(key)
    o = jnp.asarray([2.5, 2.5, 5.0]) + jax.random.normal(k1, (R, 3)) * 0.5
    tgt = jnp.asarray([2.5, 2.5, -1.0]) + jax.random.normal(k2, (R, 3))
    d = tgt - o
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    time = jnp.zeros(R)

    ref = cluster_trace.cluster_trace(scene, o, d, time, 1e-3, 1e12)

    mesh = sharding.make_mesh(8)
    cl = ring_trace.shard_clusters(scene.clusters, 8)
    scene_s = scene.replace(clusters=None)

    def fn(scene_s, cl_shard, o, d, time):
        s = scene_s.replace(clusters=cl_shard)
        hit = ring_trace.ring_trace(s, o, d, time, 1e-3, 1e12)
        return hit.t, hit.tri, hit.a, hit.b

    t, tri, a, b = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(), P(sharding.AXIS), P(sharding.AXIS),
                  P(sharding.AXIS), P(sharding.AXIS)),
        out_specs=P(sharding.AXIS))(scene_s, cl, o, d, time)

    np.testing.assert_array_equal(np.asarray(tri), np.asarray(ref.tri))
    np.testing.assert_allclose(np.asarray(t), np.asarray(ref.t),
                               rtol=1e-5, atol=1e-5)


def test_geometry_sharded_training_matches_replicated():
    """Geometry-sharded fwd+bwd (clusters sharded, per-shard refresh inside
    shard_map) must reproduce the replicated-geometry loss/grads — with a
    vertex shift applied so the sharded-table refresh actually matters."""
    scene, cam, settings = _scene_small()
    key = jax.random.PRNGKey(13)
    params = sharding.get_params(scene)
    params = dict(params)
    params['vertices'] = params['vertices'] + jnp.asarray([0.0, 0.05, 0.0])
    target = jnp.zeros((8, 8, 3), jnp.float32)
    mesh = sharding.make_mesh(2)

    # the replicated side traces the refreshed cluster table too (the BVH's
    # node boxes are built once on the host and do not follow the shift)
    l1, g1 = sharding.loss_and_grads(params, scene, cam,
                                     settings.replace(intersector='cluster'),
                                     target, key, mesh, spp=1)
    l2, g2 = sharding.loss_and_grads_geometry_sharded(
        params, scene, cam, settings, target, key, mesh, spp=1)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for k in g1:
        # atol covers near-zero vertex grads whose hit-tie routing can
        # differ between the exact tracers (ring vs bvh) at silhouettes
        np.testing.assert_allclose(np.asarray(g1[k]), np.asarray(g2[k]),
                                   rtol=2e-4, atol=3e-5, err_msg=k)
    assert np.abs(np.asarray(g2['vertices'])).max() > 0


def test_render_geometry_sharded_matches_replicated():
    """Primitive-sharded full render == replicated data-parallel render
    (same per-shard RNG; only the tracer differs, and both are exact)."""
    scene, cam, settings = _scene()
    key = jax.random.PRNGKey(6)
    mesh = sharding.make_mesh(8)
    img_ring = sharding.render_geometry_sharded(scene, cam, settings, key,
                                                mesh, spp=1)
    img_rep = sharding.render_sharded(scene, cam, settings, key, mesh, spp=1)
    np.testing.assert_allclose(np.asarray(img_ring), np.asarray(img_rep),
                               rtol=1e-4, atol=1e-5)
