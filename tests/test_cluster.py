"""Cluster wavefront tracer: XLA impl and GPU kernel vs brute force.

Mirrors the reference's implicit BVH validation (BVH results must equal the
linear fallback, src/BVH.cpp:1114-1126); here each tracer backend must agree
hit-for-hit on random rays, including motion blur and any-hit shadow mode.
The Triton kernel runs here through the Pallas interpreter (interpret=True);
chip_smoke.py checks the compiled kernel on the GPU at the bench scene.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracer_tpu.core.vecmath import MIRO_TMAX
from raytracer_tpu.scenes import registry
from raytracer_tpu.ops import intersect, cluster_trace
from raytracer_tpu.ops.pallas import cluster_kernel
from raytracer_tpu.render import integrator


def _kernel(scene, o, d, time, tmin, tmax, any_hit=False, **kw):
    return cluster_kernel.pallas_cluster_trace(scene, o, d, time, tmin, tmax,
                                               any_hit, interpret=True, **kw)


def _random_rays(scene, R, seed):
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    # ignore padding cluster rows (point boxes at +3e37)
    real = np.asarray(scene.clusters.tri)[:, 0] >= 0
    lo = np.asarray(scene.clusters.bb_min)[real].min(0)
    hi = np.asarray(scene.clusters.bb_max)[real].max(0)
    ctr, ext = (lo + hi) / 2, (hi - lo).max()
    o = jnp.asarray(ctr) + jax.random.normal(k1, (R, 3)) * ext
    tgt = jnp.asarray(ctr) + jax.random.uniform(
        k2, (R, 3), minval=-0.5, maxval=0.5) * ext
    d = tgt - o
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    time = jax.random.uniform(k3, (R,))
    return o, d, time


SCENES = ['teapot_blinn', 'cornell_pt', 'mb_bullet']


@pytest.mark.parametrize('name', SCENES)
def test_cluster_trace_matches_brute(name):
    scene, cam, st = registry.make(name, size=16, bvh=True)
    o, d, time = _random_rays(scene, 256, 1)
    hb = intersect.brute_force_trace(scene, o, d, time, 1e-3, 1e12, False)
    hc = cluster_trace.cluster_trace(scene, o, d, time, 1e-3, 1e12, False)
    np.testing.assert_array_equal(np.asarray(hb.tri), np.asarray(hc.tri))
    hit = np.asarray(hb.tri) >= 0
    np.testing.assert_allclose(np.asarray(hb.t)[hit], np.asarray(hc.t)[hit],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('name', SCENES)
def test_pallas_cluster_kernel_matches_xla(name):
    scene, cam, st = registry.make(name, size=16, bvh=True)
    o, d, time = _random_rays(scene, 300, 2)  # not a multiple of rb
    hx = cluster_trace.cluster_trace(scene, o, d, time, 1e-3, 1e12, False)
    hp = _kernel(scene, o, d, time, 1e-3, 1e12, False, rb=128)
    np.testing.assert_array_equal(np.asarray(hx.tri), np.asarray(hp.tri))
    hit = np.asarray(hx.tri) >= 0
    np.testing.assert_allclose(np.asarray(hx.t)[hit], np.asarray(hp.t)[hit],
                               rtol=1e-4, atol=1e-5)


def test_cluster_any_hit_agrees():
    scene, cam, st = registry.make('cornell_pt', size=16, bvh=True)
    o, d, time = _random_rays(scene, 256, 3)
    hb = intersect.brute_force_trace(scene, o, d, time, 1e-3, 5.0, True)
    hc = cluster_trace.cluster_trace(scene, o, d, time, 1e-3, 5.0, True)
    hp = _kernel(scene, o, d, time, 1e-3, 5.0, True, rb=128)
    got_b = np.asarray(hb.tri) >= 0
    np.testing.assert_array_equal(got_b, np.asarray(hc.tri) >= 0)
    np.testing.assert_array_equal(got_b, np.asarray(hp.tri) >= 0)


@pytest.mark.slow
def test_cluster_render_matches_bvh_render():
    """End-to-end: full radiance through the cluster backend equals the BVH
    backend bit-for-bit (same RNG keys, same estimator)."""
    from raytracer_tpu.render import renderer
    scene, cam, st = registry.make('cornell_pt', size=16, bvh=True,
                                   max_bounces=2)
    key = jax.random.PRNGKey(0)
    img_bvh = np.asarray(renderer.render(
        scene, cam, st.replace(intersector='bvh'), key, spp=1))
    img_cl = np.asarray(renderer.render(
        scene, cam, st.replace(intersector='cluster'), key, spp=1))
    np.testing.assert_allclose(img_bvh, img_cl, rtol=1e-4, atol=1e-5)


def test_refresh_clusters_tracks_vertex_updates():
    """apply_params must refresh the baked cluster tables: after a vertex
    shift, cluster_trace on the updated scene must agree with brute force on
    the updated geometry (regression: stale tables froze the forward render
    w.r.t. vertex params)."""
    from raytracer_tpu.parallel import sharding
    scene, cam, settings = registry.make('teapot_blinn', size=8, bvh=True)
    params = sharding.get_params(scene)
    params['vertices'] = params['vertices'] + jnp.asarray([0.0, 0.37, 0.0])
    shifted = jax.jit(sharding.apply_params)(scene, params)

    o, d, time = _random_rays(scene, 128, seed=11)
    o = o + jnp.asarray([0.0, 0.37, 0.0])  # keep rays relative to geometry
    hit_cl = cluster_trace.cluster_trace(shifted, o, d, time, 1e-3, 1e12)
    hit_bf = intersect.brute_force_trace(shifted, o, d, time, 1e-3, 1e12)
    np.testing.assert_array_equal(np.asarray(hit_cl.tri),
                                  np.asarray(hit_bf.tri))
    np.testing.assert_allclose(np.asarray(hit_cl.t), np.asarray(hit_bf.t),
                               rtol=1e-5, atol=1e-5)
    # and the stale table really would have been wrong: original-scene
    # clusters on shifted rays give different hits
    hit_stale = cluster_trace.cluster_trace(scene, o, d, time, 1e-3, 1e12)
    assert not np.array_equal(np.asarray(hit_stale.tri),
                              np.asarray(hit_bf.tri))


def test_alpha_aware_pallas_matches_brute():
    """Alpha-cutout scenes through the cluster kernel + re-trace wrapper
    must agree with the alpha-aware brute-force tracer."""
    from tests.gen_scenes import leaf_scene
    scene, cam, settings = leaf_scene(size=8, max_bounces=2)
    assert scene.has_alpha_maps
    from raytracer_tpu.render import camera as cam_mod
    R = 256
    key = jax.random.PRNGKey(3)
    px = jnp.arange(R, dtype=jnp.float32) % 16
    py = (jnp.arange(R, dtype=jnp.float32) // 16) % 16
    rands = jax.random.uniform(key, (R, 5))
    o, d, tm = cam_mod.eye_rays(cam, 16, 16, px, py, 0.0, 1.0, 0.0, 1.0, rands)

    @jax.jit
    def traced(scene, o, d, tm):
        def once(o_, d_, t_, tn_, tx_, ah):
            return _kernel(scene, o_, d_, t_, tn_, tx_, ah)
        return cluster_trace.alpha_aware_trace(scene, once, o, d, tm,
                                               1e-3, 1e12)

    hit_p = traced(scene, o, d, tm)
    hit_b = intersect.brute_force_trace(scene, o, d, tm, 1e-3, 1e12)
    tri_b = np.asarray(hit_b.tri)
    # the disc cutout lets some camera rays through and stops others
    assert 0 < np.sum(tri_b >= 0) < R
    np.testing.assert_array_equal(np.asarray(hit_p.tri), tri_b)
    np.testing.assert_allclose(np.asarray(hit_p.t), np.asarray(hit_b.t),
                               rtol=1e-5, atol=1e-4)


def test_native_cluster_build_valid():
    """Native cluster-table builder (rt_native.cpp rt_build_clusters) must
    emit a complete, geometry-consistent table: every subset triangle
    appears exactly once, each lane's MT basis matches the vertex pool, and
    cluster AABBs contain their triangles (incl. the motion-blur union)."""
    from raytracer_tpu import native
    from raytracer_tpu.geometry import clusters as cl_mod

    if native.get_lib() is None:
        pytest.skip('native library unavailable')
    scene, cam, st = registry.make('mb_bullet', size=8, bvh=True)
    cl = scene.clusters
    tri = np.asarray(cl.tri)
    real = tri[tri >= 0]
    assert len(real) == scene.num_tris
    assert len(np.unique(real)) == scene.num_tris
    v = np.asarray(scene.geom.vertices)
    v1 = np.asarray(scene.geom.vertices_t1)
    f = np.asarray(scene.geom.face_v)
    m, lane = np.nonzero(tri >= 0)
    ids = tri[m, lane]
    np.testing.assert_array_equal(np.asarray(cl.p0)[m, :, lane],
                                  v[f[ids][:, 0]])
    np.testing.assert_array_equal(np.asarray(cl.e1)[m, :, lane],
                                  v[f[ids][:, 1]] - v[f[ids][:, 0]])
    np.testing.assert_array_equal(np.asarray(cl.p0_t1)[m, :, lane],
                                  v1[f[ids][:, 0]])
    pts = np.concatenate([v[f[ids]], v1[f[ids]]], axis=1)
    assert (pts.min(1) >= np.asarray(cl.bb_min)[m] - 1e-4).all()
    assert (pts.max(1) <= np.asarray(cl.bb_max)[m] + 1e-4).all()
    # tracing through the native table == brute force (MB lerp included)
    o, d, time = _random_rays(scene, 128, 21)
    hb = intersect.brute_force_trace(scene, o, d, time, 1e-3, 1e12, False)
    hc = cluster_trace.cluster_trace(scene, o, d, time, 1e-3, 1e12, False)
    np.testing.assert_array_equal(np.asarray(hb.tri), np.asarray(hc.tri))


# ---------------------------------------------------------------- kernel
@pytest.mark.parametrize('name', ['teapot_blinn', 'mb_bullet'])
@pytest.mark.parametrize('any_hit', [False, True], ids=['nearest', 'any'])
@pytest.mark.parametrize('R', [77, 300])
@pytest.mark.parametrize('cut', [False, True], ids=['open', 'cut'])
def test_kernel_matches_references(name, any_hit, R, cut):
    """The kernel against the XLA sweep and brute force: ray counts that are
    not a multiple of the block, per-ray tmin/tmax cut-offs, motion blur."""
    scene, cam, st = registry.make(name, size=16, bvh=True)
    o, d, time = _random_rays(scene, R, 5 + R)
    if cut:
        # windows around the distance to the scene's centre
        real = np.asarray(scene.clusters.tri)[:, 0] >= 0
        ctr = (np.asarray(scene.clusters.bb_min)[real].min(0)
               + np.asarray(scene.clusters.bb_max)[real].max(0)) / 2
        dist = jnp.linalg.norm(o - jnp.asarray(ctr), axis=1)
        k1, k2 = jax.random.split(jax.random.PRNGKey(R))
        tmin = dist * jax.random.uniform(k1, (R,), maxval=1.0)
        tmax = tmin + dist * jax.random.uniform(k2, (R,), minval=0.05,
                                                maxval=0.5)
    else:
        tmin, tmax = 1e-3, MIRO_TMAX
    hk = _kernel(scene, o, d, time, tmin, tmax, any_hit, rb=32)
    hx = cluster_trace.cluster_trace(scene, o, d, time, tmin, tmax, any_hit)
    hb = intersect.brute_force_trace(scene, o, d, time, tmin, tmax, any_hit)
    valid = np.asarray(hb.tri) >= 0
    assert 0 < valid.sum() < R
    for ref in (hx, hb):
        np.testing.assert_array_equal(np.asarray(hk.tri) >= 0,
                                      np.asarray(ref.tri) >= 0)
    t = np.asarray(hk.t)
    tmin_b = np.broadcast_to(np.asarray(tmin), (R,))
    tmax_b = np.broadcast_to(np.asarray(tmax), (R,))
    assert np.all(t[valid] >= tmin_b[valid]) and np.all(t[valid] < tmax_b[valid])
    assert np.all(t[~valid] == MIRO_TMAX)
    if not any_hit:
        for ref in (hx, hb):
            np.testing.assert_array_equal(np.asarray(hk.tri),
                                          np.asarray(ref.tri))
            np.testing.assert_allclose(t, np.asarray(ref.t), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(np.asarray(hk.a)[valid],
                                       np.asarray(ref.a)[valid], atol=1e-4)


@pytest.mark.parametrize('rb,tc,warps,group', [
    (16, 32, 4, 32), (32, 32, 4, 2), (64, 64, 4, 4), (128, 128, 8, 8)])
def test_kernel_block_shapes(rb, tc, warps, group):
    """Every ray block, triangle tile and cluster group the wrapper accepts
    gives the same hits: one group padded with empty clusters, or several
    groups."""
    scene, cam, st = registry.make('teapot_blinn', size=16, bvh=True)
    o, d, time = _random_rays(scene, 200, 9)
    hk = _kernel(scene, o, d, time, 1e-3, MIRO_TMAX, rb=rb, tc=tc,
                 num_warps=warps, group=group)
    hx = cluster_trace.cluster_trace(scene, o, d, time, 1e-3, MIRO_TMAX)
    np.testing.assert_array_equal(np.asarray(hk.tri), np.asarray(hx.tri))


def test_kernel_skips_disabled_rays():
    """tmax < 0 marks dead wavefront lanes: they never hit."""
    scene, cam, st = registry.make('teapot_blinn', size=16, bvh=True)
    o, d, time = _random_rays(scene, 96, 4)
    tmax = jnp.where(jnp.arange(96) % 3 == 0, -1.0, MIRO_TMAX)
    hk = _kernel(scene, o, d, time, 1e-3, tmax)
    hx = cluster_trace.cluster_trace(scene, o, d, time, 1e-3, tmax)
    tri = np.asarray(hk.tri)
    assert np.all(tri[::3] == -1)
    np.testing.assert_array_equal(tri, np.asarray(hx.tri))


@pytest.mark.parametrize('backend', ['gpu', 'metal'])
def test_kernel_never_interprets_off_cpu(monkeypatch, backend):
    """On an accelerator, interpret=True raises instead of running the
    kernel in the Pallas interpreter."""
    scene, cam, st = registry.make('teapot_blinn', size=16, bvh=True)
    o, d, time = _random_rays(scene, 8, 1)
    monkeypatch.setattr(jax, 'default_backend', lambda: backend)
    with pytest.raises(RuntimeError, match='interpret'):
        _kernel(scene, o, d, time, 1e-3, MIRO_TMAX)


@pytest.mark.parametrize('backend', ['cpu', 'metal'])
def test_kernel_is_compiled_for_gpu_only(monkeypatch, backend):
    """Without interpret=True the kernel runs only on a GPU; elsewhere it
    raises instead of falling back."""
    scene, cam, st = registry.make('teapot_blinn', size=16, bvh=True)
    o, d, time = _random_rays(scene, 8, 1)
    monkeypatch.setattr(jax, 'default_backend', lambda: backend)
    with pytest.raises(RuntimeError, match='GPU'):
        cluster_kernel.pallas_cluster_trace(scene, o, d, time, 1e-3,
                                            MIRO_TMAX)


def test_kernel_refuses_two_level_scene():
    scene, cam, st = registry.make('instanced_teapots', size=8, grid=2)
    assert scene.clusters is None
    o = jnp.zeros((8, 3))
    d = jnp.ones((8, 3)) / np.sqrt(3.0)
    with pytest.raises(ValueError, match='single-level'):
        _kernel(scene, o, d, 0.5, 1e-3, MIRO_TMAX)


# --------------------------------------------------- tracer choice ('auto')
@pytest.mark.parametrize('backend,scene_kind,expected', [
    ('gpu', 'single', integrator.GPU_SINGLE_LEVEL),
    ('gpu', 'two_level', 'bvh'),
    ('gpu', 'no_bvh', 'brute'),
    ('cpu', 'single', 'bvh'),
    ('cpu', 'two_level', 'bvh'),
    ('cpu', 'no_bvh', 'brute'),
])
def test_auto_intersector(monkeypatch, backend, scene_kind, expected):
    if scene_kind == 'two_level':
        scene, _, st = registry.make('instanced_teapots', size=8, grid=2)
    else:
        scene, _, st = registry.make('teapot_blinn', size=8,
                                     bvh=scene_kind == 'single')
    assert integrator.auto_intersector(scene, backend) == expected
    # trace_fn resolves 'auto' through the default backend
    seen = []
    monkeypatch.setattr(jax, 'default_backend', lambda: backend)
    monkeypatch.setattr(integrator, 'auto_intersector',
                        lambda s, b: seen.append(b) or 'brute')
    integrator.trace_fn(scene, st.replace(intersector='auto'))
    assert seen == [backend]


@pytest.mark.parametrize('mode', ['cluster', 'cluster_pallas'])
def test_cluster_modes_refuse_two_level_scene(mode):
    """A cluster mode asked for a scene it cannot trace raises instead of
    quietly tracing with another intersector."""
    scene, _, st = registry.make('instanced_teapots', size=8, grid=2)
    with pytest.raises(ValueError, match='single-level'):
        integrator.trace_fn(scene, st.replace(intersector=mode))


def test_trace_fn_rejects_unknown_and_unbuilt_modes():
    scene, _, st = registry.make('teapot_blinn', size=8, bvh=False)
    with pytest.raises(ValueError, match='bvh=True'):
        integrator.trace_fn(scene, st.replace(intersector='bvh'))
    with pytest.raises(ValueError, match='unknown intersector'):
        integrator.trace_fn(scene, st.replace(intersector='pallas'))


def test_equal_t_ties_pick_smallest_triangle_id():
    """Coplanar overlapping triangles hit at the same t: every tracer keeps
    the smallest triangle id, whatever order its walk visits them in."""
    from raytracer_tpu.geometry import shapes
    from raytracer_tpu.geometry.build import SceneBuilder
    rng = np.random.default_rng(0)
    b = SceneBuilder()
    mat = b.add_lambert()
    # > 1 cluster of overlapping squares in z = 0, at multiples of 1/8 so
    # that every tracer computes t = 5 exactly for the rays below
    for _ in range(200):
        x, y = rng.integers(-32, 32, 2) / 8.0
        s = rng.integers(4, 16) / 8.0
        b.add_mesh(shapes.quad((x - s, y - s, 0), (x + s, y - s, 0),
                               (x + s, y + s, 0), (x - s, y + s, 0)), mat)
    scene = b.build(bvh=True)
    assert scene.clusters.num_clusters > 1
    R = 160
    xy = jax.random.uniform(jax.random.PRNGKey(0), (R, 2), minval=-4,
                            maxval=4)
    o = jnp.concatenate([xy, jnp.full((R, 1), 5.0)], axis=1)
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0]), (R, 3))
    hb = intersect.brute_force_trace(scene, o, d, 0.0, 1e-3, MIRO_TMAX)
    hx = cluster_trace.cluster_trace(scene, o, d, 0.0, 1e-3, MIRO_TMAX)
    hk = _kernel(scene, o, d, 0.0, 1e-3, MIRO_TMAX)
    tri_b = np.asarray(hb.tri)
    assert (tri_b >= 0).mean() > 0.5
    np.testing.assert_array_equal(np.asarray(hx.tri), tri_b)
    np.testing.assert_array_equal(np.asarray(hk.tri), tri_b)
