"""Smoke test of the main path on one GPU: the quickest proof that the system
still starts on the card and computes the right thing.

    python chip_smoke.py                # one card, all phases below
    python chip_smoke.py --four-cards   # only the 4-card mesh phases

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. devices: platform, device kind, count, JAX version, and the card's
     name and power limit from nvidia-smi. Not a GPU -> exit.
  2. trace kernel at the bench scene's full size (sponza_proxy hd, 174,724
     triangles): the Triton cluster kernel against the XLA cluster sweep
     (ops/cluster_trace) on 32,768 coherent camera rays and 32,768
     incoherent rays in the atrium, nearest and any-hit, and against the
     brute-force oracle (ops/intersect) on 2,048-ray subsets; then the
     motion-blurred mb_bullet scene.
  3. main path: two fwd+bwd steps of the bench workload (1920x1080, 10
     bounces, every scene parameter) with finite loss and gradients (compile
     seconds, step seconds and peak device bytes printed), and one
     rt.render at 480x270 with the GPU's default tracer against 'bvh'.
  4. last line: {"ok": true, "device": {...}}.

--four-cards runs the rays-sharded fwd+bwd on a 4-card mesh against the
same step on one card, and render_geometry_sharded (cluster table sharded,
ring trace) against the replicated render.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

TRI_ID_AGREE = 0.9999       # share of rays whose triangle ids must agree
TIE_RTOL = 1e-5             # id mismatches allowed only at t ties this close
T_RTOL = T_ATOL = 1e-5
RENDER_TOL = 0.01           # mean |diff| over mean pixel value
LOSS_RTOL = 1e-5            # 4-card vs 1-card (psum order differs)
GRAD_RTOL = 1e-4
ATRIUM = ((-9.5, 0.2, -4.5), (9.5, 7.5, 4.5))   # sponza_proxy's interior box

# sizes (a CPU rehearsal of the control flow may shrink them)
TRACE_W, TRACE_H = 256, 128         # 32,768 rays per trace comparison
ORACLE_STRIDE = 16                  # every 16th ray -> 2,048 vs brute force
MAIN_W, MAIN_H, MAIN_TILE = 1920, 1080, 32 * 1024
RENDER_W, RENDER_H = 480, 270
FOUR_W, FOUR_H, FOUR_TILE = 480, 272, 8 * 1024   # 16 tiles, 4 per card
HD = True


def phase_devices():
    import jax
    from raytracer_tpu.utils import runtime
    dev = jax.devices()[0]
    print(f'platform={dev.platform} kind={dev.device_kind} '
          f'count={len(jax.devices())} jax={jax.__version__}')
    info = runtime.require_gpu()
    print(f'nvidia-smi: {runtime.gpu_name_and_power()}')
    print(f'compile cache: {runtime.enable_compile_cache()}')
    return info


def camera_rays(cam, width, height, key):
    import jax
    import jax.numpy as jnp
    from raytracer_tpu.render import camera as cam_mod
    ys, xs = jnp.meshgrid(jnp.arange(height, dtype=jnp.float32),
                          jnp.arange(width, dtype=jnp.float32), indexing='ij')
    rands = jax.random.uniform(key, (width * height, 5))
    return cam_mod.eye_rays(cam, width, height, xs.reshape(-1),
                            ys.reshape(-1), 0.0, 1.0, 0.0, 1.0, rands)


def random_rays(key, n, lo, hi):
    import jax
    import jax.numpy as jnp
    k1, k2, k3 = jax.random.split(key, 3)
    o = jax.random.uniform(k1, (n, 3), minval=jnp.asarray(lo),
                           maxval=jnp.asarray(hi))
    d = jax.random.normal(k2, (n, 3))
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    return o, d, jax.random.uniform(k3, (n,))


def _check_nearest(label, hk, hr):
    """Kernel hit hk against reference hit hr (nearest-hit)."""
    tk, tr = np.asarray(hk.t), np.asarray(hr.t)
    mis = np.asarray(hk.tri) != np.asarray(hr.tri)
    frac = float(mis.mean())
    tie = np.abs(tk - tr) <= TIE_RTOL * np.abs(tr)
    print(f'  {label}: tri mismatch {frac:.2e} ({int(mis.sum())} rays), '
          f'max |dt| {float(np.abs(tk - tr).max()):.3e}')
    assert frac <= 1.0 - TRI_ID_AGREE, f'{label}: tri mismatch {frac}'
    assert np.all(tie[mis]), f'{label}: id mismatch away from a t tie'
    assert np.allclose(tk, tr, rtol=T_RTOL, atol=T_ATOL), f'{label}: t'


def _check_any(label, hk, hr, tmin):
    """Any-hit: the same rays are occluded, and the kernel's hit is real."""
    vk, vr = np.asarray(hk.valid), np.asarray(hr.valid)
    frac = float((vk != vr).mean())
    print(f'  {label}: occlusion mismatch {frac:.2e} '
          f'({int((vk != vr).sum())} rays), occluded {float(vk.mean()):.3f}')
    assert frac <= 1.0 - TRI_ID_AGREE, f'{label}: occlusion mismatch {frac}'
    assert np.all(np.asarray(hk.t)[vk] >= tmin), f'{label}: hit before tmin'


def phase_trace():
    import jax
    import jax.numpy as jnp
    from raytracer_tpu.core.vecmath import MIRO_TMAX
    from raytracer_tpu.ops import cluster_trace as ct
    from raytracer_tpu.ops import intersect as isect
    from raytracer_tpu.ops.pallas import cluster_kernel as ck
    from raytracer_tpu.scenes import registry

    key = jax.random.PRNGKey(7)
    tmin = 1e-3
    W, H = TRACE_W, TRACE_H
    scene, cam, _ = registry.make('sponza_proxy', width=W, height=H, hd=HD)
    print(f'sponza_proxy hd: {scene.num_tris} triangles, '
          f'{scene.clusters.num_clusters} clusters')
    o, d, tm = camera_rays(cam, W, H, key)
    coherent = (o, d, tm)
    incoherent = random_rays(jax.random.fold_in(key, 1), W * H, *ATRIUM)
    shadow_tmax = jax.random.uniform(jax.random.fold_in(key, 2), (W * H,),
                                     minval=0.5, maxval=12.0)
    with jax.default_matmul_precision('highest'):
        for name, (o, d, tm) in (('coherent', coherent),
                                 ('incoherent', incoherent)):
            t0 = time.time()
            hk = jax.block_until_ready(
                ck.pallas_cluster_trace(scene, o, d, tm, tmin, MIRO_TMAX))
            print(f'  kernel {name} nearest: first call {time.time() - t0:.1f}s')
            hx = ct.cluster_trace(scene, o, d, tm, tmin, MIRO_TMAX)
            _check_nearest(f'{name} nearest vs XLA cluster', hk, hx)
            sub = slice(None, None, ORACLE_STRIDE)
            hb = isect.brute_force_trace(scene, o[sub], d[sub], tm[sub],
                                         tmin, MIRO_TMAX)
            _check_nearest(f'{name} nearest vs brute force',
                           jax.tree_util.tree_map(lambda x: x[sub], hk), hb)
            ak = ck.pallas_cluster_trace(scene, o, d, tm, tmin, shadow_tmax,
                                         any_hit=True)
            ax = ct.cluster_trace(scene, o, d, tm, tmin, shadow_tmax,
                                  any_hit=True)
            _check_any(f'{name} any-hit vs XLA cluster', ak, ax, tmin)
            ab = isect.brute_force_trace(scene, o[sub], d[sub], tm[sub],
                                         tmin, shadow_tmax[sub], any_hit=True)
            _check_any(f'{name} any-hit vs brute force',
                       jax.tree_util.tree_map(lambda x: x[sub], ak), ab, tmin)

        scene, cam, _ = registry.make('mb_bullet', size=W)
        assert scene.has_motion_blur
        for name, (o, d, tm) in (
                ('mb camera', camera_rays(cam, W, H, key)),
                ('mb incoherent', random_rays(key, W * H,
                                               (-1.5, -1.5, -1.5),
                                               (2.5, 1.5, 1.5)))):
            hk = ck.pallas_cluster_trace(scene, o, d, tm, tmin, MIRO_TMAX)
            hx = ct.cluster_trace(scene, o, d, tm, tmin, MIRO_TMAX)
            _check_nearest(f'{name} nearest vs XLA cluster', hk, hx)
            ak = ck.pallas_cluster_trace(scene, o, d, tm, tmin, shadow_tmax,
                                         any_hit=True)
            ax = ct.cluster_trace(scene, o, d, tm, tmin, shadow_tmax,
                                  any_hit=True)
            _check_any(f'{name} any-hit vs XLA cluster', ak, ax, tmin)


def phase_main_path():
    import jax
    import jax.numpy as jnp
    import raytracer_tpu as rt
    from raytracer_tpu.parallel import sharding
    from raytracer_tpu.render import integrator
    from raytracer_tpu.scenes import registry

    W, H, tile = MAIN_W, MAIN_H, MAIN_TILE
    scene, cam, settings = registry.make('sponza_proxy', width=W, height=H,
                                         hd=HD, max_bounces=10,
                                         ray_tile=tile)
    default = integrator.auto_intersector(scene, jax.default_backend())
    print(f'default tracer on {jax.default_backend()}: {default}')
    params = sharding.get_params(scene)
    target = jnp.zeros((H, W, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    t0 = time.time()
    step_fn = sharding.loss_and_grads_scanned.lower(
        params, scene, cam, settings, target, key, tile=tile).compile()
    print(f'fwd+bwd compile: {time.time() - t0:.2f}s; '
          f'{step_fn.memory_analysis()}')
    for step in range(2):
        t0 = time.time()
        loss, grads = jax.block_until_ready(step_fn(
            params, scene, cam, target, jax.random.fold_in(key, step)))
        print(f'fwd+bwd step {step}: {time.time() - t0:.2f}s '
              f'loss={float(loss):.6f}')
        assert np.isfinite(float(loss)), 'non-finite loss'
        for name, g in grads.items():
            assert np.all(np.isfinite(np.asarray(g))), f'non-finite grad {name}'
    stats = jax.devices()[0].memory_stats() or {}
    print(f'peak_bytes_in_use={stats.get("peak_bytes_in_use")}')

    # same estimator, same key: the default tracer must render what the BVH
    # renders. sort_rays off: with it on, a last-bit difference in a hit
    # point can move a ray to another wavefront slot and re-bind its random
    # numbers, which compares two noise patterns instead of two tracers.
    st = settings.replace(width=RENDER_W, height=RENDER_H, sort_rays=False)
    imgs = {}
    for mode in (default, 'bvh'):
        t0 = time.time()
        imgs[mode] = np.asarray(rt.render(scene, cam,
                                          st.replace(intersector=mode), key))
        print(f'render {RENDER_W}x{RENDER_H} {mode}: '
              f'{time.time() - t0:.2f}s (compile included)')
    a, b = imgs[default], imgs['bvh']
    assert np.all(np.isfinite(a)) and a.shape == (RENDER_H, RENDER_W, 3)
    rel = float(np.abs(a - b).mean() / max(float(b.mean()), 1e-12))
    print(f'render {default} vs bvh: mean |diff| / mean = {rel:.2e}')
    assert rel <= RENDER_TOL, f'render mismatch {rel}'


def phase_four_cards():
    import jax
    import jax.numpy as jnp
    from raytracer_tpu.parallel import sharding
    from raytracer_tpu.render import integrator
    from raytracer_tpu.scenes import registry

    assert len(jax.devices()) >= 4, f'need 4 cards, have {jax.devices()}'
    mesh = sharding.make_mesh(4)
    W, H, tile = FOUR_W, FOUR_H, FOUR_TILE
    # sort_rays off: the two programs may round a hit point differently in
    # the last bit, and a re-sorted wavefront would re-bind random numbers
    # and compare two noise patterns instead of two reductions
    scene, cam, settings = registry.make('sponza_proxy', width=W, height=H,
                                         hd=HD, max_bounces=10,
                                         ray_tile=tile, sort_rays=False)
    print(f'tracer: {integrator.auto_intersector(scene, jax.default_backend())}'
          f' (replicated), ring (geometry-sharded)')
    params = sharding.get_params(scene)
    target = jnp.full((H, W, 3), 0.1, jnp.float32)
    key = jax.random.PRNGKey(0)
    t0 = time.time()
    l1, g1 = sharding.loss_and_grads_scanned(params, scene, cam, settings,
                                             target, key, tile=tile)
    l4, g4 = sharding.loss_and_grads_scanned(params, scene, cam, settings,
                                             target, key, tile=tile,
                                             mesh=mesh)
    jax.block_until_ready((l1, g1, l4, g4))
    print(f'fwd+bwd 1 card and 4 cards: {time.time() - t0:.1f}s '
          f'(compile included)')
    lrel = abs(float(l4) - float(l1)) / abs(float(l1))
    print(f'loss 1 card {float(l1):.8f}, 4 cards {float(l4):.8f}, '
          f'rel diff {lrel:.2e}')
    assert lrel <= LOSS_RTOL, f'loss rel diff {lrel}'
    for name in g1:
        a, b = np.asarray(g4[name]), np.asarray(g1[name])
        den = float(np.linalg.norm(b))
        grel = float(np.linalg.norm(a - b)) / den if den else \
            float(np.linalg.norm(a))
        print(f'  grad {name}: rel L2 {grel:.2e}')
        assert grel <= GRAD_RTOL, f'grad {name} rel L2 {grel}'

    t0 = time.time()
    ref = np.asarray(sharding.render_sharded(scene, cam, settings, key,
                                             mesh))
    geo = np.asarray(sharding.render_geometry_sharded(scene, cam, settings,
                                                      key, mesh))
    print(f'replicated and geometry-sharded renders: {time.time() - t0:.1f}s '
          f'(compile included)')
    assert np.all(np.isfinite(geo)) and geo.shape == ref.shape
    rel = float(np.abs(geo - ref).mean() / max(float(ref.mean()), 1e-12))
    print(f'render_geometry_sharded vs replicated: mean |diff| / mean = '
          f'{rel:.2e}')
    assert rel <= RENDER_TOL, f'geometry-sharded render mismatch {rel}'


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--four-cards', action='store_true',
                    help='run only the 4-card mesh phases')
    args = ap.parse_args(argv)
    info = phase_devices()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_trace()
        phase_main_path()
    print(json.dumps({'ok': True, 'device': info}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
