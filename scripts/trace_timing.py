"""Trace-only timing of the tracers on one GPU, at the bench scene.

Times one trace call of each intersector on 32,768-ray wavefronts of the
benchmark scene (sponza_proxy hd, 174,724 triangles): coherent camera
primaries and incoherent random rays inside the atrium, nearest-hit and
any-hit (shadow rays with random tmax). The intersectors:

  cluster_pallas  the Triton cluster kernel (ops/pallas/cluster_kernel.py),
                  at each configuration of --kernel-configs
  cluster         the XLA cluster sweep (ops/cluster_trace.py)
  bvh             the vmap'd while-loop BVH (ops/traverse.py)

Timing: host clock around calls that end in block_until_ready; the median
of --iters calls after one warm-up (compile) call. Prints one JSON line per
(mode, workload) and writes them all to --out.

    python scripts/trace_timing.py [--rays 32768] [--iters 5] \\
        [--modes cluster_pallas,cluster,bvh] [--kernel-configs 32x4,16x2x64]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--rays', type=int, default=32768)
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--modes', default='cluster_pallas,cluster,bvh')
    ap.add_argument('--kernel-configs', default='32x4',
                    help='comma-separated RBxWARPS[xTC[xGROUP]]: rays per '
                         'program, warps, triangle lanes per MT tile, '
                         'clusters per group box test')
    ap.add_argument('--out', default='chiprun_out/trace_timing.jsonl')
    args = ap.parse_args()

    import jax
    import numpy as np
    from raytracer_tpu.core.vecmath import MIRO_TMAX
    from raytracer_tpu.ops import cluster_trace as ct
    from raytracer_tpu.ops import traverse
    from raytracer_tpu.ops.pallas import cluster_kernel as ck
    from raytracer_tpu.scenes import registry
    from raytracer_tpu.utils import runtime

    device = runtime.require_gpu()
    runtime.enable_compile_cache()
    print(f'# device {device} nvidia-smi: {runtime.gpu_name_and_power()}',
          flush=True)

    R = args.rays
    W = 256
    H = R // W
    scene, cam, _ = registry.make('sponza_proxy', width=W, height=H, hd=True)
    key = jax.random.PRNGKey(7)
    import chip_smoke
    coherent = chip_smoke.camera_rays(cam, W, H, key)
    incoherent = chip_smoke.random_rays(jax.random.fold_in(key, 1), R,
                                         *chip_smoke.ATRIUM)
    shadow_tmax = jax.random.uniform(jax.random.fold_in(key, 2), (R,),
                                     minval=0.5, maxval=12.0)

    tracers = []
    for mode in args.modes.split(','):
        if mode == 'cluster_pallas':
            for cfg in args.kernel_configs.split(','):
                # RB x WARPS [x TC [x GROUP]]
                kw = dict(zip(('rb', 'num_warps', 'tc', 'group'),
                              (int(x) for x in cfg.split('x'))))
                tracers.append((f'cluster_pallas {kw}',
                                lambda *a, kw=kw, **k:
                                ck.pallas_cluster_trace(*a, **kw, **k)))
        elif mode == 'cluster':
            tracers.append(('cluster', ct.cluster_trace))
        elif mode == 'bvh':
            tracers.append(('bvh', traverse.bvh_trace))
        else:
            raise SystemExit(f'unknown mode {mode}')

    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'a') as fh:
        for label, tracer in tracers:
            for rays_name, (o, d, tm) in (('coherent', coherent),
                                          ('incoherent', incoherent)):
                for any_hit in (False, True):
                    tmax = shadow_tmax if any_hit else MIRO_TMAX
                    fn = jax.jit(lambda s, o, d, tm, tx, ah=any_hit,
                                 tr=tracer: tr(s, o, d, tm, 1e-3, tx,
                                               any_hit=ah))
                    t0 = time.perf_counter()
                    hit = jax.block_until_ready(fn(scene, o, d, tm, tmax))
                    first = time.perf_counter() - t0
                    walls = []
                    for _ in range(args.iters):
                        t0 = time.perf_counter()
                        jax.block_until_ready(fn(scene, o, d, tm, tmax))
                        walls.append(time.perf_counter() - t0)
                    med = float(np.median(walls))
                    rec = {'mode': label, 'rays': rays_name,
                           'any_hit': any_hit, 'n_rays': R,
                           'median_s': med, 'walls_s': walls,
                           'first_call_s': first,
                           'mrays_per_s': R / med / 1e6,
                           'hit_share': float(np.mean(
                               np.asarray(hit.tri) >= 0)),
                           'tris': scene.num_tris, 'device': device}
                    print(json.dumps(rec), flush=True)
                    fh.write(json.dumps(rec) + '\n')


if __name__ == '__main__':
    main()
