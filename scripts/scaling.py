"""Scaling-efficiency harness: rays/s vs device count (BASELINE: >=85%
rays/s scaling efficiency from 1 chip to >=2 hosts).

Measures BOTH workloads:
  * forward render (render_sharded / render_geometry_sharded), and
  * the production fwd+bwd step (loss_and_grads_scanned, tiles sharded
    over the mesh) — the BASELINE metric is fwd+bwd, so --train is the
    number that counts.

Multi-host: launch one process per host with RT_COORDINATOR /
RT_NUM_PROCESSES / RT_PROCESS_ID set and pass --distributed; the harness
then initializes jax.distributed and builds the mesh over the GLOBAL
device list (parallel/distributed.py). --cpu validates the plumbing on
virtual CPU devices (CPU numbers are not device measurements).

Prints one JSON line per device count plus the efficiency summary.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, '.')


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--cpu', action='store_true',
                    help='force 8 virtual CPU devices (plumbing check)')
    ap.add_argument('--distributed', action='store_true',
                    help='jax.distributed.initialize from RT_* env vars')
    ap.add_argument('--scene', default='cornell_pt')
    ap.add_argument('--size', type=int, default=256)
    ap.add_argument('--spp', type=int, default=1)
    ap.add_argument('--iters', type=int, default=3)
    ap.add_argument('--tile', type=int, default=0,
                    help='ray tile for --train (0 = settings default)')
    ap.add_argument('--train', action='store_true',
                    help='measure the fwd+bwd scanned step (BASELINE '
                         'metric) instead of the forward render')
    ap.add_argument('--mode', choices=['replicated', 'geometry_sharded'],
                    default='replicated')
    args = ap.parse_args()

    import os
    if args.distributed:
        from raytracer_tpu.parallel import distributed
        assert distributed.init_from_env(), \
            '--distributed needs RT_COORDINATOR / RT_NUM_PROCESSES / RT_PROCESS_ID'
    if args.cpu and not args.distributed:
        os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')
                                   + ' --xla_force_host_platform_device_count=8')
    import jax
    if args.cpu and not args.distributed:
        jax.config.update('jax_platforms', 'cpu')
    import jax.numpy as jnp
    from raytracer_tpu.scenes import registry
    from raytracer_tpu.parallel import sharding

    n_avail = len(jax.devices())
    pid = jax.process_index()
    scene, cam, settings = registry.make(args.scene, size=args.size,
                                         bvh=True, max_bounces=2)
    key = jax.random.PRNGKey(0)
    R = settings.width * settings.height * args.spp
    tile = args.tile or None

    def make_mesh(n):
        if args.distributed:
            from raytracer_tpu.parallel import distributed
            return distributed.global_mesh(n)
        return sharding.make_mesh(n)

    if args.train:
        params = sharding.get_params(scene)
        target = jnp.zeros((settings.height, settings.width, 3), jnp.float32)

        def step(k, mesh):
            loss, grads = sharding.loss_and_grads_scanned(
                params, scene, cam, settings, target, k, spp=args.spp,
                tile=tile, mesh=mesh)
            jax.block_until_ready(grads)
            return float(loss)  # fetch: async dispatch can hide wall time
    else:
        render = (sharding.render_geometry_sharded
                  if args.mode == 'geometry_sharded'
                  else sharding.render_sharded)

        def step(k, mesh):
            img = render(scene, cam, settings, k, mesh, spp=args.spp)
            jax.block_until_ready(img)
            return float(jnp.sum(img))

    # on a distributed run every process must execute every count together,
    # AND every process must own devices of every mesh: a mesh over the
    # first n global devices with n < total leaves some processes
    # device-less, which multi-process jax rejects or hangs on. Restrict
    # distributed sweeps to multiples of (local devices x processes).
    if args.distributed:
        quantum = jax.local_device_count() * jax.process_count()
        counts = [n for n in (1, 2, 4, 8, 16, 32, 64)
                  if n <= n_avail and n % quantum == 0]
    else:
        counts = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= n_avail]
    results = []
    for n in counts:
        mesh = make_mesh(n)
        step(key, mesh)  # compile + warm
        t0 = time.time()
        for i in range(args.iters):
            step(jax.random.fold_in(key, 100 + i), mesh)
        dt = (time.time() - t0) / args.iters
        rps = R / dt
        results.append((n, rps))
        if pid == 0:
            print(json.dumps({
                'devices': n,
                'workload': 'fwd+bwd' if args.train else 'forward',
                'rays_per_sec': round(rps, 1),
                'rays_per_sec_per_device': round(rps / n, 1)}), flush=True)

    if len(results) > 1 and pid == 0:
        base = results[0][1]
        n_last, rps_last = results[-1]
        eff = rps_last / (base * n_last)
        print(json.dumps({'scaling_efficiency': round(eff, 3),
                          'from_devices': results[0][0],
                          'to_devices': n_last,
                          'workload': 'fwd+bwd' if args.train else 'forward',
                          'target': 0.85}), flush=True)


if __name__ == '__main__':
    main()
