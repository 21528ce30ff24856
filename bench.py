"""Headline benchmark: primary rays/s on one GPU, forward+backward, Sponza-scale
1080p 1 spp.

sponza.obj is not shipped with the reference (BASELINE.md), so the workload is
the generated sponza_proxy in its HD configuration (174,724 triangles with a
second-story gallery + upper colonnade for real interior occlusion, rect area
light, path traced at the registry's own max_bounces=10) at 1920x1080, 1 spp,
forward render + backward pass to all differentiable scene parameters
through sharding.loss_and_grads_scanned.

vs_baseline: the reference publishes no rays/s number; its final frame
(1920x1080, adaptive 9-25 spp, ~20 min on an i7 quad-core,
webpage/aguzman_jschwarzhaupt.html) implies ~15k primary rays/s forward-only.
We report our fwd+bwd primary rays/s divided by that estimate.

Environment knobs: RT_BENCH_W / _H / _BOUNCES / _SPP / _TILE / _ITERS, and
RT_BENCH_INTERSECTOR (default 'auto') to time one tracer end to end.

Prints the device (platform, kind, nvidia-smi name and power limit) on a
line of its own, then ONE JSON line: {"metric", "value", "unit",
"vs_baseline", ...}. Refuses to run without a GPU.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REF_RAYS_PER_SEC = 15_000.0  # i7 estimate, see module docstring


def main():
    import jax
    import jax.numpy as jnp
    from raytracer_tpu.parallel import sharding
    from raytracer_tpu.render import integrator
    from raytracer_tpu.scenes import registry
    from raytracer_tpu.utils import runtime

    device = runtime.require_gpu()
    runtime.enable_compile_cache()
    print(f'# device platform={device["platform"]} kind={device["kind"]} '
          f'count={device["count"]} nvidia-smi: {runtime.gpu_name_and_power()}')

    width = int(os.environ.get('RT_BENCH_W', 1920))
    height = int(os.environ.get('RT_BENCH_H', 1080))
    bounces = int(os.environ.get('RT_BENCH_BOUNCES', 10))
    spp = int(os.environ.get('RT_BENCH_SPP', 1))
    tile = int(os.environ.get('RT_BENCH_TILE', 32 * 1024))
    intersector = os.environ.get('RT_BENCH_INTERSECTOR', 'auto')

    scene, cam, settings = registry.make(
        'sponza_proxy', width=width, height=height, bvh=True, hd=True,
        path_trace=True, max_bounces=bounces, ray_tile=tile,
        intersector=intersector)
    if intersector == 'auto':
        intersector = integrator.auto_intersector(scene, jax.default_backend())
    key = jax.random.PRNGKey(0)
    params = sharding.get_params(scene)
    target = jnp.zeros((height, width, 3), jnp.float32)

    def step(k):
        return sharding.loss_and_grads_scanned(params, scene, cam, settings,
                                               target, k, spp=spp, tile=tile)

    # compile (one tile shape compiles once; the scan then streams tiles)
    t0 = time.time()
    jax.block_until_ready(step(key))
    compile_s = time.time() - t0

    # distinct RNG key per iteration; median of several runs with the spread
    n_iter = int(os.environ.get('RT_BENCH_ITERS', 5))
    walls = []
    for i in range(n_iter):
        t0 = time.time()
        loss, grads = jax.block_until_ready(
            step(jax.random.fold_in(key, 1000 + i)))
        walls.append(time.time() - t0)
    dt = float(np.median(walls))

    rays_per_sec = width * height * spp / dt
    print(json.dumps({
        'metric': 'primary_rays_per_sec_fwd_bwd_sponza_hd_1080p',
        'value': rays_per_sec,
        'unit': 'rays/s',
        'vs_baseline': rays_per_sec / REF_RAYS_PER_SEC,
        'wall_median_s': dt,
        'wall_spread_s': [min(walls), max(walls)],
        'iters': n_iter,
        'compile_s': compile_s,
        'intersector': intersector,
        'tris': scene.num_tris,
        'bounces': bounces,
        'device': device,
    }))
    print(f'# loss={float(loss):.6f} walls={walls}', file=sys.stderr)


if __name__ == '__main__':
    main()
