"""Render observability: ray/test counters, BVH stats, timing reports.

The reference keeps per-thread counters (Ray::counter, rayTriangleIntersections,
BVH::rayBoxIntersections — src/Ray.h:30-31, src/BVH.h:116) incremented in the
hot loops and printed post-render together with wall time
(src/Scene.cpp:202-216); BVH build prints node/leaf/depth/faces-per-leaf stats
(src/BVH.cpp:563-574). The equivalents here:

  * `bvh_stats(bvh)` — host-side structural stats of the flattened wide BVH;
  * `trace_stats(scene, o, d, ...)` — per-wavefront ray-AABB / ray-triangle
    test counters from an instrumented traversal (jit, device-side counters
    summed like the reference's post-render reduction);
  * `render_with_stats(...)` — timed render returning a RenderReport with
    rays/sec and, optionally, probe-sampled test counters;
  * `profile_trace(dir)` — context manager around the JAX/XLA profiler so a
    render can be inspected in TensorBoard/xprof.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Scene, Camera, RenderSettings, BVHArrays
from ..core.vecmath import EPSILON, MIRO_TMAX
from . import console


def bvh_stats(bvh: BVHArrays) -> dict:
    """Structural stats of a flattened wide BVH (src/BVH.cpp:563-574)."""
    count = np.asarray(bvh.count)
    n_nodes = count.shape[0]
    tri_leaves = count > 0
    inst_leaves = count <= -2
    internal = count == 0
    n_tri_leaves = int(tri_leaves.sum())
    n_tris_ref = int(count[tri_leaves].sum()) if n_tri_leaves else 0
    return dict(
        nodes=n_nodes,
        branch=count.shape[1],
        tri_leaves=n_tri_leaves,
        inst_leaves=int(inst_leaves.sum()),
        internal_children=int(internal.sum()),
        tri_refs=n_tris_ref,
        faces_per_leaf=(n_tris_ref / n_tri_leaves) if n_tri_leaves else 0.0,
        max_depth=bvh.depth,
    )


def print_bvh_stats(bvh: BVHArrays) -> None:
    s = bvh_stats(bvh)
    console.info('BVH: %d nodes (%d-wide), %d tri leaves, %d instance '
                 'leaves, %.2f faces/leaf, depth<=%d',
                 s['nodes'], s['branch'], s['tri_leaves'], s['inst_leaves'],
                 s['faces_per_leaf'], s['max_depth'])


def trace_stats(scene: Scene, o, d, time_=0.0, tmin=EPSILON,
                tmax=MIRO_TMAX) -> dict:
    """Ray-AABB / ray-triangle test counts for one wavefront.

    Returns python ints: total tests plus per-ray means — the TPU analogue of
    the reference's per-thread counter reduction (src/Scene.cpp:202-208).
    """
    from ..ops import traverse
    if scene.blas is None:
        n = int(o.shape[0]) * int(scene.num_tris)
        return dict(rays=int(o.shape[0]), ray_aabb=0, ray_tri=n,
                    aabb_per_ray=0.0, tri_per_ray=float(scene.num_tris))
    _, st = traverse.bvh_trace(scene, o, d, time_, tmin, tmax,
                               collect_stats=True)
    aabb = int(jnp.sum(st['ray_aabb']))
    tri = int(jnp.sum(st['ray_tri']))
    R = int(o.shape[0])
    return dict(rays=R, ray_aabb=aabb, ray_tri=tri,
                aabb_per_ray=aabb / R, tri_per_ray=tri / R)


@dataclasses.dataclass
class RenderReport:
    """Post-render stats in the spirit of src/Scene.cpp:211-216."""
    width: int
    height: int
    spp: int
    wall_s: float
    compile_s: float
    primary_rays: int
    primary_rays_per_s: float
    probe: dict | None = None  # trace_stats of a probe wavefront

    def pretty(self) -> str:
        lines = [
            f'Rendered {self.width}x{self.height} @ {self.spp}spp '
            f'in {self.wall_s:.3f}s (+{self.compile_s:.1f}s compile)',
            f'Primary rays cast: {self.primary_rays:,} '
            f'({self.primary_rays_per_s:,.0f} rays/s)',
        ]
        if self.probe:
            lines.append(
                f'Probe wavefront: {self.probe["aabb_per_ray"]:.1f} '
                f'ray/AABB tests, {self.probe["tri_per_ray"]:.1f} '
                f'ray/tri tests per ray')
        return '\n'.join(lines)


def render_with_stats(scene: Scene, cam: Camera, settings: RenderSettings,
                      key, spp: int = 1, probe: bool = True,
                      log: bool = True):
    """Timed render -> (image, RenderReport).

    The first call pays compile; `compile_s` separates it from steady-state
    wall time (a second run is timed after the compiled first run).
    """
    from ..render import renderer

    t0 = time.time()
    img = renderer.render(scene, cam, settings, key, spp=spp)
    jax.block_until_ready(img)
    t1 = time.time()
    img = renderer.render(scene, cam, settings, key, spp=spp)
    jax.block_until_ready(img)
    t2 = time.time()

    wall = t2 - t1
    compile_s = (t1 - t0) - wall
    R = settings.width * settings.height * spp
    probe_stats = None
    if probe and scene.blas is not None:
        from ..render import camera as cam_mod
        n = min(4096, settings.width * settings.height)
        px = jnp.linspace(0, settings.width - 1, n)
        py = jnp.linspace(0, settings.height - 1, n)
        rands = jnp.full((n, 5), 0.5)
        o, d, tm = cam_mod.eye_rays(cam, settings.width, settings.height,
                                    px, py, 0.0, 1.0, 0.0, 1.0, rands)
        probe_stats = trace_stats(scene, o, d, tm)
    report = RenderReport(
        width=settings.width, height=settings.height, spp=spp,
        wall_s=wall, compile_s=max(compile_s, 0.0), primary_rays=R,
        primary_rays_per_s=R / max(wall, 1e-9), probe=probe_stats)
    if log:
        console.info('%s', report.pretty())
    return img, report


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """JAX profiler scope: xprof/TensorBoard trace of everything inside."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
