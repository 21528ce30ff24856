"""The compiled Triton cluster kernel on a GPU against the XLA sweep.

These tests skip without a GPU (the kernel has no CPU form; the CPU tests run
it through the Pallas interpreter). chip_smoke.py phase 2 checks the same
kernel on the card at the bench scene's full size.
"""
import numpy as np
import jax
import pytest

from raytracer_tpu.core.vecmath import MIRO_TMAX
from raytracer_tpu.ops import cluster_trace
from raytracer_tpu.ops.pallas import cluster_kernel
from raytracer_tpu.scenes import registry
from tests.test_cluster import _random_rays


@pytest.mark.gpu
@pytest.mark.parametrize('name', ['teapot_blinn', 'mb_bullet'])
@pytest.mark.parametrize('any_hit', [False, True], ids=['nearest', 'any'])
def test_compiled_kernel_matches_xla(gpu, name, any_hit):
    scene, cam, st = registry.make(name, size=16, bvh=True)
    o, d, time = _random_rays(scene, 1000, 3)
    tmax = 5.0 if any_hit else MIRO_TMAX
    with jax.default_matmul_precision('highest'):
        hk = cluster_kernel.pallas_cluster_trace(scene, o, d, time, 1e-3,
                                                 tmax, any_hit)
        hx = cluster_trace.cluster_trace(scene, o, d, time, 1e-3, tmax,
                                         any_hit)
    np.testing.assert_array_equal(np.asarray(hk.tri) >= 0,
                                  np.asarray(hx.tri) >= 0)
    if not any_hit:
        np.testing.assert_array_equal(np.asarray(hk.tri), np.asarray(hx.tri))
        np.testing.assert_allclose(np.asarray(hk.t), np.asarray(hx.t),
                                   rtol=1e-5, atol=1e-5)
