"""Feature coverage: path tracing, dome light, instancing, motion blur,
procedural textures, dispersion-capable materials."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracer_tpu.render import renderer
from raytracer_tpu.scenes import registry
from raytracer_tpu.shading import procedural


def _render(name, size=16, spp=1, **kw):
    scene, cam, settings = registry.make(name, size=size, **kw)
    img = np.asarray(renderer.render(scene, cam, settings,
                                     jax.random.PRNGKey(0), spp=spp))
    assert np.isfinite(img).all(), f'{name}: non-finite pixels'
    return img, scene


def test_cornell_path_traced():
    img, scene = _render('cornell_pt', size=16, spp=2, num_rect_samples=1,
                         max_bounces=3)
    assert img.max() > 0.01  # light reaches the camera
    # color bleeding sanity: scene contains red+green walls -> nonzero all chans
    assert (img.sum((0, 1)) > 0).all()


@pytest.mark.slow
def test_cornell_whitted_vs_pt_differ():
    s, cam, st = registry.make('cornell_pt', size=8, num_rect_samples=1,
                               max_bounces=3)
    st_off = st.replace(path_trace=False)
    key = jax.random.PRNGKey(0)
    a = np.asarray(renderer.render(s, cam, st, key, spp=1))
    b = np.asarray(renderer.render(s, cam, st_off, key, spp=1))
    # GI adds energy somewhere
    assert not np.allclose(a, b)
    assert a.mean() > b.mean()


def test_dome_light():
    from tests.gen_scenes import dome_scene
    scene, cam, settings = dome_scene(size=16, dome_samples=2)
    img = np.asarray(renderer.render(scene, cam, settings,
                                     jax.random.PRNGKey(0), spp=1))
    assert np.isfinite(img).all()
    assert scene.dome is not None
    assert img.mean() > 0.01


@pytest.mark.slow
def test_instancing_matches_flattened():
    """TLAS/BLAS instancing renders ~ the same image as baking instances."""
    from raytracer_tpu.geometry import shapes
    from raytracer_tpu.geometry.build import SceneBuilder
    from raytracer_tpu.io.objload import MeshData, compute_tangents
    from raytracer_tpu.core.types import Camera, RenderSettings
    teapot = shapes.teapot()
    compute_tangents(teapot)
    xforms = []
    for k, (dx, dz, s) in enumerate([(-2, 0, 1.0), (2, 1, 0.7)]):
        m = np.asarray([[s, 0, 0, dx], [0, s, 0, 0], [0, 0, s, dz]],
                       np.float32)
        xforms.append(m)

    # instanced version
    b1 = SceneBuilder()
    mat = b1.add_blinn(kd=(0.8, 0.5, 0.3))
    b1.begin_prototype()
    b1.add_mesh(teapot, mat)
    proto = b1.end_prototype()
    for m in xforms:
        b1.add_instance(proto, m)
    b1.add_point_light((10, 10, 10), 700.0)
    b1.set_bg_color((0, 0, 0.2))
    s1 = b1.build(bvh=True)

    # flattened version (transforms baked into vertices)
    b2 = SceneBuilder()
    mat2 = b2.add_blinn(kd=(0.8, 0.5, 0.3))
    for m in xforms:
        v = teapot.vertices @ m[:, :3].T + m[:, 3]
        mm = MeshData(vertices=v.astype(np.float32), normals=teapot.normals,
                      texcoords=teapot.texcoords, face_v=teapot.face_v,
                      face_n=teapot.face_n, face_t=teapot.face_t,
                      tangents=teapot.tangents, bitangents=teapot.bitangents)
        b2.add_mesh(mm, mat2)
    b2.add_point_light((10, 10, 10), 700.0)
    b2.set_bg_color((0, 0, 0.2))
    s2 = b2.build(bvh=True)

    cam = Camera.make(eye=(0, 4, 8), look_at=(0, 0.5, 0), fov=45.0)
    st = RenderSettings(width=24, height=24, max_wavefront_steps=2)
    key = jax.random.PRNGKey(0)
    i1 = np.asarray(renderer.render_center(s1, cam, st, key))
    i2 = np.asarray(renderer.render_center(s2, cam, st, key))
    # identical geometry; uniform-scale instancing normals match baked ones
    diff = np.abs(i1 - i2).max(-1)
    assert (diff > 1e-3).mean() < 0.02, f'instancing mismatch {diff.max()}'


def test_motion_blur_spreads():
    scene, cam, st = registry.make('mb_bullet', size=24, shutter=1.0)
    key = jax.random.PRNGKey(0)
    blurred = np.asarray(renderer.render(scene, cam, st, key, spp=8))
    cam0 = cam.replace(shutter=jnp.float32(1e-3))
    sharp = np.asarray(renderer.render(scene, cam0, st, key, spp=8))
    assert np.isfinite(blurred).all() and np.isfinite(sharp).all()
    assert not np.allclose(blurred, sharp)
    # blur covers at least as many pixels with the object as the sharp frame
    bg = np.asarray([0.1, 0.1, 0.15])
    hit_b = (np.abs(blurred - bg).max(-1) > 1e-3).sum()
    hit_s = (np.abs(sharp - bg).max(-1) > 1e-3).sum()
    assert hit_b >= hit_s


def test_perlin_reference_values():
    # Perlin noise is deterministic: spot-check invariants
    n0 = float(procedural.perlin_noise(0.0, 0.0, 0.0))
    assert abs(n0) < 1e-6  # zero at lattice points
    n = np.asarray(procedural.perlin_noise(
        jnp.linspace(0, 10, 1000), jnp.linspace(0, 7, 1000),
        jnp.full(1000, 0.5)))
    assert np.isfinite(n).all()
    assert n.min() >= -1.0 and n.max() <= 1.0
    assert n.std() > 0.05


def test_stone_texture_bake():
    img = procedural.bake_stone_texture(num_cells=20, size=64)
    assert img.shape == (64, 64, 3)
    assert np.isfinite(img).all()
    # stone and grout regions both present
    assert img.std() > 0.05


@pytest.mark.slow
def test_glass_sphere_scene():
    img, scene = _render('cornell_spheres', size=12, spp=2)
    assert bool(scene.materials.reflect_amt.max() == 1.0)
    assert img.max() > 0.01


def test_use_schlick_fresnel_option():
    """The reference's USE_SCHLICK compile switch (src/Material.h:55-67) is
    a live RenderSettings knob: the Schlick render must differ from full
    Fresnel on a refractive scene yet stay close (the approximation is
    within a few percent away from grazing angles), and both formulas must
    agree exactly at normal incidence."""
    import jax
    import jax.numpy as jnp
    from raytracer_tpu.core import vecmath as vm
    from raytracer_tpu.render import renderer
    from raytracer_tpu.scenes import registry

    # normal incidence: R0 = ((n1-n2)/(n1+n2))^2 for both
    n1, n2 = jnp.float32(1.0), jnp.float32(1.5)
    full = float(vm.fresnel(n1, n2, jnp.float32(1.0)))
    schl = float(vm.schlick_fresnel(n1, n2, jnp.float32(1.0)))
    np.testing.assert_allclose(full, schl, rtol=1e-5)
    np.testing.assert_allclose(full, ((1.0 - 1.5) / 2.5) ** 2, rtol=1e-5)

    scene, cam, st = registry.make('cornell_spheres', size=24, bvh=True)
    key = jax.random.PRNGKey(0)
    a = np.asarray(renderer.render_center(scene, cam, st, key))
    b = np.asarray(renderer.render_center(
        scene, cam, st.replace(use_schlick=True), key))
    assert not np.array_equal(a, b)
    # per-pixel values can differ a lot (the changed Fresnel re-weights the
    # Russian-roulette split, realizing different branches per ray); the
    # total energy must stay in the same ballpark
    assert abs(a.mean() - b.mean()) < 0.25 * (a.mean() + 1e-3)
