"""Feature-activation coverage: alpha cutout, dispersion, translucency,
normal maps, and the flagship final_forest scene — each dormant path from
round 1/2 (VERDICT items 3-5) exercised through a real render.

Reference fixtures mirrored: makeAlphaTest (src/Assignment3.h:19-95),
testDispersion (src/Assignment3.h:97-193), makeFinalScene
(src/main.cpp:132-671).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from raytracer_tpu.render import renderer
from raytracer_tpu.scenes import registry


def _render(scene, cam, settings, spp=1, key=0):
    img = np.asarray(renderer.render(scene, cam, settings,
                                     jax.random.PRNGKey(key), spp=spp))
    assert np.isfinite(img).all()
    return img


@pytest.mark.slow
def test_stone_ground_renders():
    """Procedural Worley/Perlin StoneTexture baked onto the dome_teapot
    ground (reference StoneTexture on live floors, src/main.cpp:18,
    src/StoneTexture.cpp:10-109): the stone ground must render and differ
    from the grass ground with otherwise identical sampling."""
    kw = dict(size=24, dome_samples=1)
    s1, cam, st = registry.make('dome_teapot', ground='stone', **kw)
    s2, _, _ = registry.make('dome_teapot', ground='grass', **kw)
    img1 = _render(s1, cam, st)
    img2 = _render(s2, cam, st)
    assert img1.mean() > 0.01
    assert np.abs(img1 - img2).max() > 0.05
    # stone is grayscale-ish grout/cell pattern: per-pixel luminance varies
    lum = img1.mean(-1)
    assert lum.std() > 0.02


@pytest.mark.slow
def test_alpha_cutout_active():
    """The leaf texture's alpha channel must punch holes: disabling the
    alpha map (tex_alpha=-1) changes the image (reference cutout re-test,
    src/BVH.cpp:1401-1435)."""
    from tests.gen_scenes import leaf_scene
    scene, cam, settings = leaf_scene(size=32, max_bounces=2)
    assert scene.has_alpha_maps
    img = _render(scene, cam, settings)
    no_alpha = scene.replace(
        materials=scene.materials.replace(
            tex_alpha=jnp.full_like(scene.materials.tex_alpha, -1)),
        has_alpha_maps=False)
    img2 = _render(no_alpha, cam, settings)
    # cutout exposes the env/background through parts of the leaf quads
    assert not np.allclose(img, img2, atol=1e-3)
    diff_frac = np.mean(np.any(np.abs(img - img2) > 1e-3, axis=-1))
    assert diff_frac > 0.01, f'cutout changed only {diff_frac:.3%} of pixels'


@pytest.mark.slow
def test_dispersion_separates_channels():
    """disperse=True refracts each RGB channel with its own IOR
    (src/Blinn.cpp:275-301): the dispersing render must differ from the
    same scene with dispersion off (single IOR refraction)."""
    scene, cam, settings = registry.make('dispersion', size=32,
                                         max_bounces=4, dome_samples=1)
    assert scene.has_dispersion
    img = _render(scene, cam, settings, spp=2)
    no_disp = scene.replace(
        materials=scene.materials.replace(
            disperse=jnp.zeros_like(scene.materials.disperse)),
        has_dispersion=False)
    img2 = _render(no_disp, cam, settings, spp=2)
    assert img.max() > 0.01
    assert not np.allclose(img, img2, atol=1e-3)


def test_translucency_adds_backlight():
    """translucency samples lights on the back side (src/Blinn.cpp:223-236);
    the alpha_leaf layout's only light sits behind the leaves, so zeroing
    translucency must change (darken) lit leaf pixels."""
    from tests.gen_scenes import leaf_scene
    scene, cam, settings = leaf_scene(size=32, max_bounces=2)
    assert scene.has_translucency
    img = _render(scene, cam, settings)
    opaque = scene.replace(
        materials=scene.materials.replace(
            translucency=jnp.zeros_like(scene.materials.translucency)),
        has_translucency=False)
    img2 = _render(opaque, cam, settings)
    assert not np.allclose(img, img2, atol=1e-4)
    # removing the transmitted term can only lose energy
    assert img.sum() > img2.sum()


@pytest.mark.slow
def test_normal_map_perturbs_shading():
    """tex_normal routes the tangent-frame mapped normal into shading
    (src/Blinn.cpp:120-128). A constant-tilt normal map must change the
    image vs the unmapped normal."""
    import os
    from raytracer_tpu.geometry.build import SceneBuilder
    from raytracer_tpu.geometry import shapes
    from raytracer_tpu.core.types import Camera, RenderSettings

    def build(with_map):
        b = SceneBuilder()
        # normal map encoding: texel value used directly as TBN coords
        tilt = np.tile(np.asarray([0.45, 0.0, 0.89], np.float32),
                       (8, 8, 1))
        tid = b.add_texture(tilt) if with_map else -1
        m = b.add_blinn(kd=(0.8, 0.2, 0.2), spec_exp=10.0, spec_amt=0.5,
                        tex_normal=tid)
        b.add_mesh(shapes.quad((-2, 0, -2), (2, 0, -2), (2, 0, 2),
                               (-2, 0, 2)), m)
        b.add_point_light((3, 5, 3), 500.0)
        scene = b.build(bvh=False)
        cam = Camera.make(eye=(0, 3, 4), look_at=(0, 0, 0), fov=45.0)
        st = RenderSettings(width=16, height=16, path_trace=False,
                            max_wavefront_steps=2)
        return scene, cam, st

    s1, cam, st = build(True)
    s0, _, _ = build(False)
    img1 = _render(s1, cam, st)
    img0 = _render(s0, cam, st)
    assert not np.allclose(img1, img0, atol=1e-4)


@pytest.mark.slow
def test_final_forest_renders():
    """Flagship scene (instancing + alpha leaves + MB + dome + DOF) renders
    finite, non-trivial pixels at a reduced scale."""
    scene, cam, settings = registry.make(
        'final_forest', width=32, height=18, n_trees=6, n_flowers=3,
        grass_grid=3, max_bounces=2, dome_samples=1)
    assert scene.has_motion_blur
    assert scene.has_alpha_maps
    assert scene.has_translucency
    assert scene.has_dispersion
    assert not scene.single_level          # instanced two-level hierarchy
    assert scene.instances.m.shape[0] > 10
    img = _render(scene, cam, settings)
    assert img.mean() > 1e-3
    assert img.std() > 1e-3


@pytest.mark.slow
def test_per_light_adaptive_sampling_active():
    """Reference per-light adaptive behaviors (round-4 parity items):
    light_noise_cutoff (src/RectangleLight.cpp:117-124) stops weak-light
    sampling after the first draw, and light_secondary_single
    (src/DomeLight.cpp:89) drops secondary rays to 1 sample per area light.
    Both must change the estimate (they re-weight which RNG draws are
    used) while staying close to the full-sample mean."""
    scene, cam, st = registry.make('cornell_pt', size=16, bvh=True,
                                   num_rect_samples=4, max_bounces=2)
    key = jax.random.PRNGKey(4)
    base = _render(scene, cam, st.replace(light_noise_cutoff=0.0,
                                          light_secondary_single=False),
                   spp=4, key=4)
    # a cutoff far above any irradiance: every ray stops after 1 sample
    cut = _render(scene, cam, st.replace(light_noise_cutoff=1e9,
                                         light_secondary_single=False),
                  spp=4, key=4)
    assert not np.array_equal(base, cut)
    assert abs(cut.mean() - base.mean()) < 0.15 * base.mean() + 1e-3
    # secondary-single applies to the DOME light only, as in the reference
    # (DomeLight::sampleLight checks isSecondary, src/DomeLight.cpp:89;
    # RectangleLight always draws m_numSamples) — rect-light scenes are
    # unaffected by the flag...
    sec_rect = _render(scene, cam, st.replace(light_noise_cutoff=0.0,
                                              light_secondary_single=True),
                       spp=4, key=4)
    np.testing.assert_array_equal(base, sec_rect)
    # ...while dome scenes re-mask their secondary NEE draws
    from tests.gen_scenes import dome_scene
    sd, cd, std = dome_scene(size=16)
    # the fixture ships whitted-style; secondary NEE draws only exist on
    # GI bounces, so path-trace it
    std = std.replace(path_trace=True, max_bounces=2, max_wavefront_steps=4)
    base_d = _render(sd, cd, std.replace(light_secondary_single=False),
                     spp=2, key=4)
    sec_d = _render(sd, cd, std.replace(light_secondary_single=True),
                    spp=2, key=4)
    assert not np.array_equal(base_d, sec_d)
    assert abs(sec_d.mean() - base_d.mean()) < 0.2 * base_d.mean() + 1e-3
