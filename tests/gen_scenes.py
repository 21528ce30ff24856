"""Test scenes with generated textures, in place of the registry scenes that
read the reference's texture and HDR files (alpha_leaf, dome_teapot).

Same layout, materials and lights as those registry scenes; the leaf
texture is a green disc whose alpha cuts out the corners of the quad, and
the sky is a smooth blue-to-white gradient with a bright sun spot.
"""
import numpy as np

from raytracer_tpu.core.types import Camera, RenderSettings
from raytracer_tpu.geometry import shapes
from raytracer_tpu.geometry.build import SceneBuilder


def leaf_texture(n=32) -> np.ndarray:
    """(n, n, 4) RGBA: green disc, alpha 1 inside the disc and 0 outside."""
    y, x = np.mgrid[0:n, 0:n] / (n - 1) * 2.0 - 1.0
    inside = (x * x + y * y) <= 0.8
    img = np.zeros((n, n, 4), np.float32)
    img[..., 0] = 0.2 + 0.1 * x
    img[..., 1] = 0.6 + 0.2 * y
    img[..., 2] = 0.1
    img[..., 3] = inside
    return img


def sky_hdr(h=16, w=32) -> np.ndarray:
    """(h, w, 3) lat-long sky: blue at the horizon to white at the zenith,
    with one bright sun texel block."""
    t = np.linspace(1.0, 0.0, h)[:, None, None]
    img = (t * np.asarray([1.0, 1.0, 1.0]) + (1 - t) *
           np.asarray([0.2, 0.4, 0.9])) * np.ones((h, w, 3))
    img[2:4, 5:7] = 40.0
    return img.astype(np.float32)


def leaf_scene(size=32, max_bounces=2, **kw):
    """alpha_leaf's layout (makeAlphaTest, src/Assignment3.h:19-95): two
    translucent alpha-cutout leaf quads lit from below and behind, under
    an environment map, path traced."""
    b = SceneBuilder()
    leaf_tex = b.add_texture(leaf_texture())
    env = b.add_texture(sky_hdr())
    leaf = b.add_blinn(kd=(1, 1, 1), translucency=0.9, tex_color=leaf_tex,
                       tex_alpha=leaf_tex)
    for dx, dy, z in ((-2.0, 0.0, 0.0), (-1.0, 0.5, -0.5)):
        b.add_mesh(shapes.quad((dx - 1, dy - 1, z), (dx + 1, dy - 1, z),
                               (dx + 1, dy + 1, z), (dx - 1, dy + 1, z)),
                   leaf)
    b.add_point_light((-10, -10, -10), 4000.0)
    b.set_env_map(env, 1.0)
    b.set_bg_color((0, 0, 0))
    scene = b.build(bvh=True)
    cam = Camera.make(eye=(-1.5, 0.3, 4), look_at=(-1.5, 0.3, 0), fov=45.0)
    settings = RenderSettings(width=size, height=size, path_trace=True,
                              max_bounces=max_bounces,
                              max_wavefront_steps=max_bounces + 2, **kw)
    return scene, cam, settings


def dome_scene(size=16, dome_samples=2, **kw):
    """dome_teapot's layout: ground quad and teapot under an importance-
    sampled HDR dome light, the same sky as the environment map."""
    b = SceneBuilder()
    sky = b.add_texture(sky_hdr())
    ground = b.add_blinn(kd=(0.6, 0.6, 0.5))
    b.add_mesh(shapes.quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8)),
               ground)
    pot = b.add_blinn(kd=(0.9, 0.85, 0.8), spec_amt=0.3, spec_exp=20.0)
    b.add_mesh(shapes.teapot(), pot)
    b.set_dome_light(sky, gain=1.0, num_samples=dome_samples)
    b.set_env_map(sky, 1.0)
    scene = b.build(bvh=True)
    cam = Camera.make(eye=(0, 2.5, 5), look_at=(0, 0.8, 0), fov=45.0)
    settings = RenderSettings(width=size, height=size, path_trace=False,
                              max_wavefront_steps=2, **kw)
    return scene, cam, settings
