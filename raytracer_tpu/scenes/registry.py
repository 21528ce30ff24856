"""Named scene fixtures.

The reference hard-codes scenes as C++ functions selected at compile time
(src/main.cpp:29, src/Assignment*.h, src/assignment2.h); here they are a
registry of builders returning (Scene, Camera, RenderSettings). Parameters
mirror the reference constructors cited per scene.

Scenes whose meshes the reference ships (teapot, Cornell box, motion-blur
bullet, sponza light quad) build them in code (geometry/shapes.py), so they
need no files. Scenes that need the reference's textures, HDR maps or other
models read them from the directory RT_ASSETS names (the reference's asset
tree: Models/, Textures/, Images/); without it they raise naming the file.
bunny.obj / dragon_2.obj / sponza.obj are referenced by the original scenes
but not shipped (BASELINE.md); procedural stand-ins are used where needed.
"""
from __future__ import annotations

import os

import numpy as np

from ..core.types import Camera, RenderSettings
from ..geometry.build import SceneBuilder
from ..geometry import shapes
from ..io.objload import MeshData, load_obj, make_single_triangle


def asset(*parts: str) -> str:
    """Path of a file in the reference's asset tree (RT_ASSETS); raises a
    FileNotFoundError naming the file when it is not there."""
    root = os.environ.get('RT_ASSETS', '')
    path = os.path.join(root, *parts)
    if not root or not os.path.isfile(path):
        raise FileNotFoundError(
            f"scene asset {os.path.join(*parts)} not found"
            + (f' under RT_ASSETS={root}' if root else
               ' (RT_ASSETS is not set)')
            + ": point RT_ASSETS at a copy of the reference's asset tree")
    return path

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def names():
    return sorted(_REGISTRY)


def make(name, **kwargs):
    return _REGISTRY[name](**kwargs)


@register('triangle_sphere')
def triangle_sphere(size=256, bvh=False, **kw):
    """BASELINE config #1: single triangle + sphere + point light, Lambert,
    256x256, CPU-runnable. Layout follows makeTeapotScene2's floor/light
    (src/assignment2.h:34-80) with a unit sphere instead of the teapot."""
    b = SceneBuilder()
    lam = b.add_lambert(kd=(1.0, 1.0, 1.0))
    b.add_mesh(make_single_triangle((-10, 0, -10), (0, 0, 10), (10, 0, -10),
                                    n=(0, 1, 0)), lam)
    b.add_mesh(shapes.uv_sphere((0, 1, 0), 1.0, 12, 24, with_uv=False), lam)
    b.add_point_light((10, 10, 10), 700.0)
    b.set_bg_color((0.0, 0.0, 0.2))
    scene = b.build(bvh=bvh)
    cam = Camera.make(eye=(0, 3, 6), look_at=(0, 0, 0), fov=45.0)
    settings = RenderSettings(width=size, height=size, path_trace=False,
                              max_bounces=5, max_wavefront_steps=2, **kw)
    return scene, cam, settings


def _facing(corners, normal) -> MeshData:
    """shapes.quad over 4 corners, wound so its normal points along
    `normal`."""
    q = shapes.quad(*corners)
    if np.dot(q.normals[0], normal) < 0:
        q = shapes.quad(*corners[::-1])
    return q


def _cornell_box(b: SceneBuilder, emitter_power=0.0, blocks=True):
    """Shared Cornell geometry (makePathTracingScene,
    src/assignment2.h:379-438): a 5.5-unit box open towards +z (the
    camera), red wall at x=0, green wall at x=5.5, an emitter patch under
    the ceiling at the rect light's corners, and (blocks=True) the classic
    short and tall white blocks."""
    L = 5.5
    lmat = b.add_blinn(kd=(1, 1, 1), emitted_power=emitter_power, le=(1, 1, 1))
    y = L - 0.01
    b.add_mesh(_facing([(2.5, y, -3.0), (3.0, y, -3.0), (3.0, y, -2.5),
                        (2.5, y, -2.5)], (0, -1, 0)), lmat)
    wmat = b.add_blinn(kd=(1, 1, 1))
    for corners, n in (
            ([(0, 0, 0), (L, 0, 0), (L, 0, -L), (0, 0, -L)], (0, 1, 0)),
            ([(0, L, 0), (L, L, 0), (L, L, -L), (0, L, -L)], (0, -1, 0)),
            ([(0, 0, -L), (L, 0, -L), (L, L, -L), (0, L, -L)], (0, 0, 1))):
        b.add_mesh(_facing(corners, n), wmat)
    if blocks:
        b.add_mesh(shapes.box((1.3, 0.0, -2.7), (2.9, 1.65, -1.1)), wmat)
        b.add_mesh(shapes.box((3.0, 0.0, -4.6), (4.6, 3.3, -3.0)), wmat)
    rmat = b.add_blinn(kd=(0.80, 0.20, 0.20))
    b.add_mesh(_facing([(0, 0, 0), (0, 0, -L), (0, L, -L), (0, L, 0)],
                       (1, 0, 0)), rmat)
    gmat = b.add_blinn(kd=(0.20, 0.80, 0.20))
    b.add_mesh(_facing([(L, 0, 0), (L, 0, -L), (L, L, -L), (L, L, 0)],
                       (-1, 0, 0)), gmat)


@register('cornell_pt')
def cornell_pt(size=512, num_rect_samples=4, bvh=True, max_bounces=5, **kw):
    """BASELINE config #2: Cornell box, path traced, area RectangleLight.

    Mirrors makePathTracingScene (src/assignment2.h:379-438) geometry/light;
    bounce count is configurable (the reference uses numPaths=100,
    maxBounces=40 — fold paths into spp at render time)."""
    b = SceneBuilder()
    _cornell_box(b, emitter_power=50.0)
    b.add_rect_light((3.0, 5.5, -2.5), (3.0, 5.5, -3.0), (2.5, 5.5, -2.5),
                     power=10.0, num_samples=num_rect_samples)
    b.set_bg_color((0, 0, 0))
    scene = b.build(bvh=bvh)
    cam = Camera.make(eye=(2.25, 2.25, 5.5), look_at=(2.5, 2.25, 0), fov=55.0)
    settings = RenderSettings(width=size, height=size, path_trace=True,
                              max_bounces=max_bounces,
                              max_wavefront_steps=max_bounces + 2, **kw)
    return scene, cam, settings


@register('cornell_spheres')
def cornell_spheres(size=512, bvh=True, **kw):
    """makePathTracingScene3 (src/assignment2.h:440-524): Cornell box with a
    glass sphere and a glossy metal sphere, adaptive 1..4 subdivs. The box
    and spheres are generated (_cornell_box, shapes.uv_sphere).

    Note: the reference's setIor(2.2) only writes IOR channel 0, which the
    shader never reads for non-dispersive materials (src/Blinn.cpp:183 reads
    m_ior[1] = ctor default 1.5) — we set all channels, i.e. the intent."""
    b = SceneBuilder()
    _cornell_box(b, emitter_power=0.0, blocks=False)
    glass = b.add_blinn(kd=(0.7, 0.1, 0.05), spec_exp=30.0, ior=2.2,
                        reflect_amt=1.0, refract_amt=1.0)
    b.add_mesh(shapes.uv_sphere((1.8, 1.0, -2.0), 1.0), glass)
    metal = b.add_blinn(kd=(0.09, 0.094, 0.1), spec_exp=30.0, spec_amt=0.0,
                        ior=6.0, reflect_amt=0.90, refract_amt=0.0,
                        spec_gloss=0.98)
    b.add_mesh(shapes.uv_sphere((3.8, 1.0, -3.6), 1.0), metal)
    b.add_rect_light((3.0, 5.5, -2.5), (3.0, 5.5, -3.0), (2.5, 5.5, -2.5),
                     power=15.0, num_samples=1)
    b.set_bg_color((0, 0, 0))
    scene = b.build(bvh=bvh)
    cam = Camera.make(eye=(2.75, 2.75, 5.0), look_at=(2.75, 2.75, 0),
                      fov=55.0, focus_plane=8.6, aperture=0.0)
    settings = RenderSettings(width=size, height=size, path_trace=True,
                              max_bounces=5, min_subdivs=1, max_subdivs=4,
                              noise_threshold=0.01, max_wavefront_steps=8, **kw)
    return scene, cam, settings


@register('teapot_blinn')
def teapot_blinn(size=512, bvh=True, spec=True, **kw):
    """BASELINE config #3 stand-in: teapot + floor, Blinn, point light, BVH
    (makeTeapotScene2, src/assignment2.h:34-80; bunny.obj is not shipped).
    The teapot is generated (shapes.teapot)."""
    b = SceneBuilder()
    mat = b.add_blinn(kd=(1, 1, 1),
                      spec_amt=0.5 if spec else 0.0, spec_exp=30.0)
    b.add_mesh(shapes.teapot(), mat)
    b.add_mesh(make_single_triangle((-10, 0, -10), (0, 0, 10), (10, 0, -10),
                                    n=(0, 1, 0)), mat)
    b.add_point_light((10, 10, 10), 700.0)
    b.set_bg_color((0.0, 0.0, 0.2))
    scene = b.build(bvh=bvh)
    cam = Camera.make(eye=(0, 3, 6), look_at=(0, 0, 0), fov=45.0)
    settings = RenderSettings(width=size, height=size, path_trace=False,
                              max_wavefront_steps=2, **kw)
    return scene, cam, settings


@register('dome_teapot')
def dome_teapot(size=512, hdr='sky.hdr', dome_samples=4, bvh=True,
                ground='grass', **kw):
    """BASELINE config #4 stand-in: textured ground + teapot under an HDR
    DomeLight with importance sampling (dragon_2.obj is not shipped).
    Dome mechanics mirror makeFinalScene's sky.hdr dome (src/main.cpp:150-165).

    ground='stone' bakes the procedural Worley/Perlin StoneTexture
    (shading/procedural.py, reference src/StoneTexture.cpp:10-109 as used
    on live scene floors, src/main.cpp:18) onto the ground plane."""
    b = SceneBuilder()
    sky = b.add_texture_file(asset('Textures', hdr))
    if ground == 'stone':
        from ..shading.procedural import bake_stone_texture
        grass = b.add_texture(bake_stone_texture(size=256))
    else:
        grass = b.add_texture_file(asset('Textures', 'grass-color-01.tga'))
    gmat = b.add_blinn(kd=(1, 1, 1), tex_color=grass)
    b.add_mesh(shapes.quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8)),
               gmat)
    tmat = b.add_blinn(kd=(0.9, 0.85, 0.8), spec_amt=0.3, spec_exp=20.0)
    b.add_mesh(shapes.teapot(), tmat)
    b.set_dome_light(sky, gain=1.0, num_samples=dome_samples)
    b.set_env_map(sky, 1.0)
    scene = b.build(bvh=bvh)
    cam = Camera.make(eye=(0, 2.5, 5), look_at=(0, 0.8, 0), fov=45.0)
    settings = RenderSettings(width=size, height=size, path_trace=False,
                              max_wavefront_steps=2, **kw)
    return scene, cam, settings


@register('mb_bullet')
def mb_bullet(size=256, bvh=True, shutter=1.0, **kw):
    """Motion-blur fixture: a bullet in two poses (reference MBObject with
    the Models/bulletMB_01/02.obj pair, makeFinalScene src/main.cpp:167-200;
    here a generated capsule that moves between the poses)."""
    b = SceneBuilder()
    mat = b.add_blinn(kd=(0.8, 0.7, 0.2), spec_amt=0.4, spec_exp=15.0)
    m0 = shapes.capsule((0.0, 0.0, 0.0), radius=0.4, height=1.2)
    m1 = shapes.capsule((1.0, 0.2, 0.0), radius=0.4, height=1.2)
    b.add_mesh(m0, mat, mesh_t1=m1)
    floor = b.add_lambert(kd=(0.7, 0.7, 0.7))
    b.add_mesh(make_single_triangle((-20, -2, -20), (0, -2, 20), (20, -2, -20),
                                    n=(0, 1, 0)), floor)
    b.add_point_light((5, 10, 5), 500.0)
    b.set_bg_color((0.1, 0.1, 0.15))
    scene = b.build(bvh=bvh)
    lo = m0.vertices.min(0)
    hi = m0.vertices.max(0)
    c = 0.5 * (lo + hi)
    cam = Camera.make(eye=c + np.asarray([0, 0.5, 3.5]) * (hi - lo).max(),
                      look_at=c, fov=45.0, shutter=shutter)
    settings = RenderSettings(width=size, height=size, path_trace=False,
                              max_wavefront_steps=2, **kw)
    return scene, cam, settings


@register('instanced_teapots')
def instanced_teapots(size=256, grid=4, bvh=True, **kw):
    """Two-level instancing fixture (reference ProxyObject grids,
    makeBunny20Scene2 src/assignment2.h:137+ / makeProxyGrid src/main.cpp:37)."""
    b = SceneBuilder()
    mat = b.add_blinn(kd=(0.8, 0.5, 0.3), spec_amt=0.3, spec_exp=20.0)
    b.begin_prototype()
    b.add_mesh(shapes.teapot(), mat)
    proto = b.end_prototype()
    rng = np.random.default_rng(3163513)  # reference MT seed (src/Scene.cpp:28)
    for i in range(grid):
        for j in range(grid):
            ang = rng.uniform(0, 2 * np.pi)
            ca, sa = np.cos(ang), np.sin(ang)
            s = rng.uniform(0.6, 1.2)
            m = np.asarray([[s * ca, 0, s * sa, (i - grid / 2) * 3.0],
                            [0, s, 0, 0],
                            [-s * sa, 0, s * ca, (j - grid / 2) * 3.0]],
                           np.float32)
            b.add_instance(proto, m)
    floor = b.add_lambert(kd=(0.7, 0.7, 0.7))
    b.add_mesh(make_single_triangle((-60, 0, -60), (0, 0, 60), (60, 0, -60),
                                    n=(0, 1, 0)), floor)
    b.add_point_light((20, 30, 20), 5000.0)
    b.set_bg_color((0.05, 0.05, 0.1))
    scene = b.build(bvh=True)
    cam = Camera.make(eye=(0, 8, grid * 2.5 + 6), look_at=(0, 0.5, 0), fov=45.0)
    settings = RenderSettings(width=size, height=size, path_trace=False,
                              max_wavefront_steps=2, **kw)
    return scene, cam, settings


@register('instanced_grid')
def instanced_grid(size=256, n=100_000, spacing=2.0, **kw):
    """Instance-count scaling demo: n teapots on a jittered grid — the
    reference's marquee result is 1M instanced bunnies (webpage
    'Instancing'; src/ProxyObject.cpp:149-167, src/BVH.cpp:1305-1338).
    One prototype is shared by every instance (two-level BVH), so memory
    grows with n only by the instance table."""
    b = SceneBuilder()
    mat = b.add_blinn(kd=(0.75, 0.55, 0.35), spec_amt=0.3, spec_exp=20.0)
    b.begin_prototype()
    b.add_mesh(shapes.teapot(), mat)
    proto = b.end_prototype()
    g = int(np.ceil(np.sqrt(n)))
    rng = np.random.default_rng(3163513)
    ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing='ij')
    ii = ii.reshape(-1)[:n]
    jj = jj.reshape(-1)[:n]
    ang = rng.uniform(0, 2 * np.pi, n)
    sc = rng.uniform(0.5, 1.0, n).astype(np.float32)
    jit = rng.uniform(-0.3, 0.3, (n, 2)).astype(np.float32)
    ca, sa = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    tx = ((ii - g / 2) * spacing + jit[:, 0]).astype(np.float32)
    tz = ((jj - g / 2) * spacing + jit[:, 1]).astype(np.float32)
    ms = np.zeros((n, 3, 4), np.float32)
    ms[:, 0, 0] = sc * ca
    ms[:, 0, 2] = sc * sa
    ms[:, 1, 1] = sc
    ms[:, 2, 0] = -sc * sa
    ms[:, 2, 2] = sc * ca
    ms[:, 0, 3] = tx
    ms[:, 2, 3] = tz
    for k in range(n):
        b.add_instance(proto, ms[k])
    b.add_point_light((0, g * spacing, 0), float(g * spacing) ** 2 * 2.0)
    b.set_bg_color((0.05, 0.05, 0.1))
    scene = b.build(bvh=True)
    cam = Camera.make(eye=(0, g * spacing * 0.12, g * spacing * 0.55),
                      look_at=(0, 0.0, 0), fov=50.0)
    settings = RenderSettings(width=size, height=size, path_trace=False,
                              max_wavefront_steps=2, **kw)
    return scene, cam, settings


@register('sponza_proxy')
def sponza_proxy(width=1920, height=1080, bvh=True, path_trace=True,
                 max_bounces=10, rect_samples=1, hd=False, **kw):
    """BASELINE config #5 stand-in: sponza.obj is not shipped with the
    reference (only its light quad, Models/sponza-light.obj), so this builds
    a comparable atrium (floor, walls, colonnade, dense teapot clutter)
    with an emitter quad at the rectangle light's corners
    (makeSponzaScenePathTrace, src/assignment2.h:663-710). Everything is
    generated; the clutter is the 576-triangle shapes.teapot.

    hd=True is the benchmark configuration: 174,724 triangles with real
    interior occlusion — a second-story gallery slab with a central
    opening, an upper colonnade row, balustrade blocks, and 3x the floor
    clutter (real Sponza is ~260k tris with two colonnade stories)."""
    b = SceneBuilder()
    white = b.add_blinn(kd=(1, 1, 1))
    lmat = b.add_blinn(kd=(1, 1, 1), emitted_power=1.5, le=(1, 1, 1))
    light = [(8.0, 10, 2), (8.0, 10, -2.0), (-8, 10, 2)]
    b.add_mesh(_facing([light[0], light[1],
                        tuple(np.add(light[1], light[2]) - light[0]),
                        light[2]], (0, -1, 0)), lmat)
    # atrium shell
    b.add_mesh(shapes.quad((-10, 0, -5), (10, 0, -5), (10, 0, 5), (-10, 0, 5),
                           with_uv=False), white)
    b.add_mesh(shapes.box((-10, 0, -5.2), (10, 8, -5.0)), white)
    b.add_mesh(shapes.box((-10, 0, 5.0), (10, 8, 5.2)), white)
    b.add_mesh(shapes.box((-10.2, 0, -5.2), (-10.0, 8, 5.2)), white)
    b.add_mesh(shapes.box((10.0, 0, -5.2), (10.2, 8, 5.2)), white)
    # ground-floor colonnade
    for i in range(12):
        x = -9 + i * 1.64
        for z in (-3.5, 3.5):
            b.add_mesh(shapes.cylinder((x, 0, z), 0.3, 5.0, n_seg=16), white)
    if hd:
        # second-story gallery: slabs along both sides with a central
        # opening (the atrium), upper colonnade + balustrade — the
        # occluders that make interior light transport sponza-like
        for z0, z1 in ((-5.0, -2.5), (2.5, 5.0)):
            b.add_mesh(shapes.box((-10, 4.8, z0), (10, 5.0, z1)), white)
        for x0, x1 in ((-10.0, -8.5), (8.5, 10.0)):
            b.add_mesh(shapes.box((x0, 4.8, -2.5), (x1, 5.0, 2.5)), white)
        for i in range(12):
            x = -9 + i * 1.64
            for z in (-3.0, 3.0):
                b.add_mesh(shapes.cylinder((x, 5.0, z), 0.25, 3.0,
                                           n_seg=16), white)
                # balustrade blocks between upper columns
                b.add_mesh(shapes.box((x - 0.7, 5.0, z - 0.08),
                                      (x + 0.7, 5.6, z + 0.08)), white)
    # clutter to sponza-scale triangle counts
    from ..io.objload import compute_tangents
    teapot = shapes.teapot()
    compute_tangents(teapot)
    rng = np.random.default_rng(3163513)
    n_teapots = kw.pop('n_teapots', 300 if hd else 100)
    for k in range(n_teapots):
        t = teapot.vertices * rng.uniform(0.2, 0.5)
        # hd: a third of the clutter lives on the upper gallery
        if hd and k % 3 == 0:
            t = t + np.asarray([rng.uniform(-9, 9), 5.0,
                                rng.uniform(-4.6, -2.8)], np.float32)
        else:
            t = t + np.asarray([rng.uniform(-9, 9), 0.0,
                                rng.uniform(-4, 4)], np.float32)
        m = MeshData(vertices=t.astype(np.float32), normals=teapot.normals,
                     texcoords=teapot.texcoords, face_v=teapot.face_v,
                     face_n=teapot.face_n, face_t=teapot.face_t,
                     tangents=teapot.tangents, bitangents=teapot.bitangents)
        b.add_mesh(m, white)
    b.add_rect_light(*light, power=1.5, num_samples=rect_samples)
    b.set_bg_color((0.0, 0.0, 0.2))
    scene = b.build(bvh=bvh)
    cam = Camera.make(eye=(8, 1.5, 1), look_at=(0, 2.5, -1), fov=55.0)
    settings = RenderSettings(width=width, height=height,
                              path_trace=path_trace, max_bounces=max_bounces,
                              max_wavefront_steps=max_bounces + 2
                              if path_trace else 2, **kw)
    return scene, cam, settings


@register('alpha_leaf')
def alpha_leaf(size=256, bvh=True, max_bounces=5, **kw):
    """makeAlphaTest (src/Assignment3.h:19-95): two leaf_test.obj quads with
    Tree_03_Leaves.tga as BOTH color and alpha map (cutout), translucency 0.9,
    one point light from below/behind, Topanga env map, path traced.

    (The reference loads Topanga_Forest_B_3k.hdr which is not shipped;
    Topanga_Forest_B_light.hdr is the shipped variant.)"""
    from ..core import transforms as tf
    b = SceneBuilder()
    leaf_tex = b.add_texture_file(asset('Textures', 'Tree_03_Leaves.tga'))
    env = b.add_texture_file(asset('Images', 'Topanga_Forest_B_light.hdr'))
    leaf2 = b.add_blinn(kd=(1, 1, 1), translucency=0.9,
                        tex_color=leaf_tex, tex_alpha=leaf_tex)
    b.add_mesh(load_obj(asset('Models', 'leaf_test.obj'),
                        tf.translate(-2, 0, 0)), leaf2)
    b.add_mesh(load_obj(asset('Models', 'leaf_test.obj'),
                        tf.translate(-1, 0.5, 0)), leaf2)
    b.add_point_light((-10, -10, -10), 4000.0)
    b.set_env_map(env, 1.0)
    b.set_bg_color((0, 0, 0))
    scene = b.build(bvh=bvh)
    cam = Camera.make(eye=(0, 3, 6), look_at=(0, 0, 0), fov=45.0,
                      aperture=0.001, focus_plane=4.0)
    settings = RenderSettings(width=size, height=size, path_trace=True,
                              max_bounces=max_bounces,
                              max_wavefront_steps=max_bounces + 2, **kw)
    return scene, cam, settings


@register('dispersion')
def dispersion(size=256, bvh=True, max_bounces=6, dome_samples=6, **kw):
    """testDispersion (src/Assignment3.h:97-193): glass sphere with
    per-channel IOR (1.57, 1.60, 1.62), disperse=True, sky.hdr dome light
    (power 0.15, 6 samples), Topanga env map, path traced."""
    b = SceneBuilder()
    sky = b.add_texture_file(asset('Images', 'sky.hdr'))
    env = b.add_texture_file(asset('Images', 'Topanga_Forest_B_light.hdr'))
    glass = b.add_blinn(kd=(0.0, 0.5, 0.5), spec_exp=30.0,
                        ior=(1.57, 1.60, 1.62), reflect_amt=1.0,
                        refract_amt=1.0, disperse=True)
    b.add_mesh(load_obj(asset('Models', 'sphere2.obj')), glass)
    b.set_dome_light(sky, gain=0.15, num_samples=dome_samples)
    b.set_env_map(env, 1.0)
    b.set_bg_color((0, 0, 0))
    scene = b.build(bvh=bvh)
    cam = Camera.make(eye=(0, 3, 6), look_at=(0, 2, 0), fov=45.0,
                      aperture=0.001, focus_plane=4.0)
    settings = RenderSettings(width=size, height=size, path_trace=True,
                              max_bounces=max_bounces,
                              max_wavefront_steps=max_bounces + 2, **kw)
    return scene, cam, settings


def _procedural_trunk(height=1.2, radius=0.05):
    """Stand-in for the unshipped Tree0*Body.obj meshes (referenced at
    src/main.cpp:245,320,352,366 but absent from Models/Final): a tapered
    trunk of stacked cylinders."""
    parts = []
    h0 = 0.0
    r = radius
    for seg in range(3):
        h = height * (0.5 if seg == 0 else 0.3 if seg == 1 else 0.2)
        parts.append(shapes.cylinder((0.0, h0, 0.0), r, h, n_seg=8))
        h0 += h
        r *= 0.65
    verts = np.concatenate([p.vertices for p in parts])
    norms = np.concatenate([p.normals for p in parts])
    nv = np.cumsum([0] + [len(p.vertices) for p in parts[:-1]])
    nn = np.cumsum([0] + [len(p.normals) for p in parts[:-1]])
    fv = np.concatenate([p.face_v + nv[i] for i, p in enumerate(parts)])
    fn = np.concatenate([p.face_n + nn[i] for i, p in enumerate(parts)])
    return MeshData(vertices=verts.astype(np.float32),
                    normals=norms.astype(np.float32), texcoords=None,
                    face_v=fv.astype(np.int32), face_n=fn.astype(np.int32),
                    face_t=None)


@register('final_forest')
def final_forest(width=1920, height=1080, bvh=True, n_trees=200,
                 n_flowers=100, grass_grid=40, max_bounces=5,
                 flatten=False, **kw):
    """The flagship scene: makeFinalScene (src/main.cpp:132-671).

    Instanced forest (tree prototypes with alpha-cutout leaf textures and
    translucency), flower prototypes, a grass proxy grid, motion-blurred
    dispersive glass explosion + textured cannonball, dirt ground plane,
    sky.hdr dome light, HDR env background, thin-lens DOF camera with 0.1
    shutter (camera01Settings, src/main.cpp:107-118).

    Unshipped assets substituted: Tree0*Body.obj -> procedural trunks;
    testGrass2.obj -> testGrass.obj; the .tga background ->
    hdrvfx_nyany_1_n2_v101_Ref.hdr. Instance counts are parameters (the
    reference uses ~400 trees, ~1170 flowers, 40k grass patches).

    flatten=True bakes instances into world-space triangles: single-level
    geometry takes the block-coherent cluster tracers instead of two-level
    BVH traversal, at the cost of memory proportional to the flattened
    triangle count.
    """
    from ..core import transforms as tf
    from ..io.objload import transform_mesh
    rng = np.random.default_rng(3163513)
    b = SceneBuilder()

    class _Inst:
        """Prototype/instance shim: flatten=True BAKES each placement as
        world-space geometry (single-level -> the block-coherent cluster
        tracers); flatten=False keeps true two-level instancing
        (reference ProxyObject semantics, memory-bounded)."""
        def __init__(self):
            self.protos = []
            self.cur = None

        def begin(self):
            if flatten:
                self.cur = []
            else:
                b.begin_prototype()

        def mesh(self, mesh, mat):
            if flatten:
                self.cur.append((mesh, mat))
            else:
                b.add_mesh(mesh, mat)

        def end(self):
            if flatten:
                self.protos.append(self.cur)
                self.cur = None
                return len(self.protos) - 1
            return b.end_prototype()

        def inst(self, proto, m):
            if flatten:
                for mesh, mat in self.protos[proto]:
                    b.add_mesh(transform_mesh(mesh, m), mat)
            else:
                b.add_instance(proto, m)

    I = _Inst()

    # env + dome (src/main.cpp:149-165)
    env = b.add_texture_file(asset('Textures', 'hdrvfx_nyany_1_n2_v101_Ref.hdr'))
    sky = b.add_texture_file(asset('Images', 'sky.hdr'))
    b.set_env_map(env, 1.5)
    b.set_dome_light(sky, gain=0.15, num_samples=kw.pop('dome_samples', 2))
    b.set_bg_color((0, 0, 0))

    # ground plane with dirt texture (src/main.cpp:185-227)
    dirt = b.add_texture_file(asset('Textures', 'ground-dirt-texture.tga'))
    dirt_mat = b.add_blinn(kd=(0.1, 0.1, 0.1), spec_exp=30.0, ior=1.8,
                           tex_color=dirt)
    b.add_mesh(load_obj(asset('Models', 'Final', 'groundPlane.obj')),
               dirt_mat)

    # motion-blurred dispersive glass explosion (src/main.cpp:167-203)
    glass = b.add_blinn(kd=(0.9, 0.9, 0.9), spec_exp=30.0, spec_amt=0.0,
                        ior=1.56, reflect_amt=1.0, refract_amt=1.0,
                        disperse=True)
    b.add_mesh(load_obj(asset('Models', 'Final', 'explosion01.obj')),
               glass,
               load_obj(asset('Models', 'Final', 'explosion02.obj')))

    # motion-blurred cannonball (src/main.cpp:205-223)
    bullet = b.add_texture_file(asset('Textures', 'bw2.tga'))
    cball = b.add_blinn(kd=(0.01, 0.01, 0.01), spec_exp=15.0, spec_amt=0.5,
                        ior=1.8, spec_gloss=0.9, tex_color=bullet)
    b.add_mesh(load_obj(asset('Models', 'Final', 'cannonBallT1.obj')),
               cball,
               load_obj(asset('Models', 'Final', 'cannonBallT2.obj')))

    # ---- tree prototypes (src/main.cpp:230-395): procedural trunk + shipped
    # alpha-cutout leaves
    bark2 = b.add_texture_file(asset('Textures', 'AL04brk.tga'))
    leaves2 = b.add_texture_file(asset('Textures', 'AL04aut.tga'))
    bark3 = b.add_texture_file(asset('Textures', 'AL17brk.tga'))
    leaves3 = b.add_texture_file(asset('Textures', 'AL17aut.tga'))
    t2_body_m = b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                            tex_color=bark2)
    t2_leaf_m = b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                            translucency=0.6, tex_color=leaves2,
                            tex_alpha=leaves2)
    t3_body_m = b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                            tex_color=bark3)
    t3_leaf_m = b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                            translucency=0.6, tex_color=leaves3,
                            tex_alpha=leaves3)

    I.begin()
    I.mesh(_procedural_trunk(), t2_body_m)
    I.mesh(load_obj(asset('Models', 'Final', 'tree02Leaves.obj')),
               t2_leaf_m)
    tree2 = I.end()
    I.begin()
    I.mesh(_procedural_trunk(1.5, 0.06), t3_body_m)
    I.mesh(load_obj(asset('Models', 'Final', 'tree03Leaves.obj')),
               t3_leaf_m)
    tree3 = I.end()

    # makeTrees placement (src/main.cpp:54-76): ring outside |x|,|z| < 100
    placed = 0
    while placed < n_trees:
        x, z = rng.random(), rng.random()
        if x * x + z * z > 1.0:
            continue
        tx, tz = x * 800.0, -z * 800.0
        if tx < 100.0 and tz > -100.0:
            continue
        m = tf.translate(tx, rng.random() * 0.5 - 0.5, tz) \
            @ tf.scale(rng.random() * 0.3 + 0.85, rng.random() * 0.3 + 0.85,
                       rng.random() * 0.3 + 0.85) \
            @ tf.rotate_y(rng.random() * 360.0)
        I.inst(tree2 if placed % 2 == 0 else tree3, m)
        placed += 1
    # the four hand-placed near trees (src/main.cpp:231-238, 283-306)
    I.inst(tree2, tf.translate(62.872, 0, -27.025) @ tf.scale(0.64))
    I.inst(tree3, tf.translate(0, 0, -21.013))
    I.inst(tree3, tf.translate(43.078, 0, -9.234)
                   @ tf.rotate_y(-105.05))
    I.inst(tree2, tf.translate(10.92, 0, -53.16) @ tf.scale(0.71)
                   @ tf.rotate_y(100.0))

    # ---- flower prototypes (src/main.cpp:397-655)
    fl_bulb = b.add_texture_file(asset('Textures', 'bud-yellow-1.tga'))
    fl_bulb_n = b.add_texture_file(asset('Textures', 'bud-yellow-1-bump_NRM.tga'))
    fl_body_t = b.add_texture_file(asset('Textures', 'grass-color-23.tga'))
    fl_leaf_t = b.add_texture_file(asset('Textures', 'grass-color-18.tga'))
    fl_petal = b.add_texture_file(asset('Textures', 'petal-pink-02.tga'))
    fl01_lef1 = b.add_texture_file(asset('Textures', 'FL30lef1.tga'))
    fl01_stm1 = b.add_texture_file(asset('Textures', 'FL30stm1.tga'))
    fl01_flo1 = b.add_texture_file(asset('Textures', 'FL30flo1.tga'))
    fl01_pet1 = b.add_texture_file(asset('Textures', 'FL30pet1.tga'))
    fl01_stm2 = b.add_texture_file(asset('Textures', 'FL30stm2.tga'))
    fl01_lef2 = b.add_texture_file(asset('Textures', 'FL30lef2.tga'))

    def flower_mat(tex, transl=0.0, alpha=-1, normal=-1):
        return b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                           translucency=transl, tex_color=tex,
                           tex_alpha=alpha, tex_normal=normal)

    F = asset('Models', 'Final')
    I.begin()
    I.mesh(load_obj(asset('Models', 'Final', 'flower02Body.obj')),
               flower_mat(fl_body_t))
    I.mesh(load_obj(asset('Models', 'Final', 'flower02Bulb.obj')),
               flower_mat(fl_bulb, normal=fl_bulb_n))
    I.mesh(load_obj(asset('Models', 'Final', 'flower02Leaves.obj')),
               flower_mat(fl_leaf_t, transl=0.5))
    I.mesh(load_obj(asset('Models', 'Final', 'flower02Petals.obj')),
               flower_mat(fl_petal, transl=0.6))
    flower02 = I.end()

    I.begin()
    I.mesh(load_obj(asset('Models', 'Final', 'flower01BigLeaves.obj')),
               flower_mat(fl01_lef1, transl=0.6, alpha=fl01_lef1))
    I.mesh(load_obj(asset('Models', 'Final', 'flower01Body.obj')),
               flower_mat(fl01_stm1))
    I.mesh(load_obj(asset('Models', 'Final', 'flower01Bulbs01.obj')),
               flower_mat(fl01_flo1))
    I.mesh(load_obj(asset('Models', 'Final', 'flower01Bulbs02.obj')),
               flower_mat(fl01_flo1))
    I.mesh(load_obj(asset('Models', 'Final', 'flower01Bulbs03.obj')),
               flower_mat(fl01_flo1))
    I.mesh(load_obj(asset('Models', 'Final', 'flower01Petals.obj')),
               flower_mat(fl01_pet1, transl=0.6))
    I.mesh(load_obj(asset('Models', 'Final', 'flower01Pistils.obj')),
               flower_mat(fl01_stm2))
    I.mesh(load_obj(asset('Models', 'Final', 'flower01SmallLeaves.obj')),
               flower_mat(fl01_lef2, transl=0.6, alpha=fl01_lef2))
    flower01 = I.end()

    cam_eye = np.asarray((-1.277, 0.158, 2.139), np.float32)
    # makeFlowers placement (src/main.cpp:78-97): disc around the camera
    for i in range(n_flowers):
        while True:
            x, z = rng.random(), rng.random()
            if x * x + z * z <= 1.0:
                break
        # reference makeFlowers (src/main.cpp:87-90): rotY then rotX (the
        # tilt axis spins with the yaw); RNG draw order unchanged
        # (translate, scale, tilt, yaw). DELIBERATE DEVIATION: the scale
        # here is a proper S applied before rotation (trans @ sc @ R),
        # whereas the reference's Matrix4x4::scale only multiplies the
        # diagonal entries of the already-rotated matrix
        # (src/Matrix4x4.h:757-762) — a shear-y scale quirk, not S*R.
        # Cosmetic flower-shape difference only.
        trans = tf.translate(cam_eye[0] + x * 10.0,
                             rng.random() * 0.05 - 0.025,
                             cam_eye[2] - z * 10.0)
        sc = tf.scale(rng.random() * 0.2 + 0.9, rng.random() * 0.2 + 0.95,
                      rng.random() * 0.2 + 0.9)
        tilt = tf.rotate_x(rng.random() * 20.0 + 10.0)
        yaw = tf.rotate_y(rng.random() * 360.0)
        m = trans @ sc @ yaw @ tilt
        I.inst(flower02 if i % 2 else flower01, m)

    # ---- grass proxy grid (makeProxyGrid, src/main.cpp:38-52)
    grass_tex = b.add_texture_file(asset('Textures', 'grassblade2.tga'))
    grass_m = b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                          tex_color=grass_tex)
    I.begin()
    I.mesh(load_obj(asset('Models', 'testGrass.obj')), grass_m)
    grass = I.end()
    for i in range(grass_grid):
        for j in range(grass_grid):
            m = tf.translate(-2 + i * (rng.random() * 0.2 + 0.2), 0,
                             3 - j * (rng.random() * 0.2 + 0.2)) \
                @ tf.scale(rng.random() * 0.3 + 0.85,
                           rng.random() * 0.3 + 0.7,
                           rng.random() * 0.3 + 0.85) \
                @ tf.rotate_y(rng.random() * 360.0)
            I.inst(grass, m)

    scene = b.build(bvh=bvh)
    cam = Camera.make(eye=cam_eye, look_at=(0.294, 0.511, 0.503),
                      fov=39.0, aperture=0.0018, focus_plane=2.0,
                      shutter=0.1)
    settings = RenderSettings(width=width, height=height, path_trace=False,
                              max_bounces=max_bounces,
                              max_wavefront_steps=max_bounces + 2, **kw)
    return scene, cam, settings
