"""Core math + IO loader tests. The loaders read small OBJ/TGA/HDR files
that the tests write themselves."""
import struct

import numpy as np
import jax.numpy as jnp

from raytracer_tpu.core import vecmath as vm
from raytracer_tpu.geometry import shapes
from raytracer_tpu.io import imageio, objload


def _write_obj(path, mesh):
    """MeshData -> Wavefront OBJ with v/vt/vn and 1-based v/vt/vn faces."""
    lines = [f'v {x:.6f} {y:.6f} {z:.6f}' for x, y, z in mesh.vertices]
    lines += [f'vt {u:.6f} {v:.6f}' for u, v in mesh.texcoords]
    lines += [f'vn {x:.6f} {y:.6f} {z:.6f}' for x, y, z in mesh.normals]
    for fv, ft, fn in zip(mesh.face_v + 1, mesh.face_t + 1, mesh.face_n + 1):
        lines.append('f ' + ' '.join(f'{a}/{b}/{c}'
                                     for a, b, c in zip(fv, ft, fn)))
    path.write_text('\n'.join(lines) + '\n')
    return str(path)


def test_normalize_and_dot():
    a = jnp.asarray([[3.0, 0.0, 4.0]])
    n = vm.normalize(a)
    assert np.allclose(np.asarray(vm.length(n)), 1.0, atol=1e-6)
    assert np.allclose(np.asarray(vm.dot(a, a)), 25.0)


def test_reflect():
    d = jnp.asarray([[1.0, -1.0, 0.0]]) / np.sqrt(2)
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    r = vm.reflect(d, n)
    assert np.allclose(np.asarray(r), [[1 / np.sqrt(2), 1 / np.sqrt(2), 0]],
                       atol=1e-6)


def test_fresnel_normal_incidence():
    # Rs at normal incidence = ((n1-n2)/(n1+n2))^2
    rs = vm.fresnel(jnp.asarray(1.0), jnp.asarray(1.5), jnp.asarray(1.0))
    assert np.allclose(np.asarray(rs), ((1 - 1.5) / (1 + 1.5)) ** 2, atol=1e-6)


def test_fresnel_tir():
    # glass->air beyond the critical angle: total internal reflection
    cos_i = 0.2  # theta ~ 78deg > asin(1/1.5) ~ 41.8deg
    rs = vm.fresnel(jnp.asarray(1.5), jnp.asarray(1.0), jnp.asarray(cos_i))
    assert np.allclose(np.asarray(rs), 1.0, atol=1e-6)


def test_refract_straight_through():
    d = jnp.asarray([[0.0, -1.0, 0.0]])
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    t = vm.refract(d, n, jnp.asarray([1.0]), jnp.asarray([1.0 / 1.5]))
    assert np.allclose(np.asarray(t), np.asarray(d), atol=1e-6)


def test_tone_map_matches_reference_lut():
    # reference: Map() clamps to 32768 then linear_to_gamma LUT (src/Image.cpp:71-76)
    c = jnp.asarray([0.0, 0.5, 1.0, 2.0])
    u8 = np.asarray(vm.tone_map_u8(c))
    expect = []
    for r in [0.0, 0.5, 1.0, 2.0]:
        linear = min(int(32768.0 * r), 32768)
        expect.append(int((linear / 32768.0) ** (1 / 2.2) * 255.0 + 0.5))
    assert list(u8) == expect


def test_cosine_sample_distribution():
    import jax
    n = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (20000, 1))
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    e1 = jax.random.uniform(k1, (20000,))
    e2 = jax.random.uniform(k2, (20000,))
    s = np.asarray(vm.cosine_sample(n, e1, e2))
    assert (s[:, 2] > 0).all()
    # E[cos theta] for cosine-weighted = 2/3 (with the 0.99 clamp ~ same)
    assert abs(s[:, 2].mean() - 2 / 3) < 0.02


def test_obj_load_triangle(tmp_path):
    p = tmp_path / 'triangle.obj'
    p.write_text('# one triangle\nv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n')
    m = objload.load_obj(str(p))
    assert m.num_tris >= 1
    assert m.vertices.shape[1] == 3


def test_obj_load_teapot_normals(tmp_path):
    m = objload.load_obj(_write_obj(tmp_path / 'teapot.obj', shapes.teapot()))
    assert m.num_tris == 576
    lens = np.linalg.norm(m.normals, axis=1)
    assert np.all(lens > 0.99) and np.all(lens < 1.01)


def test_tga_load(tmp_path):
    # 3x2 uncompressed BGR, bottom-left origin (descriptor bit 0x20 clear)
    w, h = 3, 2
    bgr = np.arange(w * h * 3, dtype=np.uint8).reshape(h, w, 3) * 10
    header = struct.pack('<BBBHHBHHHHBB', 0, 0, 2, 0, 0, 0, 0, 0, w, h, 24, 0)
    p = tmp_path / 'x.tga'
    p.write_bytes(header + bgr.tobytes())
    img, t = imageio.load_tga(str(p))
    assert img.ndim == 3 and img.shape[2] in (1, 3, 4)
    assert img.min() >= 0.0 and img.max() <= 1.0
    assert t == imageio.RGB and img.shape == (h, w, 3)
    # file rows are bottom-first and BGR: loaded top-first and RGB
    np.testing.assert_allclose(img[0, 0], imageio._G2L[bgr[1, 0, ::-1]])


def test_tga_gamma_lut():
    # gamma->linear table matches reference quantization (src/Image.cpp:24-27)
    val = np.floor((128 / 255.0) ** 2.2 * 32768.0 + 0.5) / 32768.0
    assert abs(imageio._G2L[128] - val) < 1e-7


def test_hdr_load(tmp_path):
    # 2x8 RGBE: one new-style RLE scanline and one flat scanline
    w = 8
    rle = bytes([2, 2, 0, w])
    for c, val in enumerate((128, 64, 32, 129)):     # run of w per channel
        rle += bytes([128 + w, val])
    flat = bytes([128, 64, 32, 129]) * w
    p = tmp_path / 'x.hdr'
    p.write_bytes(b'#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X 8\n'
                  + rle + flat)
    img, t = imageio.load_hdr(str(p))
    assert t == imageio.HDR
    assert img.ndim == 3 and img.shape[2] == 3
    assert np.isfinite(img).all() and img.max() > 0
    # RGBE (128, 64, 32, e=129) -> mantissa * 2^(e - 136)
    np.testing.assert_allclose(img, np.broadcast_to(
        np.asarray([128, 64, 32], np.float32) * 2.0 ** -7, (2, w, 3)))


def test_ppm_roundtrip(tmp_path):
    img = (np.arange(2 * 3 * 3).reshape(2, 3, 3) * 10).astype(np.uint8)
    p = str(tmp_path / 'x.ppm')
    imageio.write_ppm(p, img)
    back, _ = imageio.load_ppm(p)
    # writer flips vertically (file stores top-first); loader keeps file order
    assert np.allclose(back[::-1] * 255, img)
