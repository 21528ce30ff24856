"""Generated meshes: the stand-ins for the reference's teapot and bullet
models, and the benchmark scene's size."""
import numpy as np
import pytest

from raytracer_tpu.geometry import shapes
from raytracer_tpu.io.objload import compute_tangents
from raytracer_tpu.scenes import registry


def _face_normals(m):
    p = m.vertices[m.face_v]
    return np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])


def _edge_use(m, decimals=5):
    """Undirected edges -> use count, with vertices welded by position (the
    UV seam duplicates positions)."""
    _, weld = np.unique(np.round(m.vertices, decimals), axis=0,
                        return_inverse=True)
    f = weld.reshape(-1)[m.face_v]
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]),
                axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    return counts


def test_teapot_prototype_size_and_normals():
    m = shapes.teapot()
    assert m.num_tris == 576
    lo, hi = m.vertices.min(0), m.vertices.max(0)
    assert lo[1] == 0.0 and 3.0 < hi[1] < 3.5            # rests on y = 0
    assert 5.5 < hi[0] - lo[0] < 6.5                     # spout to handle
    lens = np.linalg.norm(m.normals, axis=1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-5)
    # every triangle is wound like its vertex normals
    fn = _face_normals(m)
    vn = m.normals[m.face_n].sum(1)
    assert np.all(np.sum(fn * vn, axis=1) > 0)
    assert np.all(np.linalg.norm(fn, axis=1) > 0)        # none degenerate
    assert m.texcoords.min() >= 0.0 and m.texcoords.max() <= 1.0
    compute_tangents(m)
    assert np.isfinite(m.tangents).all() and np.isfinite(m.bitangents).all()


@pytest.mark.parametrize('mesh', ['capsule', 'teapot_body'])
def test_revolved_meshes_are_closed_with_outward_normals(mesh):
    if mesh == 'capsule':
        m = shapes.capsule((1.0, 0.2, 0.0), radius=0.4, height=1.2)
        center = np.asarray([1.0, 0.2, 0.0])
    else:
        m = shapes.revolve([(0.0, 0.05), (1.3, 0.0), (2.0, 0.6), (2.1, 1.1),
                            (1.2, 2.5), (0.0, 3.2)], n_seg=16)
        center = np.asarray([0.0, 1.5, 0.0])
    # closed: every edge is shared by exactly two triangles
    assert np.all(_edge_use(m) == 2)
    # outward: face normals point away from the centre
    fn = _face_normals(m)
    ctr = m.vertices[m.face_v].mean(1)
    assert np.all(np.sum(fn * (ctr - center), axis=1) > 0)


def test_bench_scene_triangle_count():
    """The benchmark's sponza_proxy hd keeps its 174,724 triangles."""
    scene, _, _ = registry.make('sponza_proxy', width=8, height=8, hd=True,
                                bvh=False)
    assert scene.num_tris == 174_724


def test_asset_scene_names_missing_file(monkeypatch):
    monkeypatch.delenv('RT_ASSETS', raising=False)
    with pytest.raises(FileNotFoundError, match='sky.hdr'):
        registry.make('dome_teapot', size=8)
