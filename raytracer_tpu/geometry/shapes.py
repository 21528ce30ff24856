"""Procedural mesh generators (host-side numpy).

The reference has no procedural shapes (its Sphere class is dead code,
src/Sphere.cpp); these generators supply test fixtures and stand-ins for the
reference's models (teapot.obj, bulletMB_01/02.obj, the Cornell box meshes)
and for the ones its scenes reference but don't ship (bunny.obj,
dragon_2.obj, sponza.obj — see BASELINE.md), so those scenes need no files.
"""
from __future__ import annotations

import numpy as np

from ..io.objload import MeshData


def uv_sphere(center=(0, 0, 0), radius=1.0, n_lat=16, n_lon=32,
              with_uv: bool = True) -> MeshData:
    """UV sphere with smooth normals."""
    center = np.asarray(center, np.float32)
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)
    tt, pp = np.meshgrid(lat, lon, indexing='ij')    # (n_lat+1, n_lon+1)
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    pts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    verts = center + radius * pts
    normals = pts.copy()
    uv = np.stack([pp / (2 * np.pi), 1.0 - tt / np.pi], -1).reshape(-1, 2)

    def vid(i, j):
        return i * (n_lon + 1) + j

    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b_, c, d = vid(i, j), vid(i, j + 1), vid(i + 1, j), vid(i + 1, j + 1)
            if i > 0:
                faces.append((a, c, b_))
            if i < n_lat - 1:
                faces.append((b_, c, d))
    face_v = np.asarray(faces, np.int32)
    return MeshData(vertices=verts, normals=normals.astype(np.float32),
                    texcoords=uv.astype(np.float32) if with_uv else None,
                    face_v=face_v, face_n=face_v.copy(),
                    face_t=face_v.copy() if with_uv else None)


def quad(v0, v1, v2, v3, with_uv: bool = True) -> MeshData:
    """Two-triangle quad v0-v1-v2-v3 (counter-clockwise)."""
    verts = np.asarray([v0, v1, v2, v3], np.float32)
    n = np.cross(verts[1] - verts[0], verts[3] - verts[0])
    n = (n / max(np.linalg.norm(n), 1e-20)).astype(np.float32)
    face_v = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return MeshData(vertices=verts, normals=np.repeat(n[None], 4, 0),
                    texcoords=uv if with_uv else None,
                    face_v=face_v,
                    face_n=face_v.copy(),
                    face_t=face_v.copy() if with_uv else None)


def box(lo, hi) -> MeshData:
    """Axis-aligned box with outward flat normals."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                        [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                        [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]],
                       np.float32)
    quads = [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
             (2, 3, 7, 6), (1, 2, 6, 5), (0, 4, 7, 3)]
    verts, norms, faces = [], [], []
    for q in quads:
        base = len(verts)
        pts = corners[list(q)]
        n = np.cross(pts[1] - pts[0], pts[3] - pts[0])
        n /= max(np.linalg.norm(n), 1e-20)
        verts.extend(pts)
        norms.extend([n] * 4)
        faces.append((base, base + 1, base + 2))
        faces.append((base, base + 2, base + 3))
    face_v = np.asarray(faces, np.int32)
    return MeshData(vertices=np.asarray(verts, np.float32),
                    normals=np.asarray(norms, np.float32),
                    texcoords=None, face_v=face_v, face_n=face_v.copy(),
                    face_t=None)


def cylinder(center, radius, height, n_seg=24) -> MeshData:
    """Open cylinder (columns for the sponza stand-in)."""
    center = np.asarray(center, np.float32)
    ang = np.linspace(0, 2 * np.pi, n_seg + 1)[:-1]
    ring = np.stack([np.cos(ang), np.zeros_like(ang), np.sin(ang)], -1)
    bot = center + radius * ring
    top = bot + np.asarray([0, height, 0], np.float32)
    verts = np.concatenate([bot, top]).astype(np.float32)
    normals = np.concatenate([ring, ring]).astype(np.float32)
    faces = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        faces.append((i, n_seg + i, j))
        faces.append((j, n_seg + i, n_seg + j))
    face_v = np.asarray(faces, np.int32)
    return MeshData(vertices=verts, normals=normals, texcoords=None,
                    face_v=face_v, face_n=face_v.copy(), face_t=None)


def merge(meshes) -> MeshData:
    """Concatenate meshes into one (all with UVs, or all without)."""
    cat = lambda xs: np.concatenate(xs).astype(xs[0].dtype)
    off = lambda key: np.cumsum([0] + [len(getattr(m, key))
                                       for m in meshes[:-1]])
    ov, on = off('vertices'), off('normals')
    with_uv = meshes[0].texcoords is not None
    return MeshData(
        vertices=cat([m.vertices for m in meshes]),
        normals=cat([m.normals for m in meshes]),
        texcoords=cat([m.texcoords for m in meshes]) if with_uv else None,
        face_v=cat([m.face_v + o for m, o in zip(meshes, ov)]),
        face_n=cat([m.face_n + o for m, o in zip(meshes, on)]),
        face_t=(cat([m.face_t + o for m, o in zip(meshes, off('texcoords'))])
                if with_uv else None))


def _grid_mesh(pos, nrm, uv) -> MeshData:
    """(rows, cols) grid of points -> two triangles per cell.

    Triangles that collapse (rows of coincident points at a pole) are
    dropped, and each triangle is wound so its face normal agrees with the
    vertex normals."""
    rows, cols = pos.shape[:2]
    vid = np.arange(rows * cols).reshape(rows, cols)
    a, b = vid[:-1, :-1].ravel(), vid[:-1, 1:].ravel()
    c, d = vid[1:, :-1].ravel(), vid[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, c, b], 1), np.stack([b, c, d], 1)])
    verts = pos.reshape(-1, 3).astype(np.float32)
    norms = nrm.reshape(-1, 3)
    norms = (norms / np.linalg.norm(norms, axis=1, keepdims=True)
             ).astype(np.float32)
    p = verts[faces]
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    area = np.linalg.norm(fn, axis=1)
    keep = area > 1e-6 * area.max()
    faces, fn = faces[keep], fn[keep]
    flip = np.sum(fn * norms[faces].sum(1), axis=1) < 0
    faces[flip] = faces[flip][:, ::-1]
    faces = faces.astype(np.int32)
    return MeshData(vertices=verts, normals=norms,
                    texcoords=uv.reshape(-1, 2).astype(np.float32),
                    face_v=faces, face_n=faces.copy(), face_t=faces.copy())


def revolve(profile, n_seg=16) -> MeshData:
    """Surface of revolution about +y of a (K, 2) profile of (radius, y)
    points, with smooth normals and (angle, profile) UVs. Profile points
    of radius 0 close the surface at a pole."""
    prof = np.asarray(profile, np.float64)
    r, y = prof[:, 0], prof[:, 1]
    # profile tangent by central differences -> outward (r, y) normal
    dr = np.gradient(r)
    dy = np.gradient(y)
    nr, ny = dy, -dr
    ang = np.linspace(0.0, 2.0 * np.pi, n_seg + 1)
    ca, sa = np.cos(ang)[None, :], np.sin(ang)[None, :]
    grid = (len(r), n_seg + 1)
    pos = np.stack([r[:, None] * ca, np.broadcast_to(y[:, None], grid),
                    r[:, None] * sa], -1)
    nrm = np.stack([nr[:, None] * ca, np.broadcast_to(ny[:, None], grid),
                    nr[:, None] * sa], -1)
    s = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(r), np.diff(y)))])
    uv = np.stack(np.broadcast_arrays(ang[None, :] / (2 * np.pi),
                                      (s / s[-1])[:, None]), -1)
    return _grid_mesh(pos, nrm, uv)


def tube(path, radius, n_seg=8) -> MeshData:
    """Open tube of per-point `radius` along a (K, 3) path in the xy plane."""
    path = np.asarray(path, np.float64)
    radius = np.broadcast_to(np.asarray(radius, np.float64), path.shape[:1])
    tan = np.gradient(path, axis=0)
    tan /= np.linalg.norm(tan, axis=1, keepdims=True)
    side = np.stack([-tan[:, 1], tan[:, 0], np.zeros(len(path))], 1)
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    up = np.cross(tan, side)
    ang = np.linspace(0.0, 2.0 * np.pi, n_seg + 1)
    ring = (np.cos(ang)[None, :, None] * side[:, None]
            + np.sin(ang)[None, :, None] * up[:, None])     # (K, n+1, 3)
    pos = path[:, None] + radius[:, None, None] * ring
    uv = np.stack(np.broadcast_arrays(
        ang[None, :] / (2 * np.pi),
        np.linspace(0.0, 1.0, len(path))[:, None]), -1)
    return _grid_mesh(pos, ring, uv)


def teapot() -> MeshData:
    """Stand-in for the reference's teapot.obj: 576 triangles at its size
    (about 6 units across the spout and handle, 3.2 tall, resting on y=0),
    with normals and UVs. A revolved body with lid and knob (384
    triangles), a handle and a spout (96 triangles each). The base is
    slightly domed, so it touches a floor at y=0 only along its rim
    instead of lying in the floor's plane."""
    body = revolve([(0.0, 0.05), (1.3, 0.0), (1.75, 0.2), (2.0, 0.6),
                    (2.1, 1.1), (2.0, 1.6), (1.75, 2.05), (1.45, 2.35),
                    (1.2, 2.5), (0.85, 2.7), (0.4, 2.85), (0.35, 3.0),
                    (0.22, 3.15), (0.0, 3.2)], n_seg=16)
    phi = np.radians(np.linspace(60.0, 300.0, 7))
    handle = tube(np.stack([-2.1 + 0.75 * np.cos(phi),
                            1.45 + 0.75 * np.sin(phi),
                            np.zeros(7)], 1), 0.12)
    s = np.linspace(0.0, 1.0, 7)[:, None]
    p0, p1, p2 = (np.asarray(v, np.float64) for v in
                  ((1.6, 0.9, 0.0), (2.7, 1.0, 0.0), (3.1, 2.3, 0.0)))
    spout = tube((1 - s) ** 2 * p0 + 2 * s * (1 - s) * p1 + s ** 2 * p2,
                 np.linspace(0.35, 0.15, 7))
    return merge([body, handle, spout])


def capsule(center=(0, 0, 0), radius=0.5, height=2.0, n_seg=16,
            n_cap=4) -> MeshData:
    """Closed capsule along +y (a bullet stand-in): a cylinder of `height`
    between two hemispherical caps, centred on `center`."""
    th = np.linspace(0.0, 0.5 * np.pi, n_cap + 1)
    lo = [(radius * np.sin(t), -0.5 * height - radius * np.cos(t))
          for t in th]
    hi = [(r, -yy) for r, yy in lo[::-1]]
    m = revolve(lo + hi, n_seg=n_seg)
    m.vertices += np.asarray(center, np.float32)
    return m
