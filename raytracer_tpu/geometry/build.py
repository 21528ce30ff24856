"""Host-side scene assembly: meshes/materials/textures/lights -> Scene pytree.

Replaces the reference's imperative scene constructors (makeFinalScene etc.,
src/main.cpp:132-671) and Scene::preCalc (src/Scene.cpp:62-79). Everything
here is numpy; the result is a pytree of device arrays ready for jit.
"""
from __future__ import annotations

import math

import jax
from dataclasses import dataclass, field

import numpy as np

from ..core import types as T
from ..io import imageio
from ..io.objload import MeshData, compute_tangents


def _bilinear_lookup(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Numpy mirror of Texture::getLookup (src/Texture.cpp:43-72): wrap, flip
    v, bilinear with tiled pixel fetch. img is (H, W, C) top-row-first."""
    h, w = img.shape[:2]
    u = u - np.trunc(u)
    v = v - np.trunc(v)
    u = np.where(u < 0, u + 1.0, u)
    v = np.where(v < 0, v + 1.0, v)
    v = 1.0 - v
    px = u * w
    py = v * h
    x1 = np.floor(px).astype(np.int64)
    y1 = np.floor(py).astype(np.int64)
    dx = (px - x1)[..., None]
    dy = (py - y1)[..., None]
    x2 = (x1 + 1) % w
    y2 = (y1 + 1) % h
    x1 %= w
    y1 %= h
    q1 = img[y1, x1] * (1 - dx) + img[y1, x2] * dx
    q2 = img[y2, x1] * (1 - dx) + img[y2, x2] * dx
    return q1 * (1 - dy) + q2 * dy


def _cdf_1d(f: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Distribution1D::computeStep1dCDF (src/DomeLight.h:21-30).
    Returns (cdf[n+1], func_int)."""
    n = f.shape[-1]
    cdf = np.zeros(f.shape[:-1] + (n + 1,), np.float64)
    cdf[..., 1:] = np.cumsum(f, axis=-1) / n
    func_int = cdf[..., -1].copy()
    safe = np.where(func_int > 0, func_int, 1.0)
    cdf /= safe[..., None]
    return cdf.astype(np.float32), func_int.astype(np.float32)


@dataclass
class _ProtoRange:
    lo: int
    hi: int


class SceneBuilder:
    def __init__(self):
        # geometry pools
        self._verts: list[np.ndarray] = []
        self._verts_t1: list[np.ndarray] = []
        self._norms: list[np.ndarray] = []
        self._uvs: list[np.ndarray] = [np.zeros((1, 2), np.float32)]
        self._tans: list[np.ndarray] = []
        self._bitans: list[np.ndarray] = []
        self._face_v: list[np.ndarray] = []
        self._face_n: list[np.ndarray] = []
        self._face_t: list[np.ndarray] = []
        self._face_mat: list[np.ndarray] = []
        self._face_has_uv: list[np.ndarray] = []
        self._face_mb: list[np.ndarray] = []
        self._nv = 0
        self._nn = 0
        self._nt = 1  # slot 0 is a zero uv
        self._ntri = 0
        # materials
        self._mats: list[dict] = []
        # textures
        self._tex_imgs: list[np.ndarray] = []
        # lights
        self._point_lights: list[dict] = []
        self._rect_lights: list[dict] = []
        self._dome: dict | None = None
        # instancing
        self._protos: list[_ProtoRange] = []
        self._open_proto: int | None = None
        self._instances: list[dict] = []
        # env
        self._env_tex = -1
        self._env_exposure = 1.0
        self._bg = np.zeros(3, np.float32)
        self._has_mb = False

    # ----------------------------------------------------------- textures
    def add_texture(self, img: np.ndarray) -> int:
        """img: (H, W, C) float32, top-row-first. Returns texture id."""
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = img[..., None]
        self._tex_imgs.append(img)
        return len(self._tex_imgs) - 1

    def add_texture_file(self, path: str) -> int:
        img, _ = imageio.load_image(path)
        return self.add_texture(img)

    # ---------------------------------------------------------- materials
    def _add_material(self, kind, kd, ka, ks, kt, ior, spec_exp, spec_amt,
                      reflect_amt, refract_amt, spec_gloss, translucency,
                      emitted_power, le, disperse, sample_env, env_exposure,
                      tex_color, tex_alpha, tex_normal, tex_spec, tex_reflect,
                      tex_refract, tex_env) -> int:
        def v3(x):
            x = np.asarray(x, np.float32)
            return np.broadcast_to(x, (3,)).copy()
        ior = np.asarray(ior, np.float32)
        if ior.ndim == 0:
            ior = np.repeat(ior[None], 3)
        self._mats.append(dict(
            kind=kind, kd=v3(kd), ka=v3(ka), ks=v3(ks), kt=v3(kt), ior=ior,
            spec_exp=spec_exp, spec_amt=spec_amt, reflect_amt=reflect_amt,
            refract_amt=refract_amt, spec_gloss=spec_gloss,
            translucency=translucency, emitted_power=emitted_power, le=v3(le),
            disperse=disperse, sample_env=sample_env, env_exposure=env_exposure,
            tex_color=tex_color, tex_alpha=tex_alpha, tex_normal=tex_normal,
            tex_spec=tex_spec, tex_reflect=tex_reflect, tex_refract=tex_refract,
            tex_env=tex_env))
        return len(self._mats) - 1

    def add_lambert(self, kd=(1, 1, 1), ka=(0, 0, 0), tex_color=-1) -> int:
        return self._add_material(T.MAT_LAMBERT, kd, ka, (0, 0, 0), (0, 0, 0),
                                  1.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0,
                                  (0, 0, 0), False, True, 1.0,
                                  tex_color, -1, -1, -1, -1, -1, -1)

    def add_blinn(self, kd=(1, 1, 1), ka=(0, 0, 0), ks=(1, 1, 1), kt=(0, 0, 0),
                  ior=1.5, spec_exp=1.0, spec_amt=0.0, reflect_amt=0.0,
                  refract_amt=0.0, spec_gloss=1.0, translucency=0.0,
                  emitted_power=0.0, le=(0, 0, 0), disperse=False,
                  sample_env=True, env_exposure=1.0, tex_color=-1,
                  tex_alpha=-1, tex_normal=-1, tex_spec=-1, tex_reflect=-1,
                  tex_refract=-1, tex_env=-1) -> int:
        """Defaults mirror the Blinn ctor (src/Blinn.cpp:15-33)."""
        return self._add_material(T.MAT_BLINN, kd, ka, ks, kt, ior, spec_exp,
                                  spec_amt, reflect_amt, refract_amt,
                                  spec_gloss, translucency, emitted_power, le,
                                  disperse, sample_env, env_exposure,
                                  tex_color, tex_alpha, tex_normal, tex_spec,
                                  tex_reflect, tex_refract, tex_env)

    # ----------------------------------------------------------- geometry
    def add_mesh(self, mesh: MeshData, material: int | np.ndarray,
                 mesh_t1: MeshData | None = None) -> None:
        """Append a mesh to the open prototype (or the static world).

        mesh_t1 gives the t=1 vertex pose for motion blur (reference MBObject,
        src/MBObject.h:11-27); topology must match mesh's.
        """
        if mesh.tangents is None:
            compute_tangents(mesh)
        ntri = mesh.num_tris
        self._verts.append(mesh.vertices)
        self._verts_t1.append(mesh.vertices if mesh_t1 is None
                              else mesh_t1.vertices.astype(np.float32))
        self._norms.append(mesh.normals)
        self._tans.append(mesh.tangents)
        self._bitans.append(mesh.bitangents)
        self._face_v.append(mesh.face_v + self._nv)
        self._face_n.append(mesh.face_n + self._nn)
        if mesh.texcoords is not None:
            self._uvs.append(mesh.texcoords)
            self._face_t.append(mesh.face_t + self._nt)
            self._face_has_uv.append(np.ones(ntri, bool))
            self._nt += len(mesh.texcoords)
        else:
            self._face_t.append(np.zeros((ntri, 3), np.int32))
            self._face_has_uv.append(np.zeros(ntri, bool))
        mat = np.asarray(material, np.int32)
        self._face_mat.append(np.broadcast_to(mat, (ntri,)).copy())
        mb = mesh_t1 is not None
        self._face_mb.append(np.full(ntri, mb, bool))
        self._has_mb = self._has_mb or mb
        self._nv += len(mesh.vertices)
        self._nn += len(mesh.normals)
        self._ntri += ntri

    # ---------------------------------------------------------- instancing
    def begin_prototype(self) -> None:
        assert self._open_proto is None, 'prototype already open'
        self._open_proto = self._ntri

    def end_prototype(self) -> int:
        """Close the prototype; returns its id (reference setupMultiProxy,
        src/ProxyObject.cpp:149-167)."""
        assert self._open_proto is not None
        self._protos.append(_ProtoRange(self._open_proto, self._ntri))
        self._open_proto = None
        return len(self._protos) - 1

    def add_instance(self, proto: int, m: np.ndarray) -> None:
        """m: (3,4) or (4,4) object->world transform."""
        m = np.asarray(m, np.float32)
        if m.shape == (4, 4):
            m = m[:3]
        self._instances.append(dict(proto=proto, m=m))

    # -------------------------------------------------------------- lights
    def add_point_light(self, position, power, color=(1, 1, 1),
                        cast_shadows=True, fast_shadows=True) -> None:
        self._point_lights.append(dict(position=np.asarray(position, np.float32),
                                       power=float(power),
                                       color=np.asarray(color, np.float32),
                                       cast_shadows=cast_shadows,
                                       fast_shadows=fast_shadows))

    def add_rect_light(self, v1, v2, v3, power, color=(1, 1, 1),
                       num_samples=1, cast_shadows=True,
                       fast_shadows=True) -> None:
        self._rect_lights.append(dict(
            v1=np.asarray(v1, np.float32), v2=np.asarray(v2, np.float32),
            v3=np.asarray(v3, np.float32), power=float(power),
            color=np.asarray(color, np.float32), num_samples=int(num_samples),
            cast_shadows=cast_shadows, fast_shadows=fast_shadows))

    def set_dome_light(self, tex: int, gain=1.0, num_samples=1,
                       cast_shadows=True, fast_shadows=True) -> None:
        self._dome = dict(tex=tex, gain=float(gain),
                          num_samples=int(num_samples),
                          cast_shadows=cast_shadows, fast_shadows=fast_shadows)

    def set_env_map(self, tex: int, exposure: float = 1.0) -> None:
        self._env_tex = tex
        self._env_exposure = float(exposure)

    def set_bg_color(self, color) -> None:
        self._bg = np.asarray(color, np.float32)

    # --------------------------------------------------------------- build
    def _build_dome(self) -> T.DomeLight | None:
        """2D CDF over the lat-long map (src/DomeLight.cpp:8-78):
        per-column v-distribution weighted by sin(pi*(v+.5)/nv), marginal over
        u from the column integrals."""
        if self._dome is None:
            return None
        img = self._tex_imgs[self._dome['tex']]
        nv_, nu_ = img.shape[0], img.shape[1]
        uu, vv = np.meshgrid(np.arange(nu_) / nu_, np.arange(nv_) / nv_,
                             indexing='ij')  # (nu, nv)
        lum = _bilinear_lookup(img, uu, vv)[..., :3].mean(-1)  # (nu, nv)
        sin_w = np.sin(np.pi * (np.arange(nv_) + 0.5) / nv_)
        v_func = (lum * sin_w[None, :]).astype(np.float32)      # (nu, nv)
        v_cdf, v_int = _cdf_1d(v_func)
        u_func = v_int.astype(np.float32)                        # (nu,)
        u_cdf, u_int = _cdf_1d(u_func)
        return T.DomeLight(
            tex=self._dome['tex'], gain=np.float32(self._dome['gain']),
            u_cdf=u_cdf, u_func=u_func, u_func_int=np.float32(u_int),
            v_cdf=v_cdf, v_func=v_func, v_func_int=v_int,
            cast_shadows=self._dome['cast_shadows'],
            fast_shadows=self._dome['fast_shadows'],
            num_samples=self._dome['num_samples'])

    def build(self, bvh: bool = True, leaf_size: int = 4) -> T.Scene:
        assert self._open_proto is None, 'unclosed prototype'
        assert self._ntri > 0, 'empty scene'

        geom = T.Geometry(
            vertices=np.concatenate(self._verts).astype(np.float32),
            vertices_t1=np.concatenate(self._verts_t1).astype(np.float32),
            normals=np.concatenate(self._norms).astype(np.float32),
            texcoords=np.concatenate(self._uvs).astype(np.float32),
            tangents=np.concatenate(self._tans).astype(np.float32),
            bitangents=np.concatenate(self._bitans).astype(np.float32),
            face_v=np.concatenate(self._face_v).astype(np.int32),
            face_n=np.concatenate(self._face_n).astype(np.int32),
            face_t=np.concatenate(self._face_t).astype(np.int32),
            face_mat=np.concatenate(self._face_mat).astype(np.int32),
            face_has_uv=np.concatenate(self._face_has_uv),
            face_mb=np.concatenate(self._face_mb),
        )

        mats = self._mats or [dict()]
        if not self._mats:
            self.add_lambert()
            mats = self._mats

        def col(key, dtype=np.float32):
            return np.asarray([m[key] for m in mats], dtype)

        materials = T.Materials(
            kind=col('kind', np.int32), kd=col('kd'), ka=col('ka'),
            ks=col('ks'), kt=col('kt'), ior=col('ior'),
            spec_exp=col('spec_exp'), spec_amt=col('spec_amt'),
            reflect_amt=col('reflect_amt'), refract_amt=col('refract_amt'),
            spec_gloss=col('spec_gloss'), translucency=col('translucency'),
            emitted_power=col('emitted_power'), le=col('le'),
            disperse=col('disperse', bool), sample_env=col('sample_env', bool),
            env_exposure=col('env_exposure'),
            tex_color=col('tex_color', np.int32), tex_alpha=col('tex_alpha', np.int32),
            tex_normal=col('tex_normal', np.int32), tex_spec=col('tex_spec', np.int32),
            tex_reflect=col('tex_reflect', np.int32),
            tex_refract=col('tex_refract', np.int32),
            tex_env=col('tex_env', np.int32))

        # texture pack
        if self._tex_imgs:
            flats = [img.reshape(-1) for img in self._tex_imgs]
            offs = np.cumsum([0] + [len(x) for x in flats[:-1]]).astype(np.int32)
            textures = T.TexturePack(
                data=np.concatenate(flats).astype(np.float32),
                offset=offs,
                width=np.asarray([i.shape[1] for i in self._tex_imgs], np.int32),
                height=np.asarray([i.shape[0] for i in self._tex_imgs], np.int32),
                channels=np.asarray([i.shape[2] for i in self._tex_imgs], np.int32))
        else:
            # truly EMPTY pack: every lookup short-circuits statically
            # (shading/textures.py). A 1x1 placeholder texture would still
            # make each bounce gather (and, transposed, scatter) per-ray
            # texel indices
            textures = T.TexturePack(data=np.zeros(0, np.float32),
                                     offset=np.zeros(0, np.int32),
                                     width=np.zeros(0, np.int32),
                                     height=np.zeros(0, np.int32),
                                     channels=np.zeros(0, np.int32))

        pls = self._point_lights
        point_lights = T.PointLights(
            position=np.asarray([l['position'] for l in pls], np.float32).reshape(-1, 3),
            power=np.asarray([l['power'] for l in pls], np.float32),
            color=np.asarray([l['color'] for l in pls], np.float32).reshape(-1, 3),
            cast_shadows=tuple(bool(l['cast_shadows']) for l in pls),
            fast_shadows=tuple(bool(l['fast_shadows']) for l in pls))

        rls = self._rect_lights
        rect_lights = T.RectLights(
            v1=np.asarray([l['v1'] for l in rls], np.float32).reshape(-1, 3),
            v2=np.asarray([l['v2'] for l in rls], np.float32).reshape(-1, 3),
            v3=np.asarray([l['v3'] for l in rls], np.float32).reshape(-1, 3),
            power=np.asarray([l['power'] for l in rls], np.float32),
            color=np.asarray([l['color'] for l in rls], np.float32).reshape(-1, 3),
            cast_shadows=tuple(bool(l['cast_shadows']) for l in rls),
            fast_shadows=tuple(bool(l['fast_shadows']) for l in rls),
            num_samples=max([l['num_samples'] for l in rls], default=1))

        # ------------------------------------------------------ instancing
        # implicit world prototype: triangles not claimed by any prototype
        claimed = np.zeros(self._ntri, bool)
        for p in self._protos:
            claimed[p.lo:p.hi] = True
        world_tris = np.where(~claimed)[0].astype(np.int32)

        instances = []
        ident = np.concatenate([np.eye(3, dtype=np.float32),
                                np.zeros((3, 1), np.float32)], axis=1)
        if len(world_tris) > 0:
            instances.append(dict(m=ident, lo=-1, hi=-1, tris=world_tris))
        for inst in self._instances:
            p = self._protos[inst['proto']]
            instances.append(dict(m=inst['m'], lo=p.lo, hi=p.hi, tris=None))

        single_level = (len(instances) == 1 and instances[0]['tris'] is not None
                        and len(instances[0]['tris']) == self._ntri)

        from . import bvh as bvh_mod
        blas = None
        inst_table = None
        bvh_root = 0
        if bvh:
            blas, inst_table, bvh_root = bvh_mod.build_scene_bvh(
                geom, instances, self._protos, leaf_size=leaf_size)
        else:
            # brute-force instance table (single-level only)
            assert single_level, 'instancing requires bvh=True'

        has_alpha = bool(np.any(materials.tex_alpha[geom.face_mat] >= 0))
        has_mat_env = bool(np.any(materials.tex_env >= 0))
        has_disperse = bool(np.any(materials.disperse))
        has_transl = bool(np.any(materials.translucency > 0.01))

        # flat clusters for the block-coherent tracer (single-level scenes;
        # two-level scenes trace through the BVH)
        clusters = None
        edges = None
        from ..diff.edges import build_edge_table
        if single_level:
            from . import clusters as cl_mod
            clusters = cl_mod.build_clusters(geom)
            edges = build_edge_table(geom.face_v)
        elif inst_table is not None:
            edges = build_edge_table(geom.face_v)
            # flat (instance, edge) pair enumeration for instanced
            # silhouette sampling; edges assigned to instances by their
            # first adjacent face. Capped — beyond it (forest-scale:
            # every tree instance pairs with every tree edge) boundary
            # gradients stay out of scope and edges is dropped.
            fid0 = np.asarray(edges.fid)[:, 0]
            # count pairs per unique prototype range BEFORE materializing
            # (forest-scale scenes would enumerate ~100M pairs otherwise)
            sel_cache: dict = {}

            def inst_sel(inst):
                k = ('t', id(inst['tris'])) if inst['tris'] is not None \
                    else (inst['lo'], inst['hi'])
                if k not in sel_cache:
                    if inst['tris'] is not None:
                        sel_cache[k] = np.flatnonzero(
                            np.isin(fid0, np.asarray(inst['tris'])))
                    else:
                        sel_cache[k] = np.flatnonzero(
                            (fid0 >= inst['lo']) & (fid0 < inst['hi']))
                return sel_cache[k]

            n_pairs = sum(len(inst_sel(inst)) for inst in instances)
            if n_pairs <= 2_000_000:
                pi = [np.full(len(inst_sel(inst)), row, np.int32)
                      for row, inst in enumerate(instances)]
                pe = [inst_sel(inst).astype(np.int32)
                      for inst in instances]
                edges = edges.replace(pair_inst=np.concatenate(pi),
                                      pair_edge=np.concatenate(pe))
            else:
                edges = None

        scene = T.Scene(
            geom=geom, materials=materials, textures=textures,
            point_lights=point_lights, rect_lights=rect_lights,
            dome=self._build_dome(), blas=blas, tlas=None,
            instances=inst_table, clusters=clusters, edges=edges,
            env_exposure=np.float32(self._env_exposure),
            bg_color=self._bg, env_tex=self._env_tex,
            single_level=single_level, has_motion_blur=self._has_mb,
            has_alpha_maps=has_alpha,
            has_material_env=has_mat_env,
            has_dispersion=has_disperse, has_translucency=has_transl,
            bvh_root=bvh_root)
        # commit every table to the device ONCE: numpy pytree leaves
        # passed as jit arguments are re-uploaded on EVERY call
        return jax.device_put(scene)
