"""Scene representation: a pytree of SoA arrays.

The reference scene is a pointer graph of C++ objects (Scene -> Objects ->
TriangleMesh / Material / Texture, src/Scene.h:13-85). This design
flattens everything into dense arrays so the whole scene is a jit-traceable
pytree: differentiable leaves are exactly the inverse-rendering targets
(vertices, material albedo/shininess, light power, texture texels), while
integer topology (faces, BVH nodes, texture descriptors) is non-differentiable
by dtype.

Static render parameters live in `RenderSettings` fields marked
pytree_node=False so they participate in jit specialization, mirroring the
reference's compile-time flags (src/Miro.h:10-67) and Scene knobs
(src/Scene.h:60-64).
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import numpy as np
from . import struct

Array = Any  # jax or numpy array


@struct.dataclass
class Geometry:
    """Triangle soup over shared vertex pools (reference: src/TriangleMesh.h:8-62).

    All meshes are concatenated; `face_*` index into the shared pools.
    Motion blur (reference MBObject, src/MBObject.h:11-27) is per-triangle:
    vertices_t1 holds the t=1 pose (equal to vertices for static geometry) and
    intersection lerps by ray time.
    """
    vertices: Array      # (V, 3) f32 — differentiable
    vertices_t1: Array   # (V, 3) f32 — motion-blur end pose
    normals: Array       # (N, 3) f32
    texcoords: Array     # (U, 2) f32
    tangents: Array      # (N, 3) f32 (zero when mesh has no UVs)
    bitangents: Array    # (N, 3) f32
    face_v: Array        # (T, 3) i32 vertex indices
    face_n: Array        # (T, 3) i32 normal indices
    face_t: Array        # (T, 3) i32 texcoord indices (0 when absent)
    face_mat: Array      # (T,) i32 material id
    face_has_uv: Array   # (T,) bool
    face_mb: Array       # (T,) bool — motion-blurred triangle

    @property
    def num_tris(self) -> int:
        return self.face_v.shape[0]


# Material kinds (reference: Lambert src/Lambert.h, Blinn src/Blinn.h)
MAT_LAMBERT = 0
MAT_BLINN = 1


@struct.dataclass
class Materials:
    """SoA material table (reference: src/Material.h:10-74, src/Blinn.h:8-66)."""
    kind: Array          # (M,) i32: MAT_LAMBERT | MAT_BLINN
    kd: Array            # (M, 3) diffuse
    ka: Array            # (M, 3) ambient
    ks: Array            # (M, 3) specular tint (scales reflect/refract too)
    kt: Array            # (M, 3) transmission tint (kept for parity)
    ior: Array           # (M, 3) per-channel IOR (dispersion)
    spec_exp: Array      # (M,) Blinn exponent
    spec_amt: Array      # (M,)
    reflect_amt: Array   # (M,)
    refract_amt: Array   # (M,)
    spec_gloss: Array    # (M,) 1 = mirror, <1 = glossy (src/Blinn.cpp:160-165)
    translucency: Array  # (M,)
    emitted_power: Array # (M,)
    le: Array            # (M, 3) emission color
    disperse: Array      # (M,) bool
    sample_env: Array    # (M,) bool — GI rays may return env (src/Blinn.cpp:70)
    env_exposure: Array  # (M,) per-material env override exposure
    tex_color: Array     # (M,) i32 texture id or -1
    tex_alpha: Array
    tex_normal: Array
    tex_spec: Array
    tex_reflect: Array
    tex_refract: Array
    tex_env: Array


@struct.dataclass
class TexturePack:
    """All textures flattened into one differentiable texel pool.

    Replaces per-object RawImage/Texture (src/Texture.h:17-22,
    src/RawImage.h). Descriptor rows are (offset, width, height, channels);
    lookups gather from `data` with computed flat indices, so texel gradients
    flow into one array.
    """
    data: Array          # (D,) f32 — differentiable texels
    offset: Array        # (K,) i32
    width: Array         # (K,) i32
    height: Array        # (K,) i32
    channels: Array      # (K,) i32 (1 gray, 3 RGB/HDR, 4 RGBA)


@struct.dataclass
class PointLights:
    """Reference: src/PointLight.{h,cpp} — scalar wattage, white."""
    position: Array      # (L, 3)
    power: Array         # (L,) — differentiable
    color: Array         # (L, 3) — reference is implicitly white; kept as superset
    # static per-light flags (jit-specializing, like the reference's bools)
    cast_shadows: tuple = struct.field(pytree_node=False, default=())
    fast_shadows: tuple = struct.field(pytree_node=False, default=())


@struct.dataclass
class RectLights:
    """Parallelogram area light (reference: src/RectangleLight.{h,cpp}).

    `power` is the raw wattage; the 1/area normalization of
    RectangleLight::setPower (src/RectangleLight.cpp:14-40) is applied at
    sample time so vertex gradients stay correct.
    """
    v1: Array            # (L, 3)
    v2: Array            # (L, 3)
    v3: Array            # (L, 3)
    power: Array         # (L,)
    color: Array         # (L, 3)
    cast_shadows: tuple = struct.field(pytree_node=False, default=())
    fast_shadows: tuple = struct.field(pytree_node=False, default=())
    num_samples: int = struct.field(pytree_node=False, default=1)


@struct.dataclass
class DomeLight:
    """HDR environment dome with 2D-CDF importance sampling.

    Reference: src/DomeLight.{h,cpp} (PBRT-style Distribution1D over the
    lat-long map). CDF tables are rebuilt host-side from the texture
    (non-differentiable sampling distribution; radiance lookups remain
    differentiable through the texture pack).
    """
    tex: int = struct.field(pytree_node=False)
    gain: Array = None          # () f32
    u_cdf: Array = None         # (nu+1,)
    u_func: Array = None        # (nu,)
    u_func_int: Array = None    # ()
    v_cdf: Array = None         # (nu, nv+1)
    v_func: Array = None        # (nu, nv)
    v_func_int: Array = None    # (nu,)
    cast_shadows: bool = struct.field(pytree_node=False, default=True)
    fast_shadows: bool = struct.field(pytree_node=False, default=True)
    num_samples: int = struct.field(pytree_node=False, default=1)


@struct.dataclass
class BVHArrays:
    """Flattened wide BVH (reference QBVH: src/BVH.h:66-109, src/BVH.cpp:100-389).

    Node i has up to B children; child c covers box [node_min[i,c], node_max[i,c]].
    count[i,c] == 0  -> internal child, child[i,c] = child node id
    count[i,c] >  0  -> triangle leaf: `count` tris at prim_order[child[i,c]:]
    count[i,c] == -1 -> empty slot
    count[i,c] <= -2 -> instance leaf: -(count+1) instance ids at
                        prim_order[child[i,c]:] (TLAS section)

    BLAS subtrees and the TLAS live in ONE merged node pool so traversal is a
    single uniform loop (two-level like reference src/ProxyObject.cpp:76-95,
    but without divergent array selection).
    """
    node_min: Array      # (N, B, 3) f32
    node_max: Array      # (N, B, 3) f32
    child: Array         # (N, B) i32
    count: Array         # (N, B) i32
    prim_order: Array    # (T,) i32
    # static stack bound for traversal (max tree depth over all subtrees)
    depth: int = struct.field(pytree_node=False, default=64)


@struct.dataclass
class Instances:
    """Instance table (reference ProxyObject/ProxyMatrix, src/ProxyObject.h:11-35).

    m maps object->world; rays are transformed world->object by m_inv
    (src/ProxyObject.cpp:76-95); normals fixed up by m_inv_t (src/Ray.cpp:27-31).
    """
    m: Array             # (I, 3, 4)
    m_inv: Array         # (I, 3, 4)
    m_inv_t: Array       # (I, 3, 3)
    root: Array          # (I,) i32 — BLAS root node id
    tri_lo: Array        # (I,) i32 — triangle id range of the BLAS (for brute force)
    tri_hi: Array        # (I,) i32


@struct.dataclass
class EdgeTable:
    """Unique mesh edges with face adjacency, for silhouette-edge sampling
    (diff/edges.py). The reference has no analogue — visibility gradients
    are new capability (BASELINE north star: reparameterized/boundary
    sampling for d(loss)/d(vertices) across silhouettes)."""
    vid: Array           # (E, 2) i32 — endpoint vertex ids
    fid: Array           # (E, 2) i32 — adjacent face ids, -1 = open boundary
    # instanced scenes: flat (instance, edge) pair enumeration — each
    # prototype edge appears once PER instance; silhouette classification
    # and screen velocity are instance-transformed (diff/edges.py). None
    # for single-level scenes (every edge pairs with the identity).
    pair_inst: Optional[Array] = None   # (P, ) i32 — scene.instances row
    pair_edge: Optional[Array] = None   # (P, ) i32 — edge id into vid/fid


EPS_SHUTTER = 1e-3  # reference Camera ctor m_shutterSpeed = epsilon


@struct.dataclass
class Camera:
    """Thin-lens camera (reference: src/Camera.h:9-76, src/Camera.cpp:116-175).

    fov is in degrees (top = tan(fov/2 deg->rad)); shutter time samples are
    drawn as 1 - r^3 * shutter (src/Camera.h:46).
    """
    eye: Array           # (3,)
    view_dir: Array      # (3,)
    up: Array            # (3,)
    fov: Array           # () degrees
    focus_plane: Array   # ()
    aperture: Array      # ()
    shutter: Array       # ()

    @classmethod
    def make(cls, eye, look_at=None, view_dir=None, up=(0.0, 1.0, 0.0),
             fov=45.0, focus_plane=1.0, aperture=0.0, shutter=EPS_SHUTTER):
        eye = np.asarray(eye, np.float32)
        if view_dir is None:
            view_dir = np.asarray(look_at, np.float32) - eye
        view_dir = np.asarray(view_dir, np.float32)
        view_dir = view_dir / np.linalg.norm(view_dir)
        up = np.asarray(up, np.float32)
        up = up / np.linalg.norm(up)
        return cls(eye=eye, view_dir=view_dir, up=up,
                   fov=np.float32(fov), focus_plane=np.float32(focus_plane),
                   aperture=np.float32(aperture), shutter=np.float32(shutter))


@struct.dataclass
class RenderSettings:
    """Static (jit-specializing) render parameters.

    Mirrors the reference Scene knobs (src/Scene.h:60-64) plus wavefront
    sizing. All fields static: changing them recompiles.
    """
    width: int = struct.field(pytree_node=False, default=256)
    height: int = struct.field(pytree_node=False, default=256)
    path_trace: bool = struct.field(pytree_node=False, default=False)
    num_paths: int = struct.field(pytree_node=False, default=1)
    max_bounces: int = struct.field(pytree_node=False, default=5)
    spec_bounce_cap: int = struct.field(pytree_node=False, default=5)  # src/Blinn.cpp:248
    min_subdivs: int = struct.field(pytree_node=False, default=1)
    max_subdivs: int = struct.field(pytree_node=False, default=1)
    noise_threshold: float = struct.field(pytree_node=False, default=0.01)
    # wavefront loop length: number of shade/trace rounds executed by lax.scan
    max_wavefront_steps: int = struct.field(pytree_node=False, default=8)
    # max transparent-shadow march segments for "full" shadows
    # (reference loops until opaque or past light, src/PointLight.cpp:49-70)
    shadow_segments: int = struct.field(pytree_node=False, default=4)
    # per-light adaptive sample cutoff (reference m_noiseThreshold,
    # src/RectangleLight.cpp:117-124, src/DomeLight.cpp:147-151): a ray
    # stops drawing samples from an area/dome light once the light's raw
    # per-sample irradiance scaled by 1/samples_done averages below this.
    # 0.0 = off (every ray draws the full num_samples).
    light_noise_cutoff: float = struct.field(pytree_node=False, default=0.0)
    # secondary (non-primary) rays draw 1 sample per area/dome light
    # (reference isSecondary rule, src/DomeLight.cpp:89) — saves most of
    # the secondary-bounce shadow rays on multi-sample lights
    light_secondary_single: bool = struct.field(pytree_node=False,
                                                default=True)
    # Schlick approximation instead of full Fresnel in the Blinn RR split
    # (the reference's USE_SCHLICK compile switch, src/Material.h:55-67;
    # it ships disabled, so full Fresnel is the default here too)
    use_schlick: bool = struct.field(pytree_node=False, default=False)
    # intersector: 'auto' | 'brute' | 'bvh' | 'cluster' (XLA sweep) |
    # 'cluster_pallas' (GPU kernel) | 'ring' (geometry-sharded, inside
    # shard_map); 'auto' picks per backend and scene
    # (render.integrator.auto_intersector)
    intersector: str = struct.field(pytree_node=False, default='auto')
    # number of rays processed per device-shard tile (padding granularity)
    ray_tile: int = struct.field(pytree_node=False, default=8 * 128)
    # re-sort the wavefront between bounce steps: dead rays compact to the
    # back (their blocks early-exit), live rays order by direction octant +
    # origin morton so ray blocks stay coherent for the block-coherent
    # cluster tracer. Unbiased: permutations only re-bind which RNG slot a
    # ray draws from.
    sort_rays: bool = struct.field(pytree_node=False, default=True)
    # rematerialize the bounce-scan body in the backward pass (trades
    # recompute for residual memory; streamed ray tiles bound it otherwise)
    remat: bool = struct.field(pytree_node=False, default=False)


@struct.dataclass
class Scene:
    """The full scene pytree. Replaces the g_scene singleton (src/Scene.h)."""
    geom: Geometry
    materials: Materials
    textures: TexturePack
    point_lights: PointLights
    rect_lights: RectLights
    dome: Optional[DomeLight]
    blas: Optional[BVHArrays]
    tlas: Optional[BVHArrays]
    instances: Optional[Instances]
    env_exposure: Array                # ()
    bg_color: Array                    # (3,)
    # flat triangle clusters for the block-coherent wavefront tracer
    # (geometry/clusters.py); None for two-level scenes
    clusters: Optional[Any] = None
    # unique-edge adjacency for silhouette (visibility) gradients
    # (diff/edges.py); None when not built (two-level scenes)
    edges: Optional['EdgeTable'] = None
    env_tex: int = struct.field(pytree_node=False, default=-1)
    # True when there is exactly one identity instance (fast single-level path)
    single_level: bool = struct.field(pytree_node=False, default=True)
    has_motion_blur: bool = struct.field(pytree_node=False, default=False)
    has_alpha_maps: bool = struct.field(pytree_node=False, default=False)
    has_material_env: bool = struct.field(pytree_node=False, default=False)
    has_dispersion: bool = struct.field(pytree_node=False, default=False)
    has_translucency: bool = struct.field(pytree_node=False, default=False)
    # traversal entry node in the merged BVH pool (TLAS root, or the world
    # BLAS root for single-level scenes)
    bvh_root: int = struct.field(pytree_node=False, default=0)

    @property
    def num_tris(self) -> int:
        return self.geom.face_v.shape[0]
