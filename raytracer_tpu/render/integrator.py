"""Wavefront path-tracing integrator.

This replaces the reference's mutually recursive `shade -> trace -> shade`
(Blinn::shade src/Blinn.cpp:91-336, Lambert::shade src/Lambert.cpp:19-53,
Scene::sampleScene src/Scene.cpp:219-243) with a masked bounce loop under
`lax.scan`: every live ray carries its throughput, Russian-roulette weights
are realized exactly as the reference samples them, and one continuation ray
is spawned per step (diffuse GI, reflection, or refraction).

The estimator is sample-for-sample equivalent to the reference's:
  * RR split diffuse+direct vs specular with prob rrWeight =
    1 - Rs*reflectAmt - Ts*refractAmt, contributions reweighted by
    1/rrWeight resp. 1/(1-rrWeight) (src/Blinn.cpp:195-198, 335);
  * second RR reflect vs refract at prob reflectAmt*Rs (src/Blinn.cpp:246);
  * dispersion shoots 3 channel-masked refractions in the reference
    (src/Blinn.cpp:275-301); here one channel is Russian-rouletted at 1/3
    and weighted 3x (same expectation, keeps the wavefront width 1);
  * GI: one cosine-sampled bounce per path, NEE every diffuse vertex, direct
    light only at the last GI bounce (src/Blinn.cpp:39-89);
  * spec bounce cap 5 (src/Blinn.cpp:248,283,309): capped rays fall back to
    the environment color;
  * IOR stack push/pop incl. the reference's pop-on-backface-before-branch
    behavior (src/Blinn.cpp:176-185).

lax.scan (not while_loop) keeps the whole loop reverse-mode differentiable;
BVH traversal returns only integer ids and is excluded from the grad path.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.types import Scene, RenderSettings, MAT_LAMBERT, MAT_BLINN
from ..core import vecmath as vm
from ..core.vecmath import EPSILON, MIRO_TMAX
from ..ops import intersect as isect
from ..shading import textures as tex
from ..shading import lights as lt

IOR_STACK = 12  # matches the reference's IORList depth (src/Ray.h:151-178)
KIND_PRIMARY, KIND_GI, KIND_REFLECT, KIND_REFRACT = 0, 1, 2, 3


def hit_attributes(scene: Scene, tri, inst, a, b):
    """Interpolated shading attributes at a hit.

    Mirrors HitInfo::getAllInfos (src/Ray.cpp:5-49): shading normal, geometric
    normal (from the t=0 mesh), tangent frame and UVs; instance hits get
    normals transformed by the inverse transpose (tangents deliberately not,
    as in the reference).
    """
    g = scene.geom
    c = 1.0 - a - b
    w = jnp.stack([c, a, b], axis=-1)[..., None]          # (R,3,1)

    fn = g.face_n[tri]                                    # (R,3)
    N = vm.normalize(jnp.sum(g.normals[fn] * w, axis=-2))

    fv = g.face_v[tri]
    p = g.vertices[fv]                                    # (R,3,3)
    geoN = vm.normalize(jnp.cross(p[..., 1, :] - p[..., 0, :],
                                  p[..., 2, :] - p[..., 0, :]))

    has_uv = g.face_has_uv[tri]
    ft = g.face_t[tri]
    uvw = jnp.sum(g.texcoords[ft] * w, axis=-2)           # (R,2)
    u = jnp.where(has_uv, uvw[..., 0], a)
    v = jnp.where(has_uv, uvw[..., 1], b)

    T = vm.normalize(jnp.sum(g.tangents[fn] * w, axis=-2))
    BT = vm.normalize(jnp.sum(g.bitangents[fn] * w, axis=-2))
    T = jnp.where(has_uv[..., None], T, 0.0)
    BT = jnp.where(has_uv[..., None], BT, 0.0)

    if scene.instances is not None and not scene.single_level:
        mt = scene.instances.m_inv_t[jnp.maximum(inst, 0)]  # (R,3,3)
        N = vm.normalize(jnp.einsum('...ij,...j->...i', mt, N))
        geoN = vm.normalize(jnp.einsum('...ij,...j->...i', mt, geoN))
    return N, geoN, T, BT, u, v


def scene_env_color(scene: Scene, d):
    """Primary-miss background (Scene::sampleScene src/Scene.cpp:236-241)."""
    if scene.env_tex >= 0:
        return tex.env_lookup(scene.textures, scene.env_tex, d) * scene.env_exposure
    return jnp.broadcast_to(scene.bg_color, d.shape)


def material_env_color(scene: Scene, mat, d):
    """Material::getEnvironmentColor (src/Material.cpp:44-64): per-material
    env override, else scene env, else background color."""
    base = scene_env_color(scene, d)
    if not scene.has_material_env:
        return base
    tid = scene.materials.tex_env[mat]
    mat_env = tex.env_lookup(scene.textures, tid, d) \
        * scene.materials.env_exposure[mat][..., None]
    return jnp.where((tid >= 0)[..., None], mat_env, base)


def _scene_env_deferred(scene: Scene, batch, d):
    """scene_env_color via a TexBatch -> thunk (call after batch.run())."""
    if scene.env_tex >= 0:
        u, v = tex.env_uv(d)
        i = batch.add(scene.env_tex, u, v)
        return lambda: batch.get(i)[..., :3] * scene.env_exposure
    return lambda: jnp.broadcast_to(scene.bg_color, d.shape)


def _material_env_deferred(scene: Scene, batch, mat, d):
    """material_env_color via a TexBatch -> thunk (call after batch.run()).

    Same env chain as material_env_color (src/Material.cpp:44-64); the
    lookups join the bounce's fused texel gather so each bounce's backward
    pass scatters into the texel pool once, not per lookup."""
    base_f = _scene_env_deferred(scene, batch, d)
    if not scene.has_material_env:
        return base_f
    tid = scene.materials.tex_env[mat]
    u, v = tex.env_uv(d)
    i = batch.add(tid, u, v)

    def thunk():
        mat_env = batch.get(i)[..., :3] \
            * scene.materials.env_exposure[mat][..., None]
        return jnp.where((tid >= 0)[..., None], mat_env, base_f())
    return thunk


def _ior_top(stack, sp):
    return jnp.take_along_axis(stack, sp[..., None], axis=-1)[..., 0]


def _ior_push(stack, sp, value):
    sp2 = jnp.minimum(sp + 1, IOR_STACK - 1)
    onehot = jax.nn.one_hot(sp2, IOR_STACK, dtype=stack.dtype)
    stack2 = stack * (1.0 - onehot) + value[..., None] * onehot
    return stack2, sp2


def _sort_wavefront(state: dict) -> dict:
    """Permute the wavefront so ray blocks stay coherent.

    Sort key (most significant first): dead flag (dead rays compact to the
    back, so their tracer blocks early-exit), direction octant, 12-bit morton
    code of the origin within the live wavefront's bounding box. The
    permutation only re-binds RNG slots, so the estimator is unchanged; the
    block-coherent cluster tracer (ops/pallas/cluster_kernel.py) gets blocks
    whose rays overlap few clusters. The analogue in the reference is implicit:
    its recursion keeps each CPU packet's rays from one pixel neighborhood.
    """
    o, d, alive = state['o'], state['d'], state['alive']
    sg = jax.lax.stop_gradient
    o = sg(o)
    d = sg(d)
    octant = ((d[:, 0] > 0).astype(jnp.int32)
              | ((d[:, 1] > 0).astype(jnp.int32) << 1)
              | ((d[:, 2] > 0).astype(jnp.int32) << 2))
    lo = jnp.min(jnp.where(alive[:, None], o, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(alive[:, None], o, -jnp.inf), axis=0)
    q = jnp.clip(((o - lo) / jnp.maximum(hi - lo, 1e-6) * 15.0), 0.0, 15.0)
    q = q.astype(jnp.int32)                                # (R, 3) 4 bits each
    morton = jnp.zeros_like(q[:, 0])
    for bit in range(4):
        for ax in range(3):
            morton = morton | (((q[:, ax] >> bit) & 1) << (3 * bit + ax))
    key = ((~alive).astype(jnp.int32) << 20) | (octant << 12) | morton
    perm = jnp.argsort(key)
    return jax.tree_util.tree_map(lambda x: x[perm], state)


# Tracer that 'auto' picks for single-level scenes on the GPU, chosen by
# the end-to-end timing in PERF.md (bench.py with each intersector).
GPU_SINGLE_LEVEL = 'cluster_pallas'


def auto_intersector(scene: Scene, backend: str) -> str:
    """The intersector 'auto' resolves to on `backend` for `scene`.

    Single-level scenes on the GPU take GPU_SINGLE_LEVEL; two-level scenes
    (and every scene off the GPU) take the BVH; scenes built without a BVH
    take the brute-force tracer."""
    if scene.blas is None:
        return 'brute'
    if backend == 'gpu' and scene.clusters is not None:
        return GPU_SINGLE_LEVEL
    return 'bvh'


def _need_clusters(scene: Scene, mode: str) -> None:
    if scene.clusters is None:
        raise ValueError(
            f"intersector={mode!r} needs a single-level scene with a cluster "
            "table; two-level scenes trace with 'bvh'")


def trace_fn(scene: Scene, settings: RenderSettings):
    """Select the intersector backend -> tracer(o,d,time,tmin,tmax,any_hit).

    A mode the scene cannot use raises; nothing is swapped silently."""
    mode = settings.intersector
    if mode == 'auto':
        mode = auto_intersector(scene, jax.default_backend())
    if mode == 'brute':
        def tracer(o, d, time, tmin, tmax, any_hit):
            return isect.brute_force_trace(scene, o, d, time, tmin, tmax,
                                           any_hit)
        return tracer
    if mode == 'cluster':
        _need_clusters(scene, mode)
        from ..ops import cluster_trace as ct

        def tracer(o, d, time, tmin, tmax, any_hit):
            return ct.cluster_trace(scene, o, d, time, tmin, tmax, any_hit)
        return tracer
    if mode == 'cluster_pallas':
        _need_clusters(scene, mode)
        from ..ops.pallas import cluster_kernel as ck

        def once(o, d, time, tmin, tmax, any_hit):
            return ck.pallas_cluster_trace(scene, o, d, time, tmin, tmax,
                                           any_hit)

        if scene.has_alpha_maps:
            from ..ops import cluster_trace as ct

            def tracer(o, d, time, tmin, tmax, any_hit):
                return ct.alpha_aware_trace(scene, once, o, d, time, tmin,
                                            tmax, any_hit)
            return tracer
        return once
    if mode == 'ring':
        # geometry-sharded: scene.clusters holds THIS device's shard; must
        # run inside shard_map (parallel/sharding.render_geometry_sharded)
        from ..ops import ring_trace as ring

        def tracer(o, d, time, tmin, tmax, any_hit):
            return ring.ring_trace(scene, o, d, time, tmin, tmax, any_hit)
        return tracer
    if mode != 'bvh':
        raise ValueError(f'unknown intersector {mode!r}')
    if scene.blas is None:
        raise ValueError("intersector='bvh' needs a scene built with bvh=True")
    from ..ops import traverse

    def tracer(o, d, time, tmin, tmax, any_hit):
        return traverse.bvh_trace(scene, o, d, time, tmin, tmax, any_hit)
    return tracer


def radiance(scene: Scene, settings: RenderSettings, o, d, time, base_key,
             kind0: int = KIND_PRIMARY, prev_mat0=0, gi_bounces0=0):
    """Estimate radiance for a wavefront of camera rays -> (R, 3).

    One sample per ray; callers loop/average for spp (the reference's
    m_numPaths loop, src/Scene.cpp:228-232, folds into this).

    kind0/prev_mat0/gi_bounces0 (scalars or (R,) arrays) seed the
    wavefront mid-path: diff/edges.gi_edge_vertex_grad evaluates the GI
    integrand on either side of a blocker silhouette by restarting the
    path AT the first diffuse vertex (kind0=KIND_GI, prev_mat0=that
    vertex's material), so its side radiance matches what the
    integrator's own GI bounce would have delivered (env gating and
    emitter handling differ by ray kind).
    """
    R = o.shape[0]
    f32 = o.dtype
    tracer = trace_fn(scene, settings)
    mats = scene.materials

    # derive every carried array from `o` so the scan carry keeps the same
    # sharding/varying type as the loop outputs under shard_map
    zero = jnp.zeros_like(o[:, 0])
    zero_i = zero.astype(jnp.int32)
    ior_stack = zero[:, None] + jnp.zeros((R, IOR_STACK), f32)
    ior_stack = ior_stack.at[:, 0].set(1.0).at[:, 1].add(1.001)
    time = jnp.broadcast_to(time, (R,)).astype(f32)
    state = dict(
        o=o, d=d,
        tp=1.0 + zero[:, None] + jnp.zeros((R, 3), f32),
        L=zero[:, None] + jnp.zeros((R, 3), f32),
        alive=zero < 1.0,
        kind=zero_i + kind0,
        bounces=zero_i,
        gi_bounces=zero_i + gi_bounces0,
        ior_stack=ior_stack,
        ior_sp=zero_i + 1,
        prev_mat=zero_i + prev_mat0,
        time=time + zero,
        pix=zero_i + jnp.arange(R, dtype=jnp.int32),
    )

    def step(state, step_idx):
        key = jax.random.fold_in(base_key, step_idx)
        k_rr, k_gl, k_gi, k_disp, k_l1, k_l2 = jax.random.split(key, 6)
        rnd = jax.random.uniform(k_rr, (R, 3), f32)       # rr1, rr2, disp
        rnd_gl = jax.random.uniform(k_gl, (R, 2), f32)    # glossy
        rnd_gi = jax.random.uniform(k_gi, (R, 2), f32)    # GI cosine

        o, d, tp, L, alive = (state['o'], state['d'], state['tp'],
                              state['L'], state['alive'])
        kind = state['kind']
        time = state['time']
        # dead lanes get tmax < 0: every tracer culls them instantly, and
        # the cluster kernel skips whole all-dead blocks (dead rays compact
        # to the back under sort_rays)
        tmax_live = jnp.where(alive, jnp.float32(MIRO_TMAX),
                              jnp.float32(-1.0))
        hit = tracer(o, d, time, EPSILON, tmax_live, False)
        found = hit.valid & alive
        t, a, b = isect.refine_hit(scene, o, d, time, hit)

        # ---------------------------------------------- hit attrs + lookups
        # all of this bounce's texture reads (the 5 surface maps and the
        # miss-path env chain for d) fuse into ONE texel-pool gather: its
        # transpose is a single scatter-add into tex_data instead of one
        # per lookup
        tri = jnp.maximum(hit.tri, 0)
        mat = scene.geom.face_mat[tri]
        N, geoN, T, BT, u, v = hit_attributes(scene, tri, hit.inst, a, b)
        P = o + t[:, None] * d
        view = -d

        mats_tex = (mats.tex_color[mat], mats.tex_normal[mat],
                    mats.tex_spec[mat], mats.tex_reflect[mat],
                    mats.tex_refract[mat])
        tc, tn, ts_, tr_, tf_ = mats_tex
        tb = tex.TexBatch(scene.textures)
        i_surf = [tb.add(tid, u, v) for tid in mats_tex]
        env_mat_f = _material_env_deferred(scene, tb, state['prev_mat'], d)
        env_scene_f = _scene_env_deferred(scene, tb, d)
        tb.run()

        # ------------------------------------------------------ miss paths
        miss = alive & ~hit.valid
        env_mat = env_mat_f()
        env_scene = env_scene_f()
        # primary: scene env/bg; reflect/refract: material env chain;
        # GI: material env gated by sample_env && scene env map present
        gi_ok = mats.sample_env[state['prev_mat']] & (scene.env_tex >= 0)
        env_out = jnp.where((kind == KIND_PRIMARY)[:, None], env_scene,
                            env_mat)
        add_env = miss & ((kind != KIND_GI) | gi_ok)
        L = L + jnp.where(add_env[:, None], tp * env_out, 0.0)

        # ------------------------------------------------------- hit shading
        kd = mats.kd[mat]
        ka = mats.ka[mat]
        ks = mats.ks[mat]
        le = mats.le[mat]
        spec_exp = mats.spec_exp[mat]
        spec_amt = mats.spec_amt[mat]
        reflect_amt0 = mats.reflect_amt[mat]
        refract_amt0 = mats.refract_amt[mat]
        spec_gloss = mats.spec_gloss[mat]
        is_lambert = mats.kind[mat] == MAT_LAMBERT

        # texture modulation (src/Blinn.cpp:114-142)
        texcol = tb.get(i_surf[0])[..., :3]
        diffuse = jnp.where((tc >= 0)[:, None], texcol, kd)
        texn = tb.get(i_surf[1])[..., :3]
        N_mapped = texn[:, 0:1] * T + texn[:, 1:2] * BT + texn[:, 2:3] * N
        N = jnp.where((tn >= 0)[:, None], N_mapped, N)  # unnormalized, as ref
        texs = tb.get(i_surf[2])[..., :3].mean(-1)
        spec_amt = jnp.where(ts_ >= 0, texs * spec_amt, spec_amt)
        texr = tb.get(i_surf[3])[..., :3].mean(-1)
        reflect_amt = jnp.where(tr_ >= 0, texr * reflect_amt0, reflect_amt0)
        texf = tb.get(i_surf[4])[..., :3].mean(-1)
        refract_amt = jnp.where(tf_ >= 0, texf * refract_amt0, refract_amt0)

        # normal disambiguation + backface flip (src/Blinn.cpp:144-155)
        v_dot_n = vm.dot(view, N)
        v_dot_geo = vm.dot(view, geoN)
        n_eq = v_dot_n * v_dot_geo >= 0.0
        the_n = jnp.where(n_eq[:, None], N, geoN)
        v_dot = jnp.where(n_eq, v_dot_n, v_dot_geo)
        flip = v_dot < 0.0
        v_dot = jnp.abs(v_dot)
        the_n = jnp.where(flip[:, None], -the_n, the_n)
        # Lambert uses the raw interpolated normal (src/Lambert.cpp:30,45)
        the_n = jnp.where(is_lambert[:, None], N, the_n)

        rvec = d + 2.0 * v_dot[:, None] * the_n
        # glossy reflections perturb rVec (src/Blinn.cpp:160-165)
        rand_d = vm.cosine_sample(the_n, rnd_gl[:, 0], rnd_gl[:, 1])
        rvec_gl = vm.normalize(spec_gloss[:, None] * rvec
                               + (1.0 - spec_gloss)[:, None] * rand_d)
        rvec = jnp.where((spec_gloss < 1.0)[:, None], rvec_gl, rvec)

        # IOR bookkeeping (src/Blinn.cpp:167-185)
        ior_stack, ior_sp = state['ior_stack'], state['ior_sp']
        in_ior = _ior_top(ior_stack, ior_sp)
        mat_ior = mats.ior[mat]                           # (R,3)
        dispersing = (mats.disperse[mat] & (kind != KIND_REFRACT)) \
            if scene.has_dispersion else jnp.zeros(R, bool)
        # non-dispersing backface: pop (leaving the medium)
        do_pop = (~dispersing) & flip & found & (~is_lambert)
        ior_sp = jnp.where(do_pop, jnp.maximum(ior_sp - 1, 0), ior_sp)
        popped_ior = _ior_top(ior_stack, ior_sp)
        out_ior_scalar = jnp.where(flip, popped_ior, mat_ior[:, 1])
        # per-channel out IOR for dispersion
        out_ior = jnp.where(dispersing[:, None], mat_ior,
                            out_ior_scalar[:, None])      # (R,3)

        # Fresnel (src/Blinn.cpp:187-193) — uses channel 0 of out_ior.
        # use_schlick selects the reference's USE_SCHLICK approximation
        # (src/Material.h:55-67); default full Fresnel, as the reference
        # ships
        fres = vm.schlick_fresnel if settings.use_schlick else vm.fresnel
        has_spec = (reflect_amt0 > 0.0) | (refract_amt0 > 0.0)
        rs = jnp.where(has_spec, fres(in_ior, out_ior[:, 0], v_dot), 0.0)
        ts = jnp.where(has_spec, 1.0 - rs, 0.0)

        rr_weight = 1.0 - rs * reflect_amt - ts * refract_amt
        rr_weight = jnp.where(is_lambert, 1.0, rr_weight)
        rr_recip = jnp.where(rr_weight > 0.0, 1.0 / rr_weight, 1.0)
        rr_recip_s = jnp.where(1.0 - rr_weight > 0.0,
                               1.0 / (1.0 - rr_weight), 1.0)
        diffuse_branch = found & (rnd[:, 0] <= rr_weight)
        spec_branch = found & ~diffuse_branch

        # unconditional per-hit terms: Le, and ka scaled by rrRecip
        # (src/Blinn.cpp:333-335)
        L = L + jnp.where(found[:, None], tp * (le + ka * rr_recip[:, None]), 0.0)

        # ---------------------------------------------- diffuse branch: NEE
        # secondary (non-primary) lanes draw 1 sample per area/dome light
        # (reference isSecondary rule, src/DomeLight.cpp:89), realized as a
        # per-lane mask inside the samplers
        # shadow rays only for lanes whose terms survive (diffuse branch of
        # a real hit) — the rest trace with tmax<0 (instant cull / whole
        # dead kernel blocks skipped)
        lpw, specw3, lp_back = lt.sample_all_lights(
            scene, tracer, P, the_n, rvec, spec_exp, time, k_l1, False,
            settings, want_back=scene.has_translucency,
            active=diffuse_branch, secondary_mask=(kind != KIND_PRIMARY))

        w_d = (tp * rr_recip[:, None]) * diffuse_branch[:, None]
        # specw3 is already sum_i E_i*pow(spec_i, exp) (per-light pow,
        # src/Blinn.cpp:217); scale by ks*specAmt only
        spec_term = ks * spec_amt[:, None] * specw3
        spec_term = jnp.where(is_lambert[:, None], 0.0, spec_term)
        L = L + w_d * (lpw * diffuse + spec_term)

        # translucency (src/Blinn.cpp:223-236): back-hemisphere irradiance
        # from the SAME light samples/shadow rays as the NEE pass above
        # (shared-sample deviation documented in shading/lights.py)
        if scene.has_translucency:
            transl = mats.translucency[mat]
            L = L + w_d * transl[:, None] * lp_back * diffuse \
                * (transl > 0.01)[:, None]

        # --------------------------------------- diffuse branch: GI bounce
        gi_b = state['gi_bounces']
        emitter = (mats.emitted_power[mat] > 0.0) | (jnp.sum(le, -1) > 0.0)
        if settings.path_trace:
            # emitter hit: GI slot returns emittedPower*Le (src/Blinn.cpp:47-51)
            L = L + jnp.where((diffuse_branch & emitter)[:, None],
                              w_d * mats.emitted_power[mat][:, None] * le, 0.0)
            can_gi = diffuse_branch & ~emitter & ~is_lambert \
                & (gi_b < settings.max_bounces - 1)
            # last GI bounce: direct-light only, diffuse term (src/Blinn.cpp:76-87).
            # Reuses the NEE samples above (lpw) instead of a third
            # sample_all_lights pass: both terms are additive, so the
            # correlation is bias-free and the shadow-ray count drops ~1/3.
            last_gi = diffuse_branch & ~emitter & ~is_lambert \
                & (gi_b >= settings.max_bounces - 1)
            L = L + jnp.where(last_gi[:, None], w_d * lpw * diffuse, 0.0)
            gi_dir = vm.cosine_sample(the_n, rnd_gi[:, 0], rnd_gi[:, 1])
        else:
            can_gi = jnp.zeros(R, bool)
            gi_dir = d

        # ------------------------------------------------- specular branch
        bounces = state['bounces']
        can_bounce = bounces < settings.spec_bounce_cap
        refl_p = reflect_amt * rs
        take_refl = spec_branch & (rnd[:, 1] < refl_p)
        take_refr = spec_branch & ~take_refl & (refract_amt * ts > 0.0)

        # dispersion channel RR (1/3 prob, 3x mask weight)
        ch = jnp.floor(rnd[:, 2] * 3.0).astype(jnp.int32) % 3
        ch_mask = jax.nn.one_hot(ch, 3, dtype=f32) * 3.0
        disp_now = dispersing & take_refr
        eta_nd = in_ior / out_ior[:, 0]
        eta_d = in_ior / jnp.take_along_axis(out_ior, ch[:, None], -1)[:, 0]
        eta = jnp.where(disp_now, eta_d, eta_nd)
        tvec = vm.refract(d, the_n, v_dot, eta)

        w_s = tp * (ks * rr_recip_s[:, None])
        w_s = jnp.where(disp_now[:, None], w_s * ch_mask, w_s)

        # capped specular rays take the env color instead (src/Blinn.cpp:260-267,
        # 325-328 with doEnv left true when no trace happened)
        # capped-spec env colors: rvec/tvec depend on the surface lookups,
        # so these two chains form the bounce's second fused gather
        tb2 = tex.TexBatch(scene.textures)
        env_r_f = _material_env_deferred(scene, tb2, mat, rvec)
        env_t_f = _material_env_deferred(scene, tb2, mat, tvec)
        tb2.run()
        env_r = env_r_f()
        env_t = env_t_f()
        L = L + jnp.where((take_refl & ~can_bounce)[:, None], w_s * env_r, 0.0)
        L = L + jnp.where((take_refr & ~can_bounce)[:, None], w_s * env_t, 0.0)

        spawn_refl = take_refl & can_bounce
        spawn_refr = take_refr & can_bounce
        spawn_spec = spawn_refl | spawn_refr
        spawn = can_gi | spawn_spec

        # push the IOR entered by refraction (src/Blinn.cpp:285,311)
        push_val = jnp.where(disp_now,
                             jnp.take_along_axis(out_ior, ch[:, None], -1)[:, 0],
                             out_ior[:, 0])
        new_stack, new_sp = _ior_push(ior_stack, ior_sp, push_val)
        ior_stack = jnp.where(spawn_refr[:, None], new_stack, ior_stack)
        ior_sp = jnp.where(spawn_refr, new_sp, ior_sp)

        new_d = jnp.where(spawn_refl[:, None], rvec,
                          jnp.where(spawn_refr[:, None], tvec, gi_dir))
        new_kind = jnp.where(spawn_refl, KIND_REFLECT,
                             jnp.where(spawn_refr, KIND_REFRACT, KIND_GI))
        new_tp = jnp.where(spawn_spec[:, None], w_s,
                           tp * rr_recip[:, None] * diffuse)
        new_bounces = jnp.where(spawn_spec, bounces + 1, bounces)
        new_gi = jnp.where(can_gi, gi_b + 1, gi_b)

        state = dict(
            o=jnp.where(spawn[:, None], P, o),
            d=jnp.where(spawn[:, None], new_d, d),
            tp=jnp.where(spawn[:, None], new_tp, tp),
            L=L,
            alive=alive & spawn,
            kind=jnp.where(spawn, new_kind, kind),
            bounces=new_bounces,
            gi_bounces=new_gi,
            ior_stack=ior_stack,
            ior_sp=ior_sp,
            prev_mat=jnp.where(found, mat, state['prev_mat']),
            time=time,
            pix=state['pix'],
        )
        if settings.sort_rays:
            state = _sort_wavefront(state)
        return state, None

    def step_or_skip(state, step_idx):
        # skip whole steps once every ray has terminated (Russian roulette
        # kills most paths early; the reference's recursion just returns —
        # src/Blinn.cpp:239-247 — this is the wavefront equivalent)
        return jax.lax.cond(jnp.any(state['alive']),
                            lambda s: step(s, step_idx)[0],
                            lambda s: s, state), None

    steps = settings.max_wavefront_steps
    # Optionally remat the bounce body (RenderSettings.remat); memory is
    # otherwise bounded by streaming ray tiles
    # (sharding.loss_and_grads_streamed / loss_and_grads_scanned).
    body = jax.checkpoint(step_or_skip, prevent_cse=False) if settings.remat \
        else step_or_skip
    state, _ = jax.lax.scan(body, state, jnp.arange(steps, dtype=jnp.int32))
    if settings.sort_rays:
        # scatter radiance back to the original ray order
        return jnp.zeros_like(state['L']).at[state['pix']].set(state['L'])
    return state['L']
