"""Direct light sampling (point / rectangle / HDR dome).

Behavioral mirrors of the reference light loop, batched over the ray
wavefront:
  - PointLight::sampleLight  (src/PointLight.cpp:8-82)
  - RectangleLight::sampleLight (src/RectangleLight.cpp:42-137) with the
    1/area power normalization of setPower (src/RectangleLight.cpp:14-40)
  - DomeLight::sampleLight (src/DomeLight.cpp:80-161) with PBRT-style 2D CDF
    importance sampling (src/DomeLight.h:10-42)

Known deliberate deviations from the reference, kept for batching/sanity:
  - dome samples below the horizon contribute zero instead of being retried;
  - the dome specular dot is clamped at 0 (the reference can feed a negative
    base into powf -> NaN);
  - translucency (the back-hemisphere pass, src/Blinn.cpp:223-236) reuses
    the SAME light samples and shadow rays as the front pass instead of
    drawing a second independent set with hardcoded time .001f
    (src/Blinn.cpp:231). Identical expectation (the correlation is
    bias-free), and it halves the shadow-ray count on translucent scenes —
    shadow rays are the dominant per-bounce cost.

The reference's per-light ADAPTIVE sample loops are mirrored per ray:
noise-threshold early cutoff (src/RectangleLight.cpp:117-124,
src/DomeLight.cpp:147-151 — RenderSettings.light_noise_cutoff, off by
default) and the 1-sample-on-secondary rule (RenderSettings.
light_secondary_single, on by default) as masked lanes whose per-ray
sample counts divide the mean. The secondary rule applies to the DOME
light only, matching the reference: DomeLight::sampleLight checks
isSecondary (src/DomeLight.cpp:89); RectangleLight ignores it.

Every sampler takes `tracer(o, d, time, tmin, tmax, any_hit) -> Hit` so the
same code runs on the brute-force or BVH backend.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Scene
from ..core import vecmath as vm
from ..core.vecmath import EPSILON, MIRO_TMAX, INV_4PI
from ..shading import textures as tex


def _shadow_attenuation(scene: Scene, tracer, P, L, dist, time,
                        cast_shadows: bool, fast: bool, segments: int,
                        active=None):
    """Shadow visibility in [0,1].

    fast: any-hit boolean (reference IS_SHADOW_RAY early-out,
    src/BVH.cpp:1340). full: march through transparent surfaces multiplying
    each front-facing hit's refract_amt (src/PointLight.cpp:49-70).

    active (bool (R,) or None): rays whose shading term will be masked out
    anyway (non-diffuse-branch lanes) skip the shadow trace — their tmax
    goes negative, which every tracer culls instantly and the cluster
    kernel uses to skip whole dead blocks.
    """
    R = P.shape[0]
    if not cast_shadows:
        return jnp.ones(R, dtype=P.dtype)
    if fast:
        dist_eff = dist if active is None else \
            jnp.where(active, jnp.broadcast_to(jnp.asarray(dist, P.dtype),
                                               (R,)), -1.0)
        hit = tracer(P, L, time, EPSILON, dist_eff, True)
        return jnp.where(hit.valid, 0.0, 1.0)
    # transparent-shadow march, fixed max segments
    def body(carry, _):
        o, atten, traversed, live = carry
        tmax_seg = jnp.where(live, jnp.float32(MIRO_TMAX),
                             jnp.float32(-1.0))
        hit = tracer(o, L, time, EPSILON, tmax_seg, False)
        t, a, b = hit.t, hit.a, hit.b
        seg_live = live & hit.valid & (traversed + t < dist)
        # front-facing (vs -L) hits attenuate by the material's refract amount
        fn = scene.geom.face_n[jnp.maximum(hit.tri, 0)]
        c = 1.0 - a - b
        n = (scene.geom.normals[fn[:, 0]] * c[:, None]
             + scene.geom.normals[fn[:, 1]] * a[:, None]
             + scene.geom.normals[fn[:, 2]] * b[:, None])
        n = vm.normalize(n)
        ndl = vm.dot(n, -L)
        mat = scene.geom.face_mat[jnp.maximum(hit.tri, 0)]
        ra = scene.materials.refract_amt[mat]
        atten = jnp.where(seg_live & (ndl > 0.0), atten * ra, atten)
        o = jnp.where(seg_live[:, None], o + t[:, None] * L, o)
        traversed = jnp.where(seg_live, traversed + t, traversed)
        live = seg_live & (atten > EPSILON)
        return (o, atten, traversed, live), None

    zero = jnp.zeros_like(P[:, 0])
    live0 = (zero < 1.0) if active is None else (active & (zero < 1.0))
    init = (P, 1.0 + zero, zero, live0)
    (_, atten, _, _), _ = jax.lax.scan(body, init, None, length=segments)
    return atten


def _spec_pow(spec, spec_exp):
    """pow(outSpec_i, specExp) for ONE light's averaged spec dot.

    The pow base is clamped away from 0: pow(0, e) has a NaN d/de (0*log 0);
    1e-12^e underflows to the same 0 with a finite gradient.
    """
    return jnp.power(jnp.maximum(spec, 1e-12), spec_exp)


def sample_point_lights(scene: Scene, tracer, P, N, rvec, spec_exp, time,
                        segments: int = 4, want_back: bool = False,
                        active=None):
    """Sum over all point lights -> (irradiance (R,3), spec (R,3), back (R,3)).

    Mirrors src/PointLight.cpp:8-82: inverse-square falloff, N.L gating and
    cosine folded into the attenuation, scalar wattage / 4pi. `spec` is the
    PER-LIGHT exponentiated Blinn term sum_i E_i * pow(outSpec_i, specExp)
    (the reference applies pow inside the light loop, src/Blinn.cpp:217-218;
    summing raw dots and exponentiating once is wrong for >1 light).
    `back` is the same irradiance estimate for the flipped normal
    (translucency), reusing the shadow trace.
    """
    R = P.shape[0]
    power_sum = jnp.zeros((R, 3), P.dtype)
    spec_sum = jnp.zeros((R, 3), P.dtype)
    back_sum = jnp.zeros((R, 3), P.dtype)
    pl = scene.point_lights
    num = pl.position.shape[0]
    for i in range(num):
        L = pl.position[i] - P
        d2 = vm.length2(L)
        dist = jnp.sqrt(d2)
        Lhat = L / dist[:, None]
        ndl = vm.dot(N, Lhat)
        atten0 = _shadow_attenuation(
            scene, tracer, P, Lhat, dist, time,
            pl.cast_shadows[i], pl.fast_shadows[i], segments, active)
        atten = jnp.where(ndl > 0.0, atten0 * ndl, 0.0)
        E_base = (pl.power[i] * pl.color[i])[None, :] * (INV_4PI / d2)[:, None]
        E = E_base * atten[:, None]
        power_sum = power_sum + E
        spec_i = jnp.maximum(0.0, vm.dot(rvec, Lhat)) * atten
        spec_sum = spec_sum + E * _spec_pow(spec_i, spec_exp)[:, None]
        if want_back:
            atten_b = jnp.where(-ndl > 0.0, atten0 * -ndl, 0.0)
            back_sum = back_sum + E_base * atten_b[:, None]
    return power_sum, spec_sum, back_sum


def _rect_area_power(v1, v2, v3, power):
    """Area-normalized wattage (src/RectangleLight.cpp:14-40)."""
    e0 = v2 - v1
    e1 = v3 - v1
    rect_like = jnp.abs(vm.dot(e0, e1)) < EPSILON
    area_sq = jnp.where(rect_like,
                        vm.length2(e0) * vm.length2(e1),
                        vm.length2(jnp.cross(e0, e1)))
    recip = jnp.where(area_sq > EPSILON, jax.lax.rsqrt(area_sq), 1.0)
    return power * recip


def sample_rect_lights(scene: Scene, tracer, P, N, rvec, spec_exp, time, key,
                       num_samples: int, segments: int = 4,
                       want_back: bool = False, active=None,
                       noise_cutoff: float = 0.0, single_mask=None):
    """Sum over all rectangle lights -> (irradiance, spec, back).

    spec = sum_i E_i_mean * pow(spec_i_mean, specExp): the reference averages
    the spec dot over the light's samples and applies pow once per light
    (src/RectangleLight.cpp:135-136, src/Blinn.cpp:217).

    Per-ray adaptive sampling mirrors the reference's do/while loop
    (src/RectangleLight.cpp:53-133): a ray stops sampling this light when
    (E * 1/samples_done).average() < noise_cutoff; its mean divides by the
    per-ray samples actually drawn. single_mask (1 sample on secondary
    rays) is accepted for API symmetry but direct_light passes None for
    rect lights: only DomeLight implements isSecondary in the reference
    (src/DomeLight.cpp:89); RectangleLight ignores it.
    """
    R = P.shape[0]
    power_sum = jnp.zeros((R, 3), P.dtype)
    spec_sum = jnp.zeros((R, 3), P.dtype)
    back_sum = jnp.zeros((R, 3), P.dtype)
    rl = scene.rect_lights
    num = rl.v1.shape[0]
    for i in range(num):
        p_eff = _rect_area_power(rl.v1[i], rl.v2[i], rl.v3[i], rl.power[i])
        key, sub = jax.random.split(key)
        e = jax.random.uniform(sub, (num_samples, R, 2), P.dtype)
        acc = jnp.zeros((R, 3), P.dtype)
        acc_s = jnp.zeros(R, P.dtype)
        acc_b = jnp.zeros((R, 3), P.dtype)
        done = jnp.zeros(R, bool)
        n_done = jnp.zeros(R, P.dtype)
        for s in range(num_samples):
            live = ~done
            e1 = e[s, :, 0]
            e2 = jnp.minimum(e[s, :, 1], 0.99)  # src/RectangleLight.cpp:58
            pt = rl.v1[i] + e1[:, None] * (rl.v2[i] - rl.v1[i]) \
                + e2[:, None] * (rl.v3[i] - rl.v1[i])
            L = pt - P
            d2 = vm.length2(L)
            dist = jnp.sqrt(d2)
            Lhat = L / dist[:, None]
            ndl_raw = vm.dot(N, L)
            # fast shadows test against dist - eps (src/RectangleLight.cpp:84)
            sh_dist = dist - EPSILON if rl.fast_shadows[i] else dist
            act = live if active is None else (active & live)
            atten0 = _shadow_attenuation(
                scene, tracer, P, Lhat, sh_dist, time,
                rl.cast_shadows[i], rl.fast_shadows[i], segments, act)
            atten = jnp.where(ndl_raw > EPSILON, atten0, 0.0)
            # NOTE: the reference applies no cosine term for rect lights
            # (src/RectangleLight.cpp:124-131); we match it.
            E = (p_eff * rl.color[i])[None, :] * (INV_4PI / d2)[:, None]
            acc = acc + jnp.where(live[:, None], E * atten[:, None], 0.0)
            acc_s = acc_s + jnp.where(
                live, jnp.maximum(0.0, vm.dot(rvec, Lhat)) * atten, 0.0)
            if want_back:
                atten_b = jnp.where(-ndl_raw > EPSILON, atten0, 0.0)
                acc_b = acc_b + jnp.where(live[:, None],
                                          E * atten_b[:, None], 0.0)
            n_done = n_done + live
            if s + 1 < num_samples:
                if noise_cutoff > 0.0:
                    cut = jnp.mean(E, axis=-1) / n_done < noise_cutoff
                    done = done | (live & cut)
                if single_mask is not None:
                    done = done | single_mask
        recip = 1.0 / jnp.maximum(n_done, 1.0)
        E_mean = acc * recip[:, None]
        power_sum = power_sum + E_mean
        spec_sum = spec_sum \
            + E_mean * _spec_pow(acc_s * recip, spec_exp)[:, None]
        back_sum = back_sum + acc_b * recip[:, None]
    return power_sum, spec_sum, back_sum


def _sample_cdf_rows(cdf2, rows, u):
    """Distribution1D::sample (src/DomeLight.h:31-38) over per-ray rows.

    cdf2: (K, n+1) row-wise CDFs; rows, u: (R,). Returns (pos, offset, du)
    exactly equal to the dense lower_bound (count of strictly-smaller
    entries), but via a binary search of log2(n) POINTWISE gathers — the
    dense form gathered the full (R, n+1) row per ray, which at a
    1k-tall env map moves ~0.5 GB per dome sample per bounce."""
    n = cdf2.shape[-1] - 1
    lo = jnp.zeros(u.shape, jnp.int32)          # lower_bound in [0, n+1]
    hi = jnp.full(u.shape, n + 1, jnp.int32)
    for _ in range(int(np.ceil(np.log2(n + 2)))):
        mid = (lo + hi) // 2
        cm = cdf2[rows, jnp.clip(mid, 0, n)]
        less = cm < u
        lo = jnp.where(less, jnp.minimum(mid + 1, hi), lo)
        hi = jnp.where(less, hi, mid)
    offset = jnp.clip(lo - 1, 0, n - 1)
    c0 = cdf2[rows, offset]
    c1 = cdf2[rows, offset + 1]
    du = (u - c0) / jnp.maximum(c1 - c0, 1e-20)
    return offset.astype(jnp.float32) + du, offset, du


def _sample_cdf(cdf, u):
    """One shared CDF row (the u-marginal): cdf (n+1,), u (...)."""
    return _sample_cdf_rows(cdf[None, :], jnp.zeros(u.shape, jnp.int32), u)


def sample_dome_light(scene: Scene, tracer, P, N, rvec, spec_exp, time, key,
                      num_samples: int, segments: int = 4,
                      want_back: bool = False, active=None,
                      noise_cutoff: float = 0.0, single_mask=None):
    """HDR dome importance sampling -> (irradiance, spec, back).

    Mirrors src/DomeLight.cpp:80-161: sample u from the marginal CDF, v from
    the column CDF, direction from the table angles (floor indices),
    pdf = (pu*pv) / (2*pi^2*sin(theta)). spec is the dome's
    E_mean * pow(spec_mean, specExp) (per-light pow, src/Blinn.cpp:217).
    """
    dome = scene.dome
    R = P.shape[0]
    if dome is None:
        z = jnp.zeros((R, 3), P.dtype)
        return z, z, z
    nu = dome.u_func.shape[0]
    nv = dome.v_func.shape[1]
    key, sub = jax.random.split(key)
    e = jax.random.uniform(sub, (num_samples, R, 2), P.dtype)
    acc = jnp.zeros((R, 3), P.dtype)
    acc_s = jnp.zeros(R, P.dtype)
    acc_b = jnp.zeros((R, 3), P.dtype)
    done = jnp.zeros(R, bool)
    n_done = jnp.zeros(R, P.dtype)
    for s in range(num_samples):
        live = ~done
        fu, uo, _ = _sample_cdf(dome.u_cdf, e[s, :, 0])
        pdf_u = dome.u_func[uo] / dome.u_func_int
        ucol = jnp.clip(fu.astype(jnp.int32), 0, nu - 1)
        fv, vo, _ = _sample_cdf_rows(dome.v_cdf, ucol, e[s, :, 1])
        pdf_v = dome.v_func[ucol, vo] / jnp.maximum(dome.v_func_int[ucol], 1e-20)
        # table angles at floor indices (src/DomeLight.cpp:102-103)
        theta = jnp.floor(fv) * (vm.PI / nv)
        phi = jnp.floor(fu) * (2.0 * vm.PI / nu)
        sin_t = jnp.sin(theta)
        direction = jnp.stack([-sin_t * jnp.cos(phi),
                               -jnp.cos(theta),
                               -sin_t * jnp.sin(phi)], axis=-1)
        ndl = vm.dot(N, direction)
        pdf = (pdf_u * pdf_v) / (vm.TWO_PI_SQ * jnp.maximum(sin_t, 1e-8))
        radiance = tex.env_lookup(scene.textures, dome.tex, direction)
        act = live if active is None else (active & live)
        atten0 = _shadow_attenuation(
            scene, tracer, P, direction, MIRO_TMAX, time,
            dome.cast_shadows, dome.fast_shadows, segments, act)
        atten = jnp.where(ndl >= 0.0, atten0, 0.0)
        E = dome.gain * radiance / jnp.maximum(pdf, 1e-20)[:, None]
        acc = acc + jnp.where(live[:, None], E * atten[:, None], 0.0)
        acc_s = acc_s + jnp.where(
            live, jnp.maximum(0.0, vm.dot(rvec, direction)) * atten, 0.0)
        if want_back:
            atten_b = jnp.where(-ndl >= 0.0, atten0, 0.0)
            acc_b = acc_b + jnp.where(live[:, None], E * atten_b[:, None],
                                      0.0)
        n_done = n_done + live
        if s + 1 < num_samples:
            if noise_cutoff > 0.0:
                cut = jnp.mean(E, axis=-1) / n_done < noise_cutoff
                done = done | (live & cut)
            if single_mask is not None:
                done = done | single_mask
    recip = 1.0 / jnp.maximum(n_done, 1.0)
    E_mean = acc * recip[:, None]
    spec3 = E_mean * _spec_pow(acc_s * recip, spec_exp)[:, None]
    return E_mean, spec3, acc_b * recip[:, None]


def sample_all_lights(scene: Scene, tracer, P, N, rvec, spec_exp, time, key,
                      secondary: bool, settings, want_back: bool = False,
                      active=None, secondary_mask=None):
    """The reference per-hit light loop (src/Blinn.cpp:213-221).

    secondary=True forces 1 sample per area light (src/DomeLight.cpp:89).
    Returns (lightPower (R,3), lightSpec (R,3), backPower (R,3)). lightSpec
    is sum_i E_i * pow(outSpec_i, specExp) — the per-light-exponentiated
    Blinn highlight term (src/Blinn.cpp:217: pow is applied PER LIGHT inside
    the loop; callers multiply by ks*specAmt only). backPower is the
    flipped-normal (translucency) estimate sharing the same shadow rays,
    zeros unless want_back.
    """
    R = P.shape[0]
    total = jnp.zeros((R, 3), P.dtype)
    spec = jnp.zeros((R, 3), P.dtype)
    back = jnp.zeros((R, 3), P.dtype)
    segs = settings.shadow_segments
    if scene.point_lights.position.shape[0] > 0:
        p, s, b = sample_point_lights(scene, tracer, P, N, rvec, spec_exp,
                                      time, segs, want_back, active)
        total += p
        spec += s
        back += b
    cutoff = getattr(settings, 'light_noise_cutoff', 0.0)
    if secondary_mask is not None and not getattr(
            settings, 'light_secondary_single', True):
        secondary_mask = None
    if scene.rect_lights.v1.shape[0] > 0:
        ns = 1 if secondary else scene.rect_lights.num_samples
        key, sub = jax.random.split(key)
        # NO single_mask here: only DomeLight implements the isSecondary
        # 1-sample rule in the reference (src/DomeLight.cpp:89);
        # RectangleLight::sampleLight always draws m_numSamples
        # (src/RectangleLight.cpp:53-133)
        p, s, b = sample_rect_lights(scene, tracer, P, N, rvec, spec_exp,
                                     time, sub, ns, segs, want_back, active,
                                     cutoff, None)
        total += p
        spec += s
        back += b
    if scene.dome is not None:
        ns = 1 if secondary else scene.dome.num_samples
        key, sub = jax.random.split(key)
        p, s, b = sample_dome_light(scene, tracer, P, N, rvec, spec_exp,
                                    time, sub, ns, segs, want_back, active,
                                    cutoff, secondary_mask)
        total += p
        spec += s
        back += b
    return total, spec, back
