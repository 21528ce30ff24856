"""Batched 3-vector math for the TPU wavefront ray tracer.

All functions operate on arrays whose *last* axis is the vector axis (size 3),
so every op vectorizes over arbitrary leading ray/pixel axes on the VPU.

This replaces the reference's SSE vector layer (reference: src/SSE.h:7-114,
src/Vector3.h:15-326, src/Matrix4x4.h:17-856) with jnp array math; XLA fuses
these elementwise chains, the TPU generalization of the 4-wide SSE kernels.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Reference constants (reference: src/Miro.h:35-68). The reference uses a
# slightly truncated PI; we use float32 pi which matches to 1ulp.
MIRO_TMAX = 1e12
EPSILON = 1e-3            # reference: src/Miro.h:56 (epsilon = 0.001f)
PI = 3.1415926535897932
INV_PI = 1.0 / PI
INV_4PI = 0.25 / PI
TWO_PI_SQ = 2.0 * PI * PI
GAMMA = 2.2               # reference: src/Image.cpp:14


def dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Dot product over the last axis, keepdims dropped."""
    return jnp.sum(a * b, axis=-1)


def dot3(a: jax.Array, b: jax.Array) -> jax.Array:
    """Dot product keeping the last axis (size 1) for broadcasting."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.cross(a, b)


def length2(a: jax.Array) -> jax.Array:
    return jnp.sum(a * a, axis=-1)


def length(a: jax.Array) -> jax.Array:
    return jnp.sqrt(length2(a))


def normalize(a: jax.Array, eps: float = 1e-20) -> jax.Array:
    """Safe normalize: returns a * rsqrt(|a|^2), zero vectors stay zero-ish."""
    return a * jax.lax.rsqrt(jnp.maximum(length2(a), eps))[..., None]


def sqrt0(x: jax.Array) -> jax.Array:
    """sqrt(max(0, x)) whose gradient is 0 where x <= 0. The plain form's
    gradient there is inf * 0 = NaN, which a jnp.where around the result
    does not mask in the backward pass."""
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def average(a: jax.Array) -> jax.Array:
    """Mean of the 3 components (reference Vector3::average)."""
    return jnp.mean(a, axis=-1)


def reflect(d: jax.Array, n: jax.Array, v_dot_n: jax.Array | None = None) -> jax.Array:
    """Mirror direction: d + 2*(-d.n)*n with d the incoming ray direction.

    Matches reference rVec = rayD + 2*vDotN*theNormal (src/Blinn.cpp:158)
    where vDotN = dot(-rayD, N) >= 0.
    """
    if v_dot_n is None:
        v_dot_n = dot(-d, n)
    return d + 2.0 * v_dot_n[..., None] * n


def refract(d: jax.Array, n: jax.Array, v_dot_n: jax.Array, eta: jax.Array) -> jax.Array:
    """Refraction direction (not normalized-guarded against TIR).

    Matches reference (src/Blinn.cpp:305-307):
      tVec = normalize(eta*d + n*(eta*vDotN - sqrt(max(0, 1 - eta^2(1-vDotN^2)))))
    eta = n_in / n_out; under TIR the sqrt clamps to 0 (grazing direction),
    mirroring the reference's max(0, .) clamp.
    """
    sqrt_part = sqrt0(1.0 - (eta * eta) * (1.0 - v_dot_n * v_dot_n))
    t = eta[..., None] * d + n * (eta * v_dot_n - sqrt_part)[..., None]
    return normalize(t)


def fresnel(n1: jax.Array, n2: jax.Array, cos_theta_i: jax.Array) -> jax.Array:
    """Fresnel reflectance, s-polarization squared form.

    Mirrors the reference's default (non-Schlick) path (src/Material.h:47-54):
      Rs = ((n1*cos - n2*cos_t) / (n1*cos + n2*cos_t))^2
    with cos_t = max(0, sqrt(1 - (n1*sin/n2)^2)). Under TIR cos_t = 0 -> Rs = 1.
    """
    cos_theta_i = jnp.clip(cos_theta_i, 0.0, 1.0)
    sin_theta_i = sqrt0(1.0 - cos_theta_i * cos_theta_i)
    n1_cos = n1 * cos_theta_i
    s = n1 * sin_theta_i / n2
    n2_cos = n2 * sqrt0(1.0 - s * s)
    rs = (n1_cos - n2_cos) / jnp.maximum(n1_cos + n2_cos, 1e-12)
    return rs * rs


def schlick_fresnel(n1: jax.Array, n2: jax.Array, cos_theta_i: jax.Array) -> jax.Array:
    """Schlick approximation with TIR handling (reference: src/Material.h:55-67)."""
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    n = n1 / n2
    sin_t2 = n * n * (1.0 - cos_theta_i * cos_theta_i)
    tir = (n1 > n2) & (sin_t2 > 1.0)
    cos_x = jnp.where(n1 > n2, sqrt0(1.0 - sin_t2), cos_theta_i)
    x = 1.0 - cos_x
    out = r0 + (1.0 - r0) * x * x * x * x * x
    return jnp.where(tir, 1.0, out)


def build_onb(n: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Orthonormal basis (u, v) around normal n, reference convention.

    Matches src/Material.cpp:26-27:
      u = normalize(cross(|N.x| > 0.1 ? (0,1,0) : (1,0,0), N)); v = cross(N, u)
    """
    pick_y = jnp.abs(n[..., 0:1]) > 0.1
    a = jnp.where(pick_y,
                  jnp.array([0.0, 1.0, 0.0], dtype=n.dtype),
                  jnp.array([1.0, 0.0, 0.0], dtype=n.dtype))
    u = normalize(jnp.cross(a, n))
    v = jnp.cross(n, u)
    return u, v


def cosine_sample(n: jax.Array, e1: jax.Array, e2: jax.Array) -> jax.Array:
    """Cosine-distributed hemisphere sample around n.

    Mirrors src/Material.cpp:14-42 including the e2 <= 0.99 clamp:
      out = normalize(cos(2*pi*e1)*sqrt(e2)*u + sin(2*pi*e1)*sqrt(e2)*v
                      + sqrt(1-e2)*n)
    """
    e2 = jnp.minimum(e2, 0.99)
    u, v = build_onb(n)
    phi = 2.0 * PI * e1
    se2 = jnp.sqrt(e2)
    s1e2 = jnp.sqrt(1.0 - e2)
    out = (jnp.cos(phi) * se2)[..., None] * u + (jnp.sin(phi) * se2)[..., None] * v \
        + s1e2[..., None] * n
    return normalize(out)


def luminance_avg(c: jax.Array) -> jax.Array:
    return average(c)


# ---------------------------------------------------------------------------
# Tone mapping (reference: src/Image.cpp:19-87)
# ---------------------------------------------------------------------------

def linear_to_gamma_f(c: jax.Array) -> jax.Array:
    """Float gamma curve as used by the adaptive-sampling error metric.

    Mirrors Image::linear_to_gammaF[int(clamp(c,0,1)*32767)]:
      pow(i/32768, 1/2.2)*255 + 0.5, with 15-bit quantization of the input.
    We keep the quantization so adaptive cutoffs match the reference bit-wise
    on flat regions (src/Scene.cpp:278-283).
    """
    idx = jnp.floor(jnp.clip(c, 0.0, 1.0) * 32767.0)
    return jnp.power(idx / 32768.0, 1.0 / GAMMA) * 255.0 + 0.5


def tone_map_u8(c: jax.Array) -> jax.Array:
    """Map linear radiance to 8-bit gamma-encoded pixels.

    Mirrors Image::Map (src/Image.cpp:71-76): linear 15-bit clamp then the
    linear_to_gamma LUT (truncation to byte).
    """
    linear = jnp.minimum(jnp.maximum(c, 0.0) * 32768.0, 32768.0)
    linear = jnp.floor(linear)  # unsigned short cast
    g = jnp.power(linear / 32768.0, 1.0 / GAMMA) * 255.0 + 0.5
    return jnp.floor(g).astype(jnp.uint8)


def gamma_to_linear_u8(b: jax.Array) -> jax.Array:
    """8-bit gamma value -> linear float via the reference's 16-bit LUT.

    Mirrors Image::gamma_to_linear (src/Image.cpp:24-27) + the /32768 use in
    the TGA loader (src/RawImage.cpp:156).
    """
    t = jnp.floor(jnp.power(b.astype(jnp.float32) / 255.0, GAMMA) * 32768.0 + 0.5)
    return t / 32768.0


# ---------------------------------------------------------------------------
# 3x4 affine transform helpers (instancing)
# ---------------------------------------------------------------------------

def transform_point(m: jax.Array, p: jax.Array) -> jax.Array:
    """Apply (..., 3, 4) affine matrix to (..., 3) points."""
    return jnp.einsum('...ij,...j->...i', m[..., :3, :3], p) + m[..., :3, 3]


def transform_vector(m: jax.Array, v: jax.Array) -> jax.Array:
    """Apply the linear part of (..., 3, 4) matrix to (..., 3) vectors."""
    return jnp.einsum('...ij,...j->...i', m[..., :3, :3], v)
