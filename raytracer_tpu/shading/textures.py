"""Device-side texture sampling from the flat texel pool.

Mirrors Texture::getLookup / getLookupAlpha / getLookupXYZ3
(reference: src/Texture.cpp:12-125): wrap to [0,1), flip v, bilinear filter
with tiled pixel fetch, lat-long env mapping. All functions are batched over
arbitrary leading axes and differentiable w.r.t. TexturePack.data.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import TexturePack
from ..core.vecmath import PI, INV_PI


def _wrap_uv(u, v):
    u = u - jnp.trunc(u)
    v = v - jnp.trunc(v)
    u = jnp.where(u < 0, u + 1.0, u)
    v = jnp.where(v < 0, v + 1.0, v)
    return u, 1.0 - v  # v flip (src/Texture.cpp:53-54)


def _no_texture_rgba(u):
    """The no-map RGBA (rgb 0, alpha 1) used when the pool is empty.

    Derived from `u` (not fresh constants) so the result keeps u's
    varying type under shard_map."""
    z = jnp.asarray(u, jnp.float32)[..., None] * 0.0
    return jnp.concatenate([z, z, z, z + 1.0], axis=-1)


def tex_lookup(tp: TexturePack, tex_id, u, v):
    """Bilinear RGBA lookup -> (..., 4). tex_id < 0 is clamped to 0; callers
    mask the result (reference code checks the map pointer instead).

    An empty pool (a textureless scene) short-circuits to rgb 0 / alpha 1
    STATICALLY: otherwise every bounce still emits the clamped pool gather,
    whose transpose scatters into a zero-length array in the backward
    pass."""
    if tp.data.shape[0] == 0:
        return _no_texture_rgba(u)
    idx, state = _lookup_plan(tp, tex_id, u, v)
    return _lookup_combine(tp.data[idx], state)


def _lookup_plan(tp: TexturePack, tex_id, u, v):
    """Texel-pool indices + lerp state for one bilinear RGBA lookup.

    Returns (idx (..., 16) int32, (dx, dy, c)): 4 corners x 4 channels of
    pool indices; combine the gathered values with _lookup_combine. Split
    out so tex_lookup_batch can fuse MANY lookups into ONE pool gather —
    the gather's transpose is a scatter-add into the (large) texel pool,
    and one fused scatter per bounce is far cheaper than one per corner
    fetch."""
    tid = jnp.maximum(tex_id, 0)
    off = tp.offset[tid]
    w = tp.width[tid]
    h = tp.height[tid]
    c = tp.channels[tid]
    u, v = _wrap_uv(u, v)
    px = u * w
    py = v * h
    x1 = jnp.floor(px)
    y1 = jnp.floor(py)
    dx = (px - x1)[..., None]
    dy = (py - y1)[..., None]
    x1 = x1.astype(jnp.int32)
    y1 = y1.astype(jnp.int32)
    n = tp.data.shape[0]
    k = jnp.arange(4, dtype=jnp.int32)
    kc = jnp.minimum(k, c[..., None] - 1)
    idxs = []
    for cx, cy in ((x1, y1), (x1 + 1, y1), (x1, y1 + 1), (x1 + 1, y1 + 1)):
        x = jnp.remainder(cx, w)
        y = jnp.remainder(cy, h)
        base = off + (y * w + x) * c
        idxs.append(jnp.clip(base[..., None] + kc, 0, n - 1))
    return jnp.concatenate(idxs, axis=-1), (dx, dy, c)


def _lookup_combine(vals16, state):
    """Bilinear-combine the 16 gathered pool values -> RGBA (..., 4)."""
    dx, dy, c = state

    def pix(v4):
        gray = c[..., None] == 1
        rgb = jnp.where(gray, v4[..., 0:1], v4[..., :3])
        alpha = jnp.where(c >= 4, v4[..., 3], 1.0)
        return jnp.concatenate([rgb, alpha[..., None]], axis=-1)

    q11 = pix(vals16[..., 0:4])
    q21 = pix(vals16[..., 4:8])
    q12 = pix(vals16[..., 8:12])
    q22 = pix(vals16[..., 12:16])
    q1 = q11 * (1.0 - dx) + q21 * dx
    q2 = q12 * (1.0 - dx) + q22 * dx
    return q1 * (1.0 - dy) + q2 * dy


def tex_lookup_batch(tp: TexturePack, queries):
    """Many bilinear lookups, ONE texel-pool gather -> list of RGBA (..., 4).

    queries: [(tex_id, u, v), ...] with a common batch shape. Forward math
    is identical to per-query tex_lookup; the fusion exists so the
    backward pass emits a single scatter-add into tp.data per call site
    instead of one per corner fetch (4 per lookup)."""
    if tp.data.shape[0] == 0:
        return [_no_texture_rgba(u) for (_, u, _) in queries]
    plans = [_lookup_plan(tp, t, u, v) for (t, u, v) in queries]
    idx = jnp.concatenate([p[0] for p in plans], axis=-1)
    vals = tp.data[idx]
    return [_lookup_combine(vals[..., 16 * i:16 * (i + 1)], p[1])
            for i, p in enumerate(plans)]


def tex_lookup3(tp: TexturePack, tex_id, u, v):
    return tex_lookup(tp, tex_id, u, v)[..., :3]


def tex_lookup_alpha(tp: TexturePack, tex_id, u, v):
    return tex_lookup(tp, tex_id, u, v)[..., 3]


def env_uv(direction):
    """Lat-long mapping (src/Texture.cpp:90-98): theta = atan2(z, x) + pi;
    phi = acos(y); u = theta/2pi; v = 1 - phi/pi (pre-wrap)."""
    d = direction
    theta = jnp.arctan2(d[..., 2], d[..., 0]) + PI
    phi = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
    return theta * 0.5 * INV_PI, 1.0 - phi * INV_PI


def env_lookup(tp: TexturePack, tex_id, direction):
    """Lat-long environment lookup -> (..., 3)."""
    u, v = env_uv(direction)
    return tex_lookup3(tp, tex_id, u, v)


class TexBatch:
    """Collect bilinear lookups, execute them as ONE pool gather.

    Usage: i = batch.add(tex_id, u, v) per query; batch.run(); then
    batch.get(i) -> RGBA. Exists so one bounce's texture reads (surface
    maps + env chains) cost a single scatter-add in the backward pass."""

    def __init__(self, tp: TexturePack):
        self.tp = tp
        self.queries = []
        self.vals = None

    def add(self, tex_id, u, v) -> int:
        self.queries.append((tex_id, u, v))
        return len(self.queries) - 1

    def run(self) -> None:
        if self.queries:
            self.vals = tex_lookup_batch(self.tp, self.queries)

    def get(self, i: int):
        return self.vals[i]
