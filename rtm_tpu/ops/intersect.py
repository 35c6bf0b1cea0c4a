"""Intersection primitives, vectorized SoA-style.

Reference device code: sphereHit (RayTracing.shader:486-508), triangleHit
(shader:285-303, double precision), hitBox (shader:305-318).

Array reformulation: instead of the shader's one-ray/one-primitive scalar
functions inside divergent loops, everything here is expressed as dense
(rays x primitives) sweeps built from (N,3)@(3,T) contractions and
elementwise ops, which XLA compiles as they stand.  The
ray-triangle test uses the scalar-triple-product identity so that *all*
ray-dependent x triangle-dependent terms are inner products of precomputed
features (no (N,T,3) intermediates are ever materialized):

    det      = -D.n                 n  = cross(B-A, C-A)
    t * det  =  O.n - (A.n)
    u * det  =  W.AC - D.g1         W  = cross(O, D)   g1 = cross(AC, A)
    v * det  =  D.g2 - W.AB                            g2 = cross(AB, A)
    w * det  =  det - u*det - v*det

Acceptance multiplies the shader's {t,u,v,w >= 0, det > eps} through det>0,
avoiding divisions for rejected pairs.  The reference runs this test in f64
(requires shaderFloat64); f64 is slow on the accelerator, so the sweep is
f32 — the
epsilon/tolerance study lives in tests/test_intersect.py against a f64
NumPy oracle.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

FLT_MAX = np.float32(3.402823466e38)
DET_EPS = np.float32(1e-12)  # f32 stand-in for the reference's DBL_EPS gate


def _mm(a, b):
    """Geometry matmul pinned to full f32.

    A default-precision f32 matmul may run in TF32 on the GPU (10 mantissa
    bits) — catastrophic for hit distances.  Every geometric contraction
    goes through HIGHEST precision, which is true f32; the Triton sweep
    (ops/pallas/intersect_kernel.py) is elementwise f32 by construction."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def dot3(a, b):
    return jnp.sum(a * b, axis=-1)


def cross3(a, b):
    return jnp.cross(a, b)


def normalize(v, axis=-1):
    return v / jnp.linalg.norm(v, axis=axis, keepdims=True)


def safe_normalize(v, eps=1e-20):
    """normalize() whose gradient stays finite at ||v|| -> 0.

    Used wherever masked-out lanes can carry degenerate vectors: with plain
    normalize, a NaN produced on a lane that jnp.where later discards still
    poisons the backward pass (0 * NaN = NaN)."""
    sq = jnp.sum(v * v, axis=-1, keepdims=True)
    return v / jnp.sqrt(jnp.maximum(sq, eps))


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------

def sphere_hits(origin, direction, sph_pos, sph_radius):
    """All-pairs sphere distances (shader sphereHit, :486-508).

    origin/direction: (N,3); sph_pos: (S,3); sph_radius: (S,).
    Returns (N,S) f32 distances, FLT_MAX where missed.  Nearest-positive-root
    semantics: delta < 0 -> miss, t = (-b - sqrt(delta)) / 2a, t < 0 -> miss.

    Computed in the shader's op order (oc = O - C first): the algebraically
    equivalent matmul expansion of |O-C|^2 cancels catastrophically in f32
    for the reference's giant wall spheres (r = 1e4 at |C| ~ 1e4).  Sphere
    counts are tiny, so the (N,S,3) broadcast is cheap.
    """
    oc3 = origin[:, None, :] - sph_pos[None, :, :]             # (N,S,3)
    a = dot3(direction, direction)[:, None]                    # (N,1)
    b = 2.0 * jnp.sum(oc3 * direction[:, None, :], axis=-1)    # (N,S)
    c = jnp.sum(oc3 * oc3, axis=-1) - (sph_radius * sph_radius)[None, :]
    delta = b * b - 4.0 * a * c
    # double-where: sqrt has infinite slope at 0, so missed pairs
    # (delta < 0) must never reach sqrt's gradient (0 * inf = NaN).
    # Exact tangents (delta == 0) are a real singularity — dt/dparam is
    # infinite there — so the sqrt argument is floored: forward changes by
    # <= 1e-6/(2a) (below f32 noise), gradients stay finite.
    hit_delta = delta >= 0.0
    delta_safe = jnp.where(hit_delta, jnp.maximum(delta, 1e-12), 1.0)
    t = (-b - jnp.sqrt(delta_safe)) / (2.0 * a)
    valid = hit_delta & (t >= 0.0)
    return jnp.where(valid, t, FLT_MAX)


def nearest_sphere(origin, direction, sph_pos, sph_radius):
    """Nearest sphere per ray: (t (N,), idx (N,) i32).  First-min-wins tie
    order matches the reference's strict `<` update loop (shader:516-524)."""
    n = origin.shape[0]
    if sph_pos.shape[0] == 0:
        return jnp.full((n,), FLT_MAX), jnp.full((n,), -1, jnp.int32)
    t = sphere_hits(origin, direction, sph_pos, sph_radius)
    idx = jnp.argmin(t, axis=1).astype(jnp.int32)
    tmin = jnp.min(t, axis=1)
    return tmin, jnp.where(tmin < FLT_MAX, idx, -1)


# ---------------------------------------------------------------------------
# Triangles
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass
class TriFeatures:
    """Precomputed per-triangle intersection features (all (T,3)/(T,))."""

    n: jax.Array    # geometric normal cross(AB, AC) — unnormalized
    an: jax.Array   # dot(A, n)
    ab: jax.Array   # edge B-A
    ac: jax.Array   # edge C-A
    g1: jax.Array   # cross(AC, A)
    g2: jax.Array   # cross(AB, A)

    @staticmethod
    def build(a, b, c) -> "TriFeatures":
        ab = b - a
        ac = c - a
        n = jnp.cross(ab, ac)
        return TriFeatures(
            n=n, an=dot3(a, n), ab=ab, ac=ac,
            g1=jnp.cross(ac, a), g2=jnp.cross(ab, a),
        )

    @property
    def count(self) -> int:
        return self.n.shape[0]


def triangle_hits(origin, direction, f: TriFeatures, w_cross=None):
    """All-pairs ray-triangle distances: (N,T) f32, FLT_MAX on miss.

    Backface-culled det>eps + t,u,v,w >= 0 (shader triangleHit :285-303).
    `w_cross` = cross(origin, direction) may be passed to amortize.
    """
    if w_cross is None:
        w_cross = jnp.cross(origin, direction)
    det = -_mm(direction, f.n.T)                       # (N,T)
    tdet = _mm(origin, f.n.T) - f.an[None, :]
    udet = _mm(w_cross, f.ac.T) - _mm(direction, f.g1.T)
    vdet = _mm(direction, f.g2.T) - _mm(w_cross, f.ab.T)
    wdet = det - udet - vdet
    valid = (det > DET_EPS) & (tdet >= 0.0) & (udet >= 0.0) & (vdet >= 0.0) & (wdet >= 0.0)
    t = jnp.where(valid, tdet / jnp.where(valid, det, 1.0), FLT_MAX)
    return t


@partial(jax.jit, static_argnames=("chunk",))
def nearest_triangle(origin, direction, feats: TriFeatures, chunk: int = 512):
    """Nearest triangle per ray via a chunked sweep: (t (N,), idx (N,) i32).

    Chunks the triangle axis with lax.scan so peak memory is O(N*chunk), not
    O(N*T).  First-min-wins across and within chunks, matching the strict-`<`
    traversal order of the reference (triangles are visited in buffer order).
    """
    n = origin.shape[0]
    t_total = feats.count
    if t_total == 0:
        return jnp.full((n,), FLT_MAX), jnp.full((n,), -1, jnp.int32)

    pad = (-t_total) % chunk
    def padf(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths)
    f = jax.tree.map(padf, feats)
    nchunks = (t_total + pad) // chunk
    f = jax.tree.map(lambda x: x.reshape((nchunks, chunk) + x.shape[1:]), f)

    w_cross = jnp.cross(origin, direction)
    col = jax.lax.broadcasted_iota(jnp.int32, (n, chunk), 1)

    def body(carry, xs):
        best_t, best_i = carry
        chunk_idx, fc = xs
        t = triangle_hits(origin, direction, fc, w_cross)       # (N,chunk)
        tmin = jnp.min(t, axis=1)
        # first-occurrence argmin within the chunk
        imin = jnp.min(jnp.where(t == tmin[:, None], col, chunk), axis=1)
        gidx = chunk_idx * chunk + imin
        better = tmin < best_t
        return (jnp.where(better, tmin, best_t),
                jnp.where(better, gidx.astype(jnp.int32), best_i)), None

    # init derived from the (possibly shard_map-varying) rays so the scan
    # carry typechecks under varying manual axes
    zero = origin[:, 0] * 0.0
    init = (zero + FLT_MAX, zero.astype(jnp.int32) - 1)
    (best_t, best_idx), _ = jax.lax.scan(body, init, (jnp.arange(nchunks), f))
    best_idx = jnp.where(best_t < FLT_MAX, best_idx, -1)
    return best_t, best_idx


# ---------------------------------------------------------------------------
# AABB (BVH traversal path)
# ---------------------------------------------------------------------------

def aabb_hit(origin, direction, bmin, bmax):
    """Slab test (shader hitBox :305-318): entry distance or FLT_MAX.

    origin/direction (...,3) broadcast against bmin/bmax (...,3).
    Returns tNear where 0 <= tFar and tNear <= tFar, else FLT_MAX.
    """
    inv = 1.0 / direction
    lbf = (bmin - origin) * inv
    rtb = (bmax - origin) * inv
    tmin = jnp.minimum(lbf, rtb)
    tmax = jnp.maximum(lbf, rtb)
    t_near = jnp.max(tmin, axis=-1)
    t_far = jnp.min(tmax, axis=-1)
    hit = (0.0 <= t_far) & (t_near <= t_far)
    return jnp.where(hit, t_near, FLT_MAX)
