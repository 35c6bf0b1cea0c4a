"""Pallas-Triton kernel for the per-bounce nearest-triangle sweep.

This is the hot loop of the tracer: every bounce searches all triangles for
each ray's nearest hit (the reference does it per thread with a BVH and an
f64 triangle test, RayTracing.shader:324-484, 285-303).  The plain XLA
version, `ops.intersect.nearest_triangle`, computes the same test as five
K=3 contractions per triangle chunk, each an (N, chunk) f32 array.  This
kernel fuses them:

  * one program per block of RAY_BLOCK rays; the block's rays stay in
    registers as (R,) columns;
  * a loop over tiles of TRI_TILE triangles read from the 16-feature SoA
    table (`pack_triangle_features`); every pair term of the
    scalar-triple-product test (ops/intersect.py) is a broadcast f32
    multiply-add on the CUDA cores producing an (R, TRI_TILE) tile;
  * a running (t, idx) per ray with strict `<` across tiles and a
    first-occurrence argmin inside a tile, so the first minimum in buffer
    order wins, as in the reference's traversal;
  * only (t, idx) per ray is written back.

The pair test is a K~10 product, too thin for the tensor cores, and TF32
would flip the sign tests near triangle edges, so everything is exact f32.

The kernel's outputs are detached from autodiff: `bounce_payload` recomputes
the winner's hit distance differentiably from its index
(ops/trace_ref._triangle_t_from_idx), which is the detached-topology
convention of the gradient path (diff/params.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..intersect import DET_EPS, FLT_MAX

RAY_BLOCK = 64       # rays per program (power of two)
TRI_TILE = 32        # triangles per inner-loop step (power of two)
NUM_WARPS = 4

# feature rows of the packed (16, T') table
_F_NX, _F_NY, _F_NZ, _F_AN = 0, 1, 2, 3
_F_ABX, _F_ABY, _F_ABZ = 4, 5, 6
_F_ACX, _F_ACY, _F_ACZ = 7, 8, 9
_F_G1X, _F_G1Y, _F_G1Z = 10, 11, 12
_F_G2X, _F_G2Y, _F_G2Z = 13, 14, 15
NUM_FEATURES = 16


def pack_triangle_features(a, b, c):
    """The 16 per-triangle features of the pair test, padded to a whole
    number of tiles.

    a/b/c: (T,3) world-space vertices.  Returns (16, T') f32 with
    T' = ceil(T / TRI_TILE) * TRI_TILE.  Padding triangles are degenerate:
    zero normal, so det == 0 and they never pass `det > eps`.
    """
    t = a.shape[0]
    pad = max(1, -(-t // TRI_TILE)) * TRI_TILE - t

    def padt(x):
        return jnp.pad(x, ((0, pad), (0, 0)))

    a_p, b_p, c_p = padt(a), padt(b), padt(c)
    ab = b_p - a_p
    ac = c_p - a_p
    n = jnp.cross(ab, ac)
    an = jnp.sum(a_p * n, axis=-1)
    g1 = jnp.cross(ac, a_p)
    g2 = jnp.cross(ab, a_p)
    return jnp.stack([
        n[:, 0], n[:, 1], n[:, 2], an,
        ab[:, 0], ab[:, 1], ab[:, 2],
        ac[:, 0], ac[:, 1], ac[:, 2],
        g1[:, 0], g1[:, 1], g1[:, 2],
        g2[:, 0], g2[:, 1], g2[:, 2],
    ], axis=0).astype(jnp.float32)


def _kernel(rays_ref, feats_ref, t_ref, idx_ref, *, n_tiles: int):
    ox, oy, oz = rays_ref[0, :], rays_ref[1, :], rays_ref[2, :]
    dx, dy, dz = rays_ref[3, :], rays_ref[4, :], rays_ref[5, :]
    wx, wy, wz = rays_ref[6, :], rays_ref[7, :], rays_ref[8, :]
    ox, oy, oz = ox[:, None], oy[:, None], oz[:, None]
    dx, dy, dz = dx[:, None], dy[:, None], dz[:, None]
    wx, wy, wz = wx[:, None], wy[:, None], wz[:, None]
    r = ox.shape[0]
    col = jax.lax.broadcasted_iota(jnp.int32, (r, TRI_TILE), 1)

    def tile(j, carry):
        best_t, best_i = carry
        lane = pl.ds(pl.multiple_of(j * TRI_TILE, TRI_TILE), TRI_TILE)

        def f(k):
            return feats_ref[k, lane][None, :]

        nx, ny, nz = f(_F_NX), f(_F_NY), f(_F_NZ)
        det = -(dx * nx + dy * ny + dz * nz)                  # (R, tile)
        tdet = ox * nx + oy * ny + oz * nz - f(_F_AN)
        udet = ((wx * f(_F_ACX) + wy * f(_F_ACY) + wz * f(_F_ACZ))
                - (dx * f(_F_G1X) + dy * f(_F_G1Y) + dz * f(_F_G1Z)))
        vdet = ((dx * f(_F_G2X) + dy * f(_F_G2Y) + dz * f(_F_G2Z))
                - (wx * f(_F_ABX) + wy * f(_F_ABY) + wz * f(_F_ABZ)))
        wdet = det - udet - vdet
        valid = ((det > DET_EPS) & (tdet >= 0.0) & (udet >= 0.0)
                 & (vdet >= 0.0) & (wdet >= 0.0))
        t = jnp.where(valid, tdet / jnp.where(valid, det, 1.0), FLT_MAX)
        tmin = jnp.min(t, axis=1)                             # (R,)
        imin = jnp.min(jnp.where(t == tmin[:, None], col, TRI_TILE),
                       axis=1) + j * TRI_TILE
        better = tmin < best_t
        return jnp.where(better, tmin, best_t), jnp.where(better, imin,
                                                          best_i)

    init = (jnp.full((r,), FLT_MAX, jnp.float32),
            jnp.full((r,), -1, jnp.int32))
    best_t, best_i = jax.lax.fori_loop(0, n_tiles, tile, init)
    t_ref[...] = best_t
    idx_ref[...] = jnp.where(best_t < FLT_MAX, best_i, -1)


@functools.partial(jax.jit, static_argnames=("interpret",))
def _sweep(rays, feats, interpret: bool):
    n = rays.shape[1]
    kernel = functools.partial(_kernel, n_tiles=feats.shape[1] // TRI_TILE)
    # under shard_map the outputs vary over the same mesh axes as the rays
    vma = jax.typeof(rays).vma | jax.typeof(feats).vma
    return pl.pallas_call(
        kernel,
        grid=(n // RAY_BLOCK,),
        in_specs=[
            pl.BlockSpec((NUM_FEATURES, RAY_BLOCK), lambda i: (0, i)),
            pl.BlockSpec(feats.shape, lambda i: (0, 0)),
        ],
        out_specs=(pl.BlockSpec((RAY_BLOCK,), lambda i: (i,)),
                   pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))),
        out_shape=(jax.ShapeDtypeStruct((n,), jnp.float32, vma=vma),
                   jax.ShapeDtypeStruct((n,), jnp.int32, vma=vma)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="triangle_sweep",
    )(rays, feats)


def nearest_triangle_triton(origin, direction, tri_a, tri_b, tri_c, *,
                            interpret: bool = False):
    """Nearest triangle per ray through the Triton sweep.

    origin/direction: (N,3) f32.  tri_*: (T,3) world vertices.
    Returns (t (N,), idx (N,) i32, -1 on miss), both detached from
    autodiff.  interpret=True runs the kernel in the Pallas interpreter,
    for tests off the GPU.
    """
    n = origin.shape[0]
    if tri_a.shape[0] == 0:
        return jnp.full((n,), FLT_MAX), jnp.full((n,), -1, jnp.int32)
    origin, direction, tri_a, tri_b, tri_c = jax.lax.stop_gradient(
        (origin, direction, tri_a, tri_b, tri_c))
    feats = pack_triangle_features(tri_a, tri_b, tri_c)
    pad = (-n) % RAY_BLOCK
    rays = jnp.concatenate([origin, direction, jnp.cross(origin, direction),
                            jnp.zeros((n, NUM_FEATURES - 9), jnp.float32)],
                           axis=1)
    if pad:
        # filler rays from the origin along +x: they hit or miss like any
        # ray and are cut off below
        filler = jnp.zeros((pad, NUM_FEATURES), jnp.float32).at[:, 3].set(1.0)
        rays = jnp.concatenate([rays, filler], axis=0)
    t, idx = _sweep(rays.T, feats, interpret)
    return t[:n], idx[:n]
