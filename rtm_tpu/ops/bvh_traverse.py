"""BVH traversal — shader-parity validation path.

Mirrors the reference's iterative stack traversal (RayTracing.shader:324-484)
and the instance loop of bounceRay (shader:526-542): rays are transformed by
each instance's world-to-local matrix (direction NOT renormalized, so t stays
in world units), the per-mesh hierarchy is walked with an explicit 32-deep
stack, ordered near/far child descent and t-pruning, and leaves test their
triangle range in buffer order.

This is NOT the hot path (a lockstep traversal of all lanes does more work
than the dense sweep at the scene sizes the repo builds — SURVEY.md hard
part #1); it exists to (a) validate the SAH
builder end-to-end against the dense sweep the production kernel uses, and
(b) document the reference algorithm in runnable form.  It is vectorized
with a lockstep `lax.while_loop` over all rays (runs until the last ray's
stack empties), which is fine at validation sizes.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .intersect import FLT_MAX, _mm, aabb_hit, dot3

MAX_STACK = 32  # shader:341


@jax.tree_util.register_dataclass
@dataclass
class BvhArrays:
    """Device copy of accel.bvh.BvhScene buffers."""

    box_min: jax.Array          # (B,3)
    box_max: jax.Array          # (B,3)
    buffer_region: jax.Array    # (B,2) u32
    tri_a: jax.Array            # (T,3) local, reordered
    tri_b: jax.Array
    tri_c: jax.Array
    mesh_bvh_root: jax.Array    # (M,) u32
    mesh_model_root: jax.Array  # (M,) u32
    inst_world_to_local: jax.Array  # (I,4,4)
    inst_mesh_id: jax.Array     # (I,) i32

    @staticmethod
    def from_scene(bs) -> "BvhArrays":
        v = np.asarray(bs.tri_verts, np.float32)
        return BvhArrays(
            box_min=jnp.asarray(bs.box_min), box_max=jnp.asarray(bs.box_max),
            buffer_region=jnp.asarray(bs.buffer_region),
            tri_a=jnp.asarray(v[:, 0]), tri_b=jnp.asarray(v[:, 1]),
            tri_c=jnp.asarray(v[:, 2]),
            mesh_bvh_root=jnp.asarray(bs.mesh_bvh_root),
            mesh_model_root=jnp.asarray(bs.mesh_model_root),
            inst_world_to_local=jnp.asarray(bs.inst_world_to_local),
            inst_mesh_id=jnp.asarray(bs.inst_mesh_id),
        )


def _triangle_hit_single(o, d, a, b, c):
    """shader triangleHit :285-303 (f32 here; reference is f64)."""
    eab = b - a
    eac = c - a
    ao = o - a
    n = jnp.cross(eab, eac)
    dao = jnp.cross(ao, d)
    det = -dot3(d, n)
    inv_det = 1.0 / det
    t = dot3(ao, n) * inv_det
    u = dot3(eac, dao) * inv_det
    v = -dot3(eab, dao) * inv_det
    w = 1.0 - u - v
    hit = (det > 1e-12) & (t >= 0) & (u >= 0) & (v >= 0) & (w >= 0)
    return jnp.where(hit, t, FLT_MAX)


@partial(jax.jit, static_argnames=("max_leaf_tris",))
def bvh_traverse(bvh: BvhArrays, bvh_root, model_root, origin, direction,
                 max_leaf_tris: int = 16):
    """Vectorized shader bvhTraverse (:324-484) over N rays.

    bvh_root/model_root: scalars (mesh-local roots).  Returns (t, tri_idx)
    with tri_idx global into the reordered triangle buffer, -1 on miss.
    """
    n = origin.shape[0]
    root_hit = aabb_hit(origin, direction, bvh.box_min[bvh_root],
                        bvh.box_max[bvh_root])
    alive0 = root_hit < FLT_MAX

    stack = jnp.zeros((n, MAX_STACK), jnp.uint32).at[:, 0].set(bvh_root)
    sp = jnp.where(alive0, 1, 0).astype(jnp.int32)
    best_t = jnp.full((n,), FLT_MAX)
    best_i = jnp.full((n,), -1, jnp.int32)

    def cond(state):
        _, sp, *_ = state
        return jnp.any(sp > 0)

    def body(state):
        stack, sp, best_t, best_i = state
        active = sp > 0
        sp_new = jnp.where(active, sp - 1, sp)
        node = stack[jnp.arange(n), jnp.maximum(sp_new, 0)]
        node = jnp.where(active, node, bvh_root)

        region = bvh.buffer_region[node]                  # (N,2)
        is_leaf = region[:, 1] > 0

        # --- leaf: test triangle range in order (shader:376-407) ----------
        lo = region[:, 0] + model_root
        hi = region[:, 1] + model_root
        leaf_t = jnp.full((n,), FLT_MAX)
        leaf_i = jnp.full((n,), -1, jnp.int32)
        for k in range(max_leaf_tris):
            ti = lo + k
            valid = active & is_leaf & (ti < hi)
            tid = jnp.clip(ti, 0, bvh.tri_a.shape[0] - 1).astype(jnp.int32)
            t = _triangle_hit_single(origin, direction, bvh.tri_a[tid],
                                     bvh.tri_b[tid], bvh.tri_c[tid])
            upd = valid & (t < leaf_t)
            leaf_t = jnp.where(upd, t, leaf_t)
            leaf_i = jnp.where(upd, tid, leaf_i)
        upd = active & is_leaf & (leaf_t < best_t)
        best_t = jnp.where(upd, leaf_t, best_t)
        best_i = jnp.where(upd, leaf_i, best_i)

        # --- internal: ordered near/far push with pruning (shader:438-479) -
        left = bvh_root + region[:, 0]
        right = left + 1
        lt = aabb_hit(origin, direction, bvh.box_min[left], bvh.box_max[left])
        rt = aabb_hit(origin, direction, bvh.box_min[right], bvh.box_max[right])
        left_closest = lt < rt
        near = jnp.where(left_closest, left, right)
        far = jnp.where(left_closest, right, left)
        near_d = jnp.where(left_closest, lt, rt)
        far_d = jnp.where(left_closest, rt, lt)

        push_far = active & ~is_leaf & (far_d < best_t)
        stack = stack.at[jnp.arange(n), jnp.clip(sp_new, 0, MAX_STACK - 1)].set(
            jnp.where(push_far, far, stack[jnp.arange(n), jnp.clip(sp_new, 0, MAX_STACK - 1)]))
        sp2 = jnp.where(push_far, sp_new + 1, sp_new)
        push_near = active & ~is_leaf & (near_d < best_t)
        stack = stack.at[jnp.arange(n), jnp.clip(sp2, 0, MAX_STACK - 1)].set(
            jnp.where(push_near, near, stack[jnp.arange(n), jnp.clip(sp2, 0, MAX_STACK - 1)]))
        sp3 = jnp.where(push_near, sp2 + 1, sp2)
        return (stack, sp3, best_t, best_i)

    _, _, best_t, best_i = jax.lax.while_loop(
        cond, body, (stack, sp, best_t, best_i))
    return best_t, best_i


def bounce_ray_bvh(bvh: BvhArrays, origin, direction, max_leaf_tris: int = 16):
    """Instance loop of bounceRay (shader:526-542): returns
    (t, global_tri_idx, instance_idx) for the nearest mesh hit."""
    n = origin.shape[0]
    best_t = jnp.full((n,), FLT_MAX)
    best_tri = jnp.full((n,), -1, jnp.int32)
    best_inst = jnp.full((n,), -1, jnp.int32)
    num_inst = bvh.inst_mesh_id.shape[0]
    for ii in range(num_inst):
        w2l = bvh.inst_world_to_local[ii]
        o_local = _mm(origin, w2l[:3, :3].T) + w2l[:3, 3]
        d_local = _mm(direction, w2l[:3, :3].T)  # not renormalized (shader:532)
        mesh_id = int(bvh.inst_mesh_id[ii])
        t, tri = bvh_traverse(bvh, bvh.mesh_bvh_root[mesh_id],
                              bvh.mesh_model_root[mesh_id],
                              o_local, d_local, max_leaf_tris)
        upd = (tri >= 0) & (t < best_t)
        best_t = jnp.where(upd, t, best_t)
        best_tri = jnp.where(upd, tri, best_tri)
        best_inst = jnp.where(upd, ii, best_inst)
    return best_t, best_tri, best_inst
