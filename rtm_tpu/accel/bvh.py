"""Per-mesh binary BVH builder — binned SAH, exact reference semantics.

Parity with the reference builder (RayTracing/src/BVH.{h,cpp}):
  * per-triangle nodes: AABB + centroid (A+B+C)/3         (BVH.cpp:77-94)
  * root box = the mesh *volume* (glTF accessor min/max!)  (BVH.cpp:96-108)
  * binned SAH: 3 axes x 6 buckets over centroid bounds; bucket index
    min(5, (c-lo)*6/(hi-lo)); split position lo + (hi-lo)/6*(i+1)
                                                           (BVH.cpp:181-225)
  * area() quirk: half surface area (no *2), 0 for empty boxes
                                                           (BVH.cpp:35-45)
  * leaf rule: depth==32 or best plane cost >= area(parent)*count
                                                           (BVH.cpp:110-123)
  * in-place swap partition by centroid <= splitPos (left side keeps scan
    order, right side gets the swap permutation — preserved exactly, since
    leaf ranges index the *reordered* triangle buffer and first-hit-wins ties
    depend on order)                                       (BVH.cpp:128-143)
  * children appended contiguously; parent.bufferRegion = (child_offset, 0);
    leaf.bufferRegion = (lo, hi) with hi > 0 as the leaf flag
                                                           (BVH.cpp:145-151)
  * Stats{buildTime, triCnt, nodeCnt, leafCnt, leafDepth, leafTris, SAH}
                                                           (BVH.cpp:240-258)

The hot loops run through the optional C++ builder (accel/native) when
built, else this NumPy/Python implementation — both produce identical
arrays (asserted in tests).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..models.mesh import Mesh
from ..utils.logging import get_logger
from ..utils.timing import Timer

log = get_logger("engine")

MAX_DEPTH = 32          # BVH.h:71
NR_SUBPLANES = 6        # BVH.h:72
FMAX = np.float32(np.finfo(np.float32).max)


def _area(vmin, vmax) -> np.float32:
    """Reference area(): half surface area; 0 for inverted/empty boxes."""
    if np.any(vmin > vmax):
        return np.float32(0.0)
    size = (vmin - vmax).astype(np.float32)
    return np.float32(size[0] * size[1] + size[1] * size[2] + size[0] * size[2])


@dataclass
class BvhStats:
    """BVH::Stats parity (BVH.h:33-49)."""

    build_time_ms: float = 0.0
    tri_cnt: int = 0
    node_cnt: int = 0
    leaf_cnt: int = 0
    leaf_depth_min: int = 100
    leaf_depth_max: int = 0
    leaf_depth_sum: float = 0.0
    leaf_tris_min: int = 1000000
    leaf_tris_max: int = 0
    leaf_tris_sum: float = 0.0
    sah: float = 0.0

    def measure(self, depth: int, tri_count: int, cost: float) -> None:
        self.leaf_cnt += 1
        self.leaf_depth_min = min(self.leaf_depth_min, depth)
        self.leaf_depth_max = max(self.leaf_depth_max, depth)
        self.leaf_depth_sum += depth
        self.leaf_tris_min = min(self.leaf_tris_min, tri_count)
        self.leaf_tris_max = max(self.leaf_tris_max, tri_count)
        self.leaf_tris_sum += tri_count
        self.sah += cost

    @property
    def mean_depth(self) -> float:
        return self.leaf_depth_sum / max(self.leaf_cnt, 1)

    @property
    def mean_tris(self) -> float:
        return self.leaf_tris_sum / max(self.leaf_cnt, 1)

    def log(self) -> None:
        log.debug("BVH buildTime: %s ms", self.build_time_ms)
        log.debug("BVH triangles = %d nodes = %d leafs = %d",
                  self.tri_cnt, self.node_cnt, self.leaf_cnt)
        log.debug("BVH leaf Depth: Min = %d Max = %d Mean = %.2f",
                  self.leaf_depth_min, self.leaf_depth_max, self.mean_depth)
        log.debug("BVH leaf Tris: Min = %d Max = %d Mean = %.2f SAH = %.2f",
                  self.leaf_tris_min, self.leaf_tris_max, self.mean_tris, self.sah)

    def validate(self) -> None:
        """Instrumented invariants, promoted from logs to assertions
        (SURVEY.md §4(e))."""
        assert self.leaf_cnt >= 1
        assert self.node_cnt == 2 * self.leaf_cnt - 1 or self.tri_cnt == 0
        assert self.leaf_tris_sum == self.tri_cnt
        assert self.leaf_depth_max <= MAX_DEPTH


@dataclass
class BVH:
    """Built hierarchy for one mesh (flat arrays, GPU layout)."""

    box_min: np.ndarray       # (B,3) f32
    box_max: np.ndarray       # (B,3) f32
    buffer_region: np.ndarray  # (B,2) u32: internal -> (child_off, 0);
    #                                      leaf -> (lo, hi) into reordered tris
    order: np.ndarray         # (T,) u32 triangle permutation (indices)
    stats: BvhStats = field(default_factory=BvhStats)

    @property
    def num_nodes(self) -> int:
        return len(self.box_min)


def build_bvh(mesh: Mesh, use_native: bool = True) -> BVH:
    timer = Timer()
    if use_native:
        try:
            from .native import bvh_native
            result = bvh_native.build(mesh)
            if result is not None:
                result.stats.build_time_ms = timer.elapsed_ms()
                result.stats.log()
                return result
        except ImportError:
            pass
    result = _build_python(mesh)
    result.stats.build_time_ms = timer.elapsed_ms()
    result.stats.log()
    return result


def _build_python(mesh: Mesh) -> BVH:
    verts = mesh.verts.astype(np.float32)          # (T,3,3)
    t_count = len(verts)
    node_min = verts.min(axis=1)
    node_max = verts.max(axis=1)
    centers = (verts[:, 0] + verts[:, 1] + verts[:, 2]) / np.float32(3.0)

    indices = np.arange(t_count, dtype=np.uint32)
    hier_min: list = [np.asarray(mesh.volume_min, np.float32)]
    hier_max: list = [np.asarray(mesh.volume_max, np.float32)]
    hier_region: list = [np.zeros(2, np.uint32)]
    stats = BvhStats(tri_cnt=t_count)

    def split_axis(axis: int, lo: int, hi: int, blo: np.float32, bhi: np.float32):
        """BVH.cpp:181-225. Returns (cost, position)."""
        interval = np.float32(NR_SUBPLANES) / np.float32(bhi - blo)
        c = centers[indices[lo:hi], axis]
        bucket = np.minimum(NR_SUBPLANES - 1,
                            ((c - blo) * interval).astype(np.uint32))
        b_cnt = np.zeros(NR_SUBPLANES, np.uint32)
        b_min = np.full((NR_SUBPLANES, 3), FMAX, np.float32)
        b_max = np.full((NR_SUBPLANES, 3), -FMAX, np.float32)
        sel_min = node_min[indices[lo:hi]]
        sel_max = node_max[indices[lo:hi]]
        for bi in range(NR_SUBPLANES):
            m = bucket == bi
            b_cnt[bi] = m.sum()
            if b_cnt[bi]:
                b_min[bi] = sel_min[m].min(axis=0)
                b_max[bi] = sel_max[m].max(axis=0)

        best_cost = FMAX
        best_pos = np.float32(0.0)
        lmin = np.full(3, FMAX, np.float32); lmax = np.full(3, -FMAX, np.float32)
        rmin = np.full(3, FMAX, np.float32); rmax = np.full(3, -FMAX, np.float32)
        l_area = np.zeros(NR_SUBPLANES - 1, np.float32)
        l_cnt = np.zeros(NR_SUBPLANES - 1, np.uint32)
        r_area = np.zeros(NR_SUBPLANES - 1, np.float32)
        r_cnt = np.zeros(NR_SUBPLANES - 1, np.uint32)
        lc = rc = 0
        for li in range(NR_SUBPLANES - 1):
            lc += int(b_cnt[li])
            l_cnt[li] = lc
            lmin = np.minimum(lmin, b_min[li]); lmax = np.maximum(lmax, b_max[li])
            l_area[li] = _area(lmin, lmax)
            ri = NR_SUBPLANES - 1 - li
            rc += int(b_cnt[ri])
            r_cnt[ri - 1] = rc
            rmin = np.minimum(rmin, b_min[ri]); rmax = np.maximum(rmax, b_max[ri])
            r_area[ri - 1] = _area(rmin, rmax)

        subplane_size = np.float32(bhi - blo) / np.float32(NR_SUBPLANES)
        for i in range(NR_SUBPLANES - 1):
            cost = np.float32(l_cnt[i] * l_area[i] + r_cnt[i] * r_area[i])
            if cost < best_cost:
                best_cost = cost
                best_pos = np.float32(blo + subplane_size * np.float32(i + 1.0))
        return best_cost, best_pos

    def split_box(lo: int, hi: int):
        """BVH.cpp:154-179. Returns (cost, position, axis)."""
        best = (FMAX, np.float32(0.0), 0)
        if hi - lo == 0:
            return best
        for axis in range(3):
            c = centers[indices[lo:hi], axis]
            blo, bhi = np.float32(c.min()), np.float32(c.max())
            if blo == bhi:
                continue
            cost, pos = split_axis(axis, lo, hi, blo, bhi)
            if cost < best[0]:
                best = (cost, pos, axis)
        return best

    def split(parent: int, lo: int, hi: int, depth: int = 0) -> None:
        tri_count = hi - lo
        cost, pos, axis = split_box(lo, hi)
        parent_cost = _area(hier_min[parent], hier_max[parent]) * np.float32(tri_count)

        if depth == MAX_DEPTH or cost >= parent_cost:
            stats.measure(depth, tri_count, float(parent_cost))
            hier_region[parent] = np.array([lo, hi], np.uint32)
            return

        # in-place swap partition (BVH.cpp:128-143) — order-exact
        lmin = np.full(3, FMAX, np.float32); lmax = np.full(3, -FMAX, np.float32)
        rmin = np.full(3, FMAX, np.float32); rmax = np.full(3, -FMAX, np.float32)
        center = lo
        for i in range(lo, hi):
            node = indices[i]
            if centers[node, axis] <= pos:
                lmin = np.minimum(lmin, node_min[node])
                lmax = np.maximum(lmax, node_max[node])
                indices[center], indices[i] = indices[i], indices[center]
                center += 1
            else:
                rmin = np.minimum(rmin, node_min[node])
                rmax = np.maximum(rmax, node_max[node])

        child = len(hier_min)
        hier_region[parent] = np.array([child, 0], np.uint32)
        hier_min.append(lmin); hier_max.append(lmax)
        hier_region.append(np.zeros(2, np.uint32))
        hier_min.append(rmin); hier_max.append(rmax)
        hier_region.append(np.zeros(2, np.uint32))
        split(child, lo, center, depth + 1)
        split(child + 1, center, hi, depth + 1)

    if t_count > 0:
        import sys
        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 10000))
        try:
            split(0, 0, t_count)
        finally:
            sys.setrecursionlimit(old_limit)
    else:
        hier_region[0] = np.array([0, 0], np.uint32)
        stats.measure(0, 0, 0.0)

    stats.node_cnt = len(hier_min)
    return BVH(
        box_min=np.stack(hier_min), box_max=np.stack(hier_max),
        buffer_region=np.stack(hier_region), order=indices, stats=stats)


# ---------------------------------------------------------------------------
# Scene-level flattening: SceneWrapper parity (SceneWrapper.cpp:10-46)
# ---------------------------------------------------------------------------

@dataclass
class BvhScene:
    """Concatenated per-mesh BVHs + reordered triangles + instance wrappers —
    the exact GPU buffer layout the reference binds (SURVEY C25).  Used by
    the traversal validation path (ops/bvh_traverse)."""

    box_min: np.ndarray          # (B,3)
    box_max: np.ndarray          # (B,3)
    buffer_region: np.ndarray    # (B,2) u32 mesh-local semantics as in shader
    tri_verts: np.ndarray        # (T,3,3) reordered, local space
    tri_uvs: np.ndarray          # (T,3,2) reordered
    mesh_bvh_root: np.ndarray    # (M,) u32  (MeshWrapper.bvhRoot)
    mesh_model_root: np.ndarray  # (M,) u32  (MeshWrapper.modelRoot)
    inst_world_to_local: np.ndarray  # (I,4,4) f32
    inst_mesh_id: np.ndarray     # (I,) i32
    inst_material_id: np.ndarray  # (I,) i32
    stats: list = field(default_factory=list)


def build_bvh_scene(scene) -> BvhScene:
    box_min, box_max, region = [], [], []
    tv, tu = [], []
    roots, model_roots = [], []
    stats = []
    box_off = tri_off = 0
    for mesh in scene.meshes:
        bvh = build_bvh(mesh)
        roots.append(box_off)
        model_roots.append(tri_off)
        box_off += bvh.num_nodes
        tri_off += mesh.num_triangles
        box_min.append(bvh.box_min)
        box_max.append(bvh.box_max)
        region.append(bvh.buffer_region)
        tv.append(mesh.verts[bvh.order])
        tu.append(mesh.uvs[bvh.order])
        stats.append(bvh.stats)

    def cat(parts, shape, dtype=np.float32):
        return np.concatenate(parts).astype(dtype) if parts else np.zeros(shape, dtype)

    return BvhScene(
        box_min=cat(box_min, (0, 3)), box_max=cat(box_max, (0, 3)),
        buffer_region=cat(region, (0, 2), np.uint32),
        tri_verts=cat(tv, (0, 3, 3)), tri_uvs=cat(tu, (0, 3, 2)),
        mesh_bvh_root=np.asarray(roots, np.uint32),
        mesh_model_root=np.asarray(model_roots, np.uint32),
        inst_world_to_local=np.stack([o.inv_model_matrix() for o in scene.objects]).astype(np.float32)
        if scene.objects else np.zeros((0, 4, 4), np.float32),
        inst_mesh_id=np.asarray([o.mesh_id for o in scene.objects], np.int32),
        inst_material_id=np.asarray([o.material_id for o in scene.objects], np.int32),
        stats=stats,
    )
