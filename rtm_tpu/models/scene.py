"""Scene model: host container + device-ready flattened pytree.

The host `Scene` mirrors ``RT::Scene`` + the client's sphere list (ref:
Engine/src/Engine/Render/Scene.h:23-28, RayTracing/src/SceneWrapper.h:33-53).
`build_tracer_scene` plays the role of the reference's SceneWrapper::build
(SceneWrapper.cpp:10-46): it flattens meshes+instances into global GPU-layout
arrays.  One difference: instead of shipping per-instance
world-to-local matrices and transforming rays per instance in the kernel
(shader:526-532), we pre-transform each instanced triangle to world space on
the host.  For an affine instance transform the ray-parameter t, the
barycentrics and the hit acceptance are identical to the reference's
local-space test (the reference does not re-normalize the transformed ray
direction, so its t is already in world units); this turns the per-instance
kernel loop into one dense SoA intersection sweep over all triangles.

Reference quirks preserved exactly:
  * Hit normals: the shader computes cross(B-A, C-A) on the *local* vertices
    and maps it through the model matrix — NOT the inverse transpose
    (shader:252-255).  We precompute that exact vector per world triangle.
  * Texture UV barycentrics: closestHit mixes the *world* ray with *local*
    vertices (shader:257-268) — a space-mixing reference bug.  We store local
    A and local edges so the device code reproduces it bit-for-bit.
  * Backface culling det > 0 (shader:301): preserved for instance transforms
    with positive determinant (all reference scenes; asserted at build).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .material import Material, Materials
from .mesh import Mesh, MeshInstance


@dataclass
class SphereDef:
    """Host sphere (ref SceneWrapper.h Sphere: position, radius, materialId)."""
    position: tuple
    radius: float
    material_id: int


@dataclass
class Scene:
    """Host-side scene graph (mutable; the editor-facing model)."""

    materials: list = field(default_factory=list)   # list[Material]
    meshes: list = field(default_factory=list)      # list[Mesh]
    objects: list = field(default_factory=list)     # list[MeshInstance]
    spheres: list = field(default_factory=list)     # list[SphereDef]
    textures: list = field(default_factory=list)    # list[np (H,W,3) f32 in [0,1]]
    sky: np.ndarray | None = None                   # (H,W,3) f32 or None

    # --- editor CRUD parity (ref RayTracing.cpp:164-463) -------------------
    def add_material(self, m: Material) -> int:
        self.materials.append(m)
        return len(self.materials) - 1

    def add_sphere(self, s: SphereDef) -> int:
        self.spheres.append(s)
        return len(self.spheres) - 1

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_object(self, inst: MeshInstance) -> int:
        self.objects.append(inst)
        return len(self.objects) - 1

    def remove_sphere(self, i: int) -> None:
        del self.spheres[i]

    def remove_object(self, i: int) -> None:
        del self.objects[i]


@jax.tree_util.register_dataclass
@dataclass
class TracerScene:
    """Flattened, device-ready scene pytree (all leaves jnp arrays; all
    shapes static).  This is the analog of the reference's bound GPU buffer
    set (RayTracing.cpp:895-909), minus std140 padding."""

    materials: Materials

    sph_pos: jax.Array      # (S,3) f32
    sph_radius: jax.Array   # (S,)  f32
    sph_mat: jax.Array      # (S,)  i32

    tri_wa: jax.Array       # (T,3) f32 world-space vertex A
    tri_wb: jax.Array       # (T,3)
    tri_wc: jax.Array       # (T,3)
    tri_la: jax.Array       # (T,3) local-space A      (UV parity path)
    tri_lab: jax.Array      # (T,3) local edge B-A
    tri_lac: jax.Array      # (T,3) local edge C-A
    tri_normal: jax.Array   # (T,3) normalized shader-normal
    tri_uv: jax.Array       # (T,3,2)
    tri_mat: jax.Array      # (T,)  i32
    # (T,3,4) world->local affine rows of each triangle's instance
    # transform: local = rows[:, :3] @ world + rows[:, 3].  Lets vertex
    # optimization (diff/params.apply_params) recompute the local-space
    # UV-quirk arrays for ANY instance transform, not just identity.
    tri_inv_model: jax.Array

    sky: jax.Array          # (Hs,Ws,3) f32 equirect map (ClampToEdge/Linear)
    textures: jax.Array     # (K,TH,TW,3) f32 padded stack (Repeat/Linear)
    tex_size: jax.Array     # (K,2) i32 actual (H,W) per texture
    # quad-packed bilinear tables (ops/shade.py build_quad_flat): one row per
    # texel holding the 2x2 footprint, so a bilinear tap is one gather
    # instead of four (identical arithmetic to the 4-tap sample_bilinear).
    # Lanes that don't consume a sample are masked onto row 0 by every
    # caller.
    sky_quads: jax.Array    # (Hs*Ws, 4) i32 packed / (.., 12) f32 fallback
    tex_quads: jax.Array    # (K*TH*TW, 4) i32 packed / (.., 12) f32

    # environment model: False = equirect sky map (shader:216-218); True =
    # the legacy kernel's procedural sun/sky (OldRayTracing.shader:119-136,
    # ops/shade.py procedural_sun_sky) — C28 parity option
    env_sun: bool = field(default=False, metadata=dict(static=True))

    @property
    def num_spheres(self) -> int:
        return self.sph_pos.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_wa.shape[0]

    @property
    def num_textures(self) -> int:
        return self.textures.shape[0]


def _stack_textures(textures: list[np.ndarray]):
    from ..ops.shade import build_quad_flat, quad_exact_u8

    if not textures:
        return (jnp.zeros((1, 1, 1, 3), jnp.float32),
                jnp.ones((1, 2), jnp.int32),
                jnp.zeros((1, 4), jnp.int32))
    th = max(t.shape[0] for t in textures)
    tw = max(t.shape[1] for t in textures)
    # i32-packed quad rows (16B) halve the latency-bound random-row tap
    # cost vs f32x12 (48B) and are EXACT for u8-sourced texels (every
    # loader path); arbitrary float textures fall back to f32 rows
    packed = all(quad_exact_u8(t[..., :3]) for t in textures)
    qdtype = jnp.int32 if packed else jnp.float32
    qw = 4 if packed else 12
    stack = np.zeros((len(textures), th, tw, 3), np.float32)
    sizes = np.zeros((len(textures), 2), np.int32)
    quads = jnp.zeros((len(textures), th * tw, qw), qdtype)
    for i, t in enumerate(textures):
        h, w = t.shape[0], t.shape[1]
        stack[i, :h, :w] = t[..., :3]
        sizes[i] = (h, w)
        # per-texture quad table at TRUE extent (repeat wrap baked), placed
        # into the padded row layout so base + y*TW + x indexes it
        q = build_quad_flat(t[..., :3], wrap="repeat",
                            dtype=qdtype).reshape(h, w, qw)
        quads = quads.at[i].set(
            jnp.pad(q, ((0, th - h), (0, tw - w), (0, 0))).reshape(-1, qw))
    return (jnp.asarray(stack), jnp.asarray(sizes),
            quads.reshape(len(textures) * th * tw, qw))


def build_tracer_scene(scene: Scene, env_model: str = "map") -> TracerScene:
    """Flatten the host scene into the device layout (SceneWrapper parity).

    Triangles keep the reference's buffer order (instances in order, each
    mesh's triangles in order), so exact distance ties resolve as in the
    reference's traversal.
    """
    mats = Materials.from_list(scene.materials)

    if scene.spheres:
        sph_pos = np.array([s.position for s in scene.spheres], np.float32)
        sph_radius = np.array([s.radius for s in scene.spheres], np.float32)
        sph_mat = np.array([s.material_id for s in scene.spheres], np.int32)
    else:
        sph_pos = np.zeros((0, 3), np.float32)
        sph_radius = np.zeros((0,), np.float32)
        sph_mat = np.zeros((0,), np.int32)

    wa, wb, wc, la, lab, lac, nrm, uv, mat = [], [], [], [], [], [], [], [], []
    invm = []
    for inst in scene.objects:
        mesh = scene.meshes[inst.mesh_id]
        m = inst.model_matrix()
        if np.linalg.det(m[:3, :3]) <= 0:
            raise ValueError(
                "instance transform with non-positive determinant would flip "
                "the reference's backface culling; not supported")
        v = mesh.verts.astype(np.float64)            # (T,3,3) local
        world = v @ m[:3, :3].T + m[:3, 3]           # (T,3,3)
        w2l = np.linalg.inv(m.astype(np.float64))[:3, :4]   # world->local
        invm.append(np.broadcast_to(w2l, (mesh.num_triangles, 3, 4)))
        e_ab = v[:, 1] - v[:, 0]
        e_ac = v[:, 2] - v[:, 0]
        n_local = np.cross(e_ab, e_ac)
        n_shader = n_local @ m[:3, :3].T             # model matrix, NOT inv-transpose
        norm = np.linalg.norm(n_shader, axis=-1, keepdims=True)
        n_shader = n_shader / np.maximum(norm, 1e-30)
        wa.append(world[:, 0]); wb.append(world[:, 1]); wc.append(world[:, 2])
        la.append(v[:, 0]); lab.append(e_ab); lac.append(e_ac)
        nrm.append(n_shader)
        uv.append(mesh.uvs)
        mat.append(np.full(mesh.num_triangles, inst.material_id, np.int32))

    def cat(parts, shape):
        if parts:
            return np.concatenate(parts).astype(np.float32)
        return np.zeros(shape, np.float32)

    tri_wa = cat(wa, (0, 3)); tri_wb = cat(wb, (0, 3)); tri_wc = cat(wc, (0, 3))
    tri_la = cat(la, (0, 3)); tri_lab = cat(lab, (0, 3)); tri_lac = cat(lac, (0, 3))
    tri_normal = cat(nrm, (0, 3))
    tri_uv = np.concatenate(uv).astype(np.float32) if uv else np.zeros((0, 3, 2), np.float32)
    tri_mat = np.concatenate(mat) if mat else np.zeros((0,), np.int32)
    tri_inv_model = cat(invm, (0, 3, 4))

    sky = scene.sky if scene.sky is not None else np.zeros((1, 1, 3), np.float32)
    textures, tex_size, tex_quads = _stack_textures(scene.textures)

    from ..ops.shade import build_quad_flat, quad_exact_u8
    sky_np = np.asarray(sky, np.float32)
    sky_quads = build_quad_flat(
        sky_np, wrap="clamp",
        dtype=jnp.int32 if quad_exact_u8(sky_np) else jnp.float32)

    return TracerScene(
        materials=mats,
        sph_pos=jnp.asarray(sph_pos), sph_radius=jnp.asarray(sph_radius),
        sph_mat=jnp.asarray(sph_mat),
        tri_wa=jnp.asarray(tri_wa), tri_wb=jnp.asarray(tri_wb),
        tri_wc=jnp.asarray(tri_wc),
        tri_la=jnp.asarray(tri_la), tri_lab=jnp.asarray(tri_lab),
        tri_lac=jnp.asarray(tri_lac),
        tri_normal=jnp.asarray(tri_normal),
        tri_uv=jnp.asarray(tri_uv), tri_mat=jnp.asarray(tri_mat),
        tri_inv_model=jnp.asarray(tri_inv_model),
        sky=jnp.asarray(sky, jnp.float32),
        textures=textures, tex_size=tex_size,
        sky_quads=sky_quads, tex_quads=tex_quads,
        env_sun=(env_model == "sun"),
    )
