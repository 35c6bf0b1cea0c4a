"""The built-in scenes, 1:1 with the reference's loadScene
(RayTracing/src/RayTracing.cpp:634-832):

  1 — sphere Cornell box: six giant spheres forming walls + sphere light;
  2 — three spheres (glass, textured, emissive) over a 100x100 two-triangle
      ground plane with a grid texture;
  3 — Cornell box: triangle walls + area light + the tiny Stanford dragon
      (scale 5, rotated 128 deg) with a checkered floor texture;
  4 — dev platform: the dragon alone;
  5 — empty scene (the combo's case 5 hits the switch default).

Every scene gets the evening_road sky map when assets are present
(RayTracing.cpp:843); otherwise a procedural stand-in is used so tests run
hermetically.  Material ctor order matches the reference aggregate init.
"""
from __future__ import annotations

import numpy as np

from ..io.assets import asset_path
from ..io.image import load_hdr_ldr, load_texture
from .material import Material
from .mesh import Mesh, MeshInstance, Triangle
from .scene import Scene, SphereDef


def _procedural_sky(h: int = 64, w: int = 128) -> np.ndarray:
    """Stand-in equirect sky (smooth horizon gradient), 8-bit quantized like
    the reference's LDR-loaded sky map."""
    v = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    sky = np.zeros((h, w, 3), np.float32)
    sky[..., 0] = 0.6 + 0.4 * v
    sky[..., 1] = 0.7 + 0.2 * v
    sky[..., 2] = 0.9 + 0.1 * v
    return np.round(np.clip(sky, 0, 1) * 255.0) / np.float32(255.0)


def _procedural_checker(n: int = 64) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    c = ((xx // 8 + yy // 8) % 2).astype(np.float32)
    t = np.stack([c, c, c], axis=-1) * 0.9 + 0.05
    # 8-bit quantized like every file-loaded texture (u8 quad-table parity)
    return np.round(t * 255.0) / np.float32(255.0)


def load_sky() -> np.ndarray:
    p = asset_path("skyMaps", "evening_road_01_puresky_1k.hdr")
    return load_hdr_ldr(p) if p is not None else _procedural_sky()


def _load_tex(*parts) -> np.ndarray:
    p = asset_path(*parts)
    return load_texture(p) if p is not None else _procedural_checker()


def _dragon_mesh() -> Mesh:
    p = asset_path("models", "tinyStanfordDragon.glb")
    if p is not None:
        return Mesh.load(p)
    # fallback: an icosahedron stand-in so scene 3/4 stay loadable
    phi = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
                  [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
                  [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
                 np.float32) * 0.1
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    return Mesh(v[f], None)


def scene_1() -> Scene:
    """Sphere-walled box + big sphere light (RayTracing.cpp:638-657)."""
    s = Scene(sky=load_sky())
    s.add_material(Material((1, 1, 1), (1, 1, 1), 0, 0, 0, 1.0, -1))
    s.add_material(Material((0, 0, 1), (1, 1, 1), 0, 0, 0, 1.0, -1))
    s.add_material(Material((1, 0, 0), (1, 1, 1), 0, 0, 0, 1.0, -1))
    s.add_sphere(SphereDef((0.0, 0.0, -10007.0), 10000.0, 0))
    s.add_sphere(SphereDef((0.0, 0.0, 10003.0), 10000.0, 0))
    s.add_sphere(SphereDef((0.0, -10001.0, -2.0), 10000.0, 0))
    s.add_sphere(SphereDef((0.0, 10009.0, -2.0), 10000.0, 0))
    s.add_sphere(SphereDef((-10005.0, 0.0, -2.0), 10000.0, 1))
    s.add_sphere(SphereDef((10005.0, 0.0, -2.0), 10000.0, 2))
    s.add_material(Material((1, 1, 1), (1, 1, 1), 0, 0, 1.0, 1.0, -1))
    s.add_sphere(SphereDef((0.0, 18.8, -2.0), 10.0, 3))
    return s


def scene_2() -> Scene:
    """Spheres + textured ground plane (RayTracing.cpp:660-699)."""
    s = Scene(sky=load_sky())
    s.textures.append(_load_tex("textures", "templategrid_albedo.png"))
    s.add_material(Material((1, 1, 1), (1, 1, 1), 0.7, 0, 0, 1.5, -1))
    s.add_material(Material((0.2, 0.5, 0.7), (0.2, 0.5, 0.7), 0, 0, 0, 1.0, 0))
    s.add_material(Material((0.8, 0.6, 0.5), (0.8, 0.6, 0.5), 0, 0, 1.0, 1.0, -1))
    s.add_material(Material((0.4, 0.3, 0.8), (0.8, 0.6, 0.5), 0, 0, 0, 1.0, -1))
    s.add_sphere(SphereDef((0.0, 0.0, -2.0), 1.0, 0))
    ground = Mesh.from_triangles([
        Triangle((-50, -1, -50), (-50, -1, 50), (50, -1, -50),
                 (0, 0), (0, 10), (10, 0)),
        Triangle((50, -1, 50), (50, -1, -50), (-50, -1, 50),
                 (10, 10), (10, 0), (0, 10)),
    ])
    s.add_mesh(ground)
    s.add_object(MeshInstance(mesh_id=0, material_id=1))
    s.add_sphere(SphereDef((2.5, 0.0, -2.0), 1.0, 2))
    s.add_sphere(SphereDef((-2.5, 0.0, -2.0), 1.0, 3))
    return s


def scene_3() -> Scene:
    """Cornell box + dragon (RayTracing.cpp:702-806). Default scene."""
    s = Scene(sky=load_sky())
    s.textures.append(_load_tex("textures", "checkered.jpg"))
    s.add_material(Material((1, 1, 1), (1, 1, 1), 0, 0, 0, 1.0, -1))
    s.add_material(Material((1, 1, 1), (1, 1, 1), 0, 0, 0, 1.0, 0))
    s.add_material(Material((1, 1, 1), (1, 1, 1), 0, 0, 0, 1.0, -1))
    s.add_material(Material((1, 0, 0), (1, 1, 1), 0, 0, 0, 1.0, -1))
    s.add_material(Material((0, 1, 0), (1, 1, 1), 0, 0, 0, 1.0, -1))
    s.add_material(Material((1, 1, 1), (1, 1, 1), 0, 0, 8.0, 1.0, -1))

    s.add_mesh(_dragon_mesh())
    s.add_object(MeshInstance(mesh_id=0, position=np.array([0.0, 1.4, -2.0]),
                              scale=np.array([5.0, 5.0, 5.0]),
                              rotation=np.array([0.0, 128.0, 0.0]),
                              material_id=0))

    bottom = [Triangle((3, 0, 1), (3, 0, -5), (-3, 0, 1), (0, 0), (0, 1), (1, 0)),
              Triangle((-3, 0, -5), (-3, 0, 1), (3, 0, -5), (1, 1), (1, 0), (0, 1))]
    top = [Triangle((3, 6, -5), (3, 6, 1), (-3, 6, -5)),
           Triangle((-3, 6, -5), (3, 6, 1), (-3, 6, 1))]
    back = [Triangle((3, 0, -5), (3, 6, -5), (-3, 0, -5)),
            Triangle((-3, 0, -5), (3, 6, -5), (-3, 6, -5))]
    front = [Triangle((3, 6, 1), (3, 0, 1), (-3, 0, 1)),
             Triangle((3, 6, 1), (-3, 0, 1), (-3, 6, 1))]
    left = [Triangle((3, 0, -5), (3, 0, 1), (3, 6, -5)),
            Triangle((3, 0, 1), (3, 6, 1), (3, 6, -5))]
    right = [Triangle((-3, 0, -5), (-3, 6, -5), (-3, 0, 1)),
             Triangle((-3, 0, 1), (-3, 6, -5), (-3, 6, 1))]
    light = [Triangle((1, 5.9, -3), (1, 5.9, -1), (-1, 5.9, -3)),
             Triangle((-1, 5.9, -3), (1, 5.9, -1), (-1, 5.9, -1))]

    mats = [1, 2, 2, 2, 3, 4, 5]
    for tris, mat in zip([bottom, top, back, front, left, right, light], mats):
        mesh_id = s.add_mesh(Mesh.from_triangles(tris))
        s.add_object(MeshInstance(mesh_id=mesh_id, material_id=mat))
    return s


def scene_4() -> Scene:
    """Dev platform: dragon only (RayTracing.cpp:809-820)."""
    s = Scene(sky=load_sky())
    s.add_material(Material((1, 1, 1), (1, 1, 1), 0, 0, 0, 1.0, -1))
    s.add_mesh(_dragon_mesh())
    s.add_object(MeshInstance(mesh_id=0))
    return s


def scene_5() -> Scene:
    """Empty scene (combo case 5 falls through the switch)."""
    return Scene(sky=load_sky())


SCENES = {1: scene_1, 2: scene_2, 3: scene_3, 4: scene_4, 5: scene_5}


def load_scene(n: int) -> Scene:
    return SCENES[n]()


def dragon_grid(k: int = 6) -> Scene:
    """A k x k grid of instanced Stanford dragons over the procedural sky —
    the large-scene surface where an O(T) sweep meets an O(log T)
    traversal.  ~1742 world-baked triangles per instance with the
    reference's dragon asset (k=6 ~ 62.7k tris); 20 per instance with the
    built-in icosahedron stand-in.
    Instances reuse one mesh (the loaders dedupe), so build cost is the
    world bake, not IO."""
    s = Scene(sky=load_sky())
    s.add_material(Material((0.9, 0.9, 0.9), (1, 1, 1), 0.0, 0.0, 0,
                            1.0, -1))
    s.add_material(Material((1, 1, 1), (1.0, 0.9, 0.8), 0, 0, 3.0,
                            1.0, -1))
    s.add_mesh(_dragon_mesh())
    for i in range(k):
        for j in range(k):
            s.add_object(MeshInstance(
                mesh_id=0, material_id=0,
                position=np.array([2.5 * (i - (k - 1) / 2), 0.0,
                                   -4.0 - 2.5 * j]),
                scale=np.array([5.0, 5.0, 5.0]),
                rotation=np.array([0.0, 30.0 * (i + j), 0.0])))
    # one emissive marker sphere so multi-bounce light paths terminate
    # on scene geometry, not only the sky
    s.add_sphere(SphereDef((0.0, 6.0, -7.0), 1.5, 1))
    return s
