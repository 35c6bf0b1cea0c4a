"""Scene (de)serialization — save/load the full editable scene state.

The reference has no scene persistence: its editor state (materials, spheres,
meshes, instances — RayTracing/src/RayTracing.cpp:164-463) lives only in RAM
and is rebuilt from hardcoded loadScene cases on restart.  A headless
editor needs durable scenes, so this module defines the framework's scene
file format:

  <name>.rtm.json     human-editable description: materials / spheres /
                      instances / camera / render config, with meshes and
                      images referenced by key
  <name>.rtm.npz      binary sidecar: mesh vertex/uv arrays, texture and sky
                      images (keys referenced from the JSON)

Meshes loaded from a file keep their ``source`` path in the JSON for
provenance, but the triangle data is always embedded in the sidecar so a
saved scene is self-contained (the reference's assets may not exist on the
host that reloads it).

Field names/semantics mirror the host dataclasses 1:1 (models/material.py,
models/scene.py, models/mesh.py), which themselves mirror the reference
structs (Engine/src/Engine/Render/Scene.h:10-28, Mesh.h:61-78).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..config import RenderConfig
from ..models.camera import Camera
from ..models.material import Material
from ..models.mesh import Mesh, MeshInstance
from ..models.scene import Scene, SphereDef

FORMAT = "rtm-scene"
VERSION = 1


def _f3(x) -> list:
    return [float(v) for v in np.asarray(x).reshape(-1)[:3]]


def material_to_dict(m: Material) -> dict:
    return {
        "albedo": _f3(m.albedo),
        "emission_color": _f3(m.emission_color),
        "roughness": float(m.roughness),
        "metallic": float(m.metallic),
        "emission_power": float(m.emission_power),
        "refraction_ratio": float(m.refraction_ratio),
        "texture_id": int(m.texture_id),
    }


def material_from_dict(d: dict) -> Material:
    return Material(
        albedo=tuple(d.get("albedo", (1.0, 1.0, 1.0))),
        emission_color=tuple(d.get("emission_color", (1.0, 1.0, 1.0))),
        roughness=float(d.get("roughness", 0.0)),
        metallic=float(d.get("metallic", 0.0)),
        emission_power=float(d.get("emission_power", 0.0)),
        refraction_ratio=float(d.get("refraction_ratio", 1.0)),
        texture_id=int(d.get("texture_id", -1)),
    )


def sphere_to_dict(s: SphereDef) -> dict:
    return {"position": _f3(s.position), "radius": float(s.radius),
            "material_id": int(s.material_id)}


def sphere_from_dict(d: dict) -> SphereDef:
    return SphereDef(position=tuple(d["position"]),
                     radius=float(d["radius"]),
                     material_id=int(d.get("material_id", 0)))


def instance_to_dict(o: MeshInstance) -> dict:
    return {"mesh_id": int(o.mesh_id), "position": _f3(o.position),
            "scale": _f3(o.scale), "rotation": _f3(o.rotation),
            "material_id": int(o.material_id)}


def instance_from_dict(d: dict) -> MeshInstance:
    return MeshInstance(
        mesh_id=int(d["mesh_id"]),
        position=np.asarray(d.get("position", (0, 0, 0)), np.float64),
        scale=np.asarray(d.get("scale", (1, 1, 1)), np.float64),
        rotation=np.asarray(d.get("rotation", (0, 0, 0)), np.float64),
        material_id=int(d.get("material_id", 0)),
    )


def scene_to_dicts(scene: Scene) -> tuple[dict, dict]:
    """Returns (json_doc, arrays) where arrays maps sidecar keys to np
    arrays."""
    arrays: dict[str, np.ndarray] = {}
    meshes = []
    for i, mesh in enumerate(scene.meshes):
        arrays[f"mesh{i}_verts"] = np.asarray(mesh.verts, np.float32)
        arrays[f"mesh{i}_uvs"] = np.asarray(mesh.uvs, np.float32)
        meshes.append({"verts": f"mesh{i}_verts", "uvs": f"mesh{i}_uvs",
                       "source": getattr(mesh, "source", None)})
    textures = []
    for i, tex in enumerate(scene.textures):
        arrays[f"tex{i}"] = np.asarray(tex, np.float32)
        textures.append(f"tex{i}")
    sky = None
    if scene.sky is not None:
        arrays["sky"] = np.asarray(scene.sky, np.float32)
        sky = "sky"
    doc = {
        "format": FORMAT,
        "version": VERSION,
        "materials": [material_to_dict(m) for m in scene.materials],
        "spheres": [sphere_to_dict(s) for s in scene.spheres],
        "meshes": meshes,
        "objects": [instance_to_dict(o) for o in scene.objects],
        "textures": textures,
        "sky": sky,
    }
    return doc, arrays


def scene_from_dicts(doc: dict, arrays) -> Scene:
    if doc.get("format") != FORMAT:
        raise ValueError(f"not an rtm scene file: format={doc.get('format')}")
    scene = Scene()
    scene.materials = [material_from_dict(d) for d in doc.get("materials", [])]
    scene.spheres = [sphere_from_dict(d) for d in doc.get("spheres", [])]
    for md in doc.get("meshes", []):
        mesh = Mesh(np.asarray(arrays[md["verts"]], np.float32),
                    np.asarray(arrays[md["uvs"]], np.float32))
        if md.get("source"):
            mesh.source = md["source"]
        scene.meshes.append(mesh)
    scene.objects = [instance_from_dict(d) for d in doc.get("objects", [])]
    scene.textures = [np.asarray(arrays[k], np.float32)
                      for k in doc.get("textures", [])]
    if doc.get("sky") is not None:
        scene.sky = np.asarray(arrays[doc["sky"]], np.float32)
    return scene


def _paths(path) -> tuple[Path, Path]:
    p = Path(path)
    if p.name.endswith(".rtm.json"):
        base = p.name[: -len(".rtm.json")]
    else:
        base = p.stem
    return (p.parent / f"{base}.rtm.json", p.parent / f"{base}.rtm.npz")


def save_scene(path, scene: Scene, camera: Camera | None = None,
               cfg: RenderConfig | None = None) -> Path:
    """Write <path>.rtm.json + .rtm.npz. Returns the JSON path."""
    jpath, npath = _paths(path)
    doc, arrays = scene_to_dicts(scene)
    if camera is not None:
        doc["camera"] = {
            "position": _f3(camera.position),
            "direction": _f3(camera.direction),
            "fov": float(camera.fov),
            "focus_distance": float(camera.focus_distance),
            "defocus_strength": float(camera.defocus_strength),
            "blur_strength": float(camera.blur_strength),
        }
    if cfg is not None:
        doc["config"] = {
            "max_bounces": cfg.max_bounces, "max_frames": cfg.max_frames,
            "draw_environment": cfg.draw_environment,
            "accumulate": cfg.accumulate,
            "width": cfg.width, "height": cfg.height,
        }
    jpath.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(npath, **arrays)
    doc["sidecar"] = npath.name
    jpath.write_text(json.dumps(doc, indent=1))
    return jpath


def load_scene_file(path):
    """Load a saved scene. Returns (Scene, Camera|None, RenderConfig|None)."""
    jpath, npath = _paths(path)
    doc = json.loads(jpath.read_text())
    sidecar = jpath.parent / doc.get("sidecar", npath.name)
    arrays = np.load(sidecar) if sidecar.exists() else {}
    scene = scene_from_dicts(doc, arrays)
    camera = None
    if "camera" in doc:
        c = doc["camera"]
        camera = Camera(position=np.asarray(c["position"], np.float64),
                        direction=np.asarray(c["direction"], np.float64),
                        fov=float(c.get("fov", 45.0)))
        camera.focus_distance = float(c.get("focus_distance", 1.0))
        camera.defocus_strength = float(c.get("defocus_strength", 0.0))
        camera.blur_strength = float(c.get("blur_strength", 0.0))
    cfg = None
    if "config" in doc:
        k = doc["config"]
        cfg = RenderConfig(width=int(k.get("width", 1280)),
                           height=int(k.get("height", 720)),
                           max_bounces=int(k.get("max_bounces", 1)),
                           max_frames=int(k.get("max_frames", 1)),
                           draw_environment=bool(k.get("draw_environment",
                                                       False)),
                           accumulate=bool(k.get("accumulate", False)))
    return scene, camera, cfg
