"""Shared rig of the gradient tests: a small scene, its loss and a central
finite-difference check."""
import jax.numpy as jnp

from rtm_tpu import (Material, Mesh, MeshInstance, RenderConfig, Scene,
                     SphereDef, Triangle, build_tracer_scene)
from rtm_tpu.diff import render_loss
from rtm_tpu.models import scenes as builtin


def _scene():
    s = Scene(sky=builtin._procedural_sky())
    s.add_material(Material((0.7, 0.4, 0.2), (1, 1, 1), 0.3, 0.2, 0, 1.0, -1))
    s.add_material(Material((1, 1, 1), (0.9, 0.8, 0.7), 0, 0, 2.0, 1.0, -1))
    s.add_sphere(SphereDef((0, 0, -2.5), 1.0, 0))
    s.add_sphere(SphereDef((0, -101, -2), 100.0, 0))
    s.add_sphere(SphereDef((1.5, 2.0, -2.0), 0.8, 1))
    s.add_mesh(Mesh.from_triangles([
        Triangle((-2.5, -0.8, -4), (2.5, -0.8, -4), (0, 2.5, -4))]))
    s.add_object(MeshInstance(mesh_id=0, material_id=0))
    return build_tracer_scene(s)


CFG = RenderConfig(width=24, height=20, max_bounces=3, draw_environment=True)
FI = jnp.uint32(1)


def _loss_fn(ts, cam):
    target = jnp.zeros((CFG.height, CFG.width, 3), jnp.float32)

    def f(params):
        return render_loss(params, ts, cam, target, FI, CFG, remat=False)
    return f


def _fd_check(setup, get, set_, eps, tol):
    """Central finite difference along one scalar coordinate, against the
    autodiff gradient computed once for the whole module."""
    ts, cam, f, params, g = setup
    auto = float(get(g))
    p_plus = set_(params, get(params) + eps)
    p_minus = set_(params, get(params) - eps)
    fd = (float(f(p_plus)) - float(f(p_minus))) / (2 * eps)
    denom = max(abs(fd), abs(auto), 1e-8)
    rel = abs(auto - fd) / denom
    assert rel < tol, f"autodiff {auto} vs fd {fd} (rel {rel:.4f})"
    assert abs(auto) > 0, "gradient identically zero — parameter unused?"
