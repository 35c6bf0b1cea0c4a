"""Triton sweep kernel tests (Pallas interpreter on the CPU).

The kernel must pick the same triangle as the XLA chunked sweep (same
features, same acceptance test, first minimum in buffer order), for ray and
triangle counts on and off the kernel's block and tile edges, and render the
same images.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from rtm_tpu.ops.intersect import FLT_MAX, TriFeatures, nearest_triangle
from rtm_tpu.ops.pallas.intersect_kernel import (RAY_BLOCK, TRI_TILE,
                                                 nearest_triangle_triton,
                                                 pack_triangle_features)


def _random_tris(n, seed=0, spread=4.0):
    rs = np.random.RandomState(seed)
    a = (rs.rand(n, 3).astype(np.float32) - 0.5) * spread
    b = a + rs.randn(n, 3).astype(np.float32) * 0.5
    c = a + rs.randn(n, 3).astype(np.float32) * 0.5
    return jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)


def _random_rays(n, seed=1):
    rs = np.random.RandomState(seed)
    o = rs.randn(n, 3).astype(np.float32) * 3
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _xla(o, d, a, b, c):
    return nearest_triangle(o, d, TriFeatures.build(a, b, c))


# rays: one past a block, and two blocks plus two; triangles: one, one past
# a tile, a partial tile, and whole tiles
@pytest.mark.parametrize("nrays", [RAY_BLOCK + 1, 2 * RAY_BLOCK + 2])
@pytest.mark.parametrize("ntris", [1, TRI_TILE + 1, 100, 8 * TRI_TILE])
def test_matches_xla_sweep(nrays, ntris):
    a, b, c = _random_tris(ntris)
    o, d = _random_rays(nrays)
    t_p, i_p = nearest_triangle_triton(o, d, a, b, c, interpret=True)
    t_x, i_x = _xla(o, d, a, b, c)
    np.testing.assert_array_equal(np.asarray(i_p), np.asarray(i_x))
    hit = np.asarray(i_x) >= 0
    np.testing.assert_allclose(np.asarray(t_p)[hit], np.asarray(t_x)[hit],
                               rtol=1e-5, atol=1e-6)


def test_ray_padding_is_inert():
    """N not divisible by RAY_BLOCK: the filler rays must not affect real
    outputs."""
    a, b, c = _random_tris(64)
    o, d = _random_rays(77)
    _, i_p = nearest_triangle_triton(o, d, a, b, c, interpret=True)
    _, i_x = _xla(o, d, a, b, c)
    assert i_p.shape == (77,)
    np.testing.assert_array_equal(np.asarray(i_p), np.asarray(i_x))


def test_pack_features_padding_degenerate():
    a, b, c = _random_tris(100)
    feats = pack_triangle_features(a, b, c)
    assert feats.shape == (16, -(-100 // TRI_TILE) * TRI_TILE)
    # padded triangle normals are zero -> can never pass det > eps
    np.testing.assert_array_equal(np.asarray(feats[0:3, 100:]), 0.0)
    np.testing.assert_allclose(
        np.asarray(feats[0:3, :100]).T,
        np.cross(np.asarray(b - a), np.asarray(c - a)), rtol=1e-5,
        atol=1e-6)


def test_zero_triangles_all_miss():
    o, d = _random_rays(40)
    empty = jnp.zeros((0, 3), jnp.float32)
    t, i = nearest_triangle_triton(o, d, empty, empty, empty, interpret=True)
    np.testing.assert_array_equal(np.asarray(i), -1)
    np.testing.assert_array_equal(np.asarray(t), FLT_MAX)


def test_all_rays_miss():
    """Every ray points away from every triangle: idx -1, t FLT_MAX."""
    a, b, c = _random_tris(50)
    a, b, c = a - 100.0, b - 100.0, c - 100.0       # all far along -x,-y,-z
    n = 70
    o = jnp.zeros((n, 3), jnp.float32)
    d = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32), (n, 1))
    t, i = nearest_triangle_triton(o, d, a, b, c, interpret=True)
    np.testing.assert_array_equal(np.asarray(i), -1)
    np.testing.assert_array_equal(np.asarray(t), FLT_MAX)


@pytest.mark.parametrize("first", [0, 5, 40])
def test_exact_tie_first_minimum_wins(first):
    """Coincident triangles at the same distance: the lowest buffer index
    wins, inside a tile and across tiles (TRI_TILE = 32)."""
    assert TRI_TILE == 32
    a, b, c = _random_tris(64, seed=3)
    a, b, c = a + 50.0, b + 50.0, c + 50.0          # out of the way
    tri = (jnp.asarray([-1.0, -1.0, -5.0]), jnp.asarray([1.0, -1.0, -5.0]),
           jnp.asarray([0.0, 1.0, -5.0]))
    for k in (first, first + 3, 60):
        a, b, c = a.at[k].set(tri[0]), b.at[k].set(tri[1]), c.at[k].set(tri[2])
    o, _ = _random_rays(33, seed=4)
    o = o * 0.01
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), (33, 1))
    t, i = nearest_triangle_triton(o, d, a, b, c, interpret=True)
    _, i_x = _xla(o, d, a, b, c)
    np.testing.assert_array_equal(np.asarray(i), first)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_x))
    np.testing.assert_allclose(np.asarray(t), 5.0 + np.asarray(o[:, 2]),
                               rtol=1e-5)


def test_backfaces_are_culled():
    """A triangle seen from behind (det <= 0) is never hit (shader:301); the
    same triangle with its winding flipped is."""
    a = jnp.asarray([[-1.0, -1.0, -5.0]])
    b = jnp.asarray([[1.0, -1.0, -5.0]])
    c = jnp.asarray([[0.0, 1.0, -5.0]])
    o = jnp.zeros((8, 3), jnp.float32)
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), (8, 1))
    _, front = nearest_triangle_triton(o, d, a, b, c, interpret=True)
    _, back = nearest_triangle_triton(o, d, a, c, b, interpret=True)
    np.testing.assert_array_equal(np.asarray(front), 0)
    np.testing.assert_array_equal(np.asarray(back), -1)


def test_render_dispatch_triton_backend(image_compare):
    """Full render through the Triton sweep == the XLA sweep."""
    from rtm_tpu import (Camera, Material, Mesh, MeshInstance, RenderConfig,
                         Scene, SphereDef, Triangle, build_tracer_scene,
                         render_dispatch)
    from rtm_tpu.models import scenes as builtin

    s = Scene(sky=builtin._procedural_sky())
    s.add_material(Material((0.8, 0.4, 0.2), (1, 1, 1), 0, 0, 0, 1.0, -1))
    s.add_material(Material((1, 1, 1), (1, 1, 1), 0, 0, 2.0, 1.0, -1))
    s.add_sphere(SphereDef((0, 0, -2), 1.0, 0))
    s.add_mesh(Mesh.from_triangles([
        Triangle((-3, -0.5, -4), (3, -0.5, -4), (0, 3, -4)),
        Triangle((-4, -1, -6), (4, -1, -6), (0, -1, 2)),
    ]))
    s.add_object(MeshInstance(mesh_id=0, material_id=1))
    ts = build_tracer_scene(s)
    cfg = RenderConfig(width=32, height=24, max_bounces=3, draw_environment=True)
    cam = Camera().spec(cfg.width, cfg.height)
    img_x = np.asarray(render_dispatch(ts, cam, jnp.uint32(1), cfg, backend="xla"))
    img_p = np.asarray(render_dispatch(ts, cam, jnp.uint32(1), cfg,
                                       backend="triton_interpret"))
    image_compare(img_p, img_x, tol=1e-3, frac_bad=0.01, mean_tol=1e-3)


@pytest.mark.parametrize("sid", [1, 2, 3, 4, 5])
def test_builtin_scene_triton_matches_oracle(image_compare, sid):
    """The built-in scenes through the Triton sweep against the NumPy
    oracle."""
    from rtm_tpu import (Camera, RenderConfig, build_tracer_scene,
                         load_scene, render_dispatch)
    cfg = RenderConfig(width=16, height=12, max_bounces=3,
                       draw_environment=True)
    ts = build_tracer_scene(load_scene(sid))
    cam = Camera().spec(cfg.width, cfg.height)
    got = np.asarray(render_dispatch(ts, cam, jnp.uint32(1), cfg,
                                     backend="triton_interpret"))
    image_compare(got, oracle.render_oracle(ts, cam, cfg, 1))
