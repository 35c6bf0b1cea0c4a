"""End-to-end render tests: framework renderer vs the shader-literal oracle."""
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from rtm_tpu import (Camera, Material, Mesh, MeshInstance, ProgressiveRenderer,
                     RenderConfig, Scene, SphereDef, Triangle,
                     build_tracer_scene, render_dispatch)
from rtm_tpu.models import scenes as builtin
from rtm_tpu.runtime.renderer import accumulate_step


def _mini_sphere_scene():
    s = Scene(sky=builtin._procedural_sky())
    s.add_material(Material((0.8, 0.4, 0.2), (1, 1, 1), 0, 0, 0, 1.0, -1))
    s.add_material(Material((1, 1, 1), (1, 1, 1), 0, 0, 2.0, 1.0, -1))
    s.add_sphere(SphereDef((0, 0, -2), 1.0, 0))
    s.add_sphere(SphereDef((0, -101, -2), 100.0, 0))
    s.add_sphere(SphereDef((2, 2, -1), 1.0, 1))
    return s


def _mini_mesh_scene():
    s = _mini_sphere_scene()
    s.add_mesh(Mesh.from_triangles([
        Triangle((-3, -0.5, -4), (3, -0.5, -4), (0, 3, -4)),
    ]))
    s.add_object(MeshInstance(mesh_id=0, material_id=0,
                              position=np.array([0.5, 0.0, 0.0]),
                              scale=np.array([1.0, 1.0, 1.0]),
                              rotation=np.array([0.0, 15.0, 0.0])))
    return s


@pytest.mark.parametrize("bounces,frames", [(1, 1), (4, 1), (3, 2)])
def test_spheres_match_oracle(image_compare, bounces, frames):
    cfg = RenderConfig(width=48, height=32, max_bounces=bounces,
                       max_frames=frames, draw_environment=True)
    ts = build_tracer_scene(_mini_sphere_scene())
    cam = Camera().spec(cfg.width, cfg.height)
    got = np.asarray(render_dispatch(ts, cam, jnp.uint32(1), cfg))
    want = oracle.render_oracle(ts, cam, cfg, 1)
    image_compare(got, want)


def test_meshes_match_oracle(image_compare):
    cfg = RenderConfig(width=48, height=32, max_bounces=4, max_frames=1,
                       draw_environment=True)
    ts = build_tracer_scene(_mini_mesh_scene())
    cam = Camera().spec(cfg.width, cfg.height)
    got = np.asarray(render_dispatch(ts, cam, jnp.uint32(1), cfg))
    want = oracle.render_oracle(ts, cam, cfg, 1)
    image_compare(got, want)


def test_dielectric_and_texture_match_oracle(image_compare):
    s = Scene(sky=builtin._procedural_sky())
    s.textures.append(builtin._procedural_checker())
    s.add_material(Material((1, 1, 1), (1, 1, 1), 0.7, 0, 0, 1.5, -1))   # glass
    s.add_material(Material((0.2, 0.5, 0.7), (0.2, 0.5, 0.7), 0, 0, 0, 1.0, 0))
    s.add_sphere(SphereDef((0, 0, -2), 1.0, 0))
    s.add_sphere(SphereDef((0, -101, -2), 100.0, 1))
    cfg = RenderConfig(width=48, height=32, max_bounces=5, max_frames=1,
                       draw_environment=True)
    ts = build_tracer_scene(s)
    cam = Camera().spec(cfg.width, cfg.height)
    got = np.asarray(render_dispatch(ts, cam, jnp.uint32(1), cfg))
    want = oracle.render_oracle(ts, cam, cfg, 1)
    image_compare(got, want)


def test_flat_shade_mode():
    """MaxBounces==1 preview (shader:566-571): no RNG influence, flat
    albedo * lighting ramp."""
    cfg = RenderConfig(width=32, height=24, max_bounces=1)
    ts = build_tracer_scene(_mini_sphere_scene())
    cam = Camera().spec(cfg.width, cfg.height)
    a = np.asarray(render_dispatch(ts, cam, jnp.uint32(1), cfg))
    b = np.asarray(render_dispatch(ts, cam, jnp.uint32(99), cfg))
    np.testing.assert_array_equal(a, b)  # frameIndex only affects seeds
    assert np.isfinite(a).all()
    assert a.max() > 0


def test_seed_dependence():
    """Different frame_index -> different noise (progressive sampling)."""
    cfg = RenderConfig(width=32, height=24, max_bounces=4, draw_environment=True)
    ts = build_tracer_scene(_mini_sphere_scene())
    cam = Camera().spec(cfg.width, cfg.height)
    a = np.asarray(render_dispatch(ts, cam, jnp.uint32(1), cfg))
    b = np.asarray(render_dispatch(ts, cam, jnp.uint32(2), cfg))
    assert not np.array_equal(a, b)


def test_accumulation_semantics():
    """shader:711-721: accum is a running sum, display = accum / frameIndex."""
    cfg = RenderConfig(width=16, height=16, max_bounces=3, accumulate=True,
                       draw_environment=True)
    ts = build_tracer_scene(_mini_sphere_scene())
    cam = Camera().spec(cfg.width, cfg.height)
    accum = jnp.zeros((16, 16, 3), jnp.float32)
    frames = []
    for fi in (1, 2, 3):
        frame = render_dispatch(ts, cam, jnp.uint32(fi), cfg)
        frames.append(np.asarray(frame))
        accum, out = accumulate_step(ts, cam, accum, np.uint32(fi), cfg)
    np.testing.assert_allclose(np.asarray(accum), np.sum(frames, axis=0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out), np.sum(frames, axis=0) / 3.0,
                               rtol=1e-5, atol=1e-5)


def test_progressive_renderer_driver():
    s = _mini_sphere_scene()
    cfg = RenderConfig(width=16, height=16, max_bounces=3, accumulate=True,
                       draw_environment=True)
    r = ProgressiveRenderer(s, Camera(), cfg)
    r.step()
    out3 = r.render(frames=2)
    assert r.frame_index == 3
    assert np.isfinite(np.asarray(out3)).all()
    r.reset()
    assert r.frame_index == 0


def test_progressive_converges_vs_variance():
    """More accumulated frames -> lower inter-frame variance (progressive
    refinement actually averages)."""
    s = _mini_sphere_scene()
    cfg = RenderConfig(width=24, height=24, max_bounces=4, accumulate=True,
                       draw_environment=True)
    r = ProgressiveRenderer(s, Camera(), cfg)
    out1 = np.asarray(r.step())
    out2 = np.asarray(r.step())
    early_change = np.abs(out2 - out1).mean()
    for _ in range(14):
        prev = np.asarray(r.step())
    late = np.asarray(r.step())
    late_change = np.abs(late - prev).mean()
    # display changes shrink ~1/n as accumulation deepens
    assert late_change < 0.5 * early_change + 1e-9, (late_change, early_change)


def test_empty_scene_renders_sky():
    s = Scene(sky=builtin._procedural_sky())
    cfg = RenderConfig(width=16, height=12, max_bounces=3, draw_environment=True)
    ts = build_tracer_scene(s)
    cam = Camera().spec(cfg.width, cfg.height)
    img = np.asarray(render_dispatch(ts, cam, jnp.uint32(1), cfg))
    assert np.isfinite(img).all()
    assert img.min() > 0.1  # sky everywhere


def test_draw_environment_off_is_black_on_miss():
    s = Scene(sky=builtin._procedural_sky())
    cfg = RenderConfig(width=8, height=8, max_bounces=3, draw_environment=False)
    ts = build_tracer_scene(s)
    cam = Camera().spec(cfg.width, cfg.height)
    img = np.asarray(render_dispatch(ts, cam, jnp.uint32(1), cfg))
    np.testing.assert_array_equal(img, 0.0)


def test_procedural_sun_sky_env():
    """C28 parity: the legacy kernel's procedural sun/sky
    (OldRayTracing.shader:119-136) as a selectable env model."""
    import numpy as np

    from rtm_tpu.ops.shade import SUN_DIR, procedural_sun_sky

    # straight up: zenith color (skyLerp saturates, no sun term off-axis)
    up = jnp.array([[0.0, 1.0, 0.0]], jnp.float32)
    assert np.allclose(np.asarray(procedural_sun_sky(up))[0],
                       [0.5, 0.7, 1.0], atol=1e-5)
    # straight down: ground color
    down = jnp.array([[0.0, -1.0, 0.0]], jnp.float32)
    assert np.allclose(np.asarray(procedural_sun_sky(down))[0],
                       [0.3, 0.3, 0.3], atol=1e-6)
    # horizon (y=0): groundToSky saturates exactly -> horizon color + the
    # (tiny) off-axis sun term
    horiz = jnp.array([[1.0, 0.0, 0.0]], jnp.float32)
    got = np.asarray(procedural_sun_sky(horiz))[0]
    sun = (1.0 / np.sqrt(3.0)) ** 500 * 100.0
    assert np.allclose(got, np.array([0.6, 0.4, 0.4]) + sun, atol=1e-5)
    # into the sun: huge spike
    toward = jnp.asarray(SUN_DIR)[None]
    assert np.asarray(procedural_sun_sky(toward))[0, 0] > 90.0

    # end-to-end: scene 5 (empty) under the sun env — every pixel is a
    # first-bounce miss, so the image IS the env model
    from rtm_tpu import Camera, RenderConfig, build_tracer_scene, load_scene
    from rtm_tpu.ops.trace_ref import render_dispatch
    cfg = RenderConfig(width=16, height=16, max_bounces=2, max_frames=1,
                       draw_environment=True)
    scene = build_tracer_scene(load_scene(5), env_model="sun")
    cam = Camera().spec(16, 16)
    img = np.asarray(render_dispatch(scene, cam, jnp.uint32(1), cfg,
                                     backend="xla"))
    assert np.all(np.isfinite(img)) and img.max() > 0.2
    # map-env twin must differ (different environment model)
    scene_map = build_tracer_scene(load_scene(5))
    img_map = np.asarray(render_dispatch(scene_map, cam, jnp.uint32(1),
                                         cfg, backend="xla"))
    assert not np.allclose(img, img_map)
