"""Multi-device sharding tests on the fake 8-device CPU mesh (SURVEY.md §4(d)).

Oracle: the sharded renderer / sharded loss+grad must be numerically
identical (same seeds, same math, just different device placement) to the
single-device paths in ops.trace_ref and diff.inverse.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtm_tpu import Camera, RenderConfig, build_tracer_scene, load_scene
from rtm_tpu.diff.inverse import loss_and_grad
from rtm_tpu.diff.params import extract_params
from rtm_tpu.ops.trace_ref import render_dispatch
from rtm_tpu.parallel.sharding import (make_mesh, make_train_step,
                                       render_sharded, render_sharded_spp,
                                       sharded_loss_and_grad)

CFG = RenderConfig(width=24, height=20, max_bounces=3, max_frames=1,
                   draw_environment=True)


@pytest.fixture(scope="module")
def setup():
    scene = build_tracer_scene(load_scene(1))
    cam = Camera().spec(CFG.width, CFG.height)
    return scene, cam


def test_mesh_shape():
    mesh = make_mesh(8)
    assert mesh.shape["dp"] == 8


@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_render_sharded_matches_single_device(setup, n_dev):
    scene, cam = setup
    mesh = make_mesh(n_dev)
    ref = render_dispatch(scene, cam, jnp.uint32(1), CFG)
    out = render_sharded(scene, cam, jnp.uint32(1), CFG, mesh)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_render_sharded_uneven_rows(setup):
    """20 rows over 8 devices: padding path (480 pixels / device != rows)."""
    scene, cam = setup
    cfg = CFG.replace(height=19)
    mesh = make_mesh(8)
    cam19 = Camera().spec(cfg.width, cfg.height)
    ref = render_dispatch(scene, cam19, jnp.uint32(1), cfg)
    out = render_sharded(scene, cam19, jnp.uint32(1), cfg, mesh)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_render_sharded_spp_finite_and_converging(setup):
    scene, cam = setup
    mesh = make_mesh(8)
    out = render_sharded_spp(scene, cam, jnp.uint32(1), CFG, mesh)
    assert out.shape == (CFG.height, CFG.width, 3)
    assert bool(jnp.isfinite(out).all())
    # 8-device psum-mean of disjoint seed streams ~ the 1-dispatch image
    ref = render_dispatch(scene, cam, jnp.uint32(1), CFG)
    assert float(jnp.abs(out.mean() - ref.mean())) < 0.15


def test_sharded_grads_match_single_device(setup):
    scene, cam = setup
    mesh = make_mesh(8)
    params = extract_params(scene)
    target = jnp.full((CFG.height, CFG.width, 3), 0.3, jnp.float32)

    l_ref, g_ref = loss_and_grad(params, scene, cam, target, jnp.uint32(1),
                                 CFG, "xla", False, False)
    l_sh, g_sh = sharded_loss_and_grad(params, scene, cam, target,
                                       jnp.uint32(1), CFG, mesh,
                                       remat=False,
                                       rebuild_tri_geometry=False)
    np.testing.assert_allclose(float(l_sh), float(l_ref), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(g_sh), jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=1e-6)


def test_train_step_descends(setup):
    import optax
    scene, cam = setup
    mesh = make_mesh(8)
    params = extract_params(scene)
    target = render_dispatch(scene, cam, jnp.uint32(1), CFG)
    # perturb albedo; one step must reduce loss toward the target scene
    params.albedo = params.albedo * 0.5
    opt = optax.adam(5e-2)
    step = make_train_step(scene, cam, target, CFG, mesh, opt,
                           rebuild_tri_geometry=False)
    st = opt.init(params)
    losses = []
    for i in range(3):
        params, st, loss = step(params, st, jnp.uint32(1))
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_graft_entry_dryrun():
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (128, 128, 3)
    assert bool(jnp.isfinite(out).all())
    ge.dryrun_multichip(8)


def test_render_sharded_unknown_backend_raises(setup):
    """Unrecognized backend strings must be LOUD, not silently routed to
    another path."""
    scene, cam = setup
    mesh = make_mesh(2)
    with pytest.raises(ValueError, match="backend"):
        render_sharded(scene, cam, jnp.uint32(1), CFG, mesh,
                       backend="bogus")


def test_sharded_grads_not_double_counted():
    """Pin the psum-double-count failure mode EXPLICITLY: under
    check_vma=False the naive psum-inside-grad pattern measured
    replicated-parameter cotangents x n_dev; the committed
    differentiate-per-band-then-sum-outside form must yield grads whose
    scale matches single-device — a 4x-scaled gradient (what the naive
    pattern produced on a 4-mesh) must FAIL this test."""
    cfg = RenderConfig(width=16, height=16, max_bounces=3, max_frames=1,
                       draw_environment=True)
    scene = build_tracer_scene(load_scene(2))
    cam = Camera().spec(cfg.width, cfg.height)
    n_dev = 4
    mesh = make_mesh(n_dev)
    params = extract_params(scene)
    target = jnp.full((cfg.height, cfg.width, 3), 0.3, jnp.float32)
    _, g_ref = loss_and_grad(params, scene, cam, target, jnp.uint32(1),
                             cfg, "xla", False, False)
    for be in ("xla", "triton_interpret"):
        _, g_sh = sharded_loss_and_grad(params, scene, cam, target,
                                        jnp.uint32(1), cfg, mesh,
                                        backend=be, remat=False,
                                        rebuild_tri_geometry=False)
        ref = np.concatenate([np.asarray(v).ravel()
                              for v in jax.tree.leaves(g_ref)])
        sh = np.concatenate([np.asarray(v).ravel()
                             for v in jax.tree.leaves(g_sh)])
        denom = float(ref @ ref)
        assert denom > 0
        scale = float(sh @ ref) / denom      # least-squares grad scale
        assert abs(scale - 1.0) < 0.01, (be, scale)
        assert abs(scale - n_dev) > 1.0, (be, scale)
