"""Gradients through the Triton sweep (Pallas interpreter on the CPU): the
kernel picks the hit topology and every hit value is recomputed
differentiably from it, so the gradient must equal the XLA sweep's and
agree with finite differences."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grad_rig import CFG, FI, _fd_check, _loss_fn, _scene
from rtm_tpu import Camera
from rtm_tpu.diff import (InverseRenderConfig, extract_params,
                          inverse_render, render_loss)


@pytest.fixture(scope="module")
def setup():
    ts = _scene()
    cam = Camera().spec(CFG.width, CFG.height)
    f = _loss_fn(ts, cam)
    params = extract_params(ts)
    return ts, cam, f, params, jax.grad(f)(params)


@pytest.fixture(scope="module")
def triton_setup():
    """Same rig as `setup` but through render_loss(backend=
    'triton_interpret') — the Triton sweep in the Pallas interpreter."""
    ts = _scene()
    cam = Camera().spec(CFG.width, CFG.height)
    target = jnp.zeros((CFG.height, CFG.width, 3), jnp.float32)

    def f(params):
        return render_loss(params, ts, cam, target, FI, CFG,
                           backend="triton_interpret", remat=False)

    params = extract_params(ts)
    g = jax.grad(f)(params)
    return ts, cam, f, params, g


@pytest.mark.parametrize("name", ["albedo", "emission_power", "roughness",
                                  "sph_pos", "tri_verts"])
def test_triton_grads_match_xla(setup, triton_setup, name):
    """The Triton-path gradient equals the XLA-sweep gradient for albedo,
    emission, roughness, sphere centre and vertices (same detached-topology
    convention, same semantics)."""
    a = np.asarray(getattr(setup[4], name))
    b = np.asarray(getattr(triton_setup[4], name))
    assert np.abs(a).max() > 0, name
    np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-5, err_msg=name)


def test_triton_grad_albedo_fd(triton_setup):
    _fd_check(triton_setup,
              lambda q: q.albedo[0, 0],
              lambda q, v: q.__class__(**{**q.__dict__, "albedo": q.albedo.at[0, 0].set(v)}),
              eps=1e-3, tol=2e-2)


def test_triton_grad_emission_power_fd(triton_setup):
    _fd_check(triton_setup,
              lambda q: q.emission_power[1],
              lambda q, v: q.__class__(**{**q.__dict__, "emission_power": q.emission_power.at[1].set(v)}),
              eps=1e-3, tol=2e-2)


def test_triton_grad_roughness_fd(triton_setup):
    _fd_check(triton_setup,
              lambda q: q.roughness[0],
              lambda q, v: q.__class__(**{**q.__dict__, "roughness": q.roughness.at[0].set(v)}),
              eps=1e-3, tol=5e-2)


def test_triton_grad_sphere_center_fd(triton_setup):
    _fd_check(triton_setup,
              lambda q: q.sph_pos[0, 2],
              lambda q, v: q.__class__(**{**q.__dict__, "sph_pos": q.sph_pos.at[0, 2].set(v)}),
              eps=2e-2, tol=0.2)


def test_triton_grad_vertex_fd(triton_setup):
    _fd_check(triton_setup,
              lambda q: q.tri_verts[0, 2, 1],
              lambda q, v: q.__class__(**{**q.__dict__, "tri_verts": q.tri_verts.at[0, 2, 1].set(v)}),
              eps=2e-3, tol=0.15)


@pytest.mark.parametrize("backend", ["mxu", "wavefront2", "pallas", "bogus"])
def test_render_loss_unknown_backend_raises(backend):
    """Removed and unknown backend names are refused, never rerouted."""
    ts = _scene()
    cam = Camera().spec(CFG.width, CFG.height)
    target = jnp.zeros((CFG.height, CFG.width, 3), jnp.float32)
    with pytest.raises(ValueError, match="backend"):
        render_loss(extract_params(ts), ts, cam, target, FI, CFG,
                    backend=backend)


def test_inverse_render_triton_recovers_albedo():
    """BASELINE config 5 through the Triton-sweep gradient path: the
    optimizer loop recovers a perturbed albedo — end-to-end, not just a
    grad-parity check."""
    ts = _scene()
    cam = Camera().spec(CFG.width, CFG.height)
    true_params = extract_params(ts)
    from rtm_tpu.ops.trace_ref import render_dispatch
    target = render_dispatch(ts, cam, FI, CFG, backend="xla")

    p0 = true_params.__class__(**{
        **true_params.__dict__,
        "albedo": true_params.albedo.at[0].set(
            jnp.asarray([0.3, 0.6, 0.6])),
    })
    opt_cfg = InverseRenderConfig(steps=80, learning_rate=4e-2,
                                  remat=False, vary_seed=False,
                                  backend="triton_interpret")
    mask = jax.tree.map(jnp.zeros_like, p0)
    mask = mask.__class__(**{**mask.__dict__,
                             "albedo": jnp.ones_like(p0.albedo)})
    p_fit, losses = inverse_render(ts, cam, target, CFG, opt_cfg,
                                   init_params=p0, param_mask=mask)
    assert losses[-1] < losses[0] * 0.1, (losses[0], losses[-1])
    np.testing.assert_allclose(np.asarray(p_fit.albedo[0]),
                               np.asarray(true_params.albedo[0]),
                               atol=0.08)
