"""The Triton sweep under pixel-band sharding, on fake CPU meshes (Pallas
interpreter): every device runs the kernel on its own row band, and the
result must equal the single-device render and gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtm_tpu import Camera, RenderConfig, build_tracer_scene, load_scene
from rtm_tpu.diff.inverse import loss_and_grad
from rtm_tpu.diff.params import extract_params
from rtm_tpu.ops.trace_ref import render_dispatch
from rtm_tpu.parallel.sharding import (make_mesh, render_sharded,
                                       sharded_loss_and_grad)

CFG = RenderConfig(width=16, height=12, max_bounces=3, max_frames=1,
                   draw_environment=True)


@pytest.fixture(scope="module")
def scene3():
    return (build_tracer_scene(load_scene(3)),
            Camera().spec(CFG.width, CFG.height))


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_render_sharded_triton_matches_single_device(scene3, n_dev):
    scene, cam = scene3
    ref = render_dispatch(scene, cam, jnp.uint32(1), CFG,
                          backend="triton_interpret")
    out = render_sharded(scene, cam, jnp.uint32(1), CFG, make_mesh(n_dev),
                         backend="triton_interpret")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_sharded_triton_grads_match_single_device(scene3):
    scene, cam = scene3
    params = extract_params(scene)
    target = jnp.full((CFG.height, CFG.width, 3), 0.3, jnp.float32)
    l_ref, g_ref = loss_and_grad(params, scene, cam, target, jnp.uint32(1),
                                 CFG, "xla", False, False)
    l_sh, g_sh = sharded_loss_and_grad(params, scene, cam, target,
                                       jnp.uint32(1), CFG, make_mesh(4),
                                       backend="triton_interpret",
                                       remat=False,
                                       rebuild_tri_geometry=False)
    np.testing.assert_allclose(float(l_sh), float(l_ref), rtol=1e-4)
    for a, b in zip(jax.tree.leaves(g_sh), jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=3e-4, atol=2e-6)


@pytest.mark.parametrize("backend", ["mxu", "trav", "megakernel",
                                     "wavefront2", "pallas"])
def test_render_sharded_removed_backend_raises(scene3, backend):
    scene, cam = scene3
    with pytest.raises(ValueError, match="backend"):
        render_sharded(scene, cam, jnp.uint32(1), CFG, make_mesh(2),
                       backend=backend)
