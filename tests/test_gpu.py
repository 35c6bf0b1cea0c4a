"""Checks that need an NVIDIA GPU (marker `gpu`; skipped where JAX finds
none).  On the card: `python -m pytest tests/ -m gpu`.  chip_smoke.py runs
the same checks at full size."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtm_tpu import Camera, RenderConfig, build_tracer_scene, load_scene
from rtm_tpu.ops.intersect import TriFeatures, nearest_triangle
from rtm_tpu.ops.pallas.intersect_kernel import nearest_triangle_triton
from rtm_tpu.ops.trace_ref import render_dispatch

pytestmark = pytest.mark.gpu


def test_triton_sweep_matches_xla_on_gpu(gpu_device):
    rs = np.random.RandomState(0)
    a = rs.rand(2048, 3).astype(np.float32) * 4 - 2
    b = a + rs.randn(2048, 3).astype(np.float32) * 0.2
    c = a + rs.randn(2048, 3).astype(np.float32) * 0.2
    o = np.zeros((8192, 3), np.float32) + np.float32([0, 0, 5])
    d = rs.randn(8192, 3).astype(np.float32) * 0.3 + np.float32([0, 0, -1])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    with jax.default_device(gpu_device):
        _, i_k = nearest_triangle_triton(o, d, a, b, c)
        feats = TriFeatures.build(*map(jnp.asarray, (a, b, c)))
        _, i_x = nearest_triangle(jnp.asarray(o), jnp.asarray(d), feats)
    assert np.mean(np.asarray(i_k) == np.asarray(i_x)) >= 0.9999


def test_render_triton_matches_xla_on_gpu(gpu_device, image_compare):
    cfg = RenderConfig(width=64, height=64, max_bounces=4,
                       draw_environment=True)
    ts = build_tracer_scene(load_scene(3))
    cam = Camera().spec(cfg.width, cfg.height)
    with jax.default_device(gpu_device):
        a = render_dispatch(ts, cam, jnp.uint32(1), cfg, backend="triton")
        b = render_dispatch(ts, cam, jnp.uint32(1), cfg, backend="xla")
    image_compare(np.asarray(a), np.asarray(b))


def test_grad_through_triton_on_gpu(gpu_device):
    from rtm_tpu.diff.inverse import loss_and_grad
    from rtm_tpu.diff.params import extract_params
    cfg = RenderConfig(width=32, height=32, max_bounces=3,
                       draw_environment=True)
    ts = build_tracer_scene(load_scene(2))
    cam = Camera().spec(cfg.width, cfg.height)
    target = jnp.full((32, 32, 3), 0.3, jnp.float32)
    with jax.default_device(gpu_device):
        loss, g = loss_and_grad(extract_params(ts), ts, cam, target,
                                jnp.uint32(1), cfg, "triton", False, False)
    assert np.isfinite(float(loss))
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(g))
