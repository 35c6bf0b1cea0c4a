"""Which nearest-triangle backend runs: 'auto' picks from the platform
alone, and removed or unknown names are refused everywhere."""
import jax.numpy as jnp
import numpy as np
import pytest

from rtm_tpu import Camera, RenderConfig, build_tracer_scene, load_scene
from rtm_tpu.ops.trace_ref import (BACKENDS, auto_backend, render_dispatch,
                                   resolve_backend)

REMOVED = ["mxu", "mxu_interpret", "trav", "trav_interpret", "megakernel",
           "megakernel_interpret", "wavefront2", "wavefront2_interpret",
           "pallas", "pallas_interpret", "bogus"]


@pytest.mark.parametrize("platform,want", [("gpu", "triton"),
                                           ("cuda", "triton"),
                                           ("cpu", "xla")])
def test_auto_backend_per_platform(platform, want):
    assert auto_backend(platform) == want


def test_auto_resolves_to_xla_here():
    """The suite runs on the CPU: auto never picks the kernel, and never
    its interpreter."""
    assert auto_backend() == "xla"
    assert resolve_backend("auto") == "xla"


@pytest.mark.parametrize("name", BACKENDS)
def test_kept_backends_resolve_to_themselves(name):
    assert resolve_backend(name) == name


@pytest.mark.parametrize("name", REMOVED)
def test_removed_backend_names_raise(name):
    with pytest.raises(ValueError, match="backend"):
        resolve_backend(name)


def test_render_dispatch_auto_is_xla_on_cpu():
    cfg = RenderConfig(width=8, height=6, max_bounces=2,
                       draw_environment=True)
    ts = build_tracer_scene(load_scene(3))
    cam = Camera().spec(cfg.width, cfg.height)
    a = render_dispatch(ts, cam, jnp.uint32(1), cfg)
    b = render_dispatch(ts, cam, jnp.uint32(1), cfg, backend="xla")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ["megakernel", "bogus"])
def test_render_dispatch_removed_backend_raises(name):
    cfg = RenderConfig(width=8, height=6, max_bounces=2)
    ts = build_tracer_scene(load_scene(1))
    cam = Camera().spec(cfg.width, cfg.height)
    with pytest.raises(ValueError, match="backend"):
        render_dispatch(ts, cam, jnp.uint32(1), cfg, backend=name)


@pytest.mark.parametrize("name", ["mxu", "trav", "megakernel", "wavefront2",
                                  "pallas"])
def test_cli_refuses_removed_backend(name):
    from rtm_tpu.__main__ import main
    with pytest.raises(SystemExit) as e:
        main(["render", "--backend", name])
    assert e.value.code != 0
