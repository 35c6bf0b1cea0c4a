"""The built-in scenes through the XLA path against the shader-literal NumPy
oracle (tests/oracle.py): scenes 1-5 at one and two samples per dispatch,
on even and odd resolutions."""
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from rtm_tpu import Camera, RenderConfig, build_tracer_scene, load_scene
from rtm_tpu.ops.trace_ref import render_dispatch

_SCENES = {}


def _scene(sid):
    if sid not in _SCENES:
        _SCENES[sid] = build_tracer_scene(load_scene(sid))
    return _SCENES[sid]


@pytest.mark.parametrize("width,height", [(16, 12), (15, 11)])
@pytest.mark.parametrize("spp", [1, 2])
@pytest.mark.parametrize("sid", [1, 2, 3, 4, 5])
def test_builtin_scene_matches_oracle(image_compare, sid, spp, width, height):
    cfg = RenderConfig(width=width, height=height, max_bounces=3,
                       max_frames=spp, draw_environment=True)
    ts = _scene(sid)
    cam = Camera().spec(width, height)
    got = np.asarray(render_dispatch(ts, cam, jnp.uint32(1), cfg,
                                     backend="xla"))
    want = oracle.render_oracle(ts, cam, cfg, 1)
    assert got.shape == (height, width, 3)
    image_compare(got, want)
