"""Render modes against the NumPy oracle (tests/oracle.py): the
MaxBounces==1 flat-shade preview, the environment switched off, and
progressive accumulation over several dispatches."""
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from rtm_tpu import Camera, RenderConfig, build_tracer_scene, load_scene
from rtm_tpu.ops.trace_ref import render_dispatch
from rtm_tpu.runtime.renderer import render_progressive

_SCENES = {}


def _scene(sid):
    if sid not in _SCENES:
        _SCENES[sid] = build_tracer_scene(load_scene(sid))
    return _SCENES[sid]


@pytest.mark.parametrize("sid", [1, 2, 3, 4])
def test_flat_shade_matches_oracle(image_compare, sid):
    cfg = RenderConfig(width=16, height=12, max_bounces=1,
                       draw_environment=True)
    cam = Camera().spec(cfg.width, cfg.height)
    got = np.asarray(render_dispatch(_scene(sid), cam, jnp.uint32(1), cfg,
                                     backend="xla"))
    want = oracle.render_oracle(_scene(sid), cam, cfg, 1)
    image_compare(got, want)


@pytest.mark.parametrize("sid", [2, 3, 4])
def test_environment_off_matches_oracle(image_compare, sid):
    cfg = RenderConfig(width=16, height=12, max_bounces=3,
                       draw_environment=False)
    cam = Camera().spec(cfg.width, cfg.height)
    got = np.asarray(render_dispatch(_scene(sid), cam, jnp.uint32(1), cfg,
                                     backend="xla"))
    want = oracle.render_oracle(_scene(sid), cam, cfg, 1)
    image_compare(got, want)


@pytest.mark.parametrize("sid", [2, 3])
def test_progressive_accumulation_matches_oracle(image_compare, sid):
    """render_progressive over 3 dispatches == mean of the oracle's frames
    1..3 (shader:711-721: running sum / frameIndex)."""
    cfg = RenderConfig(width=16, height=12, max_bounces=3,
                       draw_environment=True, accumulate=True)
    cam = Camera().spec(cfg.width, cfg.height)
    got = np.asarray(render_progressive(_scene(sid), cam, cfg, 3,
                                        backend="xla"))
    want = np.mean([oracle.render_oracle(_scene(sid), cam, cfg, fi)
                    for fi in (1, 2, 3)], axis=0)
    image_compare(got, want)
