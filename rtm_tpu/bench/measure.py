"""Orbit-camera perf harness — reference Measure parity.

Reproduces the reference's measurement loop (RayTracing/src/RayTracing.cpp:
151-160,597-620): the camera orbits the scene on a radius-2 circle; every
`frames_per_sample` frames (3 in the reference) the average frame time is
appended to `Measure.txt` as one `angle avg_ms` line, advancing the angle 1
degree until 360.  `view_perf.py` post-processes the file exactly like the
reference's viewPerf.py.

Each timing window ends in a host transfer (np.asarray), so it includes the
transfer latency, just as the reference's "GPU time" is really submit-path
time (SURVEY.md §3.5).
"""
from __future__ import annotations

import time

import numpy as np

from ..config import RenderConfig
from ..models.camera import Camera
from ..models.scene import TracerScene
from ..utils.logging import get_logger

log = get_logger("app")


def run_measure(scene: TracerScene, cfg: RenderConfig,
                out_path: str = "Measure.txt", radius: float = 2.0,
                frames_per_sample: int = 3, angle_step: float = 1.0,
                backend: str = "auto", camera: Camera | None = None):
    """Sweep 360 deg; write `angle avg_ms` per sample.  Returns the (angle,
    avg_ms) array."""
    import jax
    import jax.numpy as jnp

    from ..ops.trace_ref import render_dispatch

    cam = camera or Camera()
    # scene as a jit ARGUMENT: closing over it would bake the texture
    # tables into the HLO as constants (render_dispatch is itself jitted,
    # so this wrapper only fixes the camera-spec/frame plumbing)
    f = jax.jit(lambda sc, spec, fi: render_dispatch(sc, spec, fi, cfg,
                                                     backend=backend))
    # warm the compile outside the timed loop
    cam.orbit(0.0, radius)
    np.asarray(f(scene, cam.spec(cfg.width, cfg.height), jnp.uint32(1)))

    rows = []
    angle = 0.0
    frame_index = 0
    with open(out_path, "w") as fh:
        while angle < 360.0:
            cam.orbit(angle, radius)
            spec = cam.spec(cfg.width, cfg.height)
            t0 = time.perf_counter()
            out = None
            for k in range(frames_per_sample):
                frame_index += 1
                out = f(scene, spec, jnp.uint32(frame_index))
            np.asarray(out)
            avg_ms = (time.perf_counter() - t0) * 1000.0 / frames_per_sample
            fh.write(f"{angle:g} {avg_ms:g}\n")
            rows.append((angle, avg_ms))
            angle += angle_step
    arr = np.asarray(rows, np.float64)
    log.info("measure: %d samples -> %s", len(rows), out_path)
    return arr


def summarize(arr: np.ndarray) -> dict:
    """viewPerf.py:4-17 parity: FPS = 1000/ms, report mean/max/min."""
    fps = 1000.0 / arr[:, 1]
    return {"mean_fps": float(fps.mean()), "max_fps": float(fps.max()),
            "min_fps": float(fps.min())}
