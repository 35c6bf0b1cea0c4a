"""Progressive renderer: the per-frame driver loop.

Analog of the reference's Application::run + RayTracingClient::update
(Application.cpp:44-68, RayTracing.cpp:501-519) and the accumulation logic in
the kernel epilogue (shader:711-721):

    incoming  = dispatch() / MaxFrames
    if frameIndex != 1: incoming += accumulation
    accumulation = incoming
    out = incoming / frameIndex           (stored RGBA8; no gamma)

frameIndex advances only while accumulation is enabled, and resets to 1 on
camera moves / resizes / scene edits (RayTracing.cpp:81,91-95,625) — here via
`reset()`.  The whole step (dispatch + accumulate) is one jitted function, so
progressive rendering runs entirely on-device with the accumulation buffer
donated between steps (the device-side analog of the reference's persistent
RGBA32F accumulation image).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..models.camera import Camera, CameraSpec
from ..models.scene import Scene, TracerScene, build_tracer_scene
from ..ops.trace_ref import render_dispatch


@partial(jax.jit, static_argnames=("cfg",), donate_argnames=("accum",))
def accumulate_step(scene: TracerScene, cam: CameraSpec, accum, frame_index,
                    cfg: RenderConfig):
    """One progressive frame. Returns (new_accum, display_image)."""
    frame_index = jnp.asarray(frame_index, jnp.uint32)
    incoming = render_dispatch(scene, cam, frame_index, cfg)
    incoming = jnp.where(frame_index != 1, incoming + accum, incoming)
    out = incoming / frame_index.astype(jnp.float32)
    return incoming, out


@partial(jax.jit, static_argnames=("cfg", "backend"))
def render_progressive(scene: TracerScene, cam: CameraSpec, cfg: RenderConfig,
                       frames, backend: str = "auto"):
    """Fully on-device progressive render: `frames` accumulation dispatches
    in one jit (a fori_loop over frame_index), returning the converged
    display image.  This is the production/bench path — one host round-trip
    for an arbitrarily deep accumulation (the interactive ProgressiveRenderer
    below instead steps once per UI frame like the reference's render loop).
    """
    h, w = cfg.height, cfg.width

    def body(fi, accum):
        incoming = render_dispatch(scene, cam, fi.astype(jnp.uint32), cfg,
                                   backend=backend)
        return jnp.where(fi != 1, accum + incoming, incoming)

    frames = jnp.asarray(frames, jnp.int32)
    accum = jax.lax.fori_loop(1, frames + 1, body,
                              jnp.zeros((h, w, 3), jnp.float32))
    return accum / frames.astype(jnp.float32)


class ProgressiveRenderer:
    """Host-side session state (scene + camera + accumulation)."""

    def __init__(self, scene: Scene | TracerScene, camera: Camera | None = None,
                 cfg: RenderConfig | None = None):
        self.cfg = cfg or RenderConfig()
        self.camera = camera or Camera()
        self.scene = scene if isinstance(scene, TracerScene) else build_tracer_scene(scene)
        self.frame_index = 0
        self.accum = jnp.zeros((self.cfg.height, self.cfg.width, 3), jnp.float32)
        self.last_ms = 0.0        # "GPU time" analog (RayTracing.cpp:77)
        self.fps = 0.0            # rolling average (ImGui Framerate parity)

    def reset(self) -> None:
        """Reset accumulation (camera move / resize / scene edit parity)."""
        self.frame_index = 0
        self.accum = jnp.zeros((self.cfg.height, self.cfg.width, 3), jnp.float32)

    def set_config(self, **kw) -> None:
        """Apply settings-panel edits (RayTracing.cpp:83-101 semantics):
        bounces / spp / accumulate / draw-environment / debug changes do NOT
        reset accumulation (the reference keeps blending the stale frames);
        only a resize reallocates+resets the accumulation image
        (RayTracing.cpp:469-485)."""
        import dataclasses
        old = self.cfg
        self.cfg = dataclasses.replace(old, **kw)
        if (self.cfg.width, self.cfg.height) != (old.width, old.height):
            self.reset()

    def set_scene(self, scene: Scene | TracerScene) -> None:
        self.scene = scene if isinstance(scene, TracerScene) else build_tracer_scene(scene)
        self.reset()

    def move_camera(self, **kw) -> None:
        self.camera.move(**kw)
        self.reset()

    def step(self) -> jax.Array:
        """Render one frame; returns the display image (H,W,3) f32."""
        import time
        t0 = time.perf_counter()
        self.frame_index = self.frame_index + 1 if self.cfg.accumulate else 1
        cam_spec = self.camera.spec(self.cfg.width, self.cfg.height)
        self.accum, out = accumulate_step(
            self.scene, cam_spec, self.accum,
            np.uint32(self.frame_index), self.cfg)
        jax.block_until_ready(out)
        self.last_ms = (time.perf_counter() - t0) * 1e3
        inst = 1e3 / max(self.last_ms, 1e-3)
        self.fps = inst if self.fps == 0.0 else 0.9 * self.fps + 0.1 * inst
        return out

    def step_async(self) -> jax.Array:
        """Dispatch one frame WITHOUT blocking: returns the device array
        immediately (JAX dispatch is asynchronous), so the host can do
        other work — event handling, encoding the previous frame — while
        the device renders.  This is the analog of the reference's two
        frames in flight (Swapchain double buffering, Utils/Constants.h:7
        + Swapchain.cpp:56-115): the viewer encodes frame N while frame
        N+1 is on the device (SURVEY §2.1 P-PP)."""
        self.frame_index = self.frame_index + 1 if self.cfg.accumulate else 1
        cam_spec = self.camera.spec(self.cfg.width, self.cfg.height)
        self.accum, out = accumulate_step(
            self.scene, cam_spec, self.accum,
            np.uint32(self.frame_index), self.cfg)
        return out

    def render(self, frames: int = 1) -> jax.Array:
        out = None
        for _ in range(frames):
            out = self.step()
        return out
