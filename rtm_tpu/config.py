"""Render configuration.

Parity with the reference's runtime-mutable ``InfoUniform`` (ref:
RayTracing/src/RayTracing.cpp:942-954) — parameter names and default values
match; the UI slider ranges become validation bounds.  The counts that the
reference carries in the uniform (MaterialsCount, SpheresCount, ObjectsCount,
TexturesCount — ref shader bindings RayTracing.shader:19-31) are *static* in
this build: XLA requires static shapes, so entity counts live on the scene
pytree as aux data and a re-jit happens on structural edits (the reference
analogously reallocates buffers + rewrites descriptors on count changes,
RayTracing.cpp:403-447).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class RenderConfig:
    """Static (hashable) per-compilation render settings.

    Attributes mirror InfoUniform:
      draw_environment  <- InfoUniform.drawEnvironment (float-as-bool in ref)
      max_bounces       <- InfoUniform.maxBounces, UI range 1..15
      max_frames        <- InfoUniform.maxFrames (samples per dispatch), UI 1..5
      width/height      <- InfoUniform.resolution
      debug             <- InfoUniform.debug (kept for parity; unused)
    `frameIndex` is *traced*, not static — it changes every frame.
    """

    width: int = 1280
    height: int = 720
    max_bounces: int = 1
    max_frames: int = 1
    draw_environment: bool = False
    accumulate: bool = False
    debug: int = 0

    def __post_init__(self):
        if not (1 <= self.max_bounces <= 64):
            raise ValueError(f"max_bounces out of range: {self.max_bounces}")
        if not (1 <= self.max_frames <= 64):
            raise ValueError(f"max_frames out of range: {self.max_frames}")
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"bad resolution {self.width}x{self.height}")

    @property
    def resolution(self) -> tuple[int, int]:
        return (self.width, self.height)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
