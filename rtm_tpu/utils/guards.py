"""Numeric guards: the analog of the reference's Vulkan validation
layers (SURVEY.md §5.2 — Debug.h:16-21 VK_LAYER_KHRONOS_validation +
CHECK_VK on every call).

XLA's dataflow ordering makes races moot, so the runtime hazard class that
remains is numeric: NaN/Inf escaping a kernel.  Two opt-in oracles:

  * assert_image_finite — post-hoc output validation (any backend, cheap:
    one reduction per frame);
  * checked_render_dispatch — jax.experimental.checkify float_checks over
    the full XLA render graph: every primitive is instrumented and the
    FIRST offending op is reported (the validation-layer experience).
    XLA backend only — checkify has no rules for Pallas kernels; the
    Triton sweep is covered by the output check + its interpreter tests.

Wire-up: `python -m rtm_tpu render --check-nans`, or call directly.
"""
from __future__ import annotations

import jax.numpy as jnp


def assert_image_finite(img, what: str = "render output") -> None:
    """Raise FloatingPointError if the (device) image contains NaN/Inf."""
    bad = int(jnp.size(img) - jnp.sum(jnp.isfinite(img)))
    if bad:
        raise FloatingPointError(
            f"{what}: {bad}/{jnp.size(img)} non-finite values "
            f"(min {float(jnp.nanmin(img))}, max {float(jnp.nanmax(img))})")


def checked_render_dispatch(scene, cam, frame_index, cfg, **kw):
    """render_dispatch with checkify float_checks: raises on the first
    NaN/Inf-producing primitive anywhere in the traced XLA graph."""
    from jax.experimental import checkify

    from ..ops.trace_ref import render_dispatch

    backend = kw.setdefault("backend", "xla")
    if backend != "xla":
        raise ValueError(
            "checked_render_dispatch instruments the XLA graph; the Triton "
            f"sweep ({backend!r}) is covered by assert_image_finite and its "
            "interpreter tests")

    def f(s, c, i):
        return render_dispatch(s, c, i, cfg, **kw)

    err, out = checkify.checkify(f, errors=checkify.float_checks)(
        scene, cam, frame_index)
    checkify.check_error(err)
    return out
