"""Nanosecond timer returning milliseconds as float.

Parity with ``RT::Timer`` (ref: Engine/src/Engine/Core/Time.h:12-30): the
reference wraps the app frame and GPU submit path in a ns-resolution timer and
reports ms floats.  On an accelerator, wall-clock measurement must bracket
``jax.block_until_ready`` to include device time (async dispatch otherwise
returns immediately).
"""
from __future__ import annotations

import time

import jax


class Timer:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._start = time.perf_counter_ns()

    def elapsed_ms(self) -> float:
        """Milliseconds since construction/reset (reference `Ellapsed`)."""
        return (time.perf_counter_ns() - self._start) / 1e6


def device_timed_ms(fn, *args, warmup: int = 1, iters: int = 10):
    """Run `fn(*args)` with block_until_ready, return (mean_ms, last_result).

    This is the analog of the reference's GPU-time measurement that wraps
    beginFrame..endFrame (ref: RayTracing/src/RayTracing.cpp:505-518).
    """
    result = None
    for _ in range(max(warmup, 0)):
        result = jax.block_until_ready(fn(*args))
    t = Timer()
    for _ in range(iters):
        result = jax.block_until_ready(fn(*args))
    return t.elapsed_ms() / iters, result
