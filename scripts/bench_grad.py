"""fwd+bwd throughput at the headline config (BASELINE.md row 2).

Times the forward dispatch, the pixel-L2 loss and jax.value_and_grad of
that loss through the differentiable path (nearest-hit search by
RTM_BENCH_BACKEND: auto, xla or triton; detached hit topology, per-bounce
remat) on the current device, and prints one JSON line per measurement.

Run: python scripts/bench_grad.py [res] [bounces]
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rtm_tpu import Camera, RenderConfig, build_tracer_scene, load_scene  # noqa: E402
from rtm_tpu.diff.inverse import loss_and_grad, render_loss  # noqa: E402
from rtm_tpu.diff.params import extract_params  # noqa: E402
from rtm_tpu.ops.trace_ref import render_dispatch, resolve_backend  # noqa: E402
from rtm_tpu.utils.cache import enable_compile_cache  # noqa: E402


def timeit(f, *args, reps=8):
    t0 = time.perf_counter()
    jax.block_until_ready(f(*args))
    comp = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, comp


def main():
    enable_compile_cache()
    res = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    bounces = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    backend = resolve_backend(os.environ.get("RTM_BENCH_BACKEND", "auto"))
    cfg = RenderConfig(width=res, height=res, max_bounces=bounces,
                       max_frames=1, draw_environment=True)
    cam = Camera().spec(res, res)
    scene = build_tracer_scene(load_scene(3))
    params = extract_params(scene)
    target = jnp.full((res, res, 3), 0.3, jnp.float32)
    rays = res * res * bounces
    device = jax.devices()[0]

    def emit(name, dt, comp):
        print(json.dumps({
            "metric": name, "ms": round(dt * 1e3, 3),
            "grays_per_s": round(rays / dt / 1e9, 4),
            "compile_s": round(comp, 1), "backend": backend,
            "device": f"{device.platform}:{device.device_kind}",
            "config": f"scene3 {res}x{res} x{bounces} bounces"}), flush=True)

    emit("fwd", *timeit(
        lambda fi: render_dispatch(scene, cam, fi, cfg, backend=backend),
        jnp.uint32(1)))
    emit("fwd_loss", *timeit(
        lambda fi: render_loss(params, scene, cam, target, fi, cfg,
                               backend, True, False),
        jnp.uint32(1)))
    emit("fwd_bwd", *timeit(
        lambda fi: loss_and_grad(params, scene, cam, target, fi, cfg,
                                 backend, True, False),
        jnp.uint32(2)))


if __name__ == "__main__":
    main()
