"""Headline benchmark: forward path-tracing throughput on the Cornell box.

Config per BASELINE.md: scene 3 (Cornell box + dragon, reference
RayTracing/src/RayTracing.cpp:702-806), 512x512, 8 bounces, 1 sample per
dispatch, progressive accumulation — measured around block_until_ready.

Prints ONE JSON line:
  {"metric": "cornell_grays_per_s", "value": N, "unit": "Grays/s/chip",
   "spread": {...}}

Rays counted = W*H*spp*max_bounces per dispatch (every lane traces every
bounce on this dense design; early-terminated lanes still occupy lanes).
"""
from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from rtm_tpu.utils.cache import enable_compile_cache


def main() -> None:
    enable_compile_cache()
    width = int(os.environ.get("RTM_BENCH_WIDTH", 512))
    height = int(os.environ.get("RTM_BENCH_HEIGHT", 512))
    bounces = int(os.environ.get("RTM_BENCH_BOUNCES", 8))
    spp = int(os.environ.get("RTM_BENCH_SPP", 1))
    scene_id = int(os.environ.get("RTM_BENCH_SCENE", 3))
    backend = os.environ.get("RTM_BENCH_BACKEND", "auto")
    repeats = int(os.environ.get("RTM_BENCH_REPEATS", 20))

    from rtm_tpu import Camera, RenderConfig, build_tracer_scene, load_scene
    from rtm_tpu.ops.trace_ref import resolve_backend, render_dispatch

    cfg = RenderConfig(width=width, height=height, max_bounces=bounces,
                       max_frames=spp, draw_environment=True, accumulate=True)
    scene = build_tracer_scene(load_scene(scene_id))
    cam = Camera().spec(cfg.width, cfg.height)

    backend = resolve_backend(backend)

    # render_dispatch is itself @jax.jit (static cfg/backend); an outer jit
    # closing over scene would bake the texture tables into the HLO as
    # constants
    def dispatch(fi):
        return render_dispatch(scene, cam, fi, cfg, backend=backend)

    # warmup / compile
    jax.block_until_ready(dispatch(jnp.uint32(1)))

    # dispersion protocol: `blocks` independent timed blocks of `repeats`
    # frames each; report the MEDIAN block rate with the min/max spread
    blocks = int(os.environ.get("RTM_BENCH_BLOCKS", 5))
    rates = []
    fi = 2
    for _b in range(blocks):
        t0 = time.perf_counter()
        for _i in range(repeats):
            out = dispatch(jnp.uint32(fi))
            fi += 1
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        rates.append(width * height * spp * bounces * repeats / dt / 1e9)
    rates.sort()
    med = rates[len(rates) // 2]
    print(json.dumps({
        "metric": "cornell_grays_per_s",
        "value": round(med, 4),
        "unit": "Grays/s/chip",
        "spread": {"min": round(rates[0], 4), "max": round(rates[-1], 4),
                   "blocks": blocks, "repeats_per_block": repeats},
    }))
    print(f"# platform={jax.devices()[0].platform} backend={backend} "
          f"{width}x{height} bounces={bounces} spp={spp} "
          f"median ms/frame={width * height * spp * bounces / med / 1e6:.2f} "
          f"(min {width * height * spp * bounces / rates[-1] / 1e6:.2f} / "
          f"max {width * height * spp * bounces / rates[0] / 1e6:.2f})",
          file=sys.stderr)


if __name__ == "__main__":
    main()
