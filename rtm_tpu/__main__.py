"""CLI entry — `python -m rtm_tpu <command>`.

The reference's startup chain (EntryPoint.h:6-9 -> Startup.cpp:18-52)
launches a windowed app; this framework is headless-first, so the
entry point is a CLI (SURVEY C1):

  render    render a scene to PNG (progressive accumulation)
  bench     one JSON line of headline throughput (same as bench.py)
  measure   orbit-camera perf sweep -> Measure.txt (C29 parity)
  viewperf  summarize/plot a Measure.txt (viewPerf.py parity)
  scenes    list built-in scenes
  optimize  inverse-rendering demo (adam on scene params vs a target)
"""
from __future__ import annotations

import argparse
import sys


def _add_render_args(p):
    p.add_argument("--scene", type=int, default=3, help="built-in scene 1-5")
    p.add_argument("--scene-file", default=None,
                   help="load a saved .rtm.json scene instead of --scene")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--bounces", type=int, default=8,
                   help="MaxBounces (reference UI range 1-15)")
    p.add_argument("--spp", type=int, default=1,
                   help="samples per dispatch (reference MaxFrames, 1-5)")
    p.add_argument("--frames", type=int, default=16,
                   help="progressive accumulation dispatches")
    p.add_argument("--no-environment", action="store_true",
                   help="disable sky lighting (DrawEnvironment=0)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "triton"],
                   help="nearest-triangle search: the Triton kernel "
                        "(GPU) or the XLA sweep; auto picks by platform")
    p.add_argument("--platform", default=None,
                   help="force jax platform (e.g. cpu)")
    p.add_argument("--env", default="map", choices=("map", "sun"),
                   help="environment model: equirect sky map, or the "
                        "legacy kernel's procedural sun/sky "
                        "(OldRayTracing.shader:119-136)")
    p.add_argument("--check-nans", action="store_true",
                   help="numeric validation layer (SURVEY §5.2): checkify "
                        "float_checks on the XLA graph + finite output "
                        "assertion on every frame")


def _setup(args, want_host_scene: bool = False):
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from rtm_tpu import (Camera, RenderConfig, build_tracer_scene,
                         load_scene)
    from rtm_tpu.ops.trace_ref import resolve_backend
    backend = resolve_backend(args.backend)
    cfg = RenderConfig(width=args.width, height=args.height,
                       max_bounces=args.bounces, max_frames=args.spp,
                       draw_environment=not args.no_environment)
    cam = Camera()
    if getattr(args, "scene_file", None):
        from rtm_tpu.io.scene_io import load_scene_file
        host, file_cam, _ = load_scene_file(args.scene_file)
        if file_cam is not None:
            cam = file_cam
    else:
        host = load_scene(args.scene)
    scene = build_tracer_scene(host, env_model=getattr(args, "env", "map"))
    if want_host_scene:
        return scene, cam, cfg, backend, host
    return scene, cam, cfg, backend


def cmd_render(args) -> int:
    import numpy as np

    from rtm_tpu.io.image import save_png
    from rtm_tpu.runtime.renderer import render_progressive

    scene, cam, cfg, backend = _setup(args)
    if getattr(args, "check_nans", False):
        import jax.numpy as jnp

        from rtm_tpu.utils.guards import (assert_image_finite,
                                          checked_render_dispatch)
        if backend == "xla":
            # instrumented first frame: pinpoints the first bad primitive
            checked_render_dispatch(scene, cam.spec(cfg.width, cfg.height),
                                    jnp.uint32(1), cfg)
    img = np.asarray(render_progressive(
        scene, cam.spec(cfg.width, cfg.height), cfg, args.frames,
        backend=backend))
    if getattr(args, "check_nans", False):
        from rtm_tpu.utils.guards import assert_image_finite
        assert_image_finite(img)
    save_png(args.out, img[::-1])   # row 0 looks down (kernel parity)
    print(f"wrote {args.out}  ({cfg.width}x{cfg.height}, "
          f"{args.frames} frames, backend={backend})")
    return 0


def cmd_bench(args) -> int:
    """Delegates to the repo-root bench.py (one JSON line)."""
    import os
    import runpy
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bench = os.path.join(root, "bench.py")
    runpy.run_path(bench, run_name="__main__")
    return 0


def cmd_measure(args) -> int:
    from rtm_tpu.bench.measure import run_measure, summarize

    scene, cam, cfg, backend = _setup(args)
    arr = run_measure(scene, cfg, out_path=args.out, radius=args.radius,
                      backend=backend, camera=cam)
    stats = summarize(arr)
    print(f"Mean: {stats['mean_fps']}")
    print(f"Max: {stats['max_fps']}")
    print(f"Min: {stats['min_fps']}")
    return 0


def cmd_viewperf(args) -> int:
    from rtm_tpu.bench.view_perf import main as vp
    vp(args.file, plot=not args.no_plot, save=args.save)
    return 0


def cmd_scenes(args) -> int:
    from rtm_tpu.models.scenes import SCENES
    for sid, fn in sorted(SCENES.items()):
        doc = (fn.__doc__ or "").splitlines()[0]
        print(f"{sid}: {doc}")
    return 0


def cmd_view(args) -> int:
    from rtm_tpu.runtime.renderer import ProgressiveRenderer
    from rtm_tpu.viewer import ViewerServer

    import dataclasses

    scene, cam, cfg, backend, host = _setup(args, want_host_scene=True)
    cfg = dataclasses.replace(cfg, accumulate=True)   # progressive viewer
    renderer = ProgressiveRenderer(scene, cam, cfg)
    server = ViewerServer(renderer, port=args.port, host_scene=host,
                          scene_id=args.scene)
    print(f"viewer: http://127.0.0.1:{server.port}  (Ctrl-C to stop)")
    server.start(block=True)
    return 0


def cmd_save_scene(args) -> int:
    """Export a built-in scene to the .rtm.json format (editable, reloadable
    via --scene-file on any command)."""
    from rtm_tpu import Camera, load_scene
    from rtm_tpu.io.scene_io import save_scene

    host = load_scene(args.scene)
    path = save_scene(args.out, host, camera=Camera())
    print(f"wrote {path}")
    return 0


def cmd_optimize(args) -> int:
    """Self-demo of BASELINE config 5: render a target with the true scene,
    perturb the material parameters, recover them by Adam descent."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtm_tpu.diff.inverse import InverseRenderConfig, inverse_render
    from rtm_tpu.diff.params import apply_params, extract_params
    from rtm_tpu.io.image import save_png
    from rtm_tpu.ops.trace_ref import render_dispatch

    scene, cam, cfg, backend = _setup(args)
    spec = cam.spec(cfg.width, cfg.height)
    target = render_dispatch(scene, spec, jnp.uint32(1), cfg)
    true_params = extract_params(scene)
    init = jax.tree.map(
        lambda x: x * 0.7 + 0.1 if x.dtype == jnp.float32 else x,
        true_params)
    opt_cfg = InverseRenderConfig(steps=args.steps,
                                  learning_rate=args.lr)
    params, losses = inverse_render(scene, spec, target, cfg, opt_cfg,
                                    init_params=init)
    print(f"optimize: loss {losses[0]:.6f} -> {losses[-1]:.6f} "
          f"({args.steps} steps)")
    if args.out:
        img = render_dispatch(apply_params(scene, params), spec,
                              jnp.uint32(1), cfg)
        save_png(args.out, np.asarray(img)[::-1])
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="rtm_tpu",
        description="differentiable progressive path tracer")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render a scene to PNG")
    _add_render_args(p)
    p.add_argument("--out", default="render.png")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("bench", help="headline throughput (one JSON line)")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("measure", help="orbit perf sweep -> Measure.txt")
    _add_render_args(p)
    p.add_argument("--out", default="Measure.txt")
    p.add_argument("--radius", type=float, default=2.0)
    p.set_defaults(fn=cmd_measure)

    p = sub.add_parser("viewperf", help="summarize/plot Measure.txt")
    p.add_argument("file", nargs="?", default="Measure.txt")
    p.add_argument("--no-plot", action="store_true")
    p.add_argument("--save", default=None, help="save plot PNG")
    p.set_defaults(fn=cmd_viewperf)

    p = sub.add_parser("scenes", help="list built-in scenes")
    p.set_defaults(fn=cmd_scenes)

    p = sub.add_parser("save-scene", help="export a scene to .rtm.json")
    p.add_argument("--scene", type=int, default=3)
    p.add_argument("--out", default="scene.rtm.json")
    p.set_defaults(fn=cmd_save_scene)

    p = sub.add_parser("view", help="interactive browser viewer")
    _add_render_args(p)
    p.add_argument("--port", type=int, default=8654)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("optimize", help="inverse-rendering demo")
    _add_render_args(p)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_optimize)

    args = parser.parse_args(argv)
    from rtm_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
