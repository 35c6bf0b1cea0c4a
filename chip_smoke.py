"""Smoke run of the tracer on one NVIDIA GPU, through the normal entry points.

    python chip_smoke.py          # one GPU: phases 1-5 below
    python chip_smoke.py --four   # four GPUs: the sharded paths only

Phases (each prints one line; any failure ends the run with a non-zero exit
code and no result line):

  1. device: JAX must find a GPU (no CPU fallback); prints the card's name
     and power limit, the JAX version and XLA_FLAGS;
  2. forward: scenes 3 and 2 at 512x512, 8 bounces, 16 progressive frames
     through render_progressive(backend="auto") must be finite, and the
     same render at 128x128 must match the XLA sweep on the CPU device of
     this process (images_close);
  3. kernel: the Triton sweep against nearest_triangle (the plain XLA
     reference) on the GPU, 262,144 camera rays of scene 3 against four
     triangle sets;
  4. gradient: loss_and_grad on scene 3 at 256x256 plus one Adam step, and
     the gradients of scene 3 (8 bounces) and scene 2 (2 bounces) at 64x64,
     triangle vertices and spheres included, against the CPU's;
  5. timing (information only): median ms per frame and per sweep, XLA
     sweep against the Triton sweep.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

W = 512                 # headline width and height
BOUNCES = 8
FRAMES = 16
REF_W = 128             # GPU-vs-CPU comparison size
# images_close defaults (tests/conftest.py): mean |diff| <= 5e-3, at most
# 1% of pixels beyond 2e-2, at most 0.3% beyond 0.2 (chaotic paths)
IMG_TOL = dict(tol=2e-2, frac_bad=0.01, outlier_frac=0.003, mean_tol=5e-3)
# kernel against reference: at least 99.99% equal indices; a mismatch must
# be a near-tie in t or a ray within f32 rounding of an edge of one pick
IDX_EQ_MIN = 0.9999
TIE_RTOL = 1e-5
EDGE_BARY = 1e-4
# t of the same triangle: f32 t = (O.n - A.n) / (-D.n) cancels on grazing
# rays, so 1e-5 holds for 99.99% of rays and 1e-4 for every ray
T_RTOL, T_RTOL_MAX = 1e-5, 1e-4
# gradients, GPU (Triton sweep) against CPU (XLA sweep): per-leaf
# |g_gpu - g_cpu| / |g_cpu| (2-norms); a few chaotic paths flip hit/miss
# between two f32 implementations and move a leaf's gradient slightly
GRAD_RTOL = 1e-2
# (scene, bounces) compared.  Scene 2's glass sphere makes deep paths
# chaotic: at 8 bounces a handful of paths diverge between any two f32
# implementations (the XLA sweep on the GPU against the CPU included) and
# their gradient spikes move whole leaves by 1e-2 to 1e2, so scene 2 is
# compared at 2 bounces, before the glass paths can diverge.
GRAD_SCENES = ((3, BOUNCES), (2, 2))
# metallic only scales the specular jitter, which is weighted by roughness;
# every non-glass material of scenes 3 and 2 has roughness 0, so its
# gradient is zero on both sides.  Every other non-empty leaf must be
# non-zero on the CPU, so that the comparison compares something.
ZERO_GRAD_LEAVES = {"metallic"}


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_phase(count):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"no GPU: JAX found {devs[0].platform} devices")
    if len(devs) < count:
        fail(f"{count} GPUs needed, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    for line in smi[:count]:
        print(line, flush=True)
    phase("device", f"{len(devs)} x {devs[0].device_kind}; jax "
          f"{jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return devs


def _scene(sid):
    from rtm_tpu import build_tracer_scene, load_scene
    return build_tracer_scene(load_scene(sid))


def forward_phase(cpu):
    import jax
    import jax.numpy as jnp

    from rtm_tpu import Camera, RenderConfig
    from rtm_tpu.runtime.renderer import render_progressive
    from rtm_tpu.utils.compare import images_close

    for sid in (3, 2):
        scene = _scene(sid)
        cfg = RenderConfig(width=W, height=W, max_bounces=BOUNCES,
                           draw_environment=True, accumulate=True)
        t0 = time.perf_counter()
        img = np.asarray(render_progressive(scene, Camera().spec(W, W), cfg,
                                            FRAMES, backend="auto"))
        secs = time.perf_counter() - t0
        if not np.isfinite(img).all():
            fail(f"scene {sid}: non-finite pixels at {W}x{W}")
        small = RenderConfig(width=REF_W, height=REF_W,
                             max_bounces=BOUNCES, draw_environment=True,
                             accumulate=True)
        cam = Camera().spec(REF_W, REF_W)
        gpu = np.asarray(render_progressive(scene, cam, small, FRAMES,
                                            backend="auto"))
        with jax.default_device(cpu):
            ref = np.asarray(render_progressive(
                jax.device_put(scene, cpu), jax.device_put(cam, cpu),
                small, jnp.int32(FRAMES), backend="xla"))
        diff = np.abs(gpu - ref).max(axis=-1)
        images_close(gpu, ref, **IMG_TOL)
        phase("forward", f"scene {sid} {W}x{W} x{BOUNCES} bounces x{FRAMES} "
              f"frames finite (first call {secs:.1f} s, mean {img.mean():.4f}); "
              f"{REF_W}x{REF_W} GPU vs CPU: mean|d| {diff.mean():.2e}, "
              f">{IMG_TOL['tol']}: {np.mean(diff > IMG_TOL['tol']):.2%}, "
              f">0.2: {np.mean(diff > 0.2):.2%} (limits {IMG_TOL})")


def camera_rays(width):
    from rtm_tpu import Camera, RenderConfig
    from rtm_tpu.ops.intersect import normalize
    from rtm_tpu.ops.trace_ref import camera_ray_basis
    cfg = RenderConfig(width=width, height=width)
    focus, _, _, pos = camera_ray_basis(Camera().spec(width, width), cfg)
    d = normalize(focus - pos)
    return np.broadcast_to(np.asarray(pos), d.shape).copy(), np.asarray(d)


def triangle_sets():
    from rtm_tpu.models.scenes import dragon_grid
    from rtm_tpu import build_tracer_scene
    s3 = _scene(3)
    g6 = build_tracer_scene(dragon_grid(6))
    lo = np.asarray(s3.tri_wa).min(0)
    hi = np.asarray(s3.tri_wa).max(0)

    def soup(n, seed):
        # seeded triangles filling scene 3's box, edges ~2 box widths/sqrt(n)
        rs = np.random.RandomState(seed)
        a = (lo + rs.rand(n, 3) * (hi - lo)).astype(np.float32)
        e = (hi - lo).max() * 2.0 / np.sqrt(n)
        return (a, (a + rs.randn(n, 3) * e).astype(np.float32),
                (a + rs.randn(n, 3) * e).astype(np.float32))

    def tris(sc):
        return tuple(np.asarray(x) for x in (sc.tri_wa, sc.tri_wb, sc.tri_wc))

    return {"scene3": tris(s3), "dragon_grid6": tris(g6),
            "soup2048": soup(2048, 0), "soup65536": soup(65536, 1)}


def _bary_margin(o, d, a, b, c, idx):
    """f64 smallest barycentric coordinate of each ray against triangle idx
    (inf where idx < 0)."""
    out = np.full(len(idx), np.inf)
    k = idx >= 0
    if not k.any():
        return out
    o, d = o[k].astype(np.float64), d[k].astype(np.float64)
    a, b, c = (x[idx[k]].astype(np.float64) for x in (a, b, c))
    ab, ac = b - a, c - a
    n = np.cross(ab, ac)
    det = -np.sum(d * n, -1)
    ao = o - a
    dao = np.cross(ao, d)
    u = np.sum(ac * dao, -1) / det
    v = -np.sum(ab * dao, -1) / det
    out[k] = np.abs(np.minimum(np.minimum(u, v), 1.0 - u - v))
    return out


def kernel_phase():
    import jax
    import jax.numpy as jnp

    from rtm_tpu.ops.intersect import TriFeatures, nearest_triangle
    from rtm_tpu.ops.pallas.intersect_kernel import nearest_triangle_triton

    o, d = camera_rays(W)
    ref_fn = jax.jit(lambda o, d, a, b, c: nearest_triangle(
        o, d, TriFeatures.build(a, b, c)))
    for name, (a, b, c) in triangle_sets().items():
        t_k, i_k = (np.asarray(x) for x in nearest_triangle_triton(
            jnp.asarray(o), jnp.asarray(d), *map(jnp.asarray, (a, b, c))))
        t_r, i_r = (np.asarray(x) for x in ref_fn(
            jnp.asarray(o), jnp.asarray(d), *map(jnp.asarray, (a, b, c))))
        mism = i_k != i_r
        eq = 1.0 - mism.mean()
        tie = np.abs(t_k - t_r) <= TIE_RTOL * np.abs(t_r)
        edge = np.minimum(_bary_margin(o, d, a, b, c, np.where(mism, i_k, -1)),
                          _bary_margin(o, d, a, b, c, np.where(mism, i_r, -1)))
        unexplained = int((mism & ~tie & ~(edge <= EDGE_BARY)).sum())
        same = ~mism & (i_r >= 0)
        rel = np.abs(t_k[same] - t_r[same]) / np.abs(t_r[same])
        within = float(np.mean(rel <= T_RTOL)) if same.any() else 1.0
        rel_max = float(rel.max()) if same.any() else 0.0
        phase("kernel", f"{name}: {len(a)} tris x {len(o)} rays, hits "
              f"{np.mean(i_r >= 0):.1%}; equal idx {eq:.6%} "
              f"(min {IDX_EQ_MIN:.2%}), mismatches {int(mism.sum())}: "
              f"near-tie {int((mism & tie).sum())}, near-edge "
              f"{int((mism & ~tie & (edge <= EDGE_BARY)).sum())}, "
              f"unexplained {unexplained}; t rtol<={T_RTOL}: {within:.4%}, "
              f"max {rel_max:.2e} (limit {T_RTOL_MAX}); precision: f32 both, "
              f"kernel elementwise FMA, reference Precision.HIGHEST")
        if eq < IDX_EQ_MIN or unexplained or within < IDX_EQ_MIN \
                or rel_max > T_RTOL_MAX:
            fail(f"kernel against reference on {name}")


def _grad_rel(g, g_ref):
    out = {}
    for k in vars(g_ref):
        a = np.asarray(getattr(g, k), np.float64).ravel()
        b = np.asarray(getattr(g_ref, k), np.float64).ravel()
        nb = np.linalg.norm(b)
        out[k] = np.linalg.norm(a - b) / nb if nb > 0 else \
            np.linalg.norm(a)
    return out


def _moved(before, after):
    """How many parameter arrays an optimizer step changed."""
    import jax
    return sum(int(np.any(np.asarray(a) != np.asarray(b)))
               for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(after)))


def _grad_setup(width, bounces=BOUNCES):
    import jax.numpy as jnp

    from rtm_tpu import Camera, RenderConfig
    cfg = RenderConfig(width=width, height=width, max_bounces=bounces,
                       draw_environment=True)
    return (cfg, Camera().spec(width, width),
            jnp.full((width, width, 3), 0.3, jnp.float32))


def gradient_phase(cpu):
    import jax
    import jax.numpy as jnp

    from rtm_tpu.diff import InverseRenderConfig, extract_params, \
        inverse_render
    from rtm_tpu.diff.inverse import loss_and_grad

    scene = _scene(3)
    params = extract_params(scene)
    cfg, cam, target = _grad_setup(256)
    loss, g = loss_and_grad(params, scene, cam, target, jnp.uint32(1), cfg,
                            "auto", True, True)
    leaves = [np.asarray(x) for x in jax.tree.leaves(g)]
    if not (np.isfinite(float(loss))
            and all(np.isfinite(x).all() for x in leaves)):
        fail("non-finite loss or gradient at 256x256")
    new, losses = inverse_render(
        scene, cam, target, cfg,
        InverseRenderConfig(steps=1, learning_rate=1e-2))
    moved = _moved(params, new)
    if not moved:
        fail("the Adam step moved no parameter")
    phase("gradient", f"scene 3 256x256 x{BOUNCES}: loss {float(loss):.6f} "
          f"finite, |g| {np.sqrt(sum(float((x * x).sum()) for x in leaves)):.4e}; "
          f"Adam step moved {moved} of {len(leaves)} parameter arrays "
          f"(loss {losses[0]:.6f})")

    for sid, bounces in GRAD_SCENES:
        cfg, cam, target = _grad_setup(64, bounces)
        scene = _scene(sid)
        params = extract_params(scene)
        _, g = loss_and_grad(params, scene, cam, target, jnp.uint32(1), cfg,
                             "auto", True, True)
        with jax.default_device(cpu):
            _, g_cpu = loss_and_grad(
                jax.device_put(params, cpu), jax.device_put(scene, cpu),
                jax.device_put(cam, cpu), jax.device_put(target, cpu),
                jnp.uint32(1), cfg, "xla", True, True)
        compared = [k for k, v in vars(g_cpu).items()
                    if np.size(v) and k not in ZERO_GRAD_LEAVES]
        zero = [k for k in compared if not np.any(np.asarray(getattr(g_cpu, k)))]
        rel = {k: v for k, v in _grad_rel(g, g_cpu).items() if k in compared}
        worst = max(rel, key=rel.get)
        phase("gradient", f"scene {sid} 64x64 x{bounces} GPU (auto) vs CPU "
              f"(xla), "
              f"{len(compared)} leaves: worst {worst} rel {rel[worst]:.2e} "
              f"(limit {GRAD_RTOL}); "
              + ", ".join(f"{k} {v:.1e}" for k, v in rel.items()))
        if zero:
            fail(f"scene {sid}: zero CPU gradient for {zero}")
        if rel[worst] > GRAD_RTOL:
            fail(f"scene {sid}: GPU gradient differs from the CPU's")


def _median_ms(f, *args, n=20):
    import jax
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def timing_phase(kind):
    import jax
    import jax.numpy as jnp

    from rtm_tpu import Camera, RenderConfig
    from rtm_tpu.ops.intersect import TriFeatures, nearest_triangle
    from rtm_tpu.ops.pallas.intersect_kernel import nearest_triangle_triton
    from rtm_tpu.ops.trace_ref import render_dispatch

    scene = _scene(3)
    cfg = RenderConfig(width=W, height=W, max_bounces=BOUNCES,
                       draw_environment=True)
    cam = Camera().spec(W, W)
    o, d = (jnp.asarray(x) for x in camera_rays(W))
    tris = (scene.tri_wa, scene.tri_wb, scene.tri_wc)
    sweeps = {
        "xla": jax.jit(lambda o, d, a, b, c: nearest_triangle(
            o, d, TriFeatures.build(a, b, c))),
        "triton": jax.jit(nearest_triangle_triton)}
    res = {}
    for be in ("xla", "triton", "triton", "xla"):
        frame = _median_ms(lambda fi: render_dispatch(scene, cam, fi, cfg,
                                                      backend=be),
                           jnp.uint32(2))
        sweep = _median_ms(sweeps[be], o, d, *tris)
        res.setdefault(be, []).append((frame, sweep))
    for be, rows in res.items():
        phase("timing", f"{kind}: scene 3 {W}x{W} x{BOUNCES} bounces, {be}: "
              f"frame ms {[round(r[0], 4) for r in rows]}, one sweep of "
              f"{W * W} rays ms {[round(r[1], 4) for r in rows]} "
              f"(medians of 20 after warm-up)")


def four_phase(devs):
    import jax
    import jax.numpy as jnp
    import optax

    from rtm_tpu import Camera, RenderConfig
    from rtm_tpu.diff.inverse import loss_and_grad
    from rtm_tpu.diff.params import extract_params
    from rtm_tpu.ops.trace_ref import render_dispatch
    from rtm_tpu.parallel.sharding import (make_mesh, make_train_step,
                                           render_sharded,
                                           sharded_loss_and_grad)
    from rtm_tpu.utils.compare import images_close

    mesh = make_mesh(4)
    scene = _scene(3)
    cfg = RenderConfig(width=W, height=W, max_bounces=BOUNCES,
                       draw_environment=True)
    cam = Camera().spec(W, W)
    with jax.default_device(devs[0]):
        ref = np.asarray(render_dispatch(scene, cam, jnp.uint32(1), cfg))
    out = np.asarray(render_sharded(scene, cam, jnp.uint32(1), cfg, mesh))
    diff = np.abs(out - ref).max(axis=-1)
    images_close(out, ref, **IMG_TOL)
    phase("four", f"render_sharded 4 x {devs[0].device_kind}, scene 3 "
          f"{W}x{W} x{BOUNCES}: vs one card mean|d| {diff.mean():.2e}, "
          f"max {diff.max():.2e} (limits {IMG_TOL})")

    gcfg, gcam, target = _grad_setup(256)
    params = extract_params(scene)
    with jax.default_device(devs[0]):
        l_ref, g_ref = loss_and_grad(params, scene, gcam, target,
                                     jnp.uint32(1), gcfg, "auto", True, True)
    l_sh, g_sh = sharded_loss_and_grad(params, scene, gcam, target,
                                       jnp.uint32(1), gcfg, mesh)
    ref_v = np.concatenate([np.asarray(x).ravel()
                            for x in jax.tree.leaves(g_ref)])
    sh_v = np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree.leaves(g_sh)])
    scale = float(sh_v @ ref_v) / float(ref_v @ ref_v)
    rel = _grad_rel(g_sh, g_ref)
    worst = max(rel, key=rel.get)
    opt = optax.adam(1e-2)
    step = make_train_step(scene, gcam, target, gcfg, mesh, opt)
    new, _, loss = step(params, opt.init(params), jnp.uint32(1))
    moved = _moved(params, new)
    phase("four", f"sharded grads 256x256: loss {float(l_sh):.6f} vs one "
          f"card {float(l_ref):.6f}; grad scale {scale:.5f} (within 1%), "
          f"worst leaf {worst} rel {rel[worst]:.2e} (limit {GRAD_RTOL}); "
          f"train step loss {float(loss):.6f}, moved {moved} arrays")
    if not (abs(scale - 1.0) < 0.01 and rel[worst] <= GRAD_RTOL
            and np.isclose(float(l_sh), float(l_ref), rtol=1e-4)
            and np.isfinite(float(loss)) and moved):
        fail("sharded gradients differ from one card's")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded paths")
    args = ap.parse_args()
    count = 4 if args.four else 1

    import jax

    from rtm_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    devs = device_phase(count)
    if args.four:
        four_phase(devs)
    else:
        cpu = jax.devices("cpu")[0]
        forward_phase(cpu)
        kernel_phase()
        gradient_phase(cpu)
        timing_phase(devs[0].device_kind)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}), flush=True)


if __name__ == "__main__":
    main()
