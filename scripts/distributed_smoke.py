"""Two-process jax.distributed smoke test (CPU backend).

Exercises parallel/distributed.initialize_distributed for real: spawns two
worker processes, each with 4 virtual CPU devices, forms the 8-device
global mesh, and runs (a) a cross-process psum and (b) one sharded render
step over the global mesh, asserting both.

This is the multi-host bring-up path (SURVEY.md §5.8) that a multi-host
cluster uses — same code, bigger mesh; only the transport differs (gRPC
here, NCCL between GPUs).

Run: python scripts/distributed_smoke.py            (parent; spawns workers)
"""
from __future__ import annotations

import os
import subprocess
import sys

NPROC = 2
LOCAL_DEVICES = 4
PORT = int(os.environ.get("RTM_SMOKE_PORT", 9377))


def worker(pid: int) -> int:
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}")
    import jax
    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from rtm_tpu.parallel.distributed import initialize_distributed

    ok = initialize_distributed(coordinator_address=f"127.0.0.1:{PORT}",
                                num_processes=NPROC, process_id=pid)
    assert ok, "initialize_distributed returned False"
    assert jax.process_count() == NPROC
    assert jax.device_count() == NPROC * LOCAL_DEVICES

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from rtm_tpu.parallel.sharding import DP_AXIS

    mesh = Mesh(np.array(jax.devices()), (DP_AXIS,))

    # (a) cross-process psum: every device contributes its global index
    local = jnp.arange(LOCAL_DEVICES, dtype=jnp.float32) \
        + pid * LOCAL_DEVICES
    garr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(DP_AXIS)), np.asarray(local))

    @jax.jit
    def total(x):
        return jax.shard_map(
            lambda v: jax.lax.psum(jnp.sum(v), DP_AXIS),
            mesh=mesh, in_specs=P(DP_AXIS), out_specs=P())(x)

    got = float(total(garr))
    want = sum(range(NPROC * LOCAL_DEVICES))
    assert got == want, (got, want)

    # (b) one sharded render dispatch over the global mesh
    from rtm_tpu import Camera, RenderConfig, build_tracer_scene, load_scene
    from rtm_tpu.parallel.sharding import render_sharded

    cfg = RenderConfig(width=32, height=32, max_bounces=2, max_frames=1,
                       draw_environment=True)
    scene = build_tracer_scene(load_scene(1))
    cam = Camera().spec(cfg.width, cfg.height)
    img = render_sharded(scene, cam, jnp.uint32(1), cfg, mesh)
    val = float(jnp.mean(jax.lax.with_sharding_constraint(
        img, NamedSharding(mesh, P()))))
    assert np.isfinite(val)
    print(f"[worker {pid}] psum ok ({got}) render ok (mean {val:.6f})",
          flush=True)
    return 0


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        return worker(int(sys.argv[2]))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--worker", str(pid)])
             for pid in range(NPROC)]
    rc = 0
    for p in procs:
        rc |= p.wait()
    print("distributed smoke:", "PASS" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    sys.exit(main())
