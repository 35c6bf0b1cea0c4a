"""Multi-device execution: pixel-grid data parallelism over a device mesh.

The reference is a single-process, single-GPU program whose only parallelism
is SIMT over pixels in 8x8 workgroups (ref: RayTracing.shader:13,675-679;
Engine/src/External/Render/Vulkan/VulkanPipeline.cpp:162-168).  This build
promotes that implicit axis to a first-class sharded one (SURVEY.md §2.1):

  * the pixel grid is block-sharded across devices over a 1-D mesh axis "dp"
    (each device traces a contiguous row band);
  * the scene pytree is tiny (KB-MB) and fully replicated;
  * forward needs NO collectives; the backward/inverse-rendering pass sums
    scene-parameter gradients across devices (the only cross-device
    traffic);
  * samples-per-pixel can be sharded instead (render_sharded_spp: each
    device traces all pixels with a disjoint seed stream, radiance is
    psum-averaged)
    — the analog the reference's MaxFrames loop (shader:695) scaled out.

Everything here is `jax.shard_map` over `jax.sharding.Mesh`, so the same
code runs on the GPUs of one host, on multi-host via `jax.distributed`
(see .distributed), and on the CPU fake-multi-device mesh used by tests.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from ..diff.params import SceneParams, apply_params
from ..models.camera import CameraSpec
from ..models.scene import TracerScene
from ..ops.trace_ref import pixel_grid, render_pixels, resolve_backend

DP_AXIS = "dp"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D data-parallel mesh over (the first n) available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (DP_AXIS,))


def _padded_grid(cfg: RenderConfig, n_dev: int):
    """Row-major pixel ids padded so each device gets an equal block.

    Returns (x, y, mask, n_real) with shapes (Np,), Np % n_dev == 0; padded
    lanes point at pixel (0,0) with mask 0.
    """
    x, y = pixel_grid(cfg.width, cfg.height)
    n = cfg.num_pixels
    pad = (-n) % n_dev
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,), jnp.int32)])
        y = jnp.concatenate([y, jnp.zeros((pad,), jnp.int32)])
    mask = (jnp.arange(n + pad) < n).astype(jnp.float32)
    return x, y, mask, n


@partial(jax.jit, static_argnames=("cfg", "mesh", "chunk", "backend"))
def render_sharded(scene: TracerScene, cam: CameraSpec, frame_index,
                   cfg: RenderConfig, mesh: Mesh, chunk: int = 512,
                   backend: str = "auto"):
    """One full-frame dispatch with the pixel grid sharded over mesh axis
    "dp".  Scene replicated; no collectives in the forward pass.  Returns
    (H, W, 3) f32 radiance (same contract as ops.trace_ref.render_dispatch).
    """
    backend = resolve_backend(backend)
    frame_index = jnp.asarray(frame_index, jnp.uint32)
    x, y, _, n = _padded_grid(cfg, mesh.shape[DP_AXIS])

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(), P(), P(DP_AXIS), P(DP_AXIS)),
             out_specs=P(DP_AXIS), check_vma=False)
    def shard_fn(scene, cam, fi, xs, ys):
        # check_vma=False: the Pallas interpreter (the Triton sweep's test
        # mode) cannot evaluate its kernel under shard_map's varying-axes
        # type checks; the compiled kernel runs the same way
        return render_pixels(scene, cam, xs, ys, fi, cfg, chunk=chunk,
                             backend=backend)

    out = shard_fn(scene, cam, frame_index, x, y)
    return out[:n].reshape(cfg.height, cfg.width, 3)


@partial(jax.jit, static_argnames=("cfg", "mesh", "chunk", "backend"))
def render_sharded_spp(scene: TracerScene, cam: CameraSpec, frame_index,
                       cfg: RenderConfig, mesh: Mesh, chunk: int = 512,
                       backend: str = "auto"):
    """Sample-axis sharding: every device traces the FULL pixel grid with a
    disjoint accumulation-frame seed stream (frame_index offset by device
    rank, matching the seed schedule shader:697), and radiance is
    psum-averaged.  Total samples = n_dev * cfg.max_frames.  Use when spp
    is large and the pixel grid is small (SURVEY.md §5.7).
    """
    backend = resolve_backend(backend)
    x, y = pixel_grid(cfg.width, cfg.height)
    frame_index = jnp.asarray(frame_index, jnp.uint32)
    n_dev = mesh.shape[DP_AXIS]

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(), P(), P(), P()), out_specs=P())
    def shard_fn(scene, cam, fi, xs, ys):
        rank = jax.lax.axis_index(DP_AXIS).astype(jnp.uint32)
        # mark the (replicated) pixel grid device-varying: the per-rank seed
        # stream makes every downstream value varying and scan carries must
        # typecheck uniformly
        xs = jax.lax.pvary(xs, (DP_AXIS,))
        ys = jax.lax.pvary(ys, (DP_AXIS,))
        # disjoint seed stream per device: stride the frame counter
        local = render_pixels(scene, cam, xs, ys,
                              fi + rank * jnp.uint32(7919), cfg,
                              chunk=chunk, backend=backend)
        return jax.lax.pmean(local, DP_AXIS)

    out = shard_fn(scene, cam, frame_index, x, y)
    return out.reshape(cfg.height, cfg.width, 3)


@partial(jax.jit, static_argnames=("cfg", "mesh", "chunk", "backend", "remat",
                                   "rebuild_tri_geometry"))
def sharded_loss_and_grad(params: SceneParams, scene: TracerScene,
                          cam: CameraSpec, target, frame_index,
                          cfg: RenderConfig, mesh: Mesh, chunk: int = 512,
                          backend: str = "auto", remat: bool = True,
                          rebuild_tri_geometry: bool = True):
    """Distributed inverse-rendering loss+grad: pixels sharded over "dp",
    per-device pixel-L2 partial loss and scene-parameter grads summed
    across devices (one all-reduce, the one collective of the whole
    framework — SURVEY.md §5.8).  Numerically identical to
    diff.inverse.render_loss: loss = mean over (H*W*3) of squared error.
    """
    backend = resolve_backend(backend)
    frame_index = jnp.asarray(frame_index, jnp.uint32)
    x, y, mask, n = _padded_grid(cfg, mesh.shape[DP_AXIS])
    denom = jnp.float32(n * 3)
    tgt = target.reshape(-1, 3)
    pad = x.shape[0] - n
    if pad:
        tgt = jnp.concatenate([tgt, jnp.zeros((pad, 3), jnp.float32)])

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(), P(), P(DP_AXIS), P(DP_AXIS), P(DP_AXIS),
                       P(DP_AXIS), P()),
             out_specs=(P(DP_AXIS), P(DP_AXIS)), check_vma=False)
    def shard_fn(params, scene, cam, xs, ys, t, m, fi):
        def local_loss(p):
            full = apply_params(scene, p, rebuild_tri_geometry)
            img = render_pixels(full, cam, xs, ys, fi, cfg, chunk=chunk,
                                backend=backend, remat=remat)
            return jnp.sum(m[:, None] * (img - t) ** 2) / denom

        # each device differentiates its own band's partial loss; the
        # (loss, grads) are summed outside, which XLA lowers to one
        # all-reduce.  (Under check_vma=False, as in render_sharded, a psum
        # inside the differentiated function would count the replicated-
        # parameter cotangents n_dev times.)
        l, g = jax.value_and_grad(local_loss)(params)
        return l[None], jax.tree.map(lambda x: x[None], g)

    losses, grads = shard_fn(params, scene, cam, x, y, tgt, mask,
                             frame_index)
    return (jnp.sum(losses),
            jax.tree.map(lambda x: jnp.sum(x, axis=0), grads))


def make_train_step(scene: TracerScene, cam: CameraSpec, target,
                    cfg: RenderConfig, mesh: Mesh, optimizer,
                    chunk: int = 512, backend: str = "auto",
                    remat: bool = True, rebuild_tri_geometry: bool = True):
    """Build the jitted multi-device inverse-rendering train step:
    (params, opt_state, frame_index) -> (params, opt_state, loss).

    __graft_entry__.dryrun_multichip runs this step over an n-device mesh.
    """
    import optax

    @jax.jit
    def train_step(params, opt_state, frame_index):
        loss, grads = sharded_loss_and_grad(
            params, scene, cam, target, frame_index, cfg, mesh,
            chunk=chunk, backend=backend, remat=remat,
            rebuild_tri_geometry=rebuild_tri_geometry)
        updates, opt_state = optimizer.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step
