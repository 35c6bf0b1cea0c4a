"""Inverse rendering: recover scene parameters from a target image.

BASELINE config 5: "recover sphere albedo/position + light emission from
target image via pixel-gradient descent".  The loss is pixel L2 between a
rendered frame and the target; gradients flow through the full bounce scan
(with optional per-bounce rematerialization) and the optimizer is Adam
(optax).  The same `loss_and_grad` is what the multi-chip training step
shards over the pixel grid (parallel/sharding.py) with a psum over
parameter gradients.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import optax

from ..config import RenderConfig
from ..models.camera import CameraSpec
from ..models.scene import TracerScene
from ..ops.trace_ref import render_dispatch, resolve_backend
from .params import SceneParams, apply_params, extract_params


@partial(jax.jit, static_argnames=("cfg", "backend", "remat",
                                   "rebuild_tri_geometry", "soft_tau"))
def render_loss(params: SceneParams, scene: TracerScene, cam: CameraSpec,
                target, frame_index, cfg: RenderConfig, backend: str = "auto",
                remat: bool = True, rebuild_tri_geometry: bool = True,
                soft_tau: float = 0.0):
    """Mean squared pixel error of a single dispatch against `target`.

    backend: as render_dispatch.  With the Triton sweep the hit topology
    comes from the kernel and every hit value is recomputed differentiably
    from it (ops/trace_ref.bounce_payload), the same detached-topology
    gradient the XLA sweep gives.
    soft_tau > 0 enables soft primary visibility (diff/silhouette.py):
    geometry gradients pick up the silhouette edge term the detached
    argmin drops, at the cost of a ~tau-wide soft edge band in the loss.
    """
    backend = resolve_backend(backend)
    full = apply_params(scene, params, rebuild_tri_geometry)
    if soft_tau > 0.0:
        from ..ops.trace_ref import pixel_grid
        from .silhouette import render_soft_primary
        x, y = pixel_grid(cfg.width, cfg.height)
        img = render_soft_primary(full, cam, x, y, frame_index, cfg,
                                  tau=soft_tau, backend=backend,
                                  remat=remat)
        img = img.reshape(cfg.height, cfg.width, 3)
    else:
        img = render_dispatch(full, cam, frame_index, cfg, backend=backend,
                              remat=remat)
    return jnp.mean((img - target) ** 2)


loss_and_grad = jax.jit(
    jax.value_and_grad(render_loss),
    static_argnames=("cfg", "backend", "remat", "rebuild_tri_geometry",
                     "soft_tau"))


@dataclass(frozen=True)
class InverseRenderConfig:
    steps: int = 100
    learning_rate: float = 2e-2
    remat: bool = True
    backend: str = "auto"
    rebuild_tri_geometry: bool = True
    vary_seed: bool = True   # new RNG stream per step (stochastic gradients)


def inverse_render(scene: TracerScene, cam: CameraSpec, target,
                   cfg: RenderConfig, opt_cfg: InverseRenderConfig,
                   init_params: SceneParams | None = None,
                   param_mask=None, callback=None):
    """Adam descent on scene parameters toward `target`.

    param_mask: optional SceneParams of 0/1 floats freezing entries (grads
    are multiplied by it) — e.g. optimize only one sphere's position.
    Returns (final SceneParams, list of losses).
    """
    params = init_params if init_params is not None else extract_params(scene)
    opt = optax.adam(opt_cfg.learning_rate)
    opt_state = opt.init(params)
    losses = []

    @partial(jax.jit, static_argnames=())
    def step(params, opt_state, frame_index):
        loss, grads = loss_and_grad(params, scene, cam, target, frame_index,
                                    cfg, opt_cfg.backend, opt_cfg.remat,
                                    opt_cfg.rebuild_tri_geometry)
        if param_mask is not None:
            grads = jax.tree.map(lambda g, m: g * m, grads, param_mask)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    for i in range(opt_cfg.steps):
        fi = jnp.uint32(1 + (i if opt_cfg.vary_seed else 0))
        params, opt_state, loss = step(params, opt_state, fi)
        losses.append(float(loss))
        if callback is not None:
            callback(i, losses[-1], params)
    return params, losses
