"""The renderer: camera ray generation + progressive path tracing dispatch.

This re-expresses the reference's compute megakernel main/traceRay
(RayTracing.shader:651-722) as array code: every pixel is a lane of dense
(N,...) arrays, the bounce recursion is a `lax.scan`, SIMT branch divergence
is masked selects, and per-thread RNG streams are reproduced bit-exactly
(ops/rng.py).  One call = one dispatch = `MaxFrames` samples per pixel,
returning radiance already divided by MaxFrames (shader:711); progressive
frame accumulation across dispatches lives in runtime/renderer.py.

The whole function is jit-compiled; it is also the differentiable path —
`jax.grad` flows through the scan (material gradients exactly; geometry
gradients with detached hit topology, see diff/).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..models.camera import CameraSpec
from ..models.scene import TracerScene
from . import rng
from .intersect import (FLT_MAX, TriFeatures, _mm, dot3, nearest_sphere,
                        nearest_triangle, normalize, safe_normalize)
from .shade import (env_radiance, flat_shade, sample_texture_quads, scatter,
                    sphere_uv)


def pixel_grid(width: int, height: int):
    """Row-major pixel ids: x (N,), y (N,) with N = W*H; image[y, x]."""
    n = width * height
    lin = jnp.arange(n, dtype=jnp.int32)
    return lin % width, lin // width


def camera_ray_basis(cam: CameraSpec, cfg: RenderConfig, x=None, y=None):
    """Per-pixel focus points + camera frame (shader:684-691).

    Returns (focus_point (N,3), right (3,), up (3,), position (3,)).
    pixelCoord = index/Resolution; coord = invP @ (2*(px,py,1,1)-1);
    direction = (invV @ (coord.xyz/coord.w, 0)).xyz * focusDistance.
    x/y: explicit pixel coordinates (defaults to the full cfg grid) — the
    sharded renderer passes per-device row bands here.
    """
    if x is None:
        x, y = pixel_grid(cfg.width, cfg.height)
    px = x.astype(jnp.float32) / jnp.float32(cfg.width)
    py = y.astype(jnp.float32) / jnp.float32(cfg.height)
    ndc = jnp.stack([2.0 * px - 1.0, 2.0 * py - 1.0,
                     jnp.ones_like(px), jnp.ones_like(px)], axis=-1)   # (N,4)
    coord = _mm(ndc, cam.inv_projection.T)                              # (N,4)
    c3 = coord[:, :3] / coord[:, 3:4]
    d4 = jnp.concatenate([c3, jnp.zeros_like(c3[:, :1])], axis=-1)
    direction = _mm(d4, cam.inv_view.T)[:, :3] * cam.focus_distance
    focus_point = cam.position[None, :] + direction
    right = cam.inv_view[:3, 0]
    up = cam.inv_view[:3, 1]
    return focus_point, right, up, cam.position


def _gather(arr, idx):
    return jnp.take(arr, idx, axis=0)


def _triangle_t_from_idx(scene: TracerScene, origin, direction, idx):
    """Differentiable hit distance for a known winning triangle.

    The Triton sweep returns only the argmin index (detached topology);
    the distance is recomputed here in XLA by gathering that triangle so
    that gradients flow to ray and vertex parameters (SURVEY.md Phase 4)."""
    ti = jnp.clip(idx, 0, scene.num_triangles - 1)
    a = _gather(scene.tri_wa, ti)
    b = _gather(scene.tri_wb, ti)
    c = _gather(scene.tri_wc, ti)
    n = jnp.cross(b - a, c - a)
    det = -dot3(direction, n)
    t = dot3(origin - a, n) / jnp.where(det == 0.0, 1.0, det)
    return jnp.where(idx >= 0, t, FLT_MAX)


# nearest-triangle search per bounce: the chunked XLA sweep, or the Triton
# kernel (ops/pallas/intersect_kernel.py); "triton_interpret" runs that
# kernel in the Pallas interpreter and is for tests off the GPU only
BACKENDS = ("xla", "triton", "triton_interpret")


def bounce_payload(scene: TracerScene, feats: TriFeatures, origin, direction,
                   chunk: int, backend: str = "xla"):
    """bounceRay + closestHit (shader:510-548, 235-283) over all lanes.

    Returns dict of per-lane hit data. Sphere wins distance ties (the
    reference checks triangles with strict `<` after spheres).
    backend: one of BACKENDS (the nearest-triangle search)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    t_s, i_s = nearest_sphere(origin, direction, scene.sph_pos, scene.sph_radius)
    if backend == "xla" or scene.num_triangles == 0:
        t_t, i_t = nearest_triangle(origin, direction, feats, chunk=chunk)
    else:
        from .pallas.intersect_kernel import nearest_triangle_triton
        _, i_t = nearest_triangle_triton(
            origin, direction, scene.tri_wa, scene.tri_wb, scene.tri_wc,
            interpret=(backend == "triton_interpret"))
        t_t = _triangle_t_from_idx(scene, origin, direction, i_t)
    use_tri = t_t < t_s
    t = jnp.where(use_tri, t_t, t_s)
    hit = t < FLT_MAX
    # masked lanes: FLT_MAX * direction overflows to inf and poisons grads
    t_safe = jnp.where(hit, t, 0.0)
    hit_pos = origin + t_safe[:, None] * direction

    n = origin.shape[0]
    if scene.num_spheres > 0:
        si = jnp.clip(i_s, 0, scene.num_spheres - 1)
        s_center = _gather(scene.sph_pos, si)
        s_normal = safe_normalize(hit_pos - s_center)
        s_u, s_v = sphere_uv(s_normal)
        s_mat = _gather(scene.sph_mat, si)
    else:
        s_normal = jnp.zeros((n, 3), jnp.float32)
        s_u = s_v = jnp.zeros((n,), jnp.float32)
        s_mat = jnp.zeros((n,), jnp.int32)

    if scene.num_triangles > 0:
        ti = jnp.clip(i_t, 0, scene.num_triangles - 1)
        t_normal = _gather(scene.tri_normal, ti)
        t_mat = _gather(scene.tri_mat, ti)
        # Reference UV quirk (shader:257-268): barycentrics from *world* ray
        # against *local* vertices/edges — reproduced exactly.
        la = _gather(scene.tri_la, ti)
        lab = _gather(scene.tri_lab, ti)
        lac = _gather(scene.tri_lac, ti)
        uvs = _gather(scene.tri_uv, ti)                  # (N,3,2)
        ao = origin - la
        dao = jnp.cross(ao, direction)
        nvec = jnp.cross(lab, lac)
        det = -dot3(direction, nvec)
        inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
        u = dot3(lac, dao) * inv_det
        v = -dot3(lab, dao) * inv_det
        w = 1.0 - u - v
        t_uv = uvs[:, 0] * w[:, None] + uvs[:, 1] * u[:, None] + uvs[:, 2] * v[:, None]
        t_u, t_v = t_uv[:, 0], t_uv[:, 1]
    else:
        t_normal = jnp.zeros((n, 3), jnp.float32)
        t_u = t_v = jnp.zeros((n,), jnp.float32)
        t_mat = jnp.zeros((n,), jnp.int32)

    use_tri3 = use_tri[:, None]
    return dict(
        t=t, hit=hit, hit_pos=hit_pos,
        normal=jnp.where(use_tri3, t_normal, s_normal),
        u=jnp.where(use_tri, t_u, s_u),
        v=jnp.where(use_tri, t_v, s_v),
        mat=jnp.where(use_tri, t_mat, s_mat),
    )


def shade_bounce(scene: TracerScene, cfg: RenderConfig, draw_env,
                 o, d, sd, color, contrib, alive, p):
    """Sky-on-miss, emission/texture accumulation and scatter for one bounce
    given its hit payload (shader:550-649 accumulateColor/scatter +
    :663-666 miss).  Returns the updated (o, d, sd, color, contrib, alive).
    """
    mats = scene.materials
    miss_now = alive & ~p["hit"]
    # miss -> sky (shader:663-666); quad-table row fetch.  Non-miss lanes
    # don't consume the sample, so their direction is masked to a constant
    # and their taps all land on one table row.
    d_sky = jnp.where(miss_now[:, None], d,
                      jnp.array([1.0, 0.0, 0.0], jnp.float32))
    sky = env_radiance(scene, d_sky)
    color = jnp.where(miss_now[:, None], color + sky * contrib * draw_env,
                      color)

    live = alive & p["hit"]
    m_rough = _gather(mats.roughness, p["mat"])
    m_metal = _gather(mats.metallic, p["mat"])
    m_refr = _gather(mats.refraction_ratio, p["mat"])
    m_albedo = _gather(mats.albedo, p["mat"])
    m_emc = _gather(mats.emission_color, p["mat"])
    m_emp = _gather(mats.emission_power, p["mat"])
    m_tex = _gather(mats.texture_id, p["mat"])

    no, nd, nsd = scatter(o, d, sd, p["hit_pos"], p["normal"],
                          m_rough, m_metal, m_refr)

    if cfg.max_bounces == 1:
        shade_val = flat_shade(m_albedo, p["normal"])       # shader:566-571
        color = jnp.where(live[:, None], shade_val, color)
    else:
        has_tex = m_tex >= 0
        # untextured lanes: collapse the (garbage-uv) tap onto row 0
        alb_tex = sample_texture_quads(
            scene.tex_quads, scene.tex_size,
            scene.textures.shape[1], scene.textures.shape[2],
            m_tex, jnp.where(has_tex, p["u"], 0.0),
            jnp.where(has_tex, p["v"], 0.0))
        emis = jnp.where(has_tex[:, None],
                         alb_tex * m_emp[:, None],
                         m_emc * m_emp[:, None])            # shader:575-585
        albedo = jnp.where(has_tex[:, None], alb_tex, m_albedo)
        color = jnp.where(live[:, None], color + emis * contrib, color)
        contrib = jnp.where(live[:, None], contrib * albedo, contrib)

    o = jnp.where(live[:, None], no, o)
    d = jnp.where(live[:, None], nd, d)
    sd = jnp.where(live, nsd, sd)
    return o, d, sd, color, contrib, live


def render_pixels(scene: TracerScene, cam: CameraSpec, x, y, frame_index,
                  cfg: RenderConfig, chunk: int = 512, backend: str = "xla",
                  remat: bool = False):
    """Trace an arbitrary set of pixels (x, y): the core dispatch.

    This is the unit both the full-frame renderer and the multi-device
    sharded renderer build on (each device traces its row band).  `remat`
    rematerializes each bounce in the backward pass instead of storing all
    per-bounce residuals — the 'long-context memory' treatment of the bounce
    scan (SURVEY.md §5.7, hard part #3).  backend: one of BACKENDS.
    Returns (N, 3) radiance averaged over cfg.max_frames samples.
    """
    feats = TriFeatures.build(scene.tri_wa, scene.tri_wb, scene.tri_wc)
    focus_point, right, up, position = camera_ray_basis(cam, cfg, x, y)
    n = x.shape[0]
    frame_index = jnp.asarray(frame_index, jnp.uint32)

    draw_env = jnp.float32(1.0 if cfg.draw_environment else 0.0)
    res = jnp.array([cfg.width, cfg.height], jnp.float32)

    def bounce(carry, i):
        o, d, sd, color, contrib, alive = carry
        sd = sd + i.astype(jnp.uint32)                          # shader:659
        p = bounce_payload(scene, feats, o, d, chunk, backend)
        return shade_bounce(scene, cfg, draw_env,
                            o, d, sd, color, contrib, alive, p), None

    body = jax.checkpoint(bounce) if remat else bounce
    incoming = jnp.zeros((n, 3), jnp.float32)
    for frame in range(1, cfg.max_frames + 1):
        seed = rng.pixel_seed(x, y, cfg.width, frame, frame_index)
        focus_jitter, seed = rng.random_circle_point(seed)
        focus_jitter = focus_jitter / res * cam.defocus_strength
        dev_jitter, seed = rng.random_circle_point(seed)
        dev_jitter = dev_jitter / res * cam.blur_strength

        dev_focus = (focus_point
                     + dev_jitter[:, :1] * right[None, :]
                     + dev_jitter[:, 1:2] * up[None, :])
        origin = (position[None, :]
                  + focus_jitter[:, :1] * right[None, :]
                  + focus_jitter[:, 1:2] * up[None, :])
        direction = normalize(dev_focus - origin)

        # carries derived from varying inputs so the scan typechecks when
        # this runs inside shard_map (axis-varying types)
        init = (origin, direction, seed,
                jnp.zeros_like(origin), jnp.ones_like(origin), x == x)
        (o, d, sd, color, contrib, alive), _ = jax.lax.scan(
            body, init, jnp.arange(cfg.max_bounces, dtype=jnp.uint32))
        incoming = incoming + color

    return incoming / jnp.float32(cfg.max_frames)               # shader:711


def auto_backend(platform: str | None = None) -> str:
    """The backend that backend='auto' means on `platform` (default: JAX's
    default backend): the Triton sweep on the GPU, where it beats the XLA
    sweep end to end (PERF.md, "Kernel decisions"); the XLA sweep
    elsewhere."""
    if platform is None:
        platform = jax.default_backend()
    return "triton" if platform in ("gpu", "cuda") else "xla"


def resolve_backend(backend: str) -> str:
    """'auto' -> auto_backend(); any other name must be in BACKENDS."""
    if backend == "auto":
        return auto_backend()
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of "
                         f"{('auto',) + BACKENDS}")
    return backend


@partial(jax.jit, static_argnames=("cfg", "chunk", "backend", "remat"))
def render_dispatch(scene: TracerScene, cam: CameraSpec, frame_index,
                    cfg: RenderConfig, chunk: int = 512,
                    backend: str = "auto", remat: bool = False):
    """One full-frame dispatch (shader main :675-722, minus the
    accumulation-image I/O which lives in runtime/renderer.py).

    frame_index: traced uint32 scalar (1-based accumulation counter).
    backend: 'auto' (see auto_backend) or one of BACKENDS.
    Returns (H, W, 3) f32 radiance averaged over cfg.max_frames samples.
    """
    backend = resolve_backend(backend)
    x, y = pixel_grid(cfg.width, cfg.height)
    incoming = render_pixels(scene, cam, x, y, frame_index, cfg, chunk,
                             backend, remat)
    return incoming.reshape(cfg.height, cfg.width, 3)
