"""Shading: sky/texture sampling and scatter.

Reference device code: getSkyColor (RayTracing.shader:197-220), scatter /
reflectRay / refractRay / reflectance (shader:590-649), accumulateColor
(shader:550-588).  All functions are vectorized over a leading lane axis and
thread the PCG seed explicitly (see ops/rng.py); branch divergence becomes
masked selects with per-branch seed advancement so the per-lane RNG stream is
bit-identical to the reference's SIMT execution.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import rng
from .intersect import dot3, safe_normalize

PI = np.float32(np.pi)
TWO_PI = np.float32(2.0 * np.pi)
OFFSET = np.float32(1.0e-4)  # hit-point normal offset (shader:616,621,628)


# ---------------------------------------------------------------------------
# Texture sampling
# ---------------------------------------------------------------------------

def _bilinear_gather(img, yi, xi):
    """img (H,W,3); yi/xi (...,) int32 already wrapped/clamped.

    Gathers through a flattened (H*W, 3) view with linear indices: one
    single-axis `take` instead of multi-index advanced indexing."""
    w = img.shape[1]
    return jnp.take(img.reshape(-1, img.shape[-1]), yi * w + xi, axis=0)


def sample_bilinear(img, u, v, wrap: str):
    """GPU-convention bilinear sample of img (H,W,3) at normalized (u,v).

    texel center convention: x = u*W - 0.5.  wrap: 'repeat' (Vulkan
    REPEAT, scene textures) or 'clamp' (CLAMP_TO_EDGE, sky map) — matches the
    sampler modes the reference creates (VulkanTexture.cpp:338-343,
    RayTracing.cpp:843 sky = Linear+ClampToEdge, scene textures default
    Linear+Repeat per Texture.h:32-35).
    Returns (...,3).
    """
    h, w = img.shape[0], img.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    x1 = x0 + 1
    y1 = y0 + 1
    if wrap == "repeat":
        x0, x1 = x0 % w, x1 % w
        y0, y1 = y0 % h, y1 % h
    else:
        x0, x1 = jnp.clip(x0, 0, w - 1), jnp.clip(x1, 0, w - 1)
        y0, y1 = jnp.clip(y0, 0, h - 1), jnp.clip(y1, 0, h - 1)
    c00 = _bilinear_gather(img, y0, x0)
    c01 = _bilinear_gather(img, y0, x1)
    c10 = _bilinear_gather(img, y1, x0)
    c11 = _bilinear_gather(img, y1, x1)
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def build_quad_flat(img, wrap: str, dtype=jnp.float32):
    """Pack (H,W,3) into a (H*W,12) quad table: row (y,x) holds the 2x2
    bilinear footprint [c(y,x), c(y,x+1), c(y+1,x), c(y+1,x+1)] with the
    wrap mode baked into the +1 neighbours.

    One row holds the whole bilinear footprint, so a sample is one row
    gather instead of four taps.  Whether that still pays on the GPU is
    an open question (ROADMAP S6).

    dtype=jnp.uint8 stores the row as the ORIGINAL texel bytes
    (round(v*255)) and sample_quads dequantizes with /255 after the
    gather: EXACT for u8-sourced images (every reference texture and the
    LDR-quantized sky/HDR path, VulkanTexture.cpp:19), and 4x fewer bytes
    per row (tables up to 4096^2 texels: 805MB at f32, 201MB at u8).
    """
    img = jnp.asarray(img, jnp.float32)
    h, w = img.shape[0], img.shape[1]
    if wrap == "repeat":
        xn = (np.arange(w) + 1) % w
        yn = (np.arange(h) + 1) % h
    else:                                     # clamp-to-edge
        xn = np.minimum(np.arange(w) + 1, w - 1)
        yn = np.minimum(np.arange(h) + 1, h - 1)
    c00 = img
    c01 = img[:, xn]
    c10 = img[yn]
    c11 = img[yn][:, xn]
    quads = jnp.concatenate([c00, c01, c10, c11], axis=-1)   # (H,W,12)
    quads = quads.reshape(h * w, 12)
    if dtype == jnp.int32:
        # one i32 lane per texel, (r,g,b) in bytes 0..2: 16B rows in a
        # 32-bit dtype, a third of the f32 row's bytes.
        # EXACT for u8-sourced images (all loader paths quantize to
        # byte/255, io/image.py; sample_quads dequantizes with the same
        # /255 division) — callers must check quad_exact_u8 first.
        q = jnp.round(jnp.clip(quads, 0.0, 1.0) * 255.0).astype(jnp.int32)
        q = q.reshape(h * w, 4, 3)
        return (q[:, :, 0] | (q[:, :, 1] << 8) | (q[:, :, 2] << 16))
    if dtype == jnp.uint8:
        q8 = jnp.round(jnp.clip(quads, 0.0, 1.0) * 255.0).astype(jnp.uint8)
        # pad rows 12 -> 16 bytes: power-of-2 stride keeps every row in
        # one aligned 16B chunk (the random-row fetch is latency-bound)
        return jnp.pad(q8, ((0, 0), (0, 4)))
    return quads.astype(dtype)


def quad_exact_u8(img) -> bool:
    """True when every texel is exactly byte/255 — i.e. the i32-packed quad
    table reproduces the f32 table bit-for-bit (all file loaders and the
    procedural textures qualify; arbitrary float textures do not)."""
    v = np.asarray(img, np.float32)
    if v.size == 0:
        return True
    if v.min() < 0.0 or v.max() > 1.0:
        return False
    # exact round-trip test, not a tolerance: a float texture whose values
    # merely sit NEAR the byte grid must keep the f32 table (advisor r2).
    # DIVISION by 255, not multiplication by (1/255): the loaders
    # (io/image.py) and sample_quads' i32 decode both divide, and the two
    # differ in f32 for 126 of 256 byte values (advisor r3) — the multiply
    # form rejected every real u8 texture and silently disabled the packed
    # fast path project-wide.
    q = np.round(v * np.float32(255.0)) / np.float32(255.0)
    return bool(np.array_equal(q.astype(np.float32), v))


def sample_quads(flat_quads, h, w, u, v, wrap: str, base=0, row_w=None):
    """Bilinear sample via the quad table (ONE gather per sample).

    h/w: true texture extent (python ints or per-lane arrays); row_w: padded
    row stride of the flattened table (defaults to w); base: per-lane row
    offset of the texture within a stacked table.
    """
    if row_w is None:
        row_w = w
    hf = h if not hasattr(h, "astype") else h.astype(jnp.float32)
    wf = w if not hasattr(w, "astype") else w.astype(jnp.float32)
    x = u * wf - 0.5
    y = v * hf - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)
    if wrap == "repeat":
        x0 = jnp.mod(x0, w)
        y0 = jnp.mod(y0, h)
    else:
        # lower-edge clamp: the original clamps BOTH taps to texel 0, so the
        # interpolation weight must collapse to the c00 corner
        fx = jnp.where((x0f < 0)[..., None], 0.0, fx)
        fy = jnp.where((y0f < 0)[..., None], 0.0, fy)
        x0 = jnp.clip(x0, 0, w - 1)
        y0 = jnp.clip(y0, 0, h - 1)
    q = jnp.take(flat_quads, base + y0 * row_w + x0, axis=0)
    if flat_quads.dtype == jnp.int32:
        # unpack 4 texels x (r,g,b) bytes; /255 DIVISION matches the
        # loaders' byte/255 exactly (build_quad_flat dtype=int32)
        t = []
        for c in range(4):
            wrd = q[..., c]
            t.append(jnp.stack(
                [(wrd & 0xFF).astype(jnp.float32),
                 ((wrd >> 8) & 0xFF).astype(jnp.float32),
                 ((wrd >> 16) & 0xFF).astype(jnp.float32)],
                axis=-1) / 255.0)
        top = t[0] * (1.0 - fx) + t[1] * fx
        bot = t[2] * (1.0 - fx) + t[3] * fx
        return top * (1.0 - fy) + bot * fy
    if flat_quads.dtype == jnp.uint8:
        q = q.astype(jnp.float32) * np.float32(1.0 / 255.0)
    else:
        q = q.astype(jnp.float32)
    top = q[..., 0:3] * (1.0 - fx) + q[..., 3:6] * fx
    bot = q[..., 6:9] * (1.0 - fx) + q[..., 9:12] * fx
    return top * (1.0 - fy) + bot * fy


def sample_texture_quads(tex_quads, tex_size, th, tw, tex_id, u, v):
    """Bindless texture sample via the stacked quad table: ONE gather.

    The whole bilinear footprint is one row, so one sample is ONE gather.
    `tex_quads` is the (K*TH*TW, 12) stacked table built
    by models/scene.py; th/tw are the padded per-texture extents (python
    ints); tex_size the true extents.  Repeat wrap is baked into the quad
    rows at build, so only the base tap is wrapped here.
    """
    k = tex_size.shape[0]
    tid = jnp.clip(tex_id, 0, k - 1)                      # <0 lanes masked out
    # per-lane (H,W) extents WITHOUT a per-lane gather: tex_size[tid] would
    # be a second gather right next to the texel tap; K is tiny, so K
    # broadcasted selects build the same extents.  Above a small K
    # the K full-lane select chain stops being free (cost grows linearly
    # with texture count) — fall back to the single gather there.
    if k <= 16:
        hh = jnp.full(tid.shape, tex_size[0, 0])
        ww = jnp.full(tid.shape, tex_size[0, 1])
        for i in range(1, k):
            hh = jnp.where(tid == i, tex_size[i, 0], hh)
            ww = jnp.where(tid == i, tex_size[i, 1], ww)
    else:
        hw = jnp.take(tex_size, tid, axis=0)
        hh, ww = hw[..., 0], hw[..., 1]
    return sample_quads(tex_quads, hh, ww, u, v,
                        wrap="repeat", base=tid * (th * tw), row_w=tw)


def sky_color_quads(direction, sky_quads, h, w):
    """Equirect sky sample through the quad table (ONE gather) — identical
    arithmetic to sky_color/sample_bilinear, f32-exact (see
    sample_texture_quads)."""
    u = jnp.arctan2(direction[..., 2], direction[..., 0]) / TWO_PI + 0.5
    v = jnp.arcsin(jnp.clip(direction[..., 1], -1.0 + 1e-6, 1.0 - 1e-6)) / PI + 0.5
    return sample_quads(sky_quads, h, w, u, v, wrap="clamp")


def sample_texture_array(textures, tex_size, tex_id, u, v):
    """Sample the bindless texture array (shader:578) for per-lane tex_id.

    textures: (K,TH,TW,3) padded stack; tex_size: (K,2) actual (H,W).
    Wrap = repeat within each texture's true extent.  tex_id < 0 lanes return
    zeros (callers mask them out anyway).
    """
    k = textures.shape[0]
    tid = jnp.clip(tex_id, 0, k - 1)
    hw = tex_size[tid]                                   # (...,2)
    h = hw[..., 0].astype(jnp.float32)
    w = hw[..., 1].astype(jnp.float32)
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    hi = hw[..., 0]
    wi = hw[..., 1]
    x0 = jnp.mod(x0f.astype(jnp.int32), wi)
    x1 = jnp.mod(x0f.astype(jnp.int32) + 1, wi)
    y0 = jnp.mod(y0f.astype(jnp.int32), hi)
    y1 = jnp.mod(y0f.astype(jnp.int32) + 1, hi)
    # flattened-take gathers (see _bilinear_gather for why)
    th, tw = textures.shape[1], textures.shape[2]
    flat = textures.reshape(-1, textures.shape[-1])
    base = tid * (th * tw)
    c00 = jnp.take(flat, base + y0 * tw + x0, axis=0)
    c01 = jnp.take(flat, base + y0 * tw + x1, axis=0)
    c10 = jnp.take(flat, base + y1 * tw + x0, axis=0)
    c11 = jnp.take(flat, base + y1 * tw + x1, axis=0)
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def sky_color(direction, sky):
    """Equirect sky sample (shader:216-218): uv = (atan2(z,x)/2pi,
    asin(y)/pi) + 0.5, Linear + ClampToEdge."""
    u = jnp.arctan2(direction[..., 2], direction[..., 0]) / TWO_PI + 0.5
    v = jnp.arcsin(jnp.clip(direction[..., 1], -1.0 + 1e-6, 1.0 - 1e-6)) / PI + 0.5
    return sample_bilinear(sky, u, v, wrap="clamp")


def sphere_uv(normal):
    """Sphere UV from the unit normal (shader:245)."""
    u = jnp.arctan2(normal[..., 2], normal[..., 0]) / TWO_PI + 0.5
    v = jnp.arcsin(jnp.clip(normal[..., 1], -1.0 + 1e-6, 1.0 - 1e-6)) / PI + 0.5
    return u, v


# ---------------------------------------------------------------------------
# Scatter
# ---------------------------------------------------------------------------

def reflect(d, n):
    """GLSL reflect."""
    return d - 2.0 * dot3(d, n)[..., None] * n


def refract(i, n, eta):
    """GLSL refract incl. the zero-vector total-internal-reflection result."""
    ndi = dot3(n, i)[..., None]
    k = 1.0 - eta[..., None] ** 2 * (1.0 - ndi * ndi)
    out = eta[..., None] * i - (eta[..., None] * ndi + jnp.sqrt(jnp.maximum(k, 1e-12))) * n
    return jnp.where(k >= 0.0, out, 0.0)


def scatter(origin, direction, seed, hit_pos, hit_normal,
            m_roughness, m_metallic, m_refraction):
    """One scatter step for every lane; returns (new_origin, new_direction,
    new_seed).  Lanes where refraction_ratio > 1 take the dielectric path
    (1 RNG draw), others the diffuse/specular path (6 draws); both streams are
    evaluated from the same incoming seed and masked, reproducing per-thread
    SIMT seed evolution exactly (shader:637-649).
    """
    is_refract = m_refraction > 1.0

    # --- dielectric branch (shader:590-624) -------------------------------
    is_front = dot3(direction, hit_normal) < 0.0
    rt = jnp.where(is_front, 1.0 / jnp.where(m_refraction == 0.0, 1.0, m_refraction), m_refraction)
    hn = jnp.where(is_front[..., None], hit_normal, -hit_normal)
    cos_theta = jnp.minimum(dot3(-direction, hn), 1.0)
    # grad-safe sqrt: at exact normal incidence sqrt(0) has infinite slope,
    # and this branch is evaluated (then masked) for every lane
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 1e-12))
    cannot_refract = rt * sin_theta > 1.0
    r0 = ((1.0 - rt) / (1.0 + rt)) ** 2
    r0p = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
    rand_refl, seed_refr = rng.fast_random(seed)
    do_reflect = cannot_refract | (r0p > rand_refl)
    o_refr = jnp.where(do_reflect[..., None], hit_pos + hn * OFFSET, hit_pos - hn * OFFSET)
    d_refr = jnp.where(do_reflect[..., None], reflect(direction, hn), refract(direction, hn, rt))

    # --- diffuse/specular branch (shader:626-635) --------------------------
    o_refl = hit_pos + hit_normal * OFFSET
    r3a, s1 = rng.random_unit_sphere(seed)
    diffuse_dir = safe_normalize(hit_normal + r3a)
    r3b, s2 = rng.random_unit_sphere(s1)
    spec_dir = safe_normalize(reflect(direction, hit_normal) + r3b * (1.0 - m_metallic)[..., None])
    rough = m_roughness[..., None]
    d_refl = safe_normalize(diffuse_dir * (1.0 - rough) + spec_dir * rough)

    mask = is_refract[..., None]
    new_origin = jnp.where(mask, o_refr, o_refl)
    new_direction = jnp.where(mask, d_refr, d_refl)
    new_seed = jnp.where(is_refract, seed_refr, s2)
    return new_origin, new_direction, new_seed


FLAT_LIGHT_DIR = np.array([-1.0, -1.0, -1.0], np.float32) / np.float32(np.sqrt(3.0))


def flat_shade(albedo, normal):
    """MaxBounces==1 preview mode (shader:566-571).  The reference calls
    clamp(0.0, 0.5, dot(-N, L)) with swapped min/max arguments, which in GLSL
    resolves to min(0.5, dot(-N, L)); preserved exactly."""
    d = dot3(-normal, jnp.asarray(FLAT_LIGHT_DIR))
    return albedo * (jnp.minimum(jnp.float32(0.5), d) + 0.5)[..., None]


# ---------------------------------------------------------------------------
# Procedural sun/sky environment (C28 parity)
# ---------------------------------------------------------------------------

SUN_DIR = np.array([1.0, 1.0, 1.0], np.float32) / np.float32(np.sqrt(3.0))
_GROUND = np.array([0.3, 0.3, 0.3], np.float32)
_ZENITH = np.array([0.5, 0.7, 1.0], np.float32)
_HORIZON = np.array([0.6, 0.4, 0.4], np.float32)


def _smoothstep(e0, e1, x):
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def procedural_sun_sky(direction):
    """The legacy kernel's procedural environment, exactly
    (OldRayTracing.shader:119-136): horizon->zenith gradient over a ground
    color with a pow-500 sun disk along -LightDir = (1,1,1)/sqrt(3); the
    sun only shows where groundToSky saturates (d.y >= 0).

    direction (...,3) -> (...,3); selectable via
    build_tracer_scene(env_model="sun")."""
    dy = direction[..., 1]
    sky_lerp = _smoothstep(0.0, 0.4, dy) ** np.float32(0.35)
    ground_to_sky = _smoothstep(-0.01, 0.0, dy)
    grad = (_HORIZON[None] + (_ZENITH - _HORIZON)[None]
            * sky_lerp[..., None])
    sun = jnp.maximum(
        0.0, jnp.sum(direction * jnp.asarray(SUN_DIR), axis=-1)
    ) ** 500.0 * 100.0
    col = (_GROUND[None] + (grad - _GROUND[None])
           * ground_to_sky[..., None])
    return col + (sun * (ground_to_sky >= 1.0))[..., None]


def env_radiance(scene, direction):
    """Environment lookup at miss (shader:663-666): the scene's equirect
    sky map, or the procedural sun/sky when the scene selects it."""
    if getattr(scene, "env_sun", False):
        return procedural_sun_sky(direction)
    return sky_color_quads(direction, scene.sky_quads,
                           scene.sky.shape[0], scene.sky.shape[1])
