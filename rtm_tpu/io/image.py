"""Image IO: textures, Radiance HDR sky maps, PNG output.

Parity notes (ref: Engine/src/External/Render/Vulkan/VulkanTexture.cpp:18-41):
the reference loads *every* texture — including the .hdr sky map — through
stb_image's 8-bit path into RGBA8 (`Format::RGBA8` forced at
VulkanTexture.cpp:19), so HDR radiance is tone-mapped to LDR by stb's
hdr-to-ldr conversion (gamma 2.2, scale 1.0) and quantized to bytes.  We
reproduce that pipeline exactly: decode RGBE floats, apply
pow(x, 1/2.2)*255+0.5 clamp, quantize to u8, normalize /255.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

STB_HDR_GAMMA = 2.2
STB_HDR_SCALE = 1.0


# ---------------------------------------------------------------------------
# Radiance RGBE (.hdr) decode — pure NumPy (no external deps)
# ---------------------------------------------------------------------------

def _decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) u8 RGBE -> (..., 3) f32, matching stb's stbi__hdr_convert:
    scale = 2^(E-136); rgb = mantissa * scale; E==0 -> black."""
    e = rgbe[..., 3].astype(np.int32)
    scale = np.ldexp(np.float32(1.0), e - 136).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * scale[..., None]
    out[e == 0] = 0.0
    return out


def load_radiance_hdr(path) -> np.ndarray:
    """Decode a Radiance .hdr file to linear (H, W, 3) float32."""
    data = Path(path).read_bytes()
    # header
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError(f"not a Radiance file: {path}")
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
    nl = data.index(b"\n", pos)
    dims = data[pos:nl].split()
    pos = nl + 1
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"unsupported Radiance orientation: {dims}")
    height, width = int(dims[1]), int(dims[3])

    img = np.zeros((height, width, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    bp = 0
    for row in range(height):
        if width < 8 or width > 0x7FFF or buf[bp] != 2 or buf[bp + 1] != 2 \
                or (int(buf[bp + 2]) << 8 | int(buf[bp + 3])) != width:
            # flat (old-style) scanline: width RGBE quads
            img[row] = buf[bp:bp + width * 4].reshape(width, 4)
            bp += width * 4
            continue
        bp += 4
        for c in range(4):
            x = 0
            while x < width:
                count = int(buf[bp]); bp += 1
                if count > 128:  # run
                    img[row, x:x + count - 128, c] = buf[bp]
                    bp += 1
                    x += count - 128
                else:            # literal
                    img[row, x:x + count, c] = buf[bp:bp + count]
                    bp += count
                    x += count
    return _decode_rgbe(img)


def stb_hdr_to_ldr(hdr: np.ndarray) -> np.ndarray:
    """stb_image's HDR->LDR8 conversion (gamma 2.2, scale 1), then /255.
    Input linear f32, output f32 in [0,1] quantized to 8-bit levels."""
    v = np.power(np.maximum(hdr * STB_HDR_SCALE, 0.0), 1.0 / STB_HDR_GAMMA)
    b = np.clip(v * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
    return b.astype(np.float32) / 255.0


def load_hdr_ldr(path) -> np.ndarray:
    """Sky-map load with reference parity (HDR file -> LDR-quantized floats)."""
    return stb_hdr_to_ldr(load_radiance_hdr(path))


# ---------------------------------------------------------------------------
# LDR textures (png/jpg)
# ---------------------------------------------------------------------------

def load_texture(path) -> np.ndarray:
    """Load an LDR texture to (H,W,3) f32 in [0,1] (UNORM byte/255)."""
    path = Path(path)
    if path.suffix.lower() == ".hdr":
        return load_hdr_ldr(path)
    from PIL import Image
    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.uint8).astype(np.float32) / 255.0


# ---------------------------------------------------------------------------
# Output
# ---------------------------------------------------------------------------

def to_u8(img: np.ndarray) -> np.ndarray:
    """RGBA8 UNORM store semantics (shader:721 imageStore to rgba8):
    round(clamp(c, 0, 1) * 255)."""
    return np.clip(np.round(np.asarray(img, np.float32) * 255.0), 0, 255).astype(np.uint8)




def encode_png(img: np.ndarray) -> bytes:
    """Dependency-free PNG encoder (8-bit RGB, no filter)."""
    if img.dtype != np.uint8:
        img = to_u8(img)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag, payload):
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_png(path, img: np.ndarray) -> None:
    """Save an (H,W,3) image as PNG. Accepts f32 [0,1] (quantized) or u8."""
    Path(path).write_bytes(encode_png(img))
