"""Image output: PNG + Radiance HDR writers, dependency-free.

Copied from project3_cuda_path_tracer_tpu/utils/image.py (NumPy only). The
texture readers and packers stay behind until the texture slice is ported;
PNG encoding is the pure-zlib form (the JAX package's optional native encoder
writes the same pixels).

Reference semantics (src/image.cpp:22-45): PNG = clamp([0,1]) * 255,
3-channel, no gamma; HDR = Radiance float. `save_render` reproduces saveImage
(src/main.cpp:78-99): divide the accumulator by the sample count and mirror x.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def encode_png(rgb8: np.ndarray) -> bytes:
    """Encode an [H,W,3] uint8 array as PNG bytes."""
    h, w, c = rgb8.shape
    if c != 3 or rgb8.dtype != np.uint8:
        raise ValueError(f"expected [H,W,3] uint8, got {rgb8.shape} "
                         f"{rgb8.dtype}")
    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, rgb8: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb8))


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """Radiance .hdr writer (flat RLE-free RGBE), matching stbi_write_hdr output
    semantics (reference: src/image.cpp:41-45)."""
    h, w, _ = rgb.shape
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    v = np.maximum(rgb.astype(np.float32), 0.0)
    maxc = v.max(axis=-1)
    nz = maxc > 1e-32
    # frexp puts the max channel's mantissa in [128,255] (stb semantics)
    _, e = np.frexp(np.where(nz, maxc, 1.0))
    scale = np.where(nz, 256.0 / np.exp2(e.astype(np.float64)), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(v * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(header)
        f.write(rgbe.tobytes())


def tonemap(accum: np.ndarray, iterations: int) -> np.ndarray:
    """accum[H,W,3] float sums -> uint8, reference semantics:
    clamp(pix/iter, 0, 1)*255, no gamma (src/image.cpp:28, src/pathtrace.cu:58-60)."""
    img = np.clip(np.asarray(accum, np.float64) / max(int(iterations), 1), 0.0, 1.0)
    return (img * 255.0).astype(np.uint8)


def aces_tonemap(img: np.ndarray) -> np.ndarray:
    """Narkowicz's ACES filmic fit (2015): the standard display curve
    for HDR radiance. [H,W,3] linear -> [0,1]."""
    x = np.asarray(img, np.float64)
    out = (x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14)
    return np.clip(out, 0.0, 1.0)


def save_render(path_base: str, accum: np.ndarray, iterations: int,
                hdr: bool = False, gamma: float = 0.0,
                aces: bool = False) -> str:
    """saveImage parity (reference: src/main.cpp:78-99): mean over samples,
    x-mirror, write `<base>.png`. The reference applies NO display curve
    (src/image.cpp:28); `gamma` > 0 and `aces` are opt-in extensions
    (applied to PNG output only — .hdr stays linear radiance)."""
    img = np.asarray(accum, np.float32)[:, ::-1, :] / max(int(iterations), 1)
    if hdr:
        out = path_base + ".hdr"
        write_hdr(out, img)
    else:
        if aces:
            img = aces_tonemap(img)
        if gamma and gamma > 0:
            img = np.clip(img, 0.0, 1.0) ** (1.0 / gamma)
        out = path_base + ".png"
        write_png(out, (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8))
    return out
