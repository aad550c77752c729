"""Image I/O: PNG + Radiance HDR readers and writers, and the packed texel
formats, dependency-free.

Copied from project3_cuda_path_tracer_tpu/utils/image.py (NumPy only), so
that the readers and packers give the JAX package's arrays bit for bit; PNG
encoding is the pure-zlib form (the JAX package's optional native encoder
writes the same pixels). The packers build the 32-bit texel tables that the
texture stages fetch through one gather each (ops/texfetch.py): RGB8 atlas
texels, Radiance RGBE env texels, and the horizontal pairs of
--bilinear-fast (RGB565 atlas pairs, 12-bit shared-exponent env pairs).

Reference semantics (src/image.cpp:22-45): PNG = clamp([0,1]) * 255,
3-channel, no gamma; HDR = Radiance float. `save_render` reproduces saveImage
(src/main.cpp:78-99): divide the accumulator by the sample count and mirror x.
"""
from __future__ import annotations

import os
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


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for 8-bit RGB/RGBA/gray, returns [H,W,3] float32 in [0,1]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    w = h = bitdepth = coltype = None
    palette = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, coltype = struct.unpack(">IIBB", body[:10])
            interlace = body[12]
            if bitdepth != 8 or interlace != 0:
                raise ValueError(f"{path}: unsupported PNG variant (bit depth "
                                 f"{bitdepth}, interlace {interlace})")
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[coltype]
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    p = 0
    for y in range(h):
        ft = raw[p]
        row = np.frombuffer(raw[p + 1:p + 1 + stride], np.uint8).astype(np.int32)
        p += 1 + stride
        if ft == 0:
            cur = row
        elif ft == 1:
            cur = row.copy()
            for i in range(nch, stride):
                cur[i] = (cur[i] + cur[i - nch]) & 0xFF
        elif ft == 2:
            cur = (row + prev) & 0xFF
        elif ft == 3:
            cur = row.copy()
            for i in range(stride):
                left = cur[i - nch] if i >= nch else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ft == 4:
            cur = row.copy()
            for i in range(stride):
                a = cur[i - nch] if i >= nch else 0
                b = prev[i]
                c = prev[i - nch] if i >= nch else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pr) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ft}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    img = out.reshape(h, w, nch)
    if coltype == 3:
        img = palette[img[..., 0]]
    elif nch == 1:
        img = np.repeat(img, 3, axis=-1)
    elif nch == 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    elif nch == 4:
        img = img[..., :3]
    return img.astype(np.float32) / 255.0


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


def read_hdr(path: str) -> np.ndarray:
    """Radiance .hdr reader (handles both flat and adaptive-RLE scanlines)."""
    with open(path, "rb") as f:
        data = f.read()
    # header
    pos = data.index(b"\n\n") + 2 if b"\n\n" in data[:512] else 0
    end = data.index(b"\n", pos)
    dims = data[pos:end].split()
    h, w = int(dims[1]), int(dims[3])
    p = end + 1
    out = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        if data[p] == 2 and data[p + 1] == 2 and (data[p + 2] << 8 | data[p + 3]) == w:
            p += 4
            for ch in range(4):
                x = 0
                while x < w:
                    count = data[p]; p += 1
                    if count > 128:
                        out[y, x:x + count - 128, ch] = data[p]
                        p += 1
                        x += count - 128
                    else:
                        out[y, x:x + count, ch] = np.frombuffer(
                            data[p:p + count], np.uint8)
                        p += count
                        x += count
        else:
            row = np.frombuffer(data[p:p + 4 * w], np.uint8).reshape(w, 4)
            out[y] = row
            p += 4 * w
    e = out[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.exp2(e - 136).astype(np.float64), 0.0)
    return (out[..., :3].astype(np.float32) + 0.5) * scale[..., None].astype(np.float32)


def pack_rgb8(img: np.ndarray) -> np.ndarray:
    """[H,W,3] float32 in [0,1] -> flat [H*W] uint32 (R | G<<8 | B<<16).

    Exact for PNG-sourced data: read_png returns byte/255, and
    round(x*255) recovers the byte, so unpack (byte/255 in f32) is
    bitwise identical to the f32 plane."""
    b = np.clip(np.rint(img.astype(np.float64) * 255.0), 0, 255).astype(
        np.uint32)
    return (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)).reshape(-1)


def pack_565_pair(img: np.ndarray) -> np.ndarray:
    """[H,W,3] float in [0,1] -> [H,W] uint32 RGB565 horizontal pairs:
    entry (y,x) = rgb565(y,x) | rgb565(y,min(x+1,W-1))<<16 — one gather
    yields a whole bilinear row (ops/wavefront._unpack_565pair; the
    --bilinear-fast 2-gather path). The right neighbor clamps at THIS
    image's edge; the parser calls this per atlas rect so pairs never
    bleed across strip entries."""
    im = np.clip(img.astype(np.float64), 0.0, 1.0)
    r = np.round(im[..., 0] * 31.0).astype(np.uint32)
    g = np.round(im[..., 1] * 63.0).astype(np.uint32)
    b = np.round(im[..., 2] * 31.0).astype(np.uint32)
    t = r | (g << 5) | (b << 11)
    nb = t[:, np.minimum(np.arange(t.shape[1]) + 1, t.shape[1] - 1)]
    return t | (nb << 16)


def pack_rgbe(img: np.ndarray) -> np.ndarray:
    """[H,W,3] float32 radiance -> flat [H*W] uint32 Radiance RGBE
    (R | G<<8 | B<<16 | E<<24), the .hdr wire format itself.

    Exact for HDR-sourced data: read_hdr returns (m+0.5)*2^(e-136); the
    shared exponent from frexp of the max channel reproduces e and
    m = round(v/2^(e-136) - 0.5) recovers the mantissa byte, so unpack is
    bitwise identical to the f32 plane."""
    v = np.maximum(img.astype(np.float64), 0.0)
    maxc = v.max(axis=-1)
    nz = maxc > 1e-32
    _, e = np.frexp(np.where(nz, maxc, 1.0))
    # stb semantics: mantissa of the max channel lands in [128, 255];
    # read_hdr's +0.5 bias puts maxc in [128.5, 255.5]*2^(e-136), whose
    # frexp exponent is e - 128 exactly.
    scale = np.where(nz, np.exp2(-(e.astype(np.float64)) + 8.0), 0.0)
    m = np.clip(np.rint(v * scale[..., None] - 0.5), 0, 255).astype(
        np.uint32)
    ee = np.where(nz, e + 128, 0).astype(np.uint32)
    return (m[..., 0] | (m[..., 1] << 8) | (m[..., 2] << 16)
            | (ee << 24)).reshape(-1)


def pack_env_pair(img: np.ndarray) -> np.ndarray:
    """[H,W,3] float32 HDR radiance -> flat [H*W] uint32 horizontal pairs
    for the --bilinear-fast ENV path: entry (y,x) packs texel (y,x) and
    its right neighbor (y,(x+1) mod W — equirect longitude wraps) as two
    12-bit mini-RGBE texels sharing ONE 8-bit exponent:

        bits  0-11: texel0  R4 | G4<<4 | B4<<8
        bits 12-23: texel1  R4 | G4<<4 | B4<<8
        bits 24-31: shared exponent E (0 = both texels black)

    The exponent is frexp of the PAIR's max channel (RGBE-style), so
    decode is channel = (m + 0.5) * 2^(E-132) and the quantization error
    is bounded by pair_max/16 per channel (4-bit mantissa: bin width
    2^(e-4) <= pair_max/8, round-to-center error half that; the darker
    texel of a high-contrast pair bears the brunt — mag-filter quality,
    exactly the --bilinear-fast contract). One u32 gather returns a whole
    bilinear row, so the 4-corner env fetch becomes 2 gathers
    (ops/wavefront._unpack_envpair)."""
    v = np.maximum(img.astype(np.float64), 0.0)
    w = v.shape[1]
    nxt = v[:, (np.arange(w) + 1) % w]
    pmax = np.maximum(v.max(axis=-1), nxt.max(axis=-1))
    nz = pmax > 1e-32
    _, e = np.frexp(np.where(nz, pmax, 1.0))
    scale = np.where(nz, np.exp2(-(e.astype(np.float64)) + 4.0), 0.0)

    def tex12(t):
        m = np.clip(np.rint(t * scale[..., None] - 0.5), 0, 15).astype(
            np.uint32)
        return m[..., 0] | (m[..., 1] << 4) | (m[..., 2] << 8)

    ee = np.where(nz, e + 128, 0).astype(np.uint32)
    return (tex12(v) | (tex12(nxt) << 12) | (ee << 24)).reshape(-1)


def unpack_env_pair(packed: np.ndarray):
    """Inverse of pack_env_pair for tests: flat [H*W] uint32 ->
    (texel0 [H*W,3], texel1 [H*W,3]) float32."""
    p = np.asarray(packed, np.uint32)
    e = ((p >> 24) & 0xFF).astype(np.int64)
    s = np.where(e > 0, np.exp2(e.astype(np.float64) - 132.0), 0.0)

    def one(q):
        return np.stack([((q & 15) + 0.5), (((q >> 4) & 15) + 0.5),
                         (((q >> 8) & 15) + 0.5)],
                        axis=-1).astype(np.float64) * s[..., None]

    return (one(p).astype(np.float32),
            one(p >> 12).astype(np.float32))


def read_image(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return read_hdr(path)
    return read_png(path)


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
