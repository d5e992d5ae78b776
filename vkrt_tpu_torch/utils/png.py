"""Tiny first-party PNG codec (zlib from the stdlib, filters in numpy); the
port's copy of ``vkrt_tpu/utils/png.py``.

Replaces stb_image (texture load) and the missing screenshot path of the
reference with a dependency-free reader/writer: decode supports 8-bit
grayscale/RGB/RGBA/palette (the formats glTF textures actually use), encode
writes 8-bit RGB/RGBA with filter 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _paeth(a, b, c):
    p = a.astype(np.int32) + b.astype(np.int32) - c.astype(np.int32)
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def decode_png(blob: bytes) -> np.ndarray:
    """Decode to (H, W, 4) uint8 RGBA."""
    if blob[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    palette = None
    trns = None
    width = height = bit_depth = color_type = None
    interlace = 0
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        ctype = blob[pos + 4 : pos + 8]
        data = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", data
            )
        elif ctype == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(data, np.uint8)
        elif ctype == b"IDAT":
            idat += data
        elif ctype == b"IEND":
            break
    if bit_depth != 8:
        raise NotImplementedError(f"PNG bit depth {bit_depth} unsupported")
    if interlace:
        raise NotImplementedError("interlaced PNG unsupported")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = width * channels
    img = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        f = raw[y * (stride + 1)]
        line = np.frombuffer(raw, np.uint8, stride, y * (stride + 1) + 1).copy()
        if f == 0:
            cur = line
        elif f == 2:  # Up
            cur = line + prev
        else:  # Sub (1), Average (3), Paeth (4) need a scalar scan per pixel
            cur = line
            left = np.zeros(channels, np.uint8)
            upleft = np.zeros(channels, np.uint8)
            for x in range(0, stride, channels):
                up = prev[x : x + channels]
                if f == 1:
                    cur[x : x + channels] = cur[x : x + channels] + left
                elif f == 3:
                    cur[x : x + channels] = cur[x : x + channels] + (
                        (left.astype(np.uint16) + up) // 2
                    ).astype(np.uint8)
                elif f == 4:
                    cur[x : x + channels] = cur[x : x + channels] + _paeth(left, up, upleft)
                left = cur[x : x + channels]
                upleft = up
        img[y] = cur
        prev = cur
    img = img.reshape(height, width, channels)
    if color_type == 3:  # palette
        rgb = palette[img[..., 0]]
        alpha = np.full((height, width, 1), 255, np.uint8)
        if trns is not None:
            a = np.full(len(palette), 255, np.uint8)
            a[: len(trns)] = trns
            alpha = a[img[..., 0]][..., None]
        return np.concatenate([rgb, alpha], axis=-1)
    if channels == 1:
        img = np.repeat(img, 3, axis=-1)
        channels = 3
    if channels == 2:
        g, a = img[..., :1], img[..., 1:]
        return np.concatenate([np.repeat(g, 3, axis=-1), a], axis=-1)
    if channels == 3:
        alpha = np.full((height, width, 1), 255, np.uint8)
        return np.concatenate([img, alpha], axis=-1)
    return img


def encode_png(img: np.ndarray) -> bytes:
    """Encode (H, W, 3|4) uint8 to PNG bytes (filter 0, zlib level 6)."""
    img = np.asarray(img)
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] in (3, 4)
    h, w, c = img.shape
    color_type = 2 if c == 3 else 6

    def chunk(ctype: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + ctype
            + data
            + struct.pack(">I", zlib.crc32(ctype + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    scan = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    idat = zlib.compress(scan.tobytes(), 6)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", idat)
        + chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
