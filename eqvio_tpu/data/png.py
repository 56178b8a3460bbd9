"""Minimal PNG codec on ``zlib`` + numpy: 8-bit images in, 8-bit gray out.

The Python fallback of the native prefetching decoder
(``native/imageloader.cpp``) and the writer of the synthetic datasets.

Reads non-interlaced 8-bit grayscale, gray+alpha, RGB and RGBA images with
any of the five PNG row filters, and converts colour to gray with the ITU-R
601 luma weights in the same fixed-point form as Pillow's ``convert("L")``.
Writes 8-bit grayscale with a filter chosen per row, as libpng and OpenCV
do for the PNGs of real datasets. Anything else (palette, 16-bit,
interlaced) raises :class:`PNGError`.

Undoing the Average and Paeth filters takes a Python loop over every byte
(hundreds of ms for a 752x480 frame); the native decoder does it in C++.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


class PNGError(ValueError):
    """A PNG this codec cannot read."""


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise PNGError("truncated chunk")
        yield kind, body
        pos += 12 + length


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw`` (rows of ``1 + stride`` bytes)."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: running sum per channel along the row
            n = -(-stride // bpp) * bpp
            padded = np.zeros(n, dtype=np.uint8)
            padded[:stride] = line
            cur = np.cumsum(padded.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left result
            cur = np.zeros(stride, dtype=np.uint8)
            ln, up = line.tolist(), prev.tolist()
            res = [0] * stride
            for i in range(stride):
                left = res[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                res[i] = (ln[i] + pred) & 0xFF
            cur[:] = res
        else:
            raise PNGError(f"unknown filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def decode_gray(data: bytes) -> np.ndarray:
    """Decode PNG bytes to a ``[H, W]`` uint8 gray image."""
    if not data.startswith(_SIGNATURE):
        raise PNGError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise PNGError("missing IHDR")
    width, height, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise PNGError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}); only 8-bit non-interlaced gray/RGB(A)"
        )
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size != height * (width * ch + 1):
        raise PNGError("image data size does not match the header")
    px = _unfilter(raw, height, width * ch, ch).reshape(height, width, ch)
    if ch <= 2:
        return np.ascontiguousarray(px[:, :, 0])
    rgb = px[:, :, :3].astype(np.uint32)
    luma = rgb[:, :, 0] * 19595 + rgb[:, :, 1] * 38470 + rgb[:, :, 2] * 7471 + 0x8000
    return (luma >> 16).astype(np.uint8)


def read_gray(path: str) -> np.ndarray:
    """Read a PNG file as a ``[H, W]`` uint8 gray image."""
    with open(path, "rb") as f:
        return decode_gray(f.read())


def load_gray_u8(path: str) -> np.ndarray:
    """Decode an image file to ``[H, W]`` uint8 gray: PNG with this codec,
    other formats through Pillow, which only they need."""
    if str(path).lower().endswith(".png"):
        return read_gray(path)
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), dtype=np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def _filter_candidates(img: np.ndarray) -> np.ndarray:
    """``[5, H, W]``: every row of ``img`` under each of the five filters."""
    x = img.astype(np.int16)
    left, up, upleft = (np.zeros_like(x) for _ in range(3))
    left[:, 1:], up[1:], upleft[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    return ((x[None] - preds) & 0xFF).astype(np.uint8)


def encode_gray(img: np.ndarray) -> bytes:
    """Encode a ``[H, W]`` uint8 image as 8-bit grayscale PNG bytes.

    Each row takes the filter whose output has the least sum of absolute
    values read as signed bytes: libpng's default choice."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise PNGError(f"expected a 2-D uint8 image, got {img.dtype} {img.shape}")
    h, w = img.shape
    cand = _filter_candidates(img)
    score = np.minimum(cand, 256 - cand.astype(np.int32)).sum(axis=2)  # [5, H]
    kinds = np.argmin(score, axis=0)
    rows = np.empty((h, w + 1), dtype=np.uint8)
    rows[:, 0] = kinds
    rows[:, 1:] = cand[kinds, np.arange(h)]
    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def write_gray(path: str, img: np.ndarray) -> None:
    """Write a ``[H, W]`` uint8 image as a grayscale PNG file."""
    with open(path, "wb") as f:
        f.write(encode_gray(img))
