"""The stdlib PNG codec against Pillow, and the native decoder against the
stdlib codec: every filter type and colour type."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from eqvio_tpu.data import png

CHANNELS = {"L": (0, 1), "LA": (4, 2), "RGB": (2, 3), "RGBA": (6, 4)}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind: int, cur: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Forward PNG filter ``kind`` of one row (the encoder side)."""
    c, p = cur.astype(np.int32), prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), c[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), p[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(c)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = p
    elif kind == 3:
        pred = (left + p) >> 1
    else:
        pred = np.array([_paeth(a, b, d) for a, b, d in zip(left, p, upleft)], np.int32)
    return ((c - pred) & 0xFF).astype(np.uint8)


def _encode(img: np.ndarray, ctype: int, kinds) -> bytes:
    """PNG bytes whose rows use the filter types ``kinds`` in turn."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch)
    raw, prev = bytearray(), np.zeros(w * ch, np.uint8)
    for y in range(h):
        kind = kinds[y % len(kinds)]
        raw += bytes([kind]) + _filter_row(kind, rows[y], prev, ch).tobytes()
        prev = rows[y]

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", sorted(CHANNELS))
@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_decode_matches_pillow(mode, kinds):
    ctype, ch = CHANNELS[mode]
    rng = np.random.default_rng(sum(kinds) + ch)
    shape = (23, 37) if ch == 1 else (23, 37, ch)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    data = _encode(img, ctype, kinds)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    np.testing.assert_array_equal(png.decode_gray(data), ref)


@pytest.mark.parametrize("mode", sorted(CHANNELS))
@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_native_decoder_matches_codec(tmp_path, mode, kinds):
    from eqvio_tpu.data import native_loader

    assert native_loader.available(), "native decoder failed to build (g++ and zlib)"
    ctype, ch = CHANNELS[mode]
    rng = np.random.default_rng(sum(kinds) + ch)
    shape = (23, 37) if ch == 1 else (23, 37, ch)
    data = _encode(rng.integers(0, 256, shape, dtype=np.uint8), ctype, kinds)
    path = tmp_path / "f.png"
    path.write_bytes(data)
    loader = native_loader.NativeImageLoader([str(path)], queue_size=2)
    frames = list(loader)
    loader.close()
    assert [k for k, _ in frames] == [0]
    np.testing.assert_array_equal(frames[0][1], png.decode_gray(data))


def _filter_types(data: bytes) -> set:
    idat = b"".join(body for kind, body in png._chunks(data) if kind == b"IDAT")
    w, h = struct.unpack(">II", data[16:24])
    return set(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)[:, 0].tolist())


def test_encode_picks_filters_per_row():
    """Smooth rows favour the predicting filters, noise rows none: the
    encoder mixes filter types as libpng does for real frames."""
    yy, xx = np.mgrid[0:40, 0:64]
    img = (128 + 100 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(np.uint8)
    img[::5] = np.random.default_rng(0).integers(0, 256, (8, 64), dtype=np.uint8)
    data = png.encode_gray(img)
    kinds = _filter_types(data)
    assert len(kinds) >= 2 and kinds & {3, 4}, kinds
    np.testing.assert_array_equal(png.decode_gray(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)


def test_encode_roundtrips_through_pillow(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (48, 64), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    png.write_gray(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(png.read_gray(path), img)
    np.testing.assert_array_equal(png.load_gray_u8(path), img)


@pytest.mark.parametrize("mode", ["I;16", "P"])
def test_unsupported_png_raises(mode):
    img = Image.new(mode, (8, 8))
    buf = io.BytesIO()
    img.save(buf, "PNG")
    with pytest.raises(png.PNGError, match="unsupported PNG"):
        png.decode_gray(buf.getvalue())


def test_not_a_png_raises():
    with pytest.raises(png.PNGError, match="not a PNG"):
        png.decode_gray(b"GIF89a...")
