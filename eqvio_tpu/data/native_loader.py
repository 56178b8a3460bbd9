"""ctypes binding for the native prefetching PNG loader (native/imageloader.cpp).

The C++ worker thread decodes frames ahead of the consumer — the native
data-loader role of the reference's ``ThreadedDataServer``.  It reads what
the Python codec of ``png.py`` reads and gives the same pixels, and needs
only zlib.  ``make`` brings the library up to date with its source at first
use in a process; when the compiler or zlib is missing, the data server
decodes with ``png.py`` instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libimageloader.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, "libimageloader.so"], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.il_create.restype = ctypes.c_void_p
        lib.il_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ]
        if hasattr(lib, "il_create2"):
            lib.il_create2.restype = ctypes.c_void_p
            lib.il_create2.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
            ]
        lib.il_next.restype = ctypes.c_int
        lib.il_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.il_next_u8.restype = ctypes.c_int
        lib.il_next_u8.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.il_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


class NativeImageLoader:
    """Iterator over decoded grayscale uint8 frames, prefetched in C++.

    uint8 is the canonical in-flight format: 4x less host->device traffic
    than f32 (normalisation happens on device in the fused chunk program)."""

    def __init__(self, paths: list[str], queue_size: int = 16,
                 max_pixels: int = 4096 * 3072, workers: int | None = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native image loader unavailable")
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        if workers is None:
            workers = int(os.environ.get("EQVIO_DECODE_THREADS", "2"))
        if hasattr(lib, "il_create2"):
            self._handle = lib.il_create2(arr, len(self._paths), queue_size, workers)
        else:  # older .so without the pool API
            self._handle = lib.il_create(arr, len(self._paths), queue_size)
        self._buf = np.empty(max_pixels, dtype=np.uint8)

    def __iter__(self):
        return self

    def __next__(self):
        h = ctypes.c_int()
        w = ctypes.c_int()
        idx = self._lib.il_next_u8(
            self._handle,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            self._buf.size,
            ctypes.byref(h),
            ctypes.byref(w),
        )
        if idx < 0:
            raise StopIteration
        if h.value == 0 or w.value == 0:
            raise IOError(f"native PNG decode failed for frame {idx}")
        img = self._buf[: h.value * w.value].reshape(h.value, w.value).copy()
        return idx, img

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.il_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
