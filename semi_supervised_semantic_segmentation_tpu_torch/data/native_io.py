"""ctypes binding of the native image decoder (``native/decoder.cpp``).

The decoder pastes a JPEG or PNG straight into a caller's canvas slot with
libjpeg / libpng, and decodes a batch on a ``std::thread`` pool.  It is
built at first use with

    g++ -O3 -shared -fPIC -std=c++17 native/decoder.cpp -o <out> -ljpeg -lpng

into ``build/native/`` at the repository root, named by a hash of the
source and the flags (an edited source rebuilds).  The output is written
under a temporary name and renamed into place, so processes that build at
once never load a half-written file.  The build needs ``g++`` and libjpeg
and libpng with their headers (``jpeglib.h``, ``png.h``); when it fails,
the first decode raises with the compiler's output.  There is no other
decode path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(REPO_DIR, "native", "decoder.cpp")
BUILD_DIR = os.path.join(REPO_DIR, "build", "native")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-ljpeg", "-lpng"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libsssegio-{digest}.so")


def build() -> str:
    """Compile the decoder unless its library exists; returns its path.
    Raises ``RuntimeError`` with the compiler's output when the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native decoder (native/decoder.cpp) is built "
                           "with g++ against libjpeg and libpng")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *LIBS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError("building the native decoder failed (it needs g++ and libjpeg and "
                           "libpng with their headers, jpeglib.h and png.h):\n"
                           + proc.stderr + proc.stdout)
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        c_int, u8p, i32p = ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
        lib.ssseg_decode_image.restype = c_int
        lib.ssseg_decode_image.argtypes = [ctypes.c_char_p, u8p, c_int, c_int,
                                           ctypes.POINTER(c_int)]
        lib.ssseg_decode_label.restype = c_int
        lib.ssseg_decode_label.argtypes = [ctypes.c_char_p, i32p, c_int, c_int,
                                           ctypes.POINTER(c_int)]
        lib.ssseg_decode_batch.restype = c_int
        lib.ssseg_decode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), c_int, u8p, c_int,
                                           c_int, i32p, c_int]
        _lib = lib
        return lib


def decode_image_into(path: str, canvas: np.ndarray) -> Tuple[int, int]:
    """Decode a JPEG or PNG into a (H, W, 3) uint8 canvas slot (top-left
    paste); returns the true (h, w) clipped to the canvas."""
    lib = _load()
    assert canvas.dtype == np.uint8 and canvas.ndim == 3 and canvas.flags["C_CONTIGUOUS"]
    hw = (ctypes.c_int * 2)()
    rc = lib.ssseg_decode_image(path.encode(),
                                canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                canvas.shape[0], canvas.shape[1], hw)
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    return int(hw[0]), int(hw[1])


def decode_label_into(path: str, canvas: np.ndarray) -> Tuple[int, int]:
    """Decode an 8-bit gray or palette PNG label into an int32 canvas slot;
    palette indices are the class ids (VOC's convention)."""
    lib = _load()
    assert canvas.dtype == np.int32 and canvas.ndim == 2 and canvas.flags["C_CONTIGUOUS"]
    hw = (ctypes.c_int * 2)()
    rc = lib.ssseg_decode_label(path.encode(),
                                canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                canvas.shape[0], canvas.shape[1], hw)
    if rc != 0:
        raise IOError(f"native label decode failed ({rc}): {path}")
    return int(hw[0]), int(hw[1])


def decode_batch(paths: Sequence[str], canvases: np.ndarray, sizes: np.ndarray,
                 threads: int = 4) -> None:
    """Decode ``paths[i]`` into ``canvases[i]`` ((N, H, W, 3) uint8) and its
    (h, w) into ``sizes[i]`` ((N, 2) int32) on ``threads`` threads."""
    lib = _load()
    assert canvases.dtype == np.uint8 and canvases.flags["C_CONTIGUOUS"]
    assert sizes.dtype == np.int32 and sizes.flags["C_CONTIGUOUS"]
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.ssseg_decode_batch(arr, n, canvases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                canvases.shape[1], canvases.shape[2],
                                sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), threads)
    if rc != 0:
        raise IOError(f"native batch decode failed ({rc})")
