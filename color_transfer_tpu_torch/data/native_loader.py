"""ctypes bindings of the native C++ image decoder (native/imageio.cc) —
port of color_transfer_tpu/data/native_loader.py.

ctypes foreign calls release the GIL, so the threaded Loader decodes in
parallel from one process. The cropped decode stops inflating PNG rows past
the crop, which the random-crop training pipeline uses.

The library is built at first use, never at import, from the unchanged
``native/imageio.cc`` with ``g++`` (native/Makefile's flags and libraries)
into ``color_transfer_tpu_torch/_build/`` (git-ignored), keyed on a hash of
the source and the command, as ops/_build.py keys the kernels' nvcc builds;
nothing is written under ``native/``. Without a compiler or the libpng /
libjpeg headers the build fails and every function decodes with PIL, the
JAX package's fallback: ``available()`` says whether the native decoder
runs and ``build_error()`` keeps the compiler's message.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "imageio.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-Wall", "-std=c++17", "-shared")
LIBS = ("-lpng", "-ljpeg", "-lz")

_lock = threading.Lock()
_lib = None
_error = None


def _build():
    """Compile the decoder into _build/ if needed -> the library's path."""
    cxx = os.environ.get("CXX", "g++")
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join((cxx, *CXX_FLAGS, *LIBS)).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"libctimageio-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def _load():
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError) as exc:  # no compiler, headers or library
            _error = str(exc)
            _lib = False
            return _lib
        i64, u8p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
        lib.ct_image_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64),
                                      ctypes.POINTER(i64)]
        lib.ct_decode_rgb8.argtypes = [ctypes.c_char_p, u8p, i64]
        lib.ct_decode_crop_rgb8.argtypes = [ctypes.c_char_p, i64, i64, i64, i64, u8p, i64]
        _lib = lib
        return _lib


def available():
    """True when the native decoder built and loaded; False means PIL."""
    return bool(_load())


def build_error():
    """The failed build's message (None when the decoder built)."""
    _load()
    return _error


def image_info(path):
    """(height, width) of an image, from its header."""
    lib = _load()
    if not lib:
        from PIL import Image

        with Image.open(path) as img:
            return img.height, img.width
    w, h = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.ct_image_info(str(path).encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"ct_image_info({path}) failed with {rc}")
    return int(h.value), int(w.value)


def _out_ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def read_image(path):
    """Decode a whole image to (H, W, 3) uint8 RGB."""
    lib = _load()
    if not lib:
        from PIL import Image

        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"), dtype=np.uint8)
    h, w = image_info(path)
    out = np.empty((h, w, 3), dtype=np.uint8)
    rc = lib.ct_decode_rgb8(str(path).encode(), _out_ptr(out), out.size)
    if rc != 0:
        raise IOError(f"ct_decode_rgb8({path}) failed with {rc}")
    return out


def read_image_crop(path, top, left, crop_h, crop_w):
    """Decode only the rows covering [top, top + crop_h) and slice the crop;
    PNG inflation stops at the last needed row."""
    lib = _load()
    if not lib:
        return read_image(path)[top : top + crop_h, left : left + crop_w]
    out = np.empty((crop_h, crop_w, 3), dtype=np.uint8)
    rc = lib.ct_decode_crop_rgb8(str(path).encode(), top, left, crop_h, crop_w,
                                 _out_ptr(out), out.size)
    if rc != 0:
        raise IOError(f"ct_decode_crop_rgb8({path}) failed with {rc}")
    return out
