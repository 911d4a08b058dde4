"""ctypes binding for the native preprocessing library
(`walkgpt_tpu_torch/_native/preprocess.cpp`).

The library is built with g++ at first use, from the package's own source,
into `build/native/` at the repository root (its file name carries a hash of
the source and flags, so an edited source is rebuilt). Where it cannot be
built or loaded, every function falls back to the PIL path of transforms.py.
The native resampler mirrors Pillow's fixed-point BILINEAR pipeline, so both
paths are byte-identical.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "_native" / "preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-march=native")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libwgpreprocess-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([os.environ.get("CXX", "g++"), *FLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)


def load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = library_path()
    if not so.exists():
        try:
            _build(so)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.wg_resize_bilinear_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, u8p, ctypes.c_int,
                                          ctypes.c_int]
    lib.wg_normalize_pad_f32.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                         f32p, f32p, f32p, ctypes.c_int]
    lib.wg_preprocess_stream.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         f32p, f32p, f32p, i32p, i32p]
    for fn in (lib.wg_resize_bilinear_u8, lib.wg_normalize_pad_f32, lib.wg_preprocess_stream):
        fn.restype = None
    _LIB = lib
    return _LIB


def available() -> bool:
    return load_library() is not None


def resize_bilinear(image: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """uint8 HWC resize, Pillow-BILINEAR-exact. Falls back to PIL."""
    lib = load_library()
    if lib is None:
        from . import transforms as T
        return T._pil_resize(image, size_hw)
    image = np.ascontiguousarray(image, np.uint8)
    h, w, c = image.shape
    out = np.empty((size_hw[0], size_hw[1], c), np.uint8)
    lib.wg_resize_bilinear_u8(image, h, w, c, out, size_hw[0], size_hw[1])
    return out


def preprocess_stream(image: np.ndarray, target_long: int, pad_size: int,
                      mean: np.ndarray, std: np.ndarray
                      ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Fused longest-side resize + normalize + pad. Returns (canvas, (rh, rw))."""
    lib = load_library()
    if lib is None:
        from . import transforms as T
        resized = T.resize_longest_side(image, target_long)
        return (T.normalize_pad(resized, mean, std, pad_size),
                resized.shape[:2])
    image = np.ascontiguousarray(image, np.uint8)
    h, w, _ = image.shape
    out = np.empty((pad_size, pad_size, 3), np.float32)
    rh = ctypes.c_int()
    rw = ctypes.c_int()
    lib.wg_preprocess_stream(image, h, w, target_long, pad_size,
                             np.ascontiguousarray(mean, np.float32),
                             np.ascontiguousarray(std, np.float32),
                             out, ctypes.byref(rh), ctypes.byref(rw))
    return out, (rh.value, rw.value)
