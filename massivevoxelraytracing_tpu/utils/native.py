"""ctypes bridge to the native host runtime (csrc/native.cpp).

Builds build/libmvrt.so on demand with g++ (cached by source mtime) and
falls back to the pure-python implementations when no compiler is available.
This is the counterpart of the reference's compiled host layer
(hipUtil/prlib): compute stays on the device, host IO/generation stays native.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "csrc", "native.cpp")
_SO = os.path.join(_ROOT, "build", "libmvrt.so")

_lib = None
_tried = False


def get_lib():
    """Returns the loaded library or None (fallback to python paths)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_SO)) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            os.makedirs(os.path.dirname(_SO), exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
                 "-shared", "-o", _SO, _SRC, "-lz"],
                check=True, capture_output=True,
            )
        lib = ctypes.CDLL(_SO)
        lib.mvrt_png_encode.restype = ctypes.c_int64
        lib.mvrt_png_bound.restype = ctypes.c_int64
        lib.mvrt_hdr_decode.restype = ctypes.c_int32
        lib.mvrt_obj_parse.restype = ctypes.c_int64
        lib.mvrt_murmur3_32.restype = ctypes.c_uint32
        lib.mvrt_split_to_cap.restype = ctypes.c_int64
        _lib = lib
    except Exception as e:
        import sys

        msg = e
        if isinstance(e, subprocess.CalledProcessError):
            msg = (e.stderr or b"").decode(errors="replace")[-400:]
        sys.stderr.write(
            f"[native] libmvrt build/load failed, using python fallbacks: {msg}\n"
        )
        _lib = None
    return _lib


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def png_encode(img: np.ndarray, level: int = 1) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    cap = lib.mvrt_png_bound(w, h, c)
    out = np.empty(cap, np.uint8)
    n = lib.mvrt_png_encode(
        _ptr(img, ctypes.c_uint8), w, h, c, level,
        _ptr(out, ctypes.c_uint8), cap,
    )
    if n <= 0:
        return None
    return out[:n].tobytes()


def hdr_decode(pix: bytes, w: int, h: int) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(pix, np.uint8)
    out = np.empty((h, w, 3), np.float32)
    rc = lib.mvrt_hdr_decode(
        _ptr(buf, ctypes.c_uint8), len(buf), w, h, _ptr(out, ctypes.c_float)
    )
    return out if rc == 0 else None


def obj_parse(path: str) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    with open(path, "rb") as f:
        text = f.read()
    buf = np.frombuffer(text, np.uint8)
    n = lib.mvrt_obj_parse(
        _ptr(buf, ctypes.c_char), len(buf), None, 0
    )
    if n < 0:
        return None
    out = np.empty((n, 3, 3), np.float32)
    n2 = lib.mvrt_obj_parse(
        _ptr(buf, ctypes.c_char), len(buf), _ptr(out, ctypes.c_float), n
    )
    return out if n2 == n else None


def pmj02_table(n_sequence: int, length: int, seed: int = 0,
                stream: int = 2525) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((n_sequence, length, 2), np.float32)
    lib.mvrt_pmj02_table(
        ctypes.c_int32(n_sequence), ctypes.c_int32(length),
        ctypes.c_uint64(seed), ctypes.c_uint64(stream),
        _ptr(out, ctypes.c_float),
    )
    return out


def morton_encode(x, y, z) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.uint32)
    y = np.ascontiguousarray(y, np.uint32)
    z = np.ascontiguousarray(z, np.uint32)
    out = np.empty(len(x), np.uint64)
    lib.mvrt_morton_encode(
        _ptr(x, ctypes.c_uint32), _ptr(y, ctypes.c_uint32),
        _ptr(z, ctypes.c_uint32), len(x), _ptr(out, ctypes.c_uint64),
    )
    return out


def morton_decode(m) -> tuple | None:
    lib = get_lib()
    if lib is None:
        return None
    m = np.ascontiguousarray(m, np.uint64)
    x = np.empty(len(m), np.uint32)
    y = np.empty(len(m), np.uint32)
    z = np.empty(len(m), np.uint32)
    lib.mvrt_morton_decode(
        _ptr(m, ctypes.c_uint64), len(m), _ptr(x, ctypes.c_uint32),
        _ptr(y, ctypes.c_uint32), _ptr(z, ctypes.c_uint32),
    )
    return x, y, z


def split_to_cap(verts, colors, emissions, origin, dps, grid_res: int,
                 cap: int) -> tuple | None:
    """Longest-edge bisection until every triangle's voxel bbox fits cap^3
    (worklist form in C++; the numpy fallback reallocates per round)."""
    lib = get_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, np.float32).reshape(-1, 9)
    c = np.ascontiguousarray(colors, np.float32).reshape(-1, 9)
    e = np.ascontiguousarray(emissions, np.float32).reshape(-1, 9)
    org = np.ascontiguousarray(origin, np.float32)
    n = len(v)
    args = (
        _ptr(v, ctypes.c_float), _ptr(c, ctypes.c_float),
        _ptr(e, ctypes.c_float), ctypes.c_int64(n),
        _ptr(org, ctypes.c_float), ctypes.c_float(dps),
        ctypes.c_int64(grid_res), ctypes.c_int64(cap),
    )
    # one sizing pass, then the fill pass (worklist recomputes; both are
    # cheap next to the per-round numpy reallocation this replaces)
    total = lib.mvrt_split_to_cap(*args, None, None, None, ctypes.c_int64(0))
    if total < 0:
        return None
    ov = np.empty((total, 9), np.float32)
    oc = np.empty((total, 9), np.float32)
    oe = np.empty((total, 9), np.float32)
    n2 = lib.mvrt_split_to_cap(
        *args, _ptr(ov, ctypes.c_float), _ptr(oc, ctypes.c_float),
        _ptr(oe, ctypes.c_float), ctypes.c_int64(total),
    )
    if n2 != total:
        return None
    return (ov.reshape(-1, 3, 3), oc.reshape(-1, 3, 3), oe.reshape(-1, 3, 3))


def murmur3_32(data: bytes, seed: int = 0) -> int | None:
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    if len(buf) == 0:
        buf = np.zeros(1, np.uint8)
    return int(lib.mvrt_murmur3_32(_ptr(buf, ctypes.c_uint8), len(data), seed))
