"""ctypes bindings for the host resize library (JAX counterpart:
transformerupscaler_tpu/native.py).

``csrc/resize.cpp`` (the port's copy of the JAX package's
``native/resize.cpp``) is PIL's antialiased bilinear resize in C++ with
OpenMP row parallelism: the streaming pipeline's host preprocess; and,
beside it, PIL's BICUBIC resize (``resize_bicubic_u8``, the inference
CLI's bicubic control image), in PIL's own fixed-point arithmetic. It is
built at first use into ``build/torch_native/`` at the root of the
checkout, under a name that carries a hash of the source and the host's CPU
model, and loaded with ctypes. The build takes the first of the host's C++
compilers (``CXX`` if set, then ``g++``, ``c++``) that compiles it with the
JAX package's flags; where none has OpenMP (a compiler without
``libgomp``), the first that compiles it without ``-fopenmp``, whose
pragmas it then ignores: the same function, each row computed alike, on
one thread. ``build_info()`` says which compiler and flags built it.

Unlike the JAX module there is no PIL fallback: a library that does not
build, does not load, or returns an error raises. ``CALLS`` counts the
resizes the library has done, so that a caller can tell it ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "resize.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-std=c++17",
             "-Wall", "-shared")
CALLS = {"resize_bilinear_u8": 0, "resize_to_model_input": 0,
         "resize_bicubic_u8": 0}

_lock = threading.Lock()
_lib = None


def compilers() -> list[str]:
    """The host C++ compilers to try, in order: ``CXX`` if set, ``g++``,
    ``c++``."""
    out = []
    for c in (os.environ.get("CXX"), "g++", "c++"):
        if c and c not in out:
            out.append(c)
    return out


def _host_cpu() -> str:
    """The host CPU's model name: ``-march=native`` builds for it, so a
    build directory carried to another host rebuilds."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def lib_path() -> Path:
    h = hashlib.sha256(" ".join((*compilers(), *CXX_FLAGS,
                                 _host_cpu())).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtuxresize-{h.hexdigest()[:12]}.so"


def build_info() -> dict:
    """{"compiler", "flags", "openmp"} of the built library."""
    return json.loads(lib_path().with_suffix(".json").read_text())


def build() -> Path:
    """Compile the library unless it is built (with OpenMP where a
    compiler has it); raises with every compiler's output when none
    builds it."""
    path = lib_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    without = tuple(f for f in CXX_FLAGS if f != "-fopenmp")
    failed = []
    for flags in (CXX_FLAGS, without):
        for cxx in compilers():
            cmd = [cxx, *flags, "-o", str(tmp), str(SOURCE)]
            try:
                run = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=300)
            except OSError as e:
                failed.append(f"{' '.join(cmd)}: cannot run: {e}")
                continue
            if run.returncode == 0:
                os.replace(tmp, path)
                path.with_suffix(".json").write_text(json.dumps(dict(
                    compiler=cxx, flags=list(flags),
                    openmp="-fopenmp" in flags)))
                return path
            failed.append(f"{' '.join(cmd)} failed ({run.returncode}):\n"
                          f"{run.stdout}{run.stderr}")
    raise RuntimeError("native resize: no compiler builds "
                       f"{SOURCE.name}:\n" + "\n".join(failed))


def load() -> ctypes.CDLL:
    """The library, built first if needed, with its signatures declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8 = ctypes.POINTER(ctypes.c_uint8)
            f32 = ctypes.POINTER(ctypes.c_float)
            i = ctypes.c_int
            lib.tux_resize_bilinear_u8.argtypes = [u8, i, i, i, u8, i, i]
            lib.tux_resize_bilinear_u8_to_f32.argtypes = [u8, i, i, i, f32,
                                                          i, i]
            lib.tux_resize_bicubic_u8.argtypes = [u8, i, i, i, u8, i, i]
            lib.tux_resize_bilinear_u8.restype = ctypes.c_int
            lib.tux_resize_bicubic_u8.restype = ctypes.c_int
            lib.tux_resize_bilinear_u8_to_f32.restype = ctypes.c_int
            _lib = lib
        return _lib


def _resize(fn: str, src: np.ndarray, out_hw, dtype) -> np.ndarray:
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if src.ndim != 3:
        raise ValueError(f"native resize: HWC frames only, got {src.shape}")
    ih, iw, c = src.shape
    h, w = out_hw
    dst = np.empty((h, w, c), dtype)
    ptr = ctypes.POINTER(np.ctypeslib.as_ctypes_type(dtype))
    rc = getattr(load(), fn)(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ih, iw, c,
        dst.ctypes.data_as(ptr), h, w)
    if rc != 0:
        raise RuntimeError(f"native resize: {fn} returned {rc} for "
                           f"{src.shape} -> {tuple(out_hw)}")
    return dst


def resize_bilinear_u8(src: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """HWC uint8 -> HWC uint8, PIL-antialias bilinear semantics."""
    out = _resize("tux_resize_bilinear_u8", src, out_hw, np.uint8)
    with _lock:
        CALLS["resize_bilinear_u8"] += 1
    return out


def resize_bicubic_u8(src: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """HWC uint8 -> HWC uint8, PIL's ``Image.resize(..., Image.BICUBIC)``."""
    out = _resize("tux_resize_bicubic_u8", src, out_hw, np.uint8)
    with _lock:
        CALLS["resize_bicubic_u8"] += 1
    return out


def resize_to_model_input(src: np.ndarray,
                          out_hw: tuple[int, int]) -> np.ndarray:
    """HWC uint8 -> HWC float32 in [0, 1] (resize and normalize in one
    pass)."""
    out = _resize("tux_resize_bilinear_u8_to_f32", src, out_hw, np.float32)
    with _lock:
        CALLS["resize_to_model_input"] += 1
    return out
