"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes`. All
sources build in parallel, at first use, into ``build/torch_kernels/`` at the
root of the checkout; a library's file name carries a hash of its sources and
flags, so an edited source rebuilds and an unchanged one is reused.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from transformerupscaler_torch.counters import COUNTERS

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Library -> {C function: argument types}. Every function returns the
# cudaError_t of its launch as an int.
SIGNATURES = {
    "conv1": {
        "tux_conv1": [_P] * 5 + [_I] * 7 + [_P],
    },
    "conv3x3": {
        "tux_conv3x3_any": [_P] * 5 + [_I] * 9 + [_P],
        "tux_conv3x3_desc_probe": [_P] * 3 + [_I] * 2 + [_P],
        "tux_conv3x3_i8_desc_probe": [_P] * 3 + [_I] * 2 + [_P],
        "tux_conv3x3_int8": [_P] * 5 + [_I] * 6 + [_P],
    },
    "conv_tail": {
        "tux_conv_tail": [_P] * 7 + [_I] * 9 + [_P],
        "tux_wgmma_kb_probe": [_P] * 3 + [_I] * 2 + [_P],
    },
    "global_mha": {
        "tux_global_mha": [_P] * 4 + [_I] * 4 + [_L] * 2 + [_I, _P],
    },
    "patch_gemm": {
        "tux_embed": [_P] * 5 + [_I] * 5 + [_P],
        "tux_unembed_combine": [_P] * 6 + [_I] * 7 + [_P],
    },
    "tail_strip": {
        "tux_tail_conv": [_P] * 4 + [_I] * 9 + [_P],
        "tux_tail_finish": [_P] * 6 + [_I] * 10 + [_P],
        "tux_tail_conv_int8": [_P] * 5 + [_I] * 9 + [_P],
    },
    "window_attn": {
        "tux_window_attn": [_P] * 3 + [_I] * 4 + [_P],
        "tux_window_attn_empty": [_I] * 3 + [_P],
    },
    "window_trunk": {
        "tux_window_trunk": [_P] * 7 + [_I] * 5 + [_P],
        "tux_wgmma_i8_probe": [_P] * 6 + [_I, _P],
        "tux_gelu_i8_probe": [_P] * 2 + [_I] * 2 + [_P],
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's kernels build only on a CUDA host")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=tuple(SIGNATURES)) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    per source, all started together. Returns seconds per library built
    (empty when all were current). Raises with the compiler's output on
    failure; the ``-Xptxas -v`` report of each build is kept beside its
    library as ``<name>.ptxas.txt``."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    secs, failed = {}, []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        (BUILD_DIR / f"{n}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, _lib_path(n))
    COUNTERS["kernel_builds"] += len(todo) - len(failed)
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` with its function signatures declared,
    building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib
