"""Build and load the package's hand-written CUDA kernels.

Each source `csrc/<name>.cu` is compiled by `nvcc` for sm_90a (Hopper) into
a shared library with a plain C interface, `_build/lib<name>-<hash>.so`
next to this file (listed in .gitignore), and loaded with ctypes: every C
entry point returns 0 or a cudaError_t, and every library has
`catears_error_string(code)`.  The hash
covers the sources and the flags, so an edited source is rebuilt.  All
sources are compiled at once (one nvcc process each) on first use; nothing
is built or loaded when this module is imported: the CPU tests import every
module of the package.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-ldl"]

_lock = threading.Lock()
_libs: Optional[Dict[str, ctypes.CDLL]] = None
BUILD_LOG: Dict[str, str] = {}  # per source: nvcc's output (ptxas -v)


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else $PATH, else /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _lib_path(src: str) -> str:
    digest = hashlib.sha256()
    for part in (open(src, "rb").read(), " ".join(NVCC_FLAGS + LINK_FLAGS)
                 .encode()):
        digest.update(part)
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def load_kernels() -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; cached per
    process.  Returns {source name: ctypes.CDLL}.

    Raises RuntimeError with nvcc's output on any build failure: a CUDA
    tensor never falls back to a plain version.
    """
    global _libs
    with _lock:
        if _libs is None:
            os.makedirs(BUILD_DIR, exist_ok=True)
            sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
            jobs = {}
            for src in sources:
                out = _lib_path(src)
                if os.path.exists(out):
                    continue
                tmp = f"{out}.{os.getpid()}.tmp"
                jobs[src] = (out, tmp, subprocess.Popen(
                    [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src, *LINK_FLAGS],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for src, (out, tmp, proc) in jobs.items():
                log, _ = proc.communicate()
                BUILD_LOG[os.path.splitext(os.path.basename(src))[0]] = log
                if proc.returncode == 0:
                    os.replace(tmp, out)
                else:
                    failed.append(f"nvcc failed on {src}:\n{log}")
            if failed:
                raise RuntimeError("\n".join(failed))
            _libs = {os.path.splitext(os.path.basename(src))[0]:
                     ctypes.CDLL(_lib_path(src)) for src in sources}
        return _libs


def kernel_library(name: str, argtypes: Dict[str, list]) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu` (built and loaded by load_kernels on
    first use) with its C functions' argument types set: ctypes.c_void_p
    for every pointer and the stream, or ctypes passes a 32-bit int."""
    lib = load_kernels()[name]
    if not getattr(lib, "catears_bound", False):
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        lib.catears_error_string.argtypes = [ctypes.c_int]
        lib.catears_error_string.restype = ctypes.c_char_p
        lib.catears_bound = True
    return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize does not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.catears_error_string(rc).decode()}")
