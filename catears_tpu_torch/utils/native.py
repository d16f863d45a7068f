"""ctypes bindings for the native C++ host library (port of
catears_tpu/utils/native.py).

The host-side hot paths stay native, as in the JAX package: the threaded
batch WAV loader, ConstFst parsing, the backtrace and the edit distance.
Every entry point has a pure Python fallback (in the modules that call
these), so the library is an accelerator, not a requirement: each call
returns None when it cannot be built, and the caller takes its Python
path.

The source is the package's own `csrc/catears_native.cc`.  On first use it
is compiled by the host C++ compiler ($CXX, else `c++`) with the flags of
the repo's csrc/Makefile into `_build/libcatears_native-<hash>.so` next to
the package (listed in .gitignore); the hash covers the source and the
flags, so an edited source is rebuilt.  The compiler's output stays in
BUILD_LOG.  Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "catears_native.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_lock = threading.Lock()
BUILD_LOG = ""  # the compiler's output (or why nothing was built)


def compiler() -> Optional[str]:
    """The host C++ compiler: $CXX, else c++ / g++ on $PATH."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        if name and shutil.which(name):
            return shutil.which(name)
    return None


def lib_path() -> str:
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as fd:
        digest.update(fd.read())
    digest.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libcatears_native-{digest.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    global BUILD_LOG
    cxx = compiler()
    if cxx is None:
        BUILD_LOG = "no C++ compiler ($CXX, c++ or g++) on this machine"
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        BUILD_LOG = f"{cxx} failed to run: {e}"
        return False
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        BUILD_LOG = f"{cxx} exited {proc.returncode}:\n{BUILD_LOG}"
        return False
    os.replace(tmp, out)
    return True


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _TRIED, BUILD_LOG
    with _lock:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        out = lib_path()
        if not os.path.exists(out) and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            BUILD_LOG += f"\nloading {out} failed: {e}"
            return None
        lib.ce_parse_wav_header.restype = ctypes.c_int
        lib.ce_pcm_to_float.restype = ctypes.c_int
        lib.ce_load_wav_batch.restype = ctypes.c_int
        lib.ce_parse_const_fst.restype = ctypes.c_int
        lib.ce_backtrace.restype = ctypes.c_int
        lib.ce_edit_distance.restype = ctypes.c_int
        _LIB = lib
        return lib


def available() -> bool:
    return load() is not None


def load_wav_batch(paths: List[str],
                   num_threads: int = 0) -> Optional[List[np.ndarray]]:
    """Threaded native batch WAV load; None if the library is missing."""
    lib = load()
    if lib is None:
        return None
    count = len(paths)
    sizes = [os.path.getsize(p) for p in paths]
    # Conservative capacity: whole file as 8-bit samples
    offsets = np.zeros(count, np.int64)
    total = 0
    for i, s in enumerate(sizes):
        offsets[i] = total
        total += s  # >= payload samples for all widths
    out = np.zeros(total, np.float32)
    lengths = np.zeros(count, np.int64)
    c_paths = (ctypes.c_char_p * count)(
        *[p.encode("utf-8") for p in paths])
    rc = lib.ce_load_wav_batch(
        c_paths, ctypes.c_int32(count),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(num_threads))
    if rc != 0:
        return None
    result = []
    for i in range(count):
        if lengths[i] < 0:
            raise IOError(f"native wav load failed for {paths[i]} "
                          f"(code {lengths[i]})")
        result.append(out[offsets[i]:offsets[i] + lengths[i]].copy())
    return result


def parse_const_fst(data: bytes):
    """Native ConstFst parse -> (start, final, pos, count, arcs[A,4]) or None."""
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    start = ctypes.c_int64()
    ns = ctypes.c_int64()
    na = ctypes.c_int64()
    rc = lib.ce_parse_const_fst(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(buf.size), ctypes.byref(start), ctypes.byref(ns),
        ctypes.byref(na), None, None, None, None)
    if rc != 0:
        return None
    final = np.zeros(ns.value, np.float32)
    pos = np.zeros(ns.value, np.int64)
    cnt = np.zeros(ns.value, np.int32)
    arcs = np.zeros((na.value, 4), np.int32)
    rc = lib.ce_parse_const_fst(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(buf.size), ctypes.byref(start), ctypes.byref(ns),
        ctypes.byref(na),
        final.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        arcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        return None
    return start.value, final, pos, cnt, arcs


def backtrace(prev_slot: np.ndarray, words: np.ndarray,
              start_slot: int) -> Optional[List[int]]:
    """Native backtrace over stacked [T, K] / [T, K, W] traces."""
    lib = load()
    if lib is None:
        return None
    t, k = prev_slot.shape
    w = words.shape[2]
    prev_c = np.ascontiguousarray(prev_slot, np.int32)
    words_c = np.ascontiguousarray(words, np.int32)
    out = np.zeros(t * w + 8, np.int32)
    n = lib.ce_backtrace(
        prev_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        words_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(t), ctypes.c_int32(k), ctypes.c_int32(w),
        ctypes.c_int32(start_slot),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(out.size))
    if n < 0:
        return None
    return [int(x) for x in out[:n]]


def edit_distance(ref: List[int], hyp: List[int]) -> Optional[int]:
    lib = load()
    if lib is None:
        return None
    r = np.asarray(ref, np.int32)
    h = np.asarray(hyp, np.int32)
    return int(lib.ce_edit_distance(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(r.size),
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(h.size)))
