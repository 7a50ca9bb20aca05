"""ctypes binding of the C++ BVH builder (``bvh_builder.cpp``).

The port's own copy of ``wavefront_path_tracer_tpu/native/``: the same
flat-array contract as ``scene.bvh.build_flat_bvh``, with bit-identical
output (``tests/test_torch_bvh.py``), so it is a drop-in accelerator that
``build_bvh(..., backend="auto")`` selects.  It is a host builder, not a
device path.  The library lands in
``build/native/<hash>/_bvh_builder.so`` at the repository root, built by
``g++`` at first use in a process; nothing runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "bvh_builder.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_NAME = "_bvh_builder.so"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / LIB_NAME


def _compile(lib: Path) -> None:
    """Build into a temporary name and rename, so that processes that
    build at once never load a half-written library."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        out = Path(tmp) / LIB_NAME
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(out), str(SRC)],
                       check=True, capture_output=True)
        os.replace(out, lib)


def _load():
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        lib.wpt_build_bvh.restype = ctypes.c_int
        lib.wpt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # centers
            ctypes.POINTER(ctypes.c_float),  # radii
            ctypes.c_int,                    # n
            ctypes.c_int,                    # bins
            ctypes.c_int,                    # max_leaf
            ctypes.POINTER(ctypes.c_float),  # out aabb_min
            ctypes.POINTER(ctypes.c_float),  # out aabb_max
            ctypes.POINTER(ctypes.c_int32),  # out left_first
            ctypes.POINTER(ctypes.c_int32),  # out prim_count
            ctypes.POINTER(ctypes.c_int32),  # out perm
        ]
        _lib = lib
        return lib


def build_flat_bvh(centers, radii, bins: int = 64, max_leaf_size: int = 4):
    """Native equivalent of scene.bvh.build_flat_bvh; (FlatBVH, perm)."""
    from wavefront_path_tracer_tpu_torch.scene.bvh import FlatBVH

    lib = _load()
    centers = np.ascontiguousarray(centers, np.float32)
    radii = np.ascontiguousarray(radii, np.float32)
    n = centers.shape[0]
    cap = 2 * n + 2
    aabb_min = np.empty((cap, 3), np.float32)
    aabb_max = np.empty((cap, 3), np.float32)
    left_first = np.empty(cap, np.int32)
    prim_count = np.empty(cap, np.int32)
    perm = np.empty(n, np.int32)

    def fptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def iptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    num_nodes = lib.wpt_build_bvh(
        fptr(centers), fptr(radii), n, bins, max_leaf_size,
        fptr(aabb_min), fptr(aabb_max), iptr(left_first), iptr(prim_count),
        iptr(perm),
    )
    if num_nodes < 0:
        raise RuntimeError("native BVH build failed (capacity)")
    bvh = FlatBVH(
        aabb_min=aabb_min[:num_nodes].copy(),
        aabb_max=aabb_max[:num_nodes].copy(),
        left_first=left_first[:num_nodes].copy(),
        prim_count=prim_count[:num_nodes].copy(),
    )
    return bvh, perm.astype(np.int64)
