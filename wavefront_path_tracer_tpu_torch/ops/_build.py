"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

The sources under ``csrc/`` have a plain C interface, so one ``nvcc``
call turns them into a shared library in seconds (PyTorch's
``cpp_extension`` route compiles PyTorch's headers and takes minutes).
The library lands in ``build/kernels/<hash>/libwpt_kernels.so`` at the
repository root, keyed by a hash of the sources and flags, and is built
at first use in a process.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libwpt_kernels.so"

# Never --use_fast_math: the nearest-hit select needs IEEE NaN compares,
# and -ftz=false -prec-div=true -prec-sqrt=true are nvcc's defaults.
# -fmad=false: without FMA contraction the kernels are bit-identical to
# their plain PyTorch versions on the card, so they are checked exactly.
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_command(out: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out),
            *(str(s) for s in sources())]


@functools.lru_cache(maxsize=1)
def build() -> tuple[Path, str, float]:
    """Compile if the hashed library is missing; (path, ptxas report,
    build seconds).  Raises with nvcc's stderr when the build fails."""
    digest = hashlib.sha256()
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, "", 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        proc = subprocess.run(build_command(tmp_lib), capture_output=True,
                              text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp_lib, lib)
    return lib, proc.stderr, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built library, with argtypes and restype declared."""
    path, _report, _seconds = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                          ctypes.c_float)
    fn = lib.wpt_persistent_launch
    fn.argtypes = [
        ptr, i32, ptr,                 # scene, n_rows, cam
        ptr, ptr, ptr, ptr, ptr,       # pix, xs, ys, valid, soff
        ptr, ptr, ptr, ptr, i32,       # rad_r, rad_g, rad_b, rays, n_lanes
        u32, u32, u32, u32,            # frame, sample_base, max_b, n_samples
        u32, f32, f32, i32,            # rr_start, rr_floor, clamp, stratified
        ptr,                           # stream
    ]
    fn.restype = ctypes.c_int
    return lib
