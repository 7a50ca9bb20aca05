"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

The sources under ``csrc/`` have a plain C interface, so ``nvcc`` turns
them into a shared library in seconds (PyTorch's ``cpp_extension`` route
compiles PyTorch's headers and takes minutes).  Each ``.cu`` file is
compiled by its own ``nvcc`` process, all started together, and one more
links the objects.  The library lands in
``build/kernels/<hash>/libwpt_kernels.so`` at the repository root, keyed
by a hash of the sources, the headers and the flags, and is built at
first use in a process.  Nothing here runs at import time.
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")

# Never --use_fast_math: the nearest-hit select needs IEEE NaN compares,
# and -ftz=false -prec-div=true -prec-sqrt=true are nvcc's defaults.
# -fmad=false: without FMA contraction the kernels are bit-identical to
# their plain PyTorch versions on the card, so they are checked exactly.
NVCC_FLAGS = (
    "-O3", "-std=c++17", *ARCH, "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
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
    """The translation units, one ``nvcc -c`` each."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def compile_command(src: Path, obj: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(objs: list[Path], out: Path) -> list[str]:
    return [_nvcc(), *ARCH, "-shared", "-o", str(out),
            *(str(o) for o in objs)]


def _digest() -> str:
    digest = hashlib.sha256()
    for path in sources() + headers():
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def _run_all(commands: list[list[str]]) -> str:
    """Run the commands in parallel; their stderr, joined.  Raises with
    the stderr of the first that fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in commands]
    outs = [p.communicate() for p in procs]
    for cmd, proc, (_out, err) in zip(commands, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    return "".join(err for _out, err in outs)


@functools.lru_cache(maxsize=1)
def build() -> tuple[Path, str, float]:
    """Compile if the hashed library is missing; (path, ptxas report,
    build seconds).  Raises with nvcc's stderr when the build fails."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, "", 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        report = _run_all([compile_command(src, obj)
                           for src, obj in zip(sources(), objs)])
        tmp_lib = Path(tmp) / LIB_NAME
        report += _run_all([link_command(objs, tmp_lib)])
        os.replace(tmp_lib, lib)
    return lib, report, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built library, with argtypes and restype declared."""
    path, _report, _seconds = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                          ctypes.c_float)
    lane_args = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # cam, pix, xs, ys, valid, soff
    ]
    salt_args = [
        u32, u32, u32, u32,            # frame, sample_base, max_b, n_samples
        u32, f32, f32, i32,            # rr_start, rr_floor, clamp, stratified
        ptr,                           # stream
    ]
    fn = lib.wpt_persistent_launch
    fn.argtypes = [
        ptr, i32,                      # scene, n_rows
        *lane_args,
        ptr, ptr, ptr, ptr, i32,       # rad_r, rad_g, rad_b, rays, n_lanes
        *salt_args,
    ]
    fn.restype = ctypes.c_int
    fn = lib.wpt_baked_launch
    fn.argtypes = [
        ptr, i32,                      # items, n_globals
        ptr, ptr, i32,                 # cluster boxes, ranges, n_clusters
        ptr, ptr, i32,                 # super boxes, ranges, n_supers
        ptr, i32,                      # consts, culled
        *lane_args,
        ptr, ptr, ptr, ptr, ptr, ptr,  # rad_r, rad_g, rad_b, rays, supers,
        i32,                           # clusters, n_lanes
        *salt_args,
    ]
    fn.restype = ctypes.c_int
    return lib
