"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

The sources under ``csrc/`` have a plain C interface, so ``nvcc`` turns
them into a shared library in seconds (PyTorch's ``cpp_extension`` route
compiles PyTorch's headers and takes minutes).  Each ``.cu`` file is
compiled by its own ``nvcc`` process, all started together, and one more
links the objects.  The library lands in
``build/kernels/<hash>/libwpt_kernels.so`` at the repository root, keyed
by a hash of its sources, the headers and the flags, and is built at
first use in a process; ptxas's report of the build is kept beside it
(``ptxas.txt``).  This hash-keyed directory is the port's counterpart of
the reference's ``utils/compile_cache.py``.  Nothing here runs at import
time.

The stage probes' kernels (``baked_probe*.cu``, ``dynculled_probe*.cu``:
the shipped kernels with one stage duplicated, which no render path
launches) make a second library, ``libwpt_stage_probes.so``, built the
same way but only where a probe is launched (:func:`load_probe_library`),
so that the shipped library's build does not carry them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libwpt_kernels.so"
PROBE_LIB_NAME = "libwpt_stage_probes.so"
# The translation units of PROBE_LIB_NAME; every other .cu is LIB_NAME's.
PROBE_UNITS = ("baked_probe*.cu", "dynculled_probe*.cu")
REPORT_NAME = "ptxas.txt"
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


def sources(lib: str = LIB_NAME) -> list[Path]:
    """The translation units of ``lib`` (:data:`LIB_NAME` or
    :data:`PROBE_LIB_NAME`), one ``nvcc -c`` each."""
    probes = {p for pattern in PROBE_UNITS for p in CSRC.glob(pattern)}
    if lib == PROBE_LIB_NAME:
        return sorted(probes)
    if lib != LIB_NAME:
        raise ValueError(f"unknown library {lib!r}")
    return sorted(set(CSRC.glob("*.cu")) - probes)


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def compile_command(src: Path, obj: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(objs: list[Path], out: Path) -> list[str]:
    return [_nvcc(), *ARCH, "-shared", "-o", str(out),
            *(str(o) for o in objs)]


def _digest(lib: str) -> str:
    digest = hashlib.sha256(lib.encode())
    for path in sources(lib) + headers():
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def _run_all(commands: list[list[str]]) -> tuple[str, list[float]]:
    """Run the commands in parallel; (their stderr, joined, and each
    one's seconds from the common start to its end).  Raises with the
    stderr of the first that fails."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in commands]
    outs, seconds = [None] * len(procs), [0.0] * len(procs)

    def wait(k):
        outs[k] = procs[k].communicate()
        seconds[k] = time.perf_counter() - t0

    threads = [threading.Thread(target=wait, args=(k,))
               for k in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for cmd, proc, (_out, err) in zip(commands, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    return "".join(err for _out, err in outs), seconds


_LOCKS = {LIB_NAME: threading.Lock(), PROBE_LIB_NAME: threading.Lock()}


def build(lib: str = LIB_NAME) -> tuple[Path, str, float]:
    """Compile ``lib`` (:data:`LIB_NAME` or :data:`PROBE_LIB_NAME`) if
    its hashed file is missing; (path, ptxas report, build seconds: 0
    where the library was there).  The report starts with one line a
    source, ``nvcc <name>: <seconds> s``, the seconds from the build's
    start to the end of that source's nvcc.  Raises with nvcc's stderr
    when the build fails.  A second thread asking for the same library
    waits for the first's build."""
    with _LOCKS[lib]:
        return _build(lib)


@functools.lru_cache(maxsize=None)
def _build(name: str) -> tuple[Path, str, float]:
    out_dir = BUILD_ROOT / _digest(name)
    lib = out_dir / name
    if lib.exists():
        report = out_dir / REPORT_NAME
        return lib, report.read_text() if report.exists() else "", 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    srcs = sources(name)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        report, seconds = _run_all([compile_command(src, obj)
                                    for src, obj in zip(srcs, objs)])
        report = "".join(f"nvcc {src.name}: {sec:.2f} s\n"
                         for src, sec in zip(srcs, seconds)) + report
        tmp_lib = Path(tmp) / name
        report += _run_all([link_command(objs, tmp_lib)])[0]
        (out_dir / REPORT_NAME).write_text(report)
        os.replace(tmp_lib, lib)
    return lib, report, time.perf_counter() - t0


def ptxas_kernels(report: str, match: str) -> list[dict]:
    """Registers, stack frame and spill bytes of each kernel whose
    mangled name holds ``match``, from ptxas's -v lines of ``report``:
    [{"mangled", "kernel" (the name demangled by c++filt where the
    machine has it, else the mangled one), "registers", "stack",
    "spill_stores", "spill_loads"}]."""
    import re

    props, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            cur = m.group(1)
            props.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            props[cur].update(stack=int(m[1]), spill_stores=int(m[2]),
                              spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            props[cur]["registers"] = int(m[1])
    names = [n for n in props if match in n]
    return [{"mangled": n, "kernel": d, **props[n]}
            for n, d in zip(names, demangle(names))]


def demangle(names: list[str]) -> list[str]:
    """``names`` demangled by c++filt, or as they are where the machine
    has no c++filt."""
    tool = shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    return subprocess.run([tool], input="\n".join(names),
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.splitlines()


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
        ptr, i32, i32,                 # scene, n_rows, loop
        *lane_args,
        ptr, ptr, ptr, ptr, i32,       # rad_r, rad_g, rad_b, rays, n_lanes
        *salt_args,
    ]
    fn.restype = ctypes.c_int
    out_args = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # rad_r, rad_g, rad_b, rays, supers,
        i32,                           # clusters, n_lanes
    ]
    baked_tables = [
        ptr, i32,                      # items, n_globals
        ptr, ptr, i32,                 # cluster boxes, ranges, n_clusters
        ptr, ptr, i32,                 # super boxes, ranges, n_supers
        ptr, i32,                      # triangles, n_tris
        ptr, ptr, i32,                 # triangle cluster boxes, ranges, n
        ptr, ptr, i32,                 # triangle super boxes, ranges, n
        ptr, i32,                      # consts, culled
        ptr, ptr, ptr, i32, i32,       # checker rows, image centres, words,
                                       # h, w
    ]
    fn = lib.wpt_baked_launch
    fn.argtypes = [
        *baked_tables, i32, i32, i32,  # textured, hint, sweep,
        i32,                           # probe
        *lane_args, *out_args, *salt_args,
    ]
    fn.restype = ctypes.c_int
    dyn_tables = [
        ptr, ptr, ptr, ptr,            # spheres, boxes, super boxes, slab
        ptr, ptr, ptr, ptr,            # the same for the triangles
        i32, i32, i32, i32, i32, i32,  # n_globals, n_clusters, n_supers,
                                       # n_tri_clusters, n_tri_supers,
                                       # cluster_size
        ptr, ptr, ptr, i32, i32,       # checker rows, image centres, words,
        i32,                           # h, w, textured
    ]
    fn = lib.wpt_dynculled_launch
    fn.argtypes = [*dyn_tables, i32, i32,  # sweep, probe
                   *lane_args, *out_args, *salt_args]
    fn.restype = ctypes.c_int
    seg_args = [
        ptr, ptr, ptr, i32,            # state, ids, counts, n_lanes
        u32, u32, u32,                 # frame, max_bounces, k_iters
        u32, f32, f32,                 # rr_start, rr_floor, clamp
        ptr,                           # stream
    ]
    fn = lib.wpt_baked_segment_launch
    fn.argtypes = [*baked_tables, i32, i32, i32,    # textured, sweep, probe
                   *seg_args]
    fn.restype = ctypes.c_int
    fn = lib.wpt_dynculled_segment_launch
    fn.argtypes = [*dyn_tables, i32, i32,           # sweep, probe
                   *seg_args]
    fn.restype = ctypes.c_int
    # Where the stage probes' library is loaded (load_probe_library).
    for fn in (lib.wpt_baked_set_probes, lib.wpt_dynculled_set_probes):
        fn.argtypes = [ptr, ptr]       # persistent loop's, segment's
        fn.restype = None
    # The probes (probes/): csrc/probe_pairs.cu, probe_tripair.cu and
    # probe_stream.cu.
    fn = lib.wpt_probe_pair_launch
    fn.argtypes = [ptr, ptr, ptr, i32, i32,   # tab, tab4, rays, n, reps
                   ptr, ptr]                  # out, stream
    fn.restype = ctypes.c_int
    fn = lib.wpt_probe_gated_launch
    fn.argtypes = [ptr, ptr, ptr, i32, i32,   # tab, cond, rays, n, reps
                   i32, i32, ptr, ptr]        # generic, gate, out, stream
    fn.restype = ctypes.c_int
    fn = lib.wpt_probe_tripair_launch
    fn.argtypes = [ptr, ptr, i32, ptr, i32,   # tab, pk, n_tri, rays, n
                   i32, i32, ptr, ptr]        # reps, form, out, stream
    fn.restype = ctypes.c_int
    fn = lib.wpt_probe_stream_grid
    fn.argtypes = [i32, i32, ctypes.c_int64]  # async, chunk_f4, n_chunks
    fn.restype = ctypes.c_int
    fn = lib.wpt_probe_stream_launch
    fn.argtypes = [ptr, ctypes.c_int64, i32,  # data, n_chunks, chunk_f4
                   i32, i32, i32, i32,        # passes, fmas, async, grid
                   ptr, ptr, ptr, ptr]        # part, xs, out, stream
    fn.restype = ctypes.c_int
    # probe_designs.cu, probe_issue.cu and probe_mma.cu.
    fn = lib.wpt_probe_design_launch
    fn.argtypes = [ptr, i32, ptr, i32, i32,   # tab, cols, rays, n, reps
                   i32, i32, i32, ptr, ptr]   # design, place, lanes, out,
    fn.restype = ctypes.c_int                 # stream
    fn = lib.wpt_probe_sqrt_mismatches
    fn.argtypes = [ptr, ptr]                  # count, stream
    fn.restype = ctypes.c_int
    fn = lib.wpt_probe_sin_mismatches
    fn.argtypes = [ptr, ptr]                  # count (2,), stream
    fn.restype = ctypes.c_int
    fn = lib.wpt_probe_issue_launch
    fn.argtypes = [i32, ptr, i32, i32,        # form, x, n_elems, reps
                   f32, f32, ptr, ptr]        # one, half, out, stream
    fn.restype = ctypes.c_int
    fn = lib.wpt_probe_mma_copies
    fn.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]   # row, copies
    fn.restype = ctypes.c_int
    fn = lib.wpt_probe_mma_launch
    fn.argtypes = [i32, ptr, ptr, i32, i32,   # row, a, b, products, copies
                   ptr, ptr]                  # out, stream
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def load_probe_library() -> ctypes.CDLL:
    """The stage probes' library (:data:`PROBE_LIB_NAME`), built if it is
    missing, its dispatch functions handed to the shipped library: from
    then on the shipped entry points launch a probe's kernel for a
    non-zero ``probe`` (``csrc/baked.cu``, ``csrc/dynculled.cu``); before,
    they return cudaErrorInvalidValue for it."""
    path, _report, _seconds = build(PROBE_LIB_NAME)
    probes = ctypes.CDLL(str(path))
    lib = load_library()
    for kind in ("baked", "dynculled"):
        getattr(lib, f"wpt_{kind}_set_probes")(*(
            ctypes.cast(getattr(probes, f"wpt_{kind}_{fn}"), ctypes.c_void_p)
            for fn in ("probe_dispatch", "segment_probe_dispatch")))
    return probes
