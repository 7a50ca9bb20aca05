"""In-kernel matrix products on the card: ``exp/micro_r2.py``'s
``matmul_bench`` (line 301), its inner ``kern`` (315).

    python -m wavefront_path_tracer_tpu_torch.probes.matmul_r2 \
        [--reps-lo 1000] [--reps-hi 4000] [--device cuda|cpu]

Seven rows, each REPS x 4 dependent products
``acc = acc + (a + acc[0, 0] * 1e-9) @ b`` summed into a float32
accumulator: f32 DEFAULT and HIGHEST at (128, 8) x (8, 1024),
(16, 400) x (400, 128) and (256, 128) x (128, 256), and bf16 at
(256, 128) x (128, 256).  Each row's a and b are drawn with
``uniform(-1, 1)`` from the module's RandomState(0) continuing after
micro_r2's module data, in row order (:func:`inputs` draws all seven);
the bf16 row casts the float64 draws to bf16 directly.

The kernels (``csrc/probe_mma.cu``): independent blocks share out the
accumulator's tiles, each also recomputing acc[0, 0] (the same
instructions, so the same bits), and copies of the whole accumulator
fill the card; DEFAULT is TF32 ``mma.sync`` (inputs rounded to nearest,
ties away), the bf16 row bf16 ``mma.sync`` with (a + s) rounded to bf16,
HIGHEST FP32 FMA chains.  The plain version is torch float32 with the
kernel's input rounding emulated; the two sum in other orders, so the
kernel is held to it within :func:`tolerance`.  The yardstick is
``torch.matmul`` (cuBLAS) in the same dependent loop, TF32 on for DEFAULT
and off for HIGHEST (:func:`library_loop`), never the port: over one
copy, over all the kernel's copies at once as a batched product, and
that batched loop captured once in a CUDA graph (:func:`library_graph`,
the host's launches taken out).  Printed: microseconds a product by
slope, the card's TFLOP/s over all copies against the dense peak of the
row's precision (495 TF32, 989 bf16, 67 FP32 TFLOP/s), and the three
library loops' microseconds a product.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.probes import _slope
from wavefront_path_tracer_tpu_torch.probes import micro_r2 as m

# matmul_bench's rows, in its order: (name, (m, k, n), precision).
ROWS = (
    ("f32 (128,8)x(8,1024) DEFAULT", (128, 8, 1024), "tf32"),
    ("f32 (128,8)x(8,1024) HIGHEST", (128, 8, 1024), "fp32"),
    ("f32 (16,400)x(400,128) DEFAULT", (16, 400, 128), "tf32"),
    ("f32 (16,400)x(400,128) HIGHEST", (16, 400, 128), "fp32"),
    ("f32 (256,128)x(128,256) DEFAULT", (256, 128, 256), "tf32"),
    ("f32 (256,128)x(128,256) HIGHEST", (256, 128, 256), "fp32"),
    ("bf16 (256,128)x(128,256)", (256, 128, 256), "bf16"),
)
PEAKS = {"tf32": _slope.PEAK_TF32, "bf16": _slope.PEAK_BF16,
         "fp32": _slope.PEAK_FP32}
# Input rounding of each precision, relative (half an ulp of the kept
# significand: TF32 10 bits, bf16 7), and float32's.
UNIT_IN = {"tf32": 2.0 ** -11, "bf16": 2.0 ** -8, "fp32": 0.0}
U32 = 2.0 ** -24
REPS = (1000, 4000)            # REPS of matmul_bench: 4 products each
LIBRARY_REPS = (100, 400)

# Kernel launches on CUDA tensors by matmul, by row index.
LAUNCHES = {r: 0 for r in range(len(ROWS))}
_COPIES: dict = {}


def module_rng() -> np.random.RandomState:
    """RandomState(0) after micro_r2's module draws, as ``matmul_bench``
    finds the module's ``rng``."""
    rs = np.random.RandomState(0)
    rs.uniform(-10, 10, (m.S, 3))
    rs.uniform(0.2, 1.0, (m.S,))
    rs.uniform(0.1, 1.0, (m.S, 10))
    for _ in range(3):
        rs.uniform(-1, 1, (m.ROWS, 128))
    rs.normal(size=(3, m.ROWS, 128))
    return rs


def inputs(device="cpu") -> list:
    """The seven rows' (a, b), drawn in row order: float32, or bf16 for
    the bf16 row (cast from the float64 draws)."""
    rs = module_rng()
    out = []
    for _name, (mm, kk, nn), prec in ROWS:
        pair = []
        for shape in ((mm, kk), (kk, nn)):
            x = rs.uniform(-1, 1, shape)
            t = (torch.from_numpy(x).to(torch.bfloat16) if prec == "bf16"
                 else torch.from_numpy(x.astype(np.float32)))
            pair.append(t.to(device))
        out.append(tuple(pair))
    return out


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 significand bits), to nearest with
    ties away from zero: cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _lhs(a, s, prec):
    x = a.float() + s
    if prec == "tf32":
        return tf32_round(x)
    if prec == "bf16":
        return x.to(torch.bfloat16).float()
    return x


def matmul_reference(a, b, products: int, row: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`matmul`: each product in float32
    (TF32 off) over the inputs rounded as the kernel rounds them; (M, N)
    float32."""
    prec = ROWS[row][2]
    bb = tf32_round(b) if prec == "tf32" else b.float()
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    with _tf32(False):
        for _ in range(products):
            s = acc[0, 0] * 1e-9
            acc = acc + _lhs(a, s, prec) @ bb
    return acc


def copies(row: int) -> int:
    """Copies of row ``row``'s whole accumulator that the kernel runs on
    the current card at once."""
    key = (row, torch.cuda.current_device())
    if key not in _COPIES:
        import ctypes

        from wavefront_path_tracer_tpu_torch.ops._build import load_library

        n = ctypes.c_int(0)
        rc = load_library().wpt_probe_mma_copies(row, ctypes.byref(n))
        if rc != 0 or n.value <= 0:
            raise RuntimeError(f"row {row}: no copy fits (CUDA error "
                               f"{rc}, {n.value} copies)")
        _COPIES[key] = n.value
    return _COPIES[key]


def matmul(a, b, products: int, row: int) -> torch.Tensor:
    """Row ``row`` of ``matmul_bench`` (:data:`ROWS`) over its inputs
    (:func:`inputs`): ``products`` dependent products; (copies, M, N)
    float32, each copy the same accumulator.

    On CPU tensors this is the plain version (one copy); on CUDA tensors
    it launches ``csrc/probe_mma.cu`` with as many copies as fit on the
    card, within :func:`tolerance` of the plain version; any other
    device raises."""
    if not 0 <= row < len(ROWS):
        raise ValueError(f"row is 0..{len(ROWS) - 1}")
    _name, (mm, kk, nn), prec = ROWS[row]
    dtype = torch.bfloat16 if prec == "bf16" else torch.float32
    for name, t, shape in (("a", a, (mm, kk)), ("b", b, (kk, nn))):
        if (tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {shape} {dtype}")
    if products < 0:
        raise ValueError("products must be >= 0")
    dev = _slope.one_device(a, b)
    if dev.type == "cpu":
        return matmul_reference(a, b, products, row)[None]
    n_copies = copies(row)
    out = torch.empty((n_copies, mm, nn), dtype=torch.float32, device=dev)
    _slope.launch("wpt_probe_mma_launch", row, a.data_ptr(), b.data_ptr(),
                  int(products), n_copies, out.data_ptr())
    LAUNCHES[row] += 1
    return out


def tolerance(a, b, products: int, row: int, acc,
              exact: bool = False) -> torch.Tensor:
    """The bound on |kernel - plain| (or, ``exact``, on |plain - the
    full-float32 product of the unrounded inputs|) for each entry of a
    row's accumulator ``acc``: per product, (K + 2) float32 roundings of
    the sum of |a'| |b| in any order (2^-23 each, to cover the tensor
    cores' accumulation), twice the input rounding when ``exact``, and
    one rounding of acc.  Both sides round the same inputs, so only the
    order of the sums differs; the shift of a + s that a last-bit change
    of acc[0, 0] makes is below 1e-15 and is not counted."""
    prec = ROWS[row][2]
    kk = a.shape[1]
    s = float(acc.abs().max()) * 1e-9
    g = (a.double().abs() + s) @ b.double().abs()
    unit = (kk + 2) * 2 * U32 + (2 * UNIT_IN[prec] if exact else 0.0)
    return (products * (unit * g + 2 * U32 * float(acc.abs().max()))
            ).to(torch.float32)


def library_loop(a, b, products: int, row: int,
                 n_copies: int | None = None) -> torch.Tensor:
    """``torch.matmul`` in the same dependent loop (TF32 on for the
    DEFAULT rows, off for HIGHEST; the bf16 row multiplies bf16 and
    accumulates its products in float32): the yardstick, not the port.
    One copy, (M, N); with ``n_copies``, that many accumulators at once,
    each product one batched (copies, M, K) x (K, N) matmul, (copies, M,
    N)."""
    prec = ROWS[row][2]
    shape = (a.shape[0], b.shape[1])
    if n_copies is not None:
        shape = (n_copies, *shape)
    acc = torch.zeros(shape, dtype=torch.float32, device=a.device)
    with _tf32(prec == "tf32"):
        for _ in range(products):
            s = acc[..., :1, :1] * 1e-9
            if prec == "bf16":
                acc = acc + torch.matmul((a.float() + s).to(torch.bfloat16),
                                         b).float()
            else:
                acc = acc + torch.matmul(a + s, b)
    return acc


def library_graph(a, b, products: int, row: int, n_copies: int):
    """The batched :func:`library_loop` captured once in a CUDA graph:
    (replay, its output tensor), ``replay()`` running the whole loop with
    no launch from the host but the graph's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        library_loop(a, b, 2, row, n_copies)       # cuBLAS's workspace
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = library_loop(a, b, products, row, n_copies)
    return graph.replay, out


def measure(row: int, reps=REPS, device="cuda") -> dict:
    """Slope-time row ``row``'s kernel (and the library loop) on the
    card: microseconds a product, TFLOP/s over all copies against the
    row's dense peak, copy 0's sum at 4 products."""
    name, (mm, kk, nn), prec = ROWS[row]
    a, b = inputs(device)[row]
    n_copies = copies(row)
    sl = _slope.slope(lambda r: matmul(a, b, 4 * r, row), *reps)
    per_product = sl["unit_s"] / 4
    flops = 2 * mm * kk * nn
    out = matmul(a, b, 4, row)
    r = {"row": row, "name": name, "precision": prec, "copies": n_copies,
         "reps": [sl["lo"], sl["hi"]], "us_per_product": per_product * 1e6,
         "tflops": flops * n_copies / per_product / 1e12,
         "peak_tflops": PEAKS[prec] / 1e12,
         "window_ms": sl["window_s"] * 1e3,
         "checksum": float(out[0].double().sum())}
    lib = _slope.slope(lambda r: library_loop(a, b, 4 * r, row),
                       *LIBRARY_REPS)
    r["library_us_per_product"] = lib["unit_s"] / 4 * 1e6
    r["library_tflops"] = flops / (lib["unit_s"] / 4) / 1e12
    lib = _slope.slope(lambda r: library_loop(a, b, 4 * r, row, n_copies),
                       *LIBRARY_REPS)
    r["library_batched_us_per_product"] = lib["unit_s"] / 4 * 1e6
    r["library_batched_tflops"] = (flops * n_copies / (lib["unit_s"] / 4)
                                   / 1e12)
    graphs = {}

    def replay(reps):
        if reps not in graphs:
            graphs[reps] = library_graph(a, b, 4 * reps, row, n_copies)[0]
        graphs[reps]()

    lib = _slope.slope(replay, *LIBRARY_REPS)
    graphs.clear()
    r["library_graph_us_per_product"] = lib["unit_s"] / 4 * 1e6
    r["library_graph_tflops"] = (flops * n_copies / (lib["unit_s"] / 4)
                                 / 1e12)
    return r


def run(argv=None) -> list:
    """The probe as its command line runs it: prints its table and
    returns its readings (the plain versions' sums with ``--device
    cpu``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps-lo", type=int, default=REPS[0])
    ap.add_argument("--reps-hi", type=int, default=REPS[1])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _slope.device(args.device)
    readings = []
    if dev.type == "cpu":
        for row, (a, b) in enumerate(inputs()):
            out = matmul(a, b, 4, row)
            checksum = float(out[0].double().sum())
            print(f"{ROWS[row][0]} plain version, 4 products: sum "
                  f"{checksum!r} (times: not measured on the CPU)")
            readings.append({"row": row, "checksum": checksum})
        return readings
    card = _slope.card()
    for row in range(len(ROWS)):
        r = measure(row, (args.reps_lo, args.reps_hi), dev)
        print(f"{r['name']}: {r['us_per_product']:.3f} us/product, "
              f"{r['tflops']:.3f} TFLOP/s over {r['copies']} copies (dense "
              f"peak {r['peak_tflops']:.0f}); torch.matmul loop, one copy "
              f"{r['library_us_per_product']:.3f} us/product, all copies "
              f"batched {r['library_batched_us_per_product']:.3f} "
              f"({r['library_batched_tflops']:.3f} TFLOP/s), in a CUDA "
              f"graph {r['library_graph_us_per_product']:.3f} "
              f"({r['library_graph_tflops']:.3f} TFLOP/s); slope window "
              f"{r['window_ms']:.1f} ms, sum {r['checksum']:.6e} [{card}]",
              flush=True)
        print(json.dumps(r), flush=True)
        readings.append(r)
    return readings


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
