"""The device-memory stream on the card (the port of ``exp/hbm_bw.py``,
its ``_stream_fn`` at line 108).

    python -m wavefront_path_tracer_tpu_torch.probes.hbm_bw \
        [--mb 256] [--reps 5] [--passes 10 310] [--device cuda|cpu]

Streams a (rows, 128) float32 buffer of ``--mb`` MB (256: five times the
50 MB L2) ``passes`` times in one launch and sums it into an (8, 128)
accumulator: acc[i, c] is the sum over rows with row % 8 == i of
data[row, c], times the pass count, plus x * 1e-30 from an FMA chain of
0, 64 or 512 FMAs a chunk run beside the stream.  Two kernels compute it
(``csrc/probe_stream.cu``): plain 16-byte loads, and a two-stage
``cp.async`` double buffer in shared memory.  A TPU chunk (64 KB-4 MB of
VMEM) has no counterpart in a 227 KB block, so the chunks are a block's
stages of 8-64 KB, and each block streams its own share of them.  Rates are slopes over the pass count, so the launch
and the second pass that reduces the blocks' partials (a fixed cost)
cancel between the two points.  The baseline is ``torch.sum`` over the
same buffer, slope-timed by calls: the counterpart of
``run_xla_baseline``, and the only place it runs.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.probes import _slope

LANES = 128
KINDS = ("plain", "async")
CHUNKS_KB = (8, 16, 32, 64)
FMAS = (0, 64, 512)
PASSES = (10, 310)
_FMA_A = float(np.float32(1.0000001))

# Kernel launches on CUDA tensors by stream, by kind.
LAUNCHES = {k: 0 for k in KINDS}


def make_data(mb: int, device="cpu", seed: int = 0) -> torch.Tensor:
    """(rows, 128) float32 uniform in [0, 1) from ``seed``, ``mb`` MB,
    drawn on ``device``."""
    rows = mb * 1024 * 1024 // (LANES * 4)
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((rows, LANES), generator=g, device=device)


def chain_value(n: int) -> float:
    """x after ``n`` steps of x <- x * 1.0000001 + 0.5 from 0.1, in
    float64 closed form."""
    a = _FMA_A
    an = a ** n
    return 0.1 * an + 0.5 * (an - 1.0) / (a - 1.0)


def stream_reference(data, passes: int, fmas: int, chunk_kb: int):
    """Plain PyTorch version of :func:`stream`: the per-class sums by
    ``torch.sum`` (another order than the kernels' blocks: a tolerance,
    not bits), times ``passes``, plus one chain of passes x chunks x
    ``fmas`` FMAs (the reference's single chain) times 1e-30."""
    rows = data.shape[0]
    chunk_rows = chunk_kb * 1024 // (LANES * 4)
    sums = data.reshape(-1, 8, LANES).sum(dim=0)
    chain = chain_value(passes * (rows // chunk_rows) * fmas)
    return sums * float(passes) + chain * 1e-30


def stream(data, passes: int, fmas: int, chunk_kb: int, kind: str = "async"):
    """Stream ``data`` ((rows, 128) float32, rows a multiple of the chunk's
    rows) ``passes`` times in ``chunk_kb`` KB chunks with an FMA chain of
    ``fmas`` a chunk: the (8, 128) float32 accumulator of the module
    docstring.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    the ``kind`` kernel (plain or async) of ``csrc/probe_stream.cu`` and
    its reduction, which agree with the plain version to float32
    summation error; any other device raises."""
    if kind not in KINDS:
        raise ValueError(f"kind is one of {KINDS}")
    if chunk_kb not in CHUNKS_KB:
        raise ValueError(f"chunk_kb is one of {CHUNKS_KB}")
    if (data.dim() != 2 or data.shape[1] != LANES
            or data.dtype != torch.float32 or not data.is_contiguous()):
        raise ValueError("data must be a contiguous (rows, 128) float32 "
                         "tensor")
    chunk_rows = chunk_kb * 1024 // (LANES * 4)
    if data.shape[0] % chunk_rows or not data.shape[0]:
        raise ValueError(f"rows must be a multiple of {chunk_rows}")
    if passes < 0 or fmas < 0:
        raise ValueError("passes and fmas must be >= 0")
    dev = _slope.one_device(data)
    if dev.type == "cpu":
        return stream_reference(data, passes, fmas, chunk_kb)
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")
    chunk_f4 = chunk_kb * 1024 // 16
    n_chunks = data.shape[0] // chunk_rows
    grid = stream_grid(kind, chunk_kb, data.shape[0])
    part = torch.empty((grid, 256, 4), dtype=torch.float32, device=dev)
    xs = torch.empty((grid, 256), dtype=torch.float32, device=dev)
    out = torch.empty((8, LANES), dtype=torch.float32, device=dev)
    _slope.launch("wpt_probe_stream_launch", data.data_ptr(),
                  n_chunks, chunk_f4, int(passes),
                  int(fmas), int(kind == "async"), grid, part.data_ptr(),
                  xs.data_ptr(), out.data_ptr())
    LAUNCHES[kind] += 1
    return out


def stream_grid(kind: str, chunk_kb: int, rows: int) -> int:
    """Blocks of a :func:`stream` launch over ``rows`` rows on the current
    card: the largest divisor of the chunk count that fits on the SMs at
    once (at most 8 blocks an SM), so that each block owns as many
    chunks."""
    from wavefront_path_tracer_tpu_torch.ops._build import load_library

    grid = load_library().wpt_probe_stream_grid(
        int(kind == "async"), chunk_kb * 1024 // 16,
        rows // (chunk_kb * 1024 // (LANES * 4)))
    if grid <= 0:
        raise RuntimeError(f"wpt_probe_stream_grid failed: CUDA error "
                           f"{-grid}")
    return grid


def exact_sums(data, passes: int) -> torch.Tensor:
    """The accumulator's sums in float64: passes x the per-class sums."""
    return data.double().reshape(-1, 8, LANES).sum(dim=0) * passes


def tolerance(data, passes: int, chunk_kb: int, blocks: int) -> float:
    """A bound on |kernel - exact| for :func:`stream` with ``blocks``
    blocks: a float32 sum of n positive terms in any order is within
    (n - 1) x 2^-24 of the exact sum, relative; a kernel thread adds the
    chunk_rows / 8 terms of each of its block's chunks x passes chunks
    and the second pass adds ``blocks`` partials, so the bound is that
    count x 2^-24 x the largest exact sum, doubled to cover the chain term
    (below 1e-20) and the float32 products of the plain version."""
    chunk_rows = chunk_kb * 1024 // (LANES * 4)
    chunks = data.shape[0] // chunk_rows * passes
    per_thread = -(-chunks // blocks) * chunk_rows // 8
    largest = float(exact_sums(data, passes).max())
    return 2.0 * (per_thread + blocks) * 2.0 ** -24 * largest


def measure(data, kind: str, chunk_kb: int, fmas: int,
            passes=PASSES) -> dict:
    """Slope-time :func:`stream` on the card: GB/s of the buffer."""
    sl = _slope.slope(lambda p: stream(data, p, fmas, chunk_kb, kind),
                      *passes)
    return {"kind": kind, "chunk_kb": chunk_kb, "fmas": fmas,
            "passes": [sl["lo"], sl["hi"]], "gb_s": data.nbytes / sl["unit_s"] / 1e9,
            "window_ms": sl["window_s"] * 1e3}


def measure_torch_sum(data, passes=PASSES) -> dict:
    """``torch.sum`` of the per-class sums over the buffer, slope-timed
    by calls: GB/s, and ms a call."""
    view = data.reshape(-1, 8, LANES)

    def run(p):
        for _ in range(p):
            torch.sum(view, dim=0)

    sl = _slope.slope(run, *passes)
    return {"kind": "torch.sum", "passes": [sl["lo"], sl["hi"]],
            "gb_s": data.nbytes / sl["unit_s"] / 1e9,
            "ms": sl["unit_s"] * 1e3, "window_ms": sl["window_s"] * 1e3}


def run(argv=None) -> list:
    """The probe as its command line runs it: prints its table and
    returns its readings (the plain versions' checksums with
    ``--device cpu``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=256,
                    help="MB streamed a pass")
    ap.add_argument("--reps", type=int, default=_slope.RUNS,
                    help="timed calls a point (the minimum is kept)")
    ap.add_argument("--passes", type=int, nargs=2, default=PASSES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _slope.device(args.device)
    if dev.type == "cpu":
        out = stream(make_data(1), 2, 64, 8)
        checksum = float(out.double().sum())
        print(f"plain version, 1 MB, 2 passes: checksum {checksum!r} "
              f"(times: not measured on the CPU)")
        return [{"kind": "plain version", "checksum": checksum}]
    card = _slope.card()
    data = make_data(args.mb, dev)
    passes = tuple(args.passes)
    print(f"payload {data.nbytes / 1e6:.0f} MB ({data.shape[0]}x{LANES} "
          f"f32), passes {passes[0]}->{passes[1]} [{card}]")
    _slope.RUNS = args.reps
    r = measure_torch_sum(data, passes)
    print(f"| torch.sum over the buffer (baseline) | {r['gb_s']:8.2f} GB/s "
          f"| slope {r['window_ms']:7.1f} ms | [{card}]", flush=True)
    print(json.dumps(r), flush=True)
    readings = [r]
    for kind in KINDS:
        for chunk_kb in CHUNKS_KB:
            for fmas in FMAS:
                r = measure(data, kind, chunk_kb, fmas, passes)
                print(f"| {kind:5s} chunk {chunk_kb:2d} KB, {fmas:3d} "
                      f"fma/chunk | {r['gb_s']:8.2f} GB/s | slope "
                      f"{r['window_ms']:7.1f} ms | [{card}]", flush=True)
                print(json.dumps(r), flush=True)
                readings.append(r)
    return readings


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
