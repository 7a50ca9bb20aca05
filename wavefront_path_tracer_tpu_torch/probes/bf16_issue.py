"""Elementwise issue rate by type on the card (the port of
``exp/bf16_issue.py``, its ``measure`` at line 66).

    python -m wavefront_path_tracer_tpu_torch.probes.bf16_issue \
        [--reps-lo 4000] [--reps-hi 36000] [--device cuda|cpu]

Per element of ``x = RandomState(0).rand(256, 128)`` cast to the type
(all zeros for the integer types), two dependent chains: each rep 32
steps of ``a = a * one + half`` and ``b = b * half + one`` from
(x, x + one); the output is a + b in the type.  The constants are the
reference's: f32 1.0000001 and 0.4999999 (as float32), bf16 exactly 1.0
and 0.5 (its rounding of the same), int16 and int8 3 and 1, wrapping.
Two operations a step.

Forms (``csrc/probe_issue.cu``), the block repeated to fill the card
(:data:`COPIES`):

- the reference's function, a rounding after each operation: ``f32``
  (FMUL then FADD), ``bf16x2`` (packed ``__hmul2`` then ``__hadd2``, two
  elements an instruction), ``bf16`` (scalar), ``i16`` and ``i8`` (32-bit
  IMAD, then the wrap), bit for bit against the plain version;
- the fused forms a prefilter would use, another rounding: ``f32_fma``
  (``__fmaf_rn``) and ``bf16x2_fma`` (``__hfma2``), one rounding a
  multiply-add, bit for bit against their own plain version
  (:func:`fma_reference`).

Printed: G elementwise operations a second by slope (reps x 64 x 2
operations x elements over the extra time), each form's ratio to f32,
and its ceiling: the card's issue rate (4 warp instructions a clock on
each SM at the maximum SM clock) times its elements an instruction times
its operations an instruction; a reading above it is impossible.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.probes import _slope

ROWS = 256
CHAIN = 64                 # operations a rep per accumulator pair, / 2
STEPS = CHAIN // 2
FORMS = ("f32", "f32_fma", "bf16x2", "bf16", "bf16x2_fma", "i16", "i8")
DTYPES = {"f32": torch.float32, "f32_fma": torch.float32,
          "bf16x2": torch.bfloat16, "bf16": torch.bfloat16,
          "bf16x2_fma": torch.bfloat16, "i16": torch.int16,
          "i8": torch.int8}
FUSED = ("f32_fma", "bf16x2_fma")
# (elements, operations) of one instruction of the form's chain step.
PER_INSTRUCTION = {"f32": (1, 1), "f32_fma": (1, 2), "bf16x2": (2, 1),
                   "bf16": (1, 1), "bf16x2_fma": (2, 2), "i16": (1, 2),
                   "i8": (1, 2)}
# Copies of the (256, 128) block: 262,144 threads, about the 270,336 that
# 132 SMs hold (the packed forms take two elements a thread).
COPIES = {f: 16 if f.startswith("bf16x2") else 8 for f in FORMS}
REPS = (4000, 36000)

# Kernel launches on CUDA tensors by chains, by form.
LAUNCHES = {f: 0 for f in FORMS}


def constants(form: str):
    """(one, half) as the reference makes them in the form's type."""
    dtype = DTYPES[form]
    if dtype == torch.float32:
        return float(np.float32(1.0000001)), float(np.float32(0.4999999))
    if dtype == torch.bfloat16:
        one = torch.tensor(1.0000001, dtype=torch.float32).to(dtype)
        half = torch.tensor(0.4999999, dtype=torch.float32).to(dtype)
        return float(one), float(half)
    return 3, 1


def make_x(form: str, copies: int = 1, device="cpu") -> torch.Tensor:
    """``RandomState(0).rand(256, 128)`` cast from float64 to the form's
    type, repeated ``copies`` times along the rows."""
    x = torch.from_numpy(np.random.RandomState(0).rand(ROWS, 128))
    return x.to(DTYPES[form]).repeat(copies, 1).to(device)


def fma_reference(a, m: float, c: float, dtype):
    """``a * m + c`` rounded once to ``dtype`` (float32 or bfloat16), as
    ``__fmaf_rn`` and ``__hfma2`` round it.  ``a`` holds values of
    ``dtype`` in the wide type (float64 for float32, float32 for
    bfloat16), whose digits hold the product exactly; TwoSum gives the
    sum's rounding error, a sum that rounded to an even last digit with
    an error moves one wide ulp toward it (round to odd), and the wide
    type's two spare digits then make the narrowing the single rounding
    of the exact result."""
    p = a * m
    s = p + c
    p_part = s - c
    err = (p - p_part) + (c - (s - p_part))
    ints = torch.int64 if s.dtype == torch.float64 else torch.int32
    even = (s.view(ints) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where(even & (err != 0), torch.nextafter(s, toward), s)
    return s.to(dtype)


def chains_reference(x, reps: int, form: str):
    """Plain PyTorch version of :func:`chains`: the unfused chains, each
    operation rounded to the type (integers wrap); the fused forms round
    each multiply-add once (:func:`fma_reference`)."""
    one, half = constants(form)
    dtype = x.dtype
    if form in FUSED:
        wide = torch.float64 if dtype == torch.float32 else torch.float32
        a = x
        b = x + torch.tensor(one, dtype=dtype, device=x.device)
        for _ in range(reps * STEPS):
            a = fma_reference(a.to(wide), one, half, dtype)
            b = fma_reference(b.to(wide), half, one, dtype)
        return a + b
    if dtype.is_floating_point:
        one_t = torch.tensor(one, dtype=dtype, device=x.device)
        half_t = torch.tensor(half, dtype=dtype, device=x.device)
    else:
        one_t, half_t = one, half
    a = x
    b = x + one_t
    for _ in range(reps * STEPS):
        a = a * one_t + half_t
        b = b * half_t + one_t
    return a + b


def chains(x, reps: int, form: str = "f32"):
    """``bf16_issue``'s kernel function (module docstring) over ``x``
    (contiguous, of the form's type, any shape): the same shape and type.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    ``csrc/probe_issue.cu``'s ``form`` kernel, bit-identical to the plain
    version; any other device raises."""
    if form not in FORMS:
        raise ValueError(f"form is one of {FORMS}")
    if x.dtype != DTYPES[form] or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous {DTYPES[form]} tensor")
    if reps < 0:
        raise ValueError("reps must be >= 0")
    dev = _slope.one_device(x)
    if dev.type == "cpu":
        return chains_reference(x, reps, form)
    if form.startswith("bf16x2") and (x.numel() % 2 or x.data_ptr() % 4):
        raise ValueError("the packed forms take an even, 4-byte aligned x")
    one, half = constants(form)
    out = torch.empty_like(x)
    _slope.launch("wpt_probe_issue_launch", FORMS.index(form), x.data_ptr(),
                  x.numel(), int(reps), float(one), float(half),
                  out.data_ptr())
    LAUNCHES[form] += 1
    return out


def peak_gops(form: str, issue: float) -> float:
    """The form's ceiling in G elementwise operations a second at
    ``issue`` thread instructions a second."""
    elems, ops = PER_INSTRUCTION[form]
    return issue * elems * ops / 1e9


def measure(form: str, reps=REPS, device="cuda") -> dict:
    """Slope-time :func:`chains` on the card: G elementwise operations a
    second and the slope window."""
    x = make_x(form, COPIES[form], device)
    sl = _slope.slope(lambda r: chains(x, r, form), *reps)
    ops_per_rep = CHAIN * 2 * x.numel()
    return {"form": form, "copies": COPIES[form], "elements": x.numel(),
            "reps": [sl["lo"], sl["hi"]],
            "gops": ops_per_rep / sl["unit_s"] / 1e9,
            "window_ms": sl["window_s"] * 1e3}


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
        for form in FORMS:
            out = chains(make_x(form), 2, form)
            checksum = float(out.double().sum())
            print(f"{form} plain version, 2 reps, ({ROWS}, 128): sum "
                  f"{checksum!r} (times: not measured on the CPU)")
            readings.append({"form": form, "checksum": checksum})
        return readings
    card = _slope.card()
    issue = _slope.issue_rate(card)
    print(f"ROWS={ROWS} CHAIN={CHAIN} reps {args.reps_lo}->{args.reps_hi} "
          f"[{card}]", flush=True)
    for form in FORMS:
        r = measure(form, (args.reps_lo, args.reps_hi), dev)
        r["peak_gops"] = peak_gops(form, issue)
        readings.append(r)
    f32 = readings[0]["gops"]
    for r in readings:
        r["ratio_f32"] = r["gops"] / f32
        print(f"| {r['form']:10s} | {r['gops']:10.1f} Gops/s | "
              f"{r['ratio_f32']:5.2f}x f32 | ceiling {r['peak_gops']:.0f} | "
              f"window {r['window_ms']:7.1f} ms | [{card}]", flush=True)
        print(json.dumps(r), flush=True)
    return readings


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
