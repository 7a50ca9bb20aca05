"""The SASS reading of ``utils/sass.py`` (the innermost loop of a listing)
and the probes phase's reading of the pair ceiling's kernels, of
``csrc/probe_designs.cu``'s, of the triangle forms' and of the matmul
rows' (``chip_smoke.py`` ``_design_forms``, ``_mma_row``,
``_sass_per_pair``) on synthetic listings in ``cuobjdump -sass``'s
layout, on the CPU: the card's listings come only from a build there."""

import importlib.util
from pathlib import Path

import pytest

from wavefront_path_tracer_tpu_torch.probes import matmul_r2 as mr
from wavefront_path_tracer_tpu_torch.probes import micro_r2 as tm
from wavefront_path_tracer_tpu_torch.probes import run_pairs as rp
from wavefront_path_tracer_tpu_torch.probes import tripair as tp
from wavefront_path_tracer_tpu_torch.utils import sass

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_sass",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _smoke()


def _listing(name, body, pairs, labels=True, tail=("EXIT",),
             marker="MUFU.RSQ"):
    """A kernel's listing: set-up, a rep loop around a sweep loop of
    ``body`` instructions of which ``pairs`` are square roots (or
    ``marker``), the rep loop's end, ``tail``, then a slow path that
    branches back into the sweep and the closing self-branch."""
    lines, addr = [f"{name}\n"], 0

    def put(text, label=None):
        nonlocal addr
        if label is not None and labels:
            lines.append(f".L_x_{label}:\n")
        lines.append(f"        /*{addr:04x}*/                   {text} ;"
                     f"                 /* 0x000fe20000000800 */\n"
                     f"                                            "
                     f"/* 0x000fe20000000800 */\n")
        addr += 16
        return addr - 16

    def target(label, at):
        return f"`(.L_x_{label})" if labels else hex(at)

    put("LDC R1, c[0x0][0x28]")
    put("S2R R0, SR_TID.X")
    rep = put("MOV R2, RZ", label=0)
    sweep = put("ULDC UR4, c[0x3][0x0]", label=1)
    for k in range(body - 3):
        put(f"{marker} R5, R4" if k < pairs else "FADD R6, R6, R7")
    put("UIADD3 UR5, UR5, 0x40, URZ")
    put(f"@P0 BRA {target(1, sweep)}")
    put("FADD R3, R3, R2")
    put(f"@!P1 BRA {target(0, rep)}")
    for text in tail:
        put(text)
    slow = put("MUFU.RSQ R9, R8", label=2)
    put(f"BRA {target(1, sweep)}")
    put(f"BRA {target(3, slow + 32)}", label=3)
    return "".join(lines)


@pytest.mark.parametrize("labels", [True, False])
def test_inner_loop_is_the_sweep(labels):
    """The sweep loop (7 instructions, 4 of them square roots) in both
    branch forms (labels, addresses); the slow path's branch back and the
    self-branch after EXIT are not loops; without a marker too."""
    text = _listing("f", 7, 4, labels=labels)
    loop = sass.inner_loop(text, "MUFU.RSQ")
    assert len(loop) == 7
    assert [sass.opcode(t) for t in loop].count("MUFU.RSQ") == 4
    assert loop[0].startswith("ULDC") and loop[-1].startswith("@P0 BRA")
    assert sass.inner_loop(text) == loop
    assert sass.inner_loop(text, "HMMA.16816") == []
    assert sass.inner_loop(_listing("g", 7, 4, tail=())) == []


def test_opcode_drops_the_predicate():
    assert sass.opcode("@!P0 LDG.E.CONSTANT R4, desc[UR4][R2.64]") == (
        "LDG.E.CONSTANT")
    assert sass.opcode("MUFU.RSQ R5, R4") == "MUFU.RSQ"
    assert sass.opcode("") == ""


def _mangled(group, *args):
    name = f"design_{group}"
    targs = "".join(f"Li{a}E" for a in args)
    return f"_ZN12_GLOBAL__N_1{len(name)}{name}I{targs}EEvPKfS2_iiPf"


def _instantiations():
    """The mangled names of the kernels ``wpt_probe_design_launch``
    instantiates (its dispatch, by hand)."""
    ids, place = rp.KERNEL_IDS, rp.PLACE_IDS
    names = [_mangled("ray_major", ids[d], place[p], 1 if d == "C5" else 8)
             for d in rp.RAY_MAJOR for p in rp.PLACES[d]]
    names += [_mangled("sphere_major", ids[d], place[p], n)
              for d in ("C6d", "C7") for p in rp.PLACES[d]
              for n in rp.LANES[d]]
    names.append(_mangled("sphere_major", ids["C"], place["global"], 8))
    names += [_mangled("tile_gated", ids[d], place[rp.PLACES[d][0]])
              for d in rp.TILE_GATED]
    return names


def test_design_forms_cover_every_form():
    """Each instantiation maps to its run_pairs forms (A2d onto C6d's
    constant-bank 8-lane kernel), together every form of the 21 designs
    once; other functions map to none."""
    got = []
    for name in _instantiations():
        group, forms = cs._design_forms(name)
        assert forms and group in ("ray_major", "sphere_major",
                                   "tile_gated")
        got += forms
    want = [(d, p, n) for d in rp.DESIGNS if d not in ("C6", "A2")
            for p, n in rp.forms(d)]
    assert sorted(got) == sorted(want)
    assert cs._design_forms("_Z16probe_pair_sweepPKfS0_iiPf") == (None, [])


C6 = ("_ZN47_GLOBAL__N__0194f6e1_14_probe_pairs_cu_e5058c8e16"
      "probe_pair_sweepILb0EEEvPKfS2_iiPf")
A2 = C6.replace("ILb0EE", "ILb1EE")
# The six gated sweeps (probe_pairs.cu probe_gated<generic, gate>).
GATED = {(p, g): "_ZN47_GLOBAL__N__0194f6e1_14_probe_pairs_cu_e5058c8e11"
                 f"probe_gatedILb{int(p == 'W8')}ELi{k}EEEvPKfPKiS2_iiPf"
         for p in tm.PATTERNS for k, g in enumerate(tm.GATINGS)}


def _read(monkeypatch, tmp_path, listings):
    """``_sass_per_pair`` over the synthetic ``listings``, each kernel's
    ptxas report at 64 registers and no spill, on a card issuing 33.45 T
    thread instructions a second."""
    from wavefront_path_tracer_tpu_torch.ops import _build
    from wavefront_path_tracer_tpu_torch.probes import _slope

    report = "".join(
        f"ptxas info    : Compiling entry function '{n}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {n}\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        f"loads\nptxas info    : Used 64 registers\n" for n in listings)
    monkeypatch.setattr(_build, "build", lambda: ("lib", report, None))
    monkeypatch.setattr(sass, "cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(sass, "listings", lambda lib: listings)
    monkeypatch.setattr(cs, "log", lambda *a: None)
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(_slope, "card", lambda: "H100, 700.00 W, 1980 MHz")
    monkeypatch.setattr(_slope, "issue_rate", lambda card: 33.45e12)
    return cs._sass_per_pair("smi", 1024)


# The triangle forms' kernels (csrc/probe_tripair.cu, its file's
# namespace holding the file's name as nvcc mangles it) and the matmul
# rows' (csrc/probe_mma.cu, Row<M, K, N, MT, NT, precision, ...>).
NS = "_ZN49_GLOBAL__N__26d535a7_16_probe_tripair_cu_81d600e1"
TRIPAIR = {f: f"{NS}13probe_tripairILb{f.startswith('T2'):d}ELb"
              f"{f.endswith('p'):d}EEEvPKfPKiiS2_iiPf" for f in tp.FORMS}
PRECISIONS = {"tf32": 0, "fp32": 1, "bf16": 2}
MMA = {row: "_ZN45_GLOBAL__N__f5d60a37_12_probe_mma_cu_a17157619probe_mma"
            "INS_3RowILi{}ELi{}ELi{}ELi16ELi32ELi{}ELi1ELi2ELi4ELi0ELi0EEEEE"
            "vPKNT_2InES6_iPf".format(*shape, PRECISIONS[prec])
       for row, (_n, shape, prec) in enumerate(mr.ROWS)}
HMMA = {"tf32": "HMMA.1688.F32.TF32", "bf16": "HMMA.16816.F32.BF16",
        "fp32": "FFMA"}


def _every_kernel():
    """Synthetic listings of the two ceiling kernels (C6 unrolled by 4,
    A2 by 8), of the six gated sweeps (16 pairs a loop, as at 4 rays a
    thread and unroll 4), of every probe_designs.cu instantiation (Q's loop 32
    pairs, as at 4 rays a thread and unroll 8; Q2's none), of the four
    triangle forms (8 reciprocals a loop, as at 4 rays a thread and
    unroll 2) and of the seven matmul rows (16 mma in the product loop
    of the tensor-core rows, none in the FP32 rows')."""
    q = _mangled("ray_major", rp.KERNEL_IDS["Q"], rp.PLACE_IDS["const"], 8)
    q2 = _mangled("ray_major", rp.KERNEL_IDS["Q2"], rp.PLACE_IDS["const"], 8)
    pairs = {n: 32 if n == q else 0 if n == q2 else 8
             for n in _instantiations()}
    pairs.update({C6: 4, A2: 8})
    pairs.update({n: 16 for n in GATED.values()})
    out = {n: _listing(n, 40, p) for n, p in pairs.items()}
    out.update({n: _listing(n, 80, 8, marker="MUFU.RCP")
                for n in TRIPAIR.values()})
    out.update({n: _listing(n, 60, 16, marker=HMMA[mr.ROWS[row][2]])
                for row, n in MMA.items()})
    return out


def test_sass_per_pair_reads_every_design_form(monkeypatch, tmp_path):
    """Every probe_designs.cu form's sweep loop, pairs and instructions a
    pair, ptxas's registers and spills from a -v report, the issue-bound
    time of the kernels line's call for the ungated forms only; Q2's loop
    has no square root and holds Q's pairs; a form without a kernel
    fails."""
    listings = _every_kernel()
    out = _read(monkeypatch, tmp_path, listings)
    assert len(out) == 2 + 6 + sum(len(rp.forms(d)) for d in rp.DESIGNS
                                   if d not in ("C6", "A2")) + 4 + 7
    for key, rep in out.items():
        if key in ("C6", "A2") or rep["group"] in ("gated", "tripair",
                                                   "matmul"):
            continue
        design = key.split()[0]
        assert rep["body"] == 40 and rep["registers"] == 64
        assert rep["spill_stores"] == 0 and rep["uniform"] == 2
        assert rep["loads"] == {"LDC": 0, "ULDC": 1, "LDG": 0, "LDS": 0}
        pairs = 32 if design in ("Q", "Q2") else 8
        assert rep["pairs_in_body"] == pairs
        assert rep["per_pair"] == 40 / pairs
        gated = design in rp.TILE_GATED and design != "W0"
        assert (rep["issue_bound_ms"] is None) == gated
    assert out["A const 1"]["issue_bound_ms"] == pytest.approx(
        5.0 * 400 * 1024 * cs.PROBE_REPS / 33.45e12 * 1e3)
    del listings[_instantiations()[0]]
    with pytest.raises(AssertionError, match="no kernel found"):
        _read(monkeypatch, tmp_path, listings)


def test_sass_per_pair_reads_the_ceiling_kernels(monkeypatch, tmp_path):
    """C6 and A2 (csrc/probe_pairs.cu) by the same yardstick as the
    designs: the sweep loop's instructions over its square roots (4 and
    8), their ptxas figures, their issue-bound times; their listings
    kept beside the designs'; a build without them fails."""
    listings = _every_kernel()
    out = _read(monkeypatch, tmp_path, listings)
    assert out["C6"]["pairs_in_body"] == 4 and out["C6"]["per_pair"] == 10.0
    assert out["A2"]["pairs_in_body"] == 8 and out["A2"]["per_pair"] == 5.0
    assert out["C6"]["group"] == "pair_ceiling"
    assert out["C6"]["registers"] == 64 and out["A2"]["spill_loads"] == 0
    assert out["C6"]["issue_bound_ms"] == pytest.approx(
        10.0 * 400 * 1024 * cs.PROBE_REPS / 33.45e12 * 1e3)
    assert (tmp_path / "probe_sass" / "C6.sass").read_text() == listings[C6]
    del listings[A2]
    with pytest.raises(AssertionError, match=r"\['A2'\]"):
        _read(monkeypatch, tmp_path, listings)


def test_sass_per_pair_reads_the_gated_kernels(monkeypatch, tmp_path):
    """The six gated sweeps (W8 and C8 under each gating) keyed "gated
    PATTERN GATING" from their template arguments, by the designs'
    yardstick (16 square roots in a sweep loop of 40), with an issue
    bound over the entered pairs (micro_r2.pairs_per_rep), apart from C6
    and A2 (whose names hold a bool argument of their own); a build
    without one of them fails."""
    listings = _every_kernel()
    out = _read(monkeypatch, tmp_path, listings)
    assert out["C6"]["function"] == C6 and out["A2"]["function"] == A2
    for (pattern, gating), name in GATED.items():
        rep = out[f"gated {pattern} {gating}"]
        assert rep["function"] == name and rep["group"] == "gated"
        assert rep["pairs_in_body"] == 16 and rep["per_pair"] == 2.5
        assert rep["pairs_per_rep"] == tm.pairs_per_rep(pattern, 1024)
        assert rep["issue_bound_ms"] == pytest.approx(
            2.5 * tm.pairs_per_rep(pattern, 1024) * cs.PROBE_REPS
            / 33.45e12 * 1e3)
        assert rep["registers"] == 64 and rep["spill_stores"] == 0
    assert out["gated W8 thread"]["pairs_per_rep"] == 12 * 16 * 1024
    assert out["gated C8 vote"]["pairs_per_rep"] == 37 * 16 * 128
    assert (tmp_path / "probe_sass" / "gated_C8_worklist.sass").exists()
    del listings[GATED[("W8", "vote")]]
    with pytest.raises(AssertionError, match=r"\['gated W8 vote'\]"):
        _read(monkeypatch, tmp_path, listings)


def test_fp32_bound_is_at_the_issue_rate(monkeypatch):
    """The smoke's FP32 bounds divide operations by the issue rate (SMs
    x 128 x the maximum SM clock; code built -fmad=false issues one
    instruction an operation), not by the 67 TFLOP/s spec, which counts
    an FFMA as two: bf16_issue's f32 call (128 operations an element a
    rep, 262,144 elements, 400 reps) takes at least 0.4012 ms on 132 SMs
    at 1980 MHz, 2.003x the spec's figure.  Bytes bounds and an explicit
    peak (TF32) stay as they were."""
    from wavefront_path_tracer_tpu_torch.probes import _slope

    rate = _slope.fp32_issue_rate(132, 1980.0)
    assert rate == pytest.approx(33.45e12, rel=1e-3)
    ops = 128 * 262_144 * 400
    assert ops == 13_421_772_800
    monkeypatch.setattr(cs, "_fp32_rate", lambda: rate)
    rep = cs._bound(ops, 2 * 262_144 * 4)
    assert rep["bound_ms"] == pytest.approx(0.4012, abs=5e-5)
    assert rep["bound_by"] == "operations"
    spec = ops / _slope.PEAK_FP32 * 1e3
    assert rep["bound_ms"] / spec == pytest.approx(2.003, abs=5e-4)
    tf32 = cs._bound(ops, 0, peak=_slope.PEAK_TF32)
    assert tf32["bound_ms"] == pytest.approx(ops / 495e12 * 1e3)
    stream = cs._bound(1.0, 256 * 2**20, bits=False)
    assert stream["bound_by"] == "bytes" and not stream["bits"]
    assert stream["bound_ms"] == pytest.approx(256 * 2**20 / 3.35e12 * 1e3)


def test_sass_per_pair_reads_the_triangle_forms_and_matmul_rows(
        monkeypatch, tmp_path):
    """The four triangle forms by the designs' yardstick over their
    reciprocals (8 a sweep loop of 80: 10 a pair), with their issue-bound
    times over the table's half a rep; each matmul row found by its
    shape and precision, with its mma instructions in the kernel and in
    the product loop and ptxas's figures; other functions of the two
    files are not read; a build without one of them fails."""
    listings = _every_kernel()
    listings[f"{NS}6helperEPy"] = _listing("helper", 10, 1,
                                           marker="MUFU.RCP")
    out = _read(monkeypatch, tmp_path, listings)
    for form in tp.FORMS:
        rep = out[f"tripair {form}"]
        assert rep["group"] == "tripair" and rep["registers"] == 64
        assert rep["pairs_in_body"] == 8 and rep["per_pair"] == 10.0
        assert rep["issue_bound_ms"] == pytest.approx(
            10.0 * tp.NTRI // 2 * 1024 * cs.PROBE_REPS / 33.45e12 * 1e3)
    for row, (_name, _shape, prec) in enumerate(mr.ROWS):
        rep = out[f"matmul {row}"]
        assert cs._mma_row(MMA[row]) == row
        assert rep["registers"] == 64 and rep["spill_stores"] == 0
        tensor = prec != "fp32"
        assert rep["mma"] == ([HMMA[prec]] if tensor else [])
        assert rep["mma_in_kernel"] == rep["mma_in_loop"] == 16 * tensor
        assert rep["loop"] == 60 * tensor
    assert not any("helper" in r["function"] for r in out.values())
    assert (tmp_path / "probe_sass" / "tripair_T2p.sass").exists()
    del listings[TRIPAIR["T1p"]], listings[MMA[6]]
    with pytest.raises(AssertionError,
                       match=r"\['tripair T1p', 'matmul 6'\]"):
        _read(monkeypatch, tmp_path, listings)


def _render_listing(name, labels=True):
    """A render kernel's listing in ``cuobjdump -sass``'s layout: one STL
    in the set-up; a loop of trips holding a sweep loop (a square root, an
    LDL and an STL in it, and a second backward branch to its head, as a
    ``continue`` makes), after it the per-hit code (two LDL) and a loop
    of a slow path's reduction (an STL, no square root); EXIT; then a
    slow path (four STL, four LDL) that branches back into the trip loop,
    and the closing self-branch."""
    lines, addr = [f"{name}\n"], 0

    def put(text, label=None):
        nonlocal addr
        if label is not None and labels:
            lines.append(f".L_x_{label}:\n")
        lines.append(f"        /*{addr:04x}*/                   {text} ;"
                     f"                 /* 0x000fe20000000800 */\n")
        addr += 16
        return addr - 16

    def target(label, at):
        return f"`(.L_x_{label})" if labels else hex(at)

    put("LDC R1, c[0x0][0x28]")
    put("STL [R1], R2")
    trip = put("S2R R0, SR_TID.X", label=0)
    sweep = put("LDG.E R4, desc[UR4][R2.64]", label=1)
    put("LDL R5, [R1+0x4]")
    put("MUFU.RSQ R5, R4")
    put(f"@P2 BRA {target(1, sweep)}")
    put("STL [R1+0x8], R6")
    put("FADD R6, R6, R7")
    put(f"@P0 BRA {target(1, sweep)}")
    back = put("LDL R8, [R1+0xc]", label=4)
    put("LDL.LU R9, [R1+0x10]")
    reduce = put("LDG.E.CONSTANT R6, desc[UR6][R6.64]", label=5)
    put("STL [R13], R8")
    put(f"@P6 BRA {target(5, reduce)}")
    put(f"@!P1 BRA {target(0, trip)}")
    put("EXIT")
    put("STL.64 [R1+0x20], R10", label=2)
    for k in range(3):
        put(f"STL [R1+0x{0x28 + 4 * k:x}], R11")
    for k in range(4):
        put(f"LDL R12, [R1+0x{0x20 + 4 * k:x}]")
    put(f"BRA {target(4, back)}")
    end = put("NOP", label=3)
    put(f"BRA {target(3, end)}")
    return "".join(lines)


@pytest.mark.parametrize("labels", [True, False])
def test_spill_sites_in_and_out_of_the_sweep(labels):
    """Local loads and stores by site: in the sweep (a loop inside the
    loop of trips that holds a square root; two backward branches to one
    head are one loop), in the trip loop outside the sweep (the per-hit
    code, and a slow path's reduction loop, which holds none), outside
    the loops, and after EXIT (the slow paths, whose branch back is no
    loop)."""
    sites = sass.spill_sites(_render_listing("k", labels=labels))
    assert tuple(sass.SITES) == ("outside", "loop", "sweep", "tail")
    assert sites == {"LDL": {"outside": 0, "loop": 2, "sweep": 1, "tail": 4},
                     "STL": {"outside": 1, "loop": 1, "sweep": 1, "tail": 4}}
    flat = sass.spill_sites(_listing("f", 7, 4, labels=labels))
    assert flat == {op: dict.fromkeys(sass.SITES, 0) for op in ("LDL", "STL")}


def test_tex_pairs_match_the_kTex_argument():
    """Each shipped render kernel's textured and untextured instantiation
    paired by ``kernel_symbol``, which differ in kTex alone; a kernel with
    one of the two, other kernels and other functions are left out; a
    symbol that matches two functions raises."""
    from wavefront_path_tracer_tpu_torch.ops import stage_probes

    def name(kernel, tris, tex, bits=0):
        sym = stage_probes.kernel_symbol(kernel, tris, tex, bits)
        return f"_ZN3wpt5baked{sym}vNS_10LaneParamsE"

    names = [name("culled", False, True), name("culled", False, False),
             name("culled", False, True, 2),
             name("unculled", False, True),
             name("dynculled", True, False), name("dynculled", True, True),
             name("segment_culled", False, False),
             name("segment_culled", False, True),
             "_Z16probe_pair_sweepPKfS0_iiPf"]
    pairs = sass.tex_pairs(names)
    assert pairs == {
        "culled tris=0": (names[0], names[1]),
        "dynculled tris=1": (names[5], names[4]),
        "segment_culled tris=0": (names[7], names[6]),
    }
    with pytest.raises(ValueError, match="2 functions match"):
        sass.tex_pairs(names + [names[0] + "x"])


def test_texture_step_bound_on_fixed_counts():
    """Row 5's bound: the step's FP32 operations for its events (checker
    and image hits a ray) at the row's rays, over the issue rate.  A
    checker event costs s * p (3), three sines at the FP32 instructions of
    sinf's fast path each, and their product (2); an image event 45.  At
    1e9 rays, 0.5 checker and 0.01 image events a ray, 33.45e12 a second:
    1e9 x (0.5 x 38 + 0.01 x 45) = 19.45e9 operations, 0.58146 ms; the
    smoke's bounds take the same counts."""
    from wavefront_path_tracer_tpu_torch.probes import texstep

    assert texstep.FLOPS_SINF == 11
    assert texstep.FLOPS_CHECKER == 3 + 3 * 11 + 2 == 38
    assert texstep.FLOPS_IMAGE == 45
    assert (cs.FLOPS_CHECKER, cs.FLOPS_IMAGE) == (38, 45)
    assert texstep.step_ops(1e9, (0.5, 0.01)) == pytest.approx(19.45e9)
    rep = texstep.step_bound(1e9, (0.5, 0.01), 33.45e12, n_bytes=16_384)
    assert rep["bound_ms"] == pytest.approx(19.45e9 / 33.45e12 * 1e3)
    assert rep["bound_ms"] == pytest.approx(0.58146, abs=5e-6)
    assert rep["bound_by"] == "operations"
    rep = texstep.step_bound(0.0, (0.5, 0.01), 33.45e12, n_bytes=3.35e9)
    assert rep["bound_by"] == "bytes"
    assert rep["bound_ms"] == pytest.approx(1.0)
