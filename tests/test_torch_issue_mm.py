"""``bf16_issue``'s chains and ``matmul_bench``'s products
(``wavefront_path_tracer_tpu_torch/probes/bf16_issue.py``,
``matmul_r2.py``) on the CPU: their data byte for byte, and each plain
version against the ``exp/`` Pallas kernel in interpret mode at reduced
sizes (the exp modules' globals set with monkeypatch; no file of
``exp/`` is edited).  The kernels run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import sys
import types
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from wavefront_path_tracer_tpu_torch.probes import bf16_issue as tbi
from wavefront_path_tracer_tpu_torch.probes import matmul_r2 as tmm

torch.set_num_threads(2)

EXP = Path(__file__).resolve().parents[1] / "exp"
if str(EXP) not in sys.path:
    sys.path.insert(0, str(EXP))

import bf16_issue as jbi  # noqa: E402
import micro_r2 as jm  # noqa: E402

JNP_TYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "i16": jnp.int16,
             "i8": jnp.int8}


# --- bf16_issue ----------------------------------------------------------------

@pytest.mark.parametrize("form", ["f32", "bf16", "i16", "i8"])
def test_issue_data_and_constants(form):
    """x is the reference's cast of RandomState(0).rand(256, 128), byte
    for byte, and the constants are its rounding of 1.0000001 and
    0.4999999 (bf16: exactly 1.0 and 0.5) or 3 and 1."""
    ref = np.asarray(jnp.asarray(np.random.RandomState(0).rand(256, 128),
                                 JNP_TYPES[form]))
    port = tbi.make_x(form)
    assert port.view(torch.int16 if form == "bf16" else port.dtype).numpy(
    ).tobytes() == ref.view(np.int16 if form == "bf16" else ref.dtype
                            ).tobytes()
    dt = JNP_TYPES[form]
    if form in ("f32", "bf16"):
        one = float(jnp.ones((), dt) * 1.0000001)
        half = float(jnp.ones((), dt) * 0.4999999)
    else:
        one, half = int(jnp.ones((), dt) * 3), int(jnp.ones((), dt))
    assert tbi.constants(form) == (one, half)
    if form == "bf16":
        assert tbi.constants(form) == (1.0, 0.5)


@pytest.mark.parametrize("form", ["f32", "bf16", "i16", "i8"])
def test_issue_chains_match_jax(form):
    """The exp kernel (make_kernel) over 8 rows of x, 2 reps, in interpret
    mode against the port's plain version: f32 within 1e-5 relative
    (XLA:CPU may contract the multiply-adds), bf16 and the integers bit
    for bit."""
    dt = JNP_TYPES[form]
    x = np.random.RandomState(0).rand(256, 128)[:8]
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    full = pl.BlockSpec(memory_space=pltpu.VMEM)
    fn = pl.pallas_call(jbi.make_kernel(dt), in_specs=[smem, full],
                        out_specs=full,
                        out_shape=jax.ShapeDtypeStruct((8, 128), dt),
                        interpret=True)
    ref = np.asarray(fn(np.array([2], np.int32), jnp.asarray(x, dt)))
    port = tbi.chains(tbi.make_x(form)[:8].contiguous(), 2, form)
    if form == "bf16":
        assert port.view(torch.int16).numpy().tobytes() == ref.view(
            np.int16).tobytes()
    elif form == "f32":
        np.testing.assert_allclose(port.numpy(), ref, rtol=1e-5, atol=0)
    else:
        assert port.numpy().tobytes() == ref.tobytes()


def _round_once(q: Fraction, shift: int) -> float:
    """The exact value ``q`` (> 0) rounded once, to nearest and ties to
    even, to float32 (``shift`` 0) or bfloat16 (16: float32's top 16
    bits), by comparing it exactly with the neighbours of a guess."""
    bits = int(np.float32(float(q)).view(np.int32)) >> shift
    cands = [np.int32((bits + d) << shift).view(np.float32)
             for d in (-1, 0, 1)]
    return float(min(cands, key=lambda v: (abs(Fraction(float(v)) - q),
                                          int(v.view(np.int32)) >> shift
                                          & 1)))


@pytest.mark.parametrize("form", ["f32_fma", "bf16x2_fma"])
def test_fused_chains_within_bound(form):
    """The fused forms' plain versions round each multiply-add once: bit
    for bit against the same chains in exact rational arithmetic rounded
    once a step, over 32 elements of x at 2 reps.  (f32's fused and
    unfused chains differ there; bf16's do not: its product by 1.0 or
    0.5 is exact.)"""
    x = tbi.make_x(form)[:1, :32].contiguous()
    fused = tbi.chains(x, 2, form)
    one, half = (Fraction(v) for v in tbi.constants(form))
    shift = 0 if x.dtype == torch.float32 else 16
    x0 = x.float().flatten().tolist()
    for i, xi in enumerate(x0):
        a = Fraction(xi)
        b = Fraction(_round_once(a + one, shift))
        for _ in range(2 * tbi.STEPS):
            a = Fraction(_round_once(a * one + half, shift))
            b = Fraction(_round_once(b * half + one, shift))
        assert float(fused.flatten()[i]) == _round_once(a + b, shift)
    unfused = tbi.chains(x, 2, {"f32_fma": "f32",
                                "bf16x2_fma": "bf16x2"}[form])
    assert torch.equal(fused, unfused) == (form == "bf16x2_fma")


# --- matmul_bench ---------------------------------------------------------------

def test_matmul_inputs_byte_identical():
    """The seven rows' (a, b) are matmul_bench's draws from the module's
    rng after its data, cast as jnp.asarray casts them."""
    rs = np.random.RandomState(0)
    for shape in ((jm.S, 3), (jm.S,), (jm.S, 10)):
        rs.uniform(0, 1, shape)
    for _ in range(3):
        rs.uniform(-1, 1, (8, 128))
    rs.normal(size=(3, 8, 128))
    assert rs.get_state()[1].tobytes() == tmm.module_rng().get_state(
    )[1].tobytes()
    assert rs.get_state()[2] == tmm.module_rng().get_state()[2]
    for (a, b), (_n, (m, k, n), prec) in zip(tmm.inputs(), tmm.ROWS):
        dt = jnp.bfloat16 if prec == "bf16" else jnp.float32
        for port, shape in ((a, (m, k)), (b, (k, n))):
            ref = np.asarray(jnp.asarray(rs.uniform(-1, 1, shape), dt))
            view = torch.int16 if prec == "bf16" else torch.float32
            assert port.view(view).numpy().tobytes() == ref.view(
                np.int16 if prec == "bf16" else np.float32).tobytes()


class _PlShim:
    """jm.pl with pallas_call in interpret mode."""

    BlockSpec = pl.BlockSpec

    @staticmethod
    def pallas_call(kernel, **kw):
        return pl.pallas_call(kernel, interpret=True, **kw)


def test_matmul_rows_match_jax(monkeypatch):
    """matmul_bench's kern for every row at REPS 1 (4 products), in
    interpret mode (jm.pl replaced by a shim that adds interpret=True;
    jm.np's asarray records each output; jm.rng replayed past the module
    data), against the port's plain version: within the stated bound of
    JAX's float32 products (the port rounds DEFAULT's inputs to TF32 and
    the bf16 row's a + s to bf16; XLA:CPU multiplies in full float32)."""
    outs = []
    shim_np = types.SimpleNamespace(
        asarray=lambda x: outs.append(np.asarray(x)) or outs[-1])
    monkeypatch.setattr(jm, "pl", _PlShim)
    monkeypatch.setattr(jm, "np", shim_np)
    monkeypatch.setattr(jm, "REPS", 1)
    monkeypatch.setattr(jm, "rng", tmm.module_rng())
    jm.matmul_bench()
    assert len(outs) == 4 * len(tmm.ROWS)       # one compile + 3 timed
    for row, (a, b) in enumerate(tmm.inputs()):
        ref = outs[4 * row]
        assert all(np.array_equal(ref, o) for o in outs[4 * row:4 * row + 4])
        port = tmm.matmul(a, b, 4, row)[0]
        bound = tmm.tolerance(a, b, 4, row, port, exact=True).numpy()
        err = np.abs(port.numpy().astype(np.float64) - ref)
        assert (err <= bound).all(), (row, float((err - bound).max()))
        assert float(np.abs(ref).max()) > 1.0


def _products_in_order(a, b, products, row, order):
    """matmul_reference with each product's K summed in ``order``: two
    halves, blocks of 8 or 16 in turn, blocks of 8 into four interleaved
    accumulators summed at the end (a kernel's k steps j into j % 4), or
    k from last to first."""
    prec = tmm.ROWS[row][2]
    bb = tmm.tf32_round(b) if prec == "tf32" else b.float()
    kk = a.shape[1]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for _ in range(products):
        lhs = tmm._lhs(a, acc[0, 0] * 1e-9, prec)
        if order == "halves":
            h = kk // 2
            d = lhs[:, :h] @ bb[:h] + lhs[:, h:] @ bb[h:]
        elif order in ("blocks8", "blocks16"):
            step = int(order[6:])
            d = torch.zeros_like(acc)
            for j in range(0, kk, step):
                d = d + lhs[:, j:j + step] @ bb[j:j + step]
        elif order == "split4":
            parts = [torch.zeros_like(acc) for _ in range(4)]
            for n, j in enumerate(range(0, kk, 8)):
                parts[n % 4] = parts[n % 4] + lhs[:, j:j + 8] @ bb[j:j + 8]
            d = ((parts[0] + parts[1]) + parts[2]) + parts[3]
        else:
            d = torch.zeros_like(acc)
            for k in reversed(range(kk)):
                d = d + torch.outer(lhs[:, k], bb[k])
        acc = acc + d
    return acc


@pytest.mark.parametrize("order", ["halves", "blocks8", "blocks16",
                                   "split4", "reversed"])
@pytest.mark.parametrize("row", range(7))
def test_matmul_bound_admits_other_orders(row, order):
    """Each row at 8 products with K summed in an order a kernel may
    take stays within tolerance of matmul_reference: the stated bound
    (unchanged) admits split-K and a fragment order of the kernel's
    choosing."""
    a, b = tmm.inputs()[row]
    ref = tmm.matmul_reference(a, b, 8, row)
    other = _products_in_order(a, b, 8, row, order)
    err = (other - ref).abs()
    assert bool((err <= tmm.tolerance(a, b, 8, row, ref)).all())
    if tmm.ROWS[row][1][1] > 8:
        assert float(err.max()) > 0.0       # the order did change the sums


def test_tf32_rounding():
    """tf32_round keeps 10 significand bits, to nearest, ties away."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12, 3.0 + 2 ** -20])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                         -(1.0 + 2 ** -10), 1.0, 3.0])
    assert torch.equal(tmm.tf32_round(x), want)


# --- entry points, wrappers ----------------------------------------------------------

MODULES = {"bf16_issue": tbi, "matmul_r2": tmm}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_issue_mm_entry_points(name, capsys, monkeypatch):
    """``--device cpu`` runs the plain versions; without a card and
    without it the probe raises and does not fall back."""
    assert MODULES[name].main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "plain version" in out and "not measured" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        MODULES[name].main([])


def test_issue_mm_wrappers_check_and_count():
    with pytest.raises(ValueError, match="form"):
        tbi.chains(tbi.make_x("f32"), 1, "f16")
    with pytest.raises(ValueError, match="bfloat16"):
        tbi.chains(tbi.make_x("f32"), 1, "bf16")
    a, b = tmm.inputs()[0]
    with pytest.raises(ValueError, match="row"):
        tmm.matmul(a, b, 1, 7)
    with pytest.raises(ValueError, match="a must be"):
        tmm.matmul(a.double(), b, 1, 0)
    with pytest.raises(ValueError, match="b must be"):
        tmm.matmul(a, b[:, :512].contiguous(), 1, 0)
    tbi.chains(tbi.make_x("i8"), 1, "i8")
    tmm.matmul(a, b, 1, 1)
    assert not any(tbi.LAUNCHES.values())
    assert not any(tmm.LAUNCHES.values())
