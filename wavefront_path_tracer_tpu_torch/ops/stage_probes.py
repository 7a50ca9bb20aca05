"""The fused kernels' differential stage probes: their names, their bits
and the kernels that have each.

Port of the reference's ``PROBE`` flags (``ops/pallas_kernels.py:61``)
for the nine names that its ``stage_timing`` (``models/fused.py:415-532``)
times.  A probe runs one stage of a fused kernel twice, the second time
from inputs shifted by a zero that the compiler cannot fold, and keeps
the results (``dbl_accum``: up to rounding); the stage's share of the
kernel's time is (t_probed - t_base) / t_base (``models/fused.py``
:func:`stage_timing`).  On the card each name is a bit of the kernels'
``kProbe`` template argument (``csrc/common.cuh``, where the same bits
are defined), instantiated in the shipped forms only
(``csrc/baked_probe*.cu``, ``csrc/dynculled_probe*.cu``), one probe at a
time; the plain versions take the same names and duplicate the same
stages in the same arithmetic.
"""

from __future__ import annotations

# Each name's bit (csrc/common.cuh kDblRaygen ... kDynDblGlobal).
PROBES = {
    "dbl_raygen": 1 << 0,      # raygen (every fused kernel's loop)
    "dbl_shade": 1 << 1,       # shade
    "dbl_accum": 1 << 2,       # the sky add, as two halves
    "dbl_loopcond": 1 << 3,    # the loop's trip vote
    "dbl_entry": 1 << 4,       # baked culled: an entered cluster's tests
    "dbl_cond": 1 << 5,        # baked culled: cluster and super conds
    "dyn_dbl_entry": 1 << 6,   # dynamic culled: an entered cluster's tests
    "dyn_dbl_cond": 1 << 7,    # dynamic culled: cluster and super conds
    "dyn_dbl_global": 1 << 8,  # dynamic culled: the global spheres
}

# The probes of the persistent loop (csrc/common.cuh trace_warp and
# bounce_finish; ops/fused_kernels.py persistent_reference).
LOOP = ("dbl_raygen", "dbl_shade", "dbl_accum", "dbl_loopcond")

# The probes each kernel has, by the wrappers' kernel names.  The
# brute-force kernel (csrc/persistent.cu) has none, as the reference's
# plain dynamic kernel has none.
KERNEL_PROBES = {
    "culled": LOOP + ("dbl_entry", "dbl_cond"),
    "unculled": LOOP,
    "dynculled": LOOP + ("dyn_dbl_entry", "dyn_dbl_cond", "dyn_dbl_global"),
}

# dbl_accum adds the sky term as two halves: each miss rounds up to three
# times instead of once, at most 1.5 ulp of the sum a sample; its render
# is held to the unprobed one within this relative error a sample (the
# bound with a margin of five) and this absolute error.  Every other probe
# keeps the unprobed render's bits.
ACCUM_RTOL_PER_SAMPLE = 1e-6
ACCUM_ATOL = 1e-7

# The reference's other PROBE names, which the port does not have, and
# why.
NOT_PORTED = {
    "dbl_scope": "it re-stages the TPU kernel's scratch scope, which the "
                 "port does not have",
    "dyn_dbl_refs": "it re-stages the TPU kernel's per-cluster VMEM refs, "
                    "which the port does not have",
    "dyn_split_entry": "it adds a pl.when boundary, a TPU construct the "
                       "port does not have",
    "dbl_rotpick": "it recomputes the TPU kernel's lane rotation, which "
                   "the port does not have",
    "dbl_entry2": "not ported yet (ROADMAP.md queue 1 item 11)",
    "dbl_cond2": "not ported yet (ROADMAP.md queue 1 item 11)",
    "hint_count": "not ported yet (ROADMAP.md queue 1 item 11)",
}


def probe_names(probe) -> frozenset:
    """``probe`` (None, one name, or names) as a frozenset of names."""
    if probe is None:
        return frozenset()
    if isinstance(probe, str):
        return frozenset((probe,))
    return frozenset(probe)


def check_name(name: str) -> None:
    """Raise ValueError for a name that is not one of :data:`PROBES`,
    saying why where the reference has it."""
    if name in PROBES:
        return
    if name in NOT_PORTED:
        raise ValueError(f"probe {name!r} is not ported: "
                         f"{NOT_PORTED[name]}")
    raise ValueError(f"unknown probe {name!r}; the probes are "
                     f"{', '.join(PROBES)}")


def probe_bits(probe, kernel: str) -> int:
    """The ``kProbe`` bitmask of ``probe`` for ``kernel`` (a key of
    :data:`KERNEL_PROBES`, or "persistent"): 0 for no probe.  Raises
    ValueError for an unknown name, a name that the kernel has no point
    for, or more than one name (the kernels instantiate one probe at a
    time)."""
    names = probe_names(probe)
    for name in sorted(names):
        check_name(name)
    if not names:
        return 0
    have = KERNEL_PROBES.get(kernel, ())
    missing = sorted(names - set(have))
    if missing:
        raise ValueError(
            f"the {kernel} kernel has no probe point for {missing}; its "
            f"probes are {list(have) or 'none'}")
    if len(names) > 1:
        raise ValueError(f"one probe at a time, got {sorted(names)}")
    return PROBES[next(iter(names))]


def kernel_symbol(kernel: str, triangles: bool, textured: bool,
                  bits: int) -> str:
    """The part of the mangled (Itanium ABI) name that identifies the
    shipped form's instantiation of ``kernel`` for a scene's kinds and
    the probe bitmask ``bits`` (0: the shipped kernel itself), as ptxas's
    report and ``cuobjdump -sass`` name it: csrc/baked.cuh's
    ``baked_culled_kernel<LaneParams, kTris, kTex, false, Coop, kProbe>``
    and ``baked_unculled_kernel<LaneParams, kTris, kTex, true, kProbe>``,
    csrc/dynculled.cuh's ``dynculled_kernel<LaneParams, kTris, kTex, Coop,
    kProbe>``."""
    t, x = int(bool(triangles)), int(bool(textured))
    coop = "NS_5SweepILi8ELi12EEE"
    body = {
        "culled": f"baked_culled_kernelINS_10LaneParamsELb{t}ELb{x}ELb0E"
                  f"{coop}",
        "unculled": f"baked_unculled_kernelINS_10LaneParamsELb{t}ELb{x}"
                    f"ELb1E",
        "dynculled": f"dynculled_kernelINS_10LaneParamsELb{t}ELb{x}E{coop}",
    }[kernel]
    return f"{body}Li{bits}EEEv"
