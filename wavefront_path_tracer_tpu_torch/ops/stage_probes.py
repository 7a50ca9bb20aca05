"""The fused kernels' differential stage probes: their names, their bits
and the kernels that have each.

Port of the reference's ``PROBE`` flags (``ops/pallas_kernels.py:61``):
the nine names that its ``stage_timing`` (``models/fused.py:415-532``)
times, and three more that its culled intersect reads (``dbl_entry2``,
``dbl_cond2``, ``hint_count``).  A timing probe runs one stage of a fused
kernel twice, the second time from inputs shifted by a zero that the
compiler cannot fold, and keeps the results (``dbl_accum``: up to
rounding); the stage's share of the kernel's time is (t_probed - t_base)
/ t_base (``models/fused.py`` :func:`stage_timing`).  ``hint_count``
counts instead: each cluster that the winner hint's prepass enters also
adds one to the supers counter, so that a hinted render reads its
prepass entries as supers(probed) - supers(base).  On the card each name
is a bit of the kernels' ``kProbe`` template argument
(``csrc/common.cuh``, where the same bits are defined), instantiated in
the shipped forms only (``csrc/baked_probe*.cu``,
``csrc/dynculled_probe*.cu``), one probe at a time; the plain versions
take the same names and duplicate the same stages in the same
arithmetic.  The segment kernels have their intersect's probes: the
reference's segment kernels read ``PROBE`` in their intersect alone
(``_segment_impl`` has no probe point of its own).
"""

from __future__ import annotations

# Each name's bit (csrc/common.cuh kDblRaygen ... kHintCount).
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
    "dbl_entry2": 1 << 9,      # baked culled: an entered sphere cluster,
                               # its whole quadratic from a shifted origin
    "dbl_cond2": 1 << 10,      # baked culled: the cluster conds from
                               # shifted box corners
    "hint_count": 1 << 11,     # baked culled with the winner hint: the
                               # prepass entries, counted in supers
}

# The probes of the persistent loop (csrc/common.cuh trace_warp and
# bounce_finish; ops/fused_kernels.py persistent_reference).
LOOP = ("dbl_raygen", "dbl_shade", "dbl_accum", "dbl_loopcond")

# The probes of the culled intersects (csrc/baked.cuh CulledIntersect,
# csrc/dynculled.cuh DynIntersect), which a segment runs too.
CULLED = ("dbl_entry", "dbl_cond", "dbl_entry2", "dbl_cond2")
DYNAMIC = ("dyn_dbl_entry", "dyn_dbl_cond", "dyn_dbl_global")

# The probes each kernel has, by the wrappers' kernel names: the culled
# kernel in the persistent loop without the winner hint and with it (its
# prepass count alone), the unculled and the dynamic culled kernels, and
# the three segment kernels (their intersect's probes: the loop's are the
# persistent loop's; baked_intersect has none).  The brute-force kernel
# (csrc/persistent.cu) has none, as the reference's plain dynamic kernel
# has none.
KERNEL_PROBES = {
    "culled": LOOP + CULLED,
    "culled_hint": ("hint_count",),
    "unculled": LOOP,
    "dynculled": LOOP + DYNAMIC,
    "segment_culled": CULLED,
    "segment_unculled": (),
    "segment_dynculled": DYNAMIC,
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
    time).  ``hint_count`` on the culled kernel without the winner hint is
    refused, where the reference traces the name to nothing."""
    names = probe_names(probe)
    for name in sorted(names):
        check_name(name)
    if not names:
        return 0
    have = KERNEL_PROBES.get(kernel, ())
    missing = sorted(names - set(have))
    if missing:
        why = (" (hint_count counts the winner hint's prepass: a culled "
               "bake with the winner hint has it)"
               if "hint_count" in missing else "")
        raise ValueError(
            f"the {kernel} kernel has no probe point for {missing}; its "
            f"probes are {list(have) or 'none'}{why}")
    if len(names) > 1:
        raise ValueError(f"one probe at a time, got {sorted(names)}")
    return PROBES[next(iter(names))]


def kernel_symbol(kernel: str, triangles: bool, textured: bool,
                  bits: int) -> str:
    """The part of the mangled (Itanium ABI) name that identifies the
    shipped form's instantiation of ``kernel`` (a key of
    :data:`KERNEL_PROBES`) for a scene's kinds and the probe bitmask
    ``bits`` (0: the shipped kernel itself), as ptxas's report and
    ``cuobjdump -sass`` name it: csrc/baked.cuh's
    ``baked_culled_kernel<P, kTris, kTex, kHint, Coop, kProbe>`` and
    ``baked_unculled_kernel<P, kTris, kTex, true, kProbe>``,
    csrc/dynculled.cuh's ``dynculled_kernel<P, kTris, kTex, Coop,
    kProbe>``, with P LaneParams (the persistent loop) or SegParams (a
    segment kernel)."""
    t, x = int(bool(triangles)), int(bool(textured))
    coop = "NS_5SweepILi8ELi12EEE"
    seg = kernel.startswith("segment_")
    params = "NS_9SegParams" if seg else "NS_10LaneParams"
    body = {
        "culled": f"baked_culled_kernelI{params}ELb{t}ELb{x}ELb0E{coop}",
        "culled_hint": f"baked_culled_kernelI{params}ELb{t}ELb{x}ELb1E"
                       f"{coop}",
        "unculled": f"baked_unculled_kernelI{params}ELb{t}ELb{x}ELb1E",
        "dynculled": f"dynculled_kernelI{params}ELb{t}ELb{x}E{coop}",
    }[kernel[len("segment_"):] if seg else kernel]
    return f"{body}Li{bits}EEEv"
