"""Hopper probes: hand-written CUDA ports of the ``exp/`` Pallas probes.

Each module follows its ``exp/`` namesake and runs as
``python -m wavefront_path_tracer_tpu_torch.probes.<name>`` on the card
(``--device cpu`` runs the plain versions at small counts):

- :mod:`.pair_ceiling`: the slope-timed sphere-pair issue ceiling (C6
  over a table read through L1, A2 over the constant bank);
- :mod:`.tripair`: the triangle-pair forms T1, T1p, T2 and T2p;
- :mod:`.hbm_bw`: the device-memory stream, plain and ``cp.async``;
- :mod:`.micro_r2`: its module data, the cond-gated sweeps of
  ``run_gated`` (per-thread, warp-vote and worklist gating), and its
  command line by the reference's variant names;
- :mod:`.run_pairs`: the 23 intersect-loop designs of ``run_pairs``;
- :mod:`.micro_slope`: ``micro_slope``'s rep points over micro_r2's
  command line;
- :mod:`.bf16_issue`: dependent chains by type (f32, bf16, int16, int8;
  unfused and fused);
- :mod:`.matmul_r2`: ``matmul_bench``'s dependent in-kernel products.

The hierarchy sweeps (:mod:`._hier`) run the render kernels with bakes
and tables of their own: :mod:`.super_gate` (the two-level sweep at the
headline), :mod:`.sweep10k` (cluster size and super factor on 10,000
spheres), :mod:`.dynsweep` (the dynamic kernel's cluster size),
:mod:`.dynnocull` (every sphere a global), :mod:`.cullstats` (supers and
clusters entered, a warp at a time), :mod:`.meshscale` and
:mod:`.knotbench` (the torus knot by triangle count) and
:mod:`.rr_floor_sweep` (the roulette's start and floor).

The last nine drivers check or time a configuration through the render
paths, with no kernel of their own: :mod:`.gate_sweep` (the sixteen
gate rows, each the port's ``validate`` in a process of its own),
:mod:`.make_golden` (the golden oracle in batches, with resume),
:mod:`.matsplit_ab` (the wavefront engine's material split),
:mod:`.clamp_bias` (the clamp's bias), :mod:`.variance10` (the spread
of one render within and across processes), :mod:`.texlut` (image
textures against the LUT budget), :mod:`.bounce0` (the bounce-0
shortlist against the lanes' own cluster entries) and :mod:`.knotprobe`
(the dynamic stage table on the knot); the orbit GIF is
``examples/turntable.py``.  Each runs on the card by default; on the
CPU with ``--device cpu`` at a small size (``gate_sweep``'s rows take
``--device`` through to ``validate``; ``make_golden`` takes its samples
from ``GOLDEN_SPP`` and ``GOLDEN_BATCH``).  None writes under
``golden/``.

The kernels are ``csrc/probe_pairs.cu``, ``probe_tripair.cu``,
``probe_stream.cu``, ``probe_designs.cu``, ``probe_issue.cu`` and
``probe_mma.cu``; :mod:`._slope` times them.
"""
