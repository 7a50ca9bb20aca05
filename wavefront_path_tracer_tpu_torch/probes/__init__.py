"""Hopper probes: hand-written CUDA ports of the ``exp/`` Pallas probes.

Each module follows its ``exp/`` namesake and runs as
``python -m wavefront_path_tracer_tpu_torch.probes.<name>`` on the card
(``--device cpu`` runs the plain versions at small counts):

- :mod:`.pair_ceiling`: the slope-timed sphere-pair issue ceiling (C6
  over a table read through L1, A2 over the constant bank);
- :mod:`.tripair`: the triangle-pair forms T1, T1p, T2 and T2p;
- :mod:`.hbm_bw`: the device-memory stream, plain and ``cp.async``;
- :mod:`.micro_r2`: its module data, and the cond-gated sweeps of
  ``run_gated`` (per-thread, warp-vote and worklist gating).

The kernels are ``csrc/probe_pairs.cu``, ``csrc/probe_tripair.cu`` and
``csrc/probe_stream.cu``; :mod:`._slope` times them.
"""
