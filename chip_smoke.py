"""Drive the PyTorch/CUDA port once on one GPU and check it.

    python3 chip_smoke.py [--phases NAME,...]

Phases (all by default), each of which raises on failure (nonzero exit).
They run in this order, but for the phases that time nothing: with more
than one phase to run, the book's cases of kernels vs plain (3) run
here, while its mesh cases, meshplain (8), textures (9), segments (11),
the two halves of oracle (17) and the bench's ``--all`` (19) run beside
them, with the plain versions of stageplain (22) and hier (25), each
in a process of its own (``--phases NAME [--part PART]``
with its own ``--record`` and ``--plain-out``, whose plain results the
later phases reuse), and the timed phases start only when all of them
have ended, so that no timed phase shares the card.  Every child process dies with
this script (``PR_SET_PDEATHSIG``); one that outlasts its time is
killed with the processes below it, and so is whatever is left below
this script when it ends or receives SIGTERM.

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the CUDA kernels from ``csrc/`` with nvcc, one process
   per source, all started together, and prints ptxas's lines for every
   kernel (persistent, baked culled and unculled, dynamic culled), then
   each persistent, baked unculled, baked culled and dynamic culled
   instantiation's registers, stack and spills;
3. kernels vs plain (``kernels``): each kernel against its plain PyTorch
   version on the same CUDA tensors, in block lane order with padding
   lanes, 50 bounces.  On book_one_final at 160x90@4spp, the CLI's
   default view: the persistent-lane kernel (default, and roulette/clamp/
   stratified AA/lane_split=2), the baked kernel culled in clusters of 16
   (the same two option sets), culled in clusters of 2 (243 clusters, so
   the two-level sweep) and unculled, and culled in clusters of 16 on the
   book with every sphere twice (exact ties).  Then the mesh cases: the
   dynamic culled kernel on mesh_terrain (seed 7, 5,000 triangles, the book
   camera) at 160x90@4spp in the two option sets, on the 50k-triangle
   knot at 160x90@2spp (rolled triangle supers), on procedural 10,000
   spheres (seed 42) in clusters of 32 (rolled sphere supers) and on
   book_bubble (a negative radius); the baked kernel culled in clusters
   of 16 and unculled on mesh_terrain at 160x90@4spp.  Radiance words and
   the counters [rays, iterations, supers, clusters] must be
   bit-identical (the kernels are built without FMA contraction);
4. golden gate: ``render()`` of book_one_final at 400x225, 1000 spp,
   against ``golden/oracle_book_400x225_1000spp.npz``, display RMSE
   < 1e-3, with the brute-force intersector and with baked/cull16;
5. main paths (``main``): the CLI at 1920x1080, 32 spp in one frame, 50
   bounces, for the brute-force path, the headline path (``--intersector
   baked --clusters 16``), the unculled baked path and the headline path
   segmented (``--recluster 2``), each warmed up and then timed, with the
   launch counts set to 0 just before the timed run and read just after;
6. full size (``full``): the checks of phase 3 at the main paths' planes
   (1920x1080, block order): the persistent kernel at 1 and 2 samples
   per lane, the two baked kernels at 1; the plain versions' times there;
   and each kernel's time at 32 samples per lane beside its bound;
7. mesh rows (``mesh``): the reference's three mesh rows (``bench.py``
   MESH_ROWS, built as its ``bench_once`` builds them) through
   ``Renderer.render_frame`` at 800x448, 50 bounces: terrain_baked
   (baked/cull16, 32 spp), terrain_dynamic (dynamic culled/16, 32 spp)
   and knot50k_dynamic (dynamic culled/16, 8 spp), each warmed up and
   then timed with the launch counts read alone; the CLI once with
   ``--scene mesh_terrain --intersector auto`` (5,003 primitives:
   dynamic culled in clusters of 32); and terrain through the dynamic,
   baked culled and baked unculled kernels, pairwise equal by the
   statistical rule; then the rays of a terrain frame at 800x448@1spp
   (the dynamic culled plain version) that are parallel to an axis and
   start on a face plane of one of its boxes, counted;
8. mesh full size (``meshfull``): at the mesh rows' planes (800x448, 1
   spp), dynamic culled on terrain checked bit for bit with kernel and
   plain times and the bound, and dynamic culled on the knot, baked
   culled/16 and unculled on terrain with their kernel times and bounds;
   and each mesh kernel's time at its row's samples per lane beside its
   bound.  Phase ``meshplain`` checks those three bit for bit against
   their plain versions there, untimed;
9. textures (``tex``): the textured kernels against their plain versions,
   bit for bit, at 160x90@4spp with padding lanes, 50 bounces: book_checker
   (a checker ground and an image sphere on book_one_final's spheres)
   through baked culled/16 (default, and roulette/clamp/stratified AA/
   lane_split=2), with the winner hint, with a 512-texel LUT (so that
   pooling runs), baked unculled and dynamic culled/16;
   ``examples/scene.json`` (a negative radius, its own camera) through
   baked culled/16; and a textured mesh (a scene file with a checker
   sphere and an OBJ that the script writes) through baked culled/16 and
   dynamic culled/16;
10. textures at full size (``texfull``): the CLI with ``--scene
   book_checker`` at 1920x1080, 32 spp in one frame, through baked
   culled/16, baked culled/16 with ``--winner-hint`` and dynamic
   culled/16, each warmed up and then timed with the launch counts read
   alone; the textured culled and dynamic kernels bit for bit at the
   1080p planes at 1 spp with kernel and plain times; the three textured
   intersects (baked culled/16, baked unculled, dynamic/16) pairwise at
   400x224@64spp: the statistical rule's image limits and ray counts
   (the diverged share recorded, beside book_one_final's); and each
   textured kernel's time
   at 1080p@32spp beside its bound and beside the untextured headline
   kernel's in the same call; then the texture step on its own
   (``probes/texstep.py``): each render kernel's textured and untextured
   instantiation's ptxas stack, spills and registers, SASS instructions
   and local loads and stores in and out of the sweep's loops; book_checker
   at 1080p@32spp through baked culled/16, baked unculled and dynamic
   culled/16, each through its textured and its untextured instantiation
   on one bake, in turns, least of 3, with equal counters (else the A/B
   is void and the phase fails): the difference is the step's own time,
   beside its bound; and the plain step over the frame's hits;
11. segments (``seg``): the recluster segment kernels in both forms (each
   lane on its own thread; the shipped one, the warp's lanes in step)
   against their plain versions through whole segmented renders at
   160x90@4spp with padding lanes, recluster 2, 50 bounces:
   book_one_final baked culled/16 (default, and roulette/clamp/stratified
   AA), the book with every sphere twice (exact ties), baked unculled,
   dynamic culled/16 on terrain and on the knot at 2 spp, book_checker
   culled/16; the state, ids and counters of two segments bit for bit in
   both forms; recluster 1,
   recluster 2 and recluster 2 without the sort giving the same radiance
   words and rays, supers and clusters (their loop trips per warp, which
   the lane order moves, printed); and ``--recluster`` through the CLI on each
   culling intersector, a mesh and a textured scene (brute force without
   clusters refuses);
12. segments at full size (``segfull``): the segment kernels in both
   forms bit for bit at the 1080p book's planes at 1 spp (baked culled/16
   and unculled) and the knot's (dynamic culled/16), with their device
   time, the plain versions' times and the bound (bytes counted from the
   lanes alive at each launch); the segment kernels' time with and
   without the sort; their time and bound at the samples the segmented
   rows run (the headline at 32 spp, the knot at 8); the segmented rows (knot50k_dynamic at recluster 0,
   1 and 2, both terrain rows and the headline at 0 and 2) through
   ``Renderer`` with frame time, device time split, device kernels and
   copies and busy share under torch.profiler, recluster 2 against 0 by
   the statistical rule; and the golden gate at recluster 2;
13. probes (``probes``): the probe kernels of ``probes/`` against their
   plain versions on the card (the pair ceiling's C6 and A2, the gated
   sweeps' W8 and C8 patterns under per-thread, warp-vote and worklist
   gating, the four triangle-pair forms at the reference's 1024 rays and
   at the full width, and run_pairs's 21 other designs in each of their
   forms (table place, lanes a ray) over the full-width rays, copy 0
   against the 1024 rays alone, bit for bit at 2 reps; bf16_issue's
   seven chain forms bit for bit (the fused ones rounding each
   multiply-add once); matmul_bench's seven rows within their stated
   bound, every copy equal; the stream's plain and cp.async kernels at
   8-64 KB chunks within the float32 summation bound of the float64
   sums), one timed full-width call of each kernels-line entry beside
   its plain version and bound (torch.sum beside the stream, the
   torch.matmul loop over all copies beside the matmul row), the SASS
   instructions a pair of the ceiling's kernels, of every
   probe_designs.cu form and of the four triangle forms (each kernel's
   sweep loop's) and the matmul rows' mma instructions, with ptxas's
   registers and spills (a kernel that spills fails), and each probe's
   command line (micro_r2 with every design's name, and micro_slope, at
   reduced rep points) with the launch counts set to 0 just before it
   and read just after; a reading above the card's spec fails.  After
   it, each culled and mesh kernel's time beside the time of its pairs
   at the measured ceiling (the mesh rows also at the bench's triangle
   ceiling);
14. sweep forms (``sweep``): the serial sweep (T = 0, every entered
   cluster on its own thread) and the shipped form (a vote per cluster,
   the cooperative fold where at most T lanes enter) of the baked culled
   kernel at the four cells that chose its form (the headline,
   book_checker and the winner-hint headline at 1920x1080@32spp,
   terrain_baked at 800x448@32spp) and of the dynamic culled kernel at
   terrain_dynamic (800x448@32spp), knot50k_dynamic (800x448@8spp) and
   book_checker dynamic/16 (1920x1080@32spp): every form bit for bit with
   the serial one at that size, then one launch of each timed by CUDA
   events in turns (serial, cooperative, cooperative, serial), each run
   and the serial runs' spread printed; both dynamic forms bit for bit
   with the plain version at 160x90@4spp on terrain, the knot,
   book_checker and the book with every sphere twice (exact ties); and
   the warp-divergence count of the headline (4 image blocks of 32x32
   at 8 spp) and of terrain_dynamic and knot50k_dynamic (4 blocks each,
   at 2 spp)
   from the plain version at the middle of each lane order, held to the
   kernel's counters over the same lanes;
15. loop forms (``loop``): the two unculled kernels, the persistent
   (brute force) one and the unculled baked one, in their two loop forms
   (per thread, ``trace_lane``; in step, ``trace_warp``, the shipped form,
   the unculled kernel's triangle rows staged a warp at a time in shared
   memory): every form bit for bit with the plain version at
   160x90@4spp (the persistent kernel on book_one_final and the doubled
   book, the unculled on book_one_final, book_checker and terrain) and at
   1920x1080@1spp (both on book_one_final); then at four cells (persistent
   and unculled on book_one_final and unculled on book_checker at
   1920x1080@32spp, unculled on terrain at 800x448@32spp) every form bit
   for bit with the lane form, one launch of each timed by CUDA events in
   turns, each run and the lane runs' spread printed beside the bound and
   the warps' fullness, and the loop trips beside those of a loop that
   regroups its lanes at every sample end (one launch a sample);
16. segment forms (``segform``): the segment kernels' two forms at six
   cells, recluster 2 (knot50k_dynamic 800x448@8spp and terrain_dynamic
   800x448@32spp on the dynamic kernel, the headline 1920x1080@32spp and
   terrain_baked 800x448@32spp on the baked culled one, book_one_final
   1920x1080@1spp and terrain 800x448@1spp on the unculled one): both
   forms' frames bit for bit, then one frame of segment launches in each
   form in turns, each launch timed by CUDA events (``probes/_stage.py``
   ``segment_frame``: behind a device-side spin, so that they bracket the
   kernel alone) and summed by its index in
   the segment schedule, beside the serial runs' spread and the bound.
   The segmented rows of phase 12 and the CLI's ``--recluster`` runs of
   phases 5 and 11 must launch only the shipped form;
17. oracle (``oracle``): the port's megakernel (plain PyTorch, brute force
   over every sphere and triangle) through ``validate`` at book_one_final
   400x224@64spp, 50 bounces, against the JAX megakernel's TPU render with
   the same streams (``golden/oracle_tpu_same_stream.npz``), display RMSE
   < 2e-3; the twelve same-stream rows of ``golden/GATE_SWEEP.json``, each
   fused variant against the port's megakernel at that size under its
   row's gate (2e-3, 3e-3 textured), with the diverged pixel share of each
   (the parity rule's, at 50 bounces and 64 spp), and wavefront_matsplit
   (the wavefront engine with material_split) at display RMSE 0.0 against
   the port's megakernel and under 2e-3 against the TPU render; terrain
   and the knot cut to 5,000
   triangles, fused (baked/16 and dynamic/16 on terrain, dynamic/16 on
   the knot) against the megakernel at 200x112@2spp, read with no gate;
   and ``validate``'s cached-golden flow (baked/16 at 400x225@1000spp
   against ``golden/oracle_book_400x225_1000spp.npz``, < 1e-3);
18. wavefront (``wavefront``): the wavefront engine (plain PyTorch, no
   kernel of its own) against the megakernel, radiance words and rays bit
   for bit, on book_one_final (the CLI's view) at 400x224@4spp, 50
   bounces, with brute force, ``ray_chunk=16384``, ``material_split`` and
   roulette from bounce 5; the BVH on both engines bit for bit with each
   other at 200x112@2spp, and wavefront/BVH against wavefront/brute force
   by the parity rule there and on terrain (the triangle BVH) at
   100x56@2spp; one BVH
   traversal of a 400x224 frame's primary rays with the unfinished lanes
   read back every 1, 8 (shipped) and 64 steps, bit for bit, each timed;
   one ``--stage-timing`` CLI run of the wavefront engine (400x224@2spp,
   a frame a sample) with the stage timer's averages; and the engine's
   Mrays/s with brute force and with the BVH at 400x224@2spp;
19. bench (``bench``): ``python -m wavefront_path_tracer_tpu_torch.bench``
   as a subprocess at its defaults (the headline, book_one_final
   1920x1080@1000spp fused/baked/cull16, and the three mesh rows at
   800x448): exit 0, a positive value and no error, all three mesh rows
   without error, every row's launches in the shipped form and its
   kernel launched, nonzero counters, every device_utilization at most
   1.05; its JSON line is printed; then ``--all`` at 160x90@8spp (every
   engine and intersector, exit 0, no configuration failed);
20. app (``app``): an ``InteractiveSession`` on the card (book_one_final,
   the CLI's view, 400x224, two samples a frame, the brute-force kernel)
   stepping twice, then with a camera move (accumulation restarts), its
   final image from the accumulator; the AOVs at 400x224@4spp on the card
   against the AOVs on the CPU of the same scene by the parity rule; a
   ``PreviewServer`` on 127.0.0.1 serving a frame rendered on the card
   (``/frame.png`` decoded equal to the published image, ``/status.json``);
   and ``--checkpoint`` at 2 spp then ``--resume`` to 4 through the CLI
   on the headline path at 400x224, bit for bit with one uninterrupted
   render of 4;
21. multi (``multi``): ``parallel/`` on the card.  The headline
   (1920x1080@32spp, 50 bounces, fused/baked/cull16, block_tiles 32)
   through ``render_samples_sharded`` over a 4x1 mesh, bit for bit with
   ``render_samples`` on cuda:0, and over 2x2 within rtol 1e-5, atol 1e-6;
   terrain_dynamic (800x448@32spp, dynamic/16) over 4x1 and the headline
   at recluster 2 over 2x1, bit for bit; each with equal rays, its kernel
   launched in the shipped form (counts read alone), and timed in turns
   against the one-device render, and without recluster each kernel
   launch also timed alone by CUDA events (a mesh takes distinct cards
   where the machine has two or more, else cuda:0 for each entry);
   ``dryrun_multichip`` over four entries of cuda:0, its five passes
   against one-device renders, while two ``parallel.dryrun --worker``
   processes over gloo sharing cuda:0 and one over NCCL in a world of one
   run beside it, each band and the gathered image bit for bit (every
   child under a timeout); more NCCL ranks than cards refused; and the
   bench with ``--mesh 1x1`` at its defaults: exit 0 and the rays of
   phase bench's headline.
22. stage plain (``stageplain``, untimed, in the window in three
   processes, ``--part book|terrain|seg``): the plain versions of phase
   23's 108 probe cases, each timed, handed back to it;
23. stage (``stage``): the fused engine's differential stage probes
   (``ops/stage_probes.py``).  Every probe kernel (culled/16: raygen,
   shade, accum, loopcond, entry, cond, entry2, cond2; culled with the
   winner hint: hint_count; unculled: the first four; dynamic
   culled/16: those four and entry, cond, global; the culled segment:
   entry, cond, entry2, cond2; the dynamic segment: entry, cond, global)
   at 160x90@4spp, 4 bounces (the segments through a segmented render at
   recluster 2), in block lane order with padding lanes, on
   book_one_final, book_checker, terrain and the textured mesh (the four
   kinds): radiance words and counters bit for bit with its plain version
   and with the unprobed kernel (``dbl_accum``: its radiance within 1e-6
   relative a sample; ``hint_count``: its supers higher by its prepass
   entries, at least one and at most its clusters entered); each probe
   kernel's SASS instructions above its unprobed kernel's
   (``cuobjdump``), ptxas's registers and spills of each; a bitmask with
   no instantiation, and a probe of the unculled segment, refused by the
   kernels' entry points; the ``--stage-timing`` tables of the headline
   and the unculled book (1920x1080@32spp) through the CLI and of
   terrain_dynamic (800x448@32spp) through ``models/fused.py``
   ``stage_timing``, each with the launch counts set to 0 just before it
   and read just after (every probe of the table launched), shares at
   least 0 that close the budget, those below the between-call drift
   marked; and ``probes/iterprobe.py`` and ``probes/dynprobe.py`` at
   their defaults, then iterprobe with ``dbl_entry2`` and ``dbl_cond2``
   with its launch counts read alone;
24. segment stage (``segstage``): the segment kernels' probes at K=2
   (recluster 2, 50 bounces), on the headline (the culled segment,
   1920x1080@32spp) and knot50k_dynamic (the dynamic segment,
   800x448@8spp): each probe's share of a frame's segment-kernel time
   (``probes/_stage.py`` ``segment_shares``: the frame's launches timed
   one by one by CUDA events and summed, base and probe in turns, least
   of 3, every probed frame bit for bit with the base's), with the launch
   counts set to 0 just before each cell and read just after; and
   ``hint_count`` on book_checker with the winner hint at
   1920x1080@32spp: the prepass entries a ray, beside the clusters
   entered a ray with and without the hint;
25. hierarchy (``hier``): ``ops/bake.py`` ``bake_culled``'s hierarchy
   parameters and the dynamic tables' cluster sizes, and the sweeps of
   ``probes/`` that choose them.  Part ``plain`` (untimed, in the window
   in a process of its own): the plain version of each case at
   160x90@4spp, 4 bounces, handed back; part ``kernels``: the baked
   culled kernel on book_one_final in clusters of 16 at super gate 0
   with supers of 8, 4 and 16 (the two-level sweep on 31 clusters), at
   global radius factors 3 and 0 (every sphere a global, no cluster), on
   procedural 10,000 spheres at clusters x supers 16x8, 32x8, 64x8 and
   32x16, with each lane's counters (``lane_counts``), and with roulette
   from bounce 3 at floor 0.25; the dynamic culled kernel on the book in
   clusters of 8, 32 and 64, with every sphere a global (``n_clusters``
   0), on procedural in clusters of 8 (rolled) with each lane's counters,
   and on the torus knot of 2,000 and 8,000 triangles: radiance words,
   the four counters and the lanes' counters bit for bit with the plain
   version, each two-level bake entering supers, each kernel timed beside
   its bound; then each sweep (super_gate, sweep10k, dynsweep, dynnocull,
   cullstats on both kernels, meshscale, knotbench with and without
   ``recluster=2``, rr_floor_sweep) at a cut size in this process, with
   the launch counts set to 0 just before and read just after: its
   kernel launched (knotbench's segmented run the dynamic segment
   kernel);
26. drivers (``drivers``, untimed, in the window in a process of its
   own): the nine drivers of ``probes/`` and ``examples/`` that time or
   check a configuration without a probe kernel of their own, each at a
   cut size with the launch counts set to 0 just before it and read just
   after, its output in ``OUT_DIR/drivers/``: ``gate_sweep --only`` a
   same-stream row (baked_cull16 at 400x224@64spp against the card's
   megakernel) and a golden row (baked/16 at 400x225@1000spp against the
   committed golden), each under its gate; ``make_golden`` at 6 spp in
   batches of 2, interrupted after one batch and resumed, bit for bit
   with an uninterrupted run; ``matsplit_ab`` at RMSE 0.0 on both scenes;
   ``clamp_bias`` and ``variance10`` (one process beside) to their end;
   ``texlut`` (the unculled kernel with the texture step), ``bounce0``
   (the culled kernel with each lane's counters), ``knotprobe`` (the
   dynamic culled kernel's triangle probes, each probed render equal to
   the base's) and ``turntable`` (the unculled kernel; the GIF's frames
   counted from the file) each launching its kernel; and every file under
   ``golden/`` hashing as it did before the phase.

The last two lines of standard output are a JSON object describing the
kernels (the probe kernels too, one entry a kernel and probe) and ``{"ok": true, "device": {...}}``; they are printed only when
every phase ran.  Larger outputs (the PNGs, a JSON of all measurements)
go to ``OUT_DIR``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# The bound's inputs: the card's published memory and TF32 peaks, kept
# with the probes' spec check (PEAK_FP32 is that check's alone: FP32
# operations are bounded at the issue rate, _fp32_rate).
from wavefront_path_tracer_tpu_torch.probes._slope import (PEAK_BYTES,
                                                           PEAK_FP32,
                                                           PEAK_TF32)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
GOLDEN = os.path.join(ROOT, "golden", "oracle_book_400x225_1000spp.npz")
GOLDEN_GATE = 1e-3
MAIN_WIDTH, MAIN_HEIGHT, MAIN_SPP = 1920, 1080, 32
SOURCE = "wavefront_path_tracer_tpu_torch/csrc/"
REPLACES = "wavefront_path_tracer_tpu/ops/pallas_kernels.py:"

# The port's kernels: their entries in the kernels line, and the CLI
# flags of the path that runs each.
KERNELS = {
    "persistent": {"name": "fused_render_persistent (loop form warp: the "
                           "warp's lanes in step, trace_warp)",
                   "source": SOURCE + "persistent.cu",
                   "replaces": REPLACES + "3098",
                   "argv": ["--intersector", "bruteforce"]},
    "culled": {"name": "fused_render_baked/baked_culled_intersect",
               "source": SOURCE + "baked.cu",
               "replaces": REPLACES + "3157",
               "argv": ["--intersector", "baked", "--clusters", "16"]},
    "unculled": {"name": "fused_render_baked/baked_intersect (sweep form "
                         "Coop: the warp's lanes in step, trace_warp, the "
                         "triangle rows staged a warp at a time)",
                 "source": SOURCE + "baked.cu",
                 "replaces": REPLACES + "3157",
                 "argv": ["--intersector", "baked", "--clusters", "0"]},
    # Its main path is the dynamic mesh rows (phase 7), not a book path.
    "dynculled": {"name": "fused_render_dynculled/"
                          "make_dynamic_culled_intersect (sweep form Coop: "
                          "a vote per cluster, the cooperative fold)",
                  "source": SOURCE + "dynculled.cu",
                  "replaces": REPLACES + "3211"},
    # The texture step of the persistent body; its main path is the
    # book_checker CLI run of phase 10, through the textured culled kernel.
    "textured": {"name": "_apply_image_textures",
                 "source": SOURCE + "common.cuh",
                 "replaces": REPLACES + "298"},
    # The recluster segments: the headline through the CLI at
    # --recluster 2 (phase 5), and the knot row at recluster 2 (phase 12).
    "segment_culled": {"name": "fused_segment_baked/_segment_impl (sweep "
                               "form Coop: the warp's lanes in step, "
                               "trace_segment_warp, with the vote and the "
                               "cooperative fold; unculled: the staged "
                               "triangle rows)",
                       "source": SOURCE + "baked.cu",
                       "replaces": REPLACES + "2997",
                       "argv": ["--intersector", "baked", "--clusters", "16",
                                "--recluster", "2"]},
    "segment_dynculled": {"name": "fused_segment_dynculled/_segment_impl "
                                  "(sweep form Coop: the warp's lanes in "
                                  "step, trace_segment_warp, with the vote "
                                  "and the cooperative fold)",
                          "source": SOURCE + "dynculled.cu",
                          "replaces": REPLACES + "3027"},
}
# The port's kernels by the names the profiler gives them.
from wavefront_path_tracer_tpu_torch.utils.sass import (  # noqa: E402
    RENDER_KERNELS as KERNEL_NAMES,
)
MESH_SIZE = (800, 448)

# FP32 operations counted from the sources (adds, multiplies, divides,
# square roots, min/max; compares and selects not counted):
FLOPS_PAIR = {
    "persistent": 24,      # persistent.cu TableIntersect: the full quadratic
    "unculled": 21,        # baked.cu UnculledIntersect, far root not taken
    "culled": 17,          # baked.cu CulledIntersect::test, far root not taken
    "dynculled": 18,       # dynculled.cu DynIntersect::test, both roots
}
FLOPS_TRI = 46             # common.cuh tri_test: 9 p, 5 det, 1 div, 3 t,
                           # 6 u, 9 q, 6 v, 6 t, u + v
FLOPS_BOX = 24             # box_range (22) and the cond's max and min
FLOPS_SLAB = 22            # slab_exit: box_range
FLOPS_RAY = 120            # shade, throughput and miss (common.cuh), per ray
FLOPS_RAY_SHIFT = {        # per ray before the sweep
    "culled": 16,          # shifted origin 3, dd_o 5, oo2 5, 1/d 3
    "dynculled": 19,       # the same and d / 2
}
# The texture step (common.cuh apply_textures), per event counted by the
# plain version (ops/textures.py EVENTS): probes/texstep.py's counts (each
# sine as the FP32 instructions of its fast path).
from wavefront_path_tracer_tpu_torch.probes import texstep  # noqa: E402
from wavefront_path_tracer_tpu_torch.probes.texstep import (  # noqa: E402
    FLOPS_CHECKER,
    FLOPS_IMAGE,
)


def log(msg: str) -> None:
    print(msg, flush=True)


# Child processes.  Each starts through _DIE_WITH_PARENT, which asks the
# kernel to kill it when this script dies (PR_SET_PDEATHSIG) and then
# runs the command in its place; it stays in this script's process
# group, and its output goes to a file under OUT_DIR.  A child that
# outlasts its time is killed with every process below it, and so is
# whatever is left below this script when it ends or is terminated.
_DIE_WITH_PARENT = (
    "import ctypes, os, signal, sys\n"
    "ctypes.CDLL(None).prctl(1, signal.SIGKILL)\n"
    "if os.getppid() != int(sys.argv[1]):\n"
    "    sys.exit('the script that started this process has ended')\n"
    "os.execv(sys.executable, [sys.executable] + sys.argv[2:])\n")


class Child:
    """``python argv`` started from the checkout as a child process."""

    def __init__(self, argv, label: str):
        self.label = label
        self.path = os.path.join(
            OUT_DIR, "child_" + "".join(c if c.isalnum() else "_"
                                        for c in label) + ".log")
        self._out = open(self.path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _DIE_WITH_PARENT, str(os.getpid()),
             *argv], cwd=ROOT, stdout=self._out, stderr=subprocess.STDOUT)
        self.ended = None
        self._reaper = threading.Thread(target=self._reap, daemon=True)
        self._reaper.start()

    def _reap(self) -> None:
        self.proc.wait()
        self.ended = time.perf_counter()

    def wait(self, timeout: float) -> tuple:
        """(exit code, output, seconds from its start to its end); killed
        with its descendants if it outlasts ``timeout`` seconds from now."""
        self._reaper.join(max(1.0, timeout))
        note = ""
        if self._reaper.is_alive():
            _kill_tree(self.proc.pid)
            self._reaper.join()
            note = f"\n({self.label}: killed after {timeout:.0f} s)"
        self._out.close()
        with open(self.path) as f:
            text = f.read() + note
        return self.proc.returncode, text, self.ended - self.t0


def _kill_tree(pid: int, spare_root: bool = False) -> None:
    """SIGKILL every process below ``pid``, and ``pid`` itself unless
    ``spare_root``."""
    below = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        below.setdefault(ppid, []).append(int(entry))
    tree, todo = [], list(below.get(pid, []))
    while todo:
        p = todo.pop()
        tree.append(p)
        todo += below.get(p, [])
    for p in tree + ([] if spare_root else [pid]):
        try:
            os.kill(p, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def _on_sigterm(signum, _frame) -> None:
    _kill_tree(os.getpid(), spare_root=True)
    os._exit(128 + signum)


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return name, smi


def phase_build(lib: str | None = None) -> dict:
    """Build ``lib`` (ops/_build.py: the shipped kernels' library, or the
    stage probes') and print ptxas's lines; for the shipped one, then
    each persistent, baked unculled, baked culled and dynamic culled
    kernel's registers and spills."""
    from wavefront_path_tracer_tpu_torch.ops import _build

    lib = lib or _build.LIB_NAME
    t0 = time.perf_counter()
    path, report, _ = _build.build(lib)
    seconds = time.perf_counter() - t0
    tag = "[build]" if lib == _build.LIB_NAME else "[probe-build]"
    log(f"{tag} {path.relative_to(ROOT)} from "
        f"{[p.name for p in _build.sources(lib)]} in {seconds:.2f} s")
    nvcc = {}
    for line in report.splitlines():
        if line.startswith("nvcc "):
            name, sec = line[len("nvcc "):].split(": ")
            nvcc[name] = float(sec.split()[0])
            log(f"{tag} {line} (from the build's start)")
        elif ("Compiling entry" in line or "registers" in line
              or "spill" in line):
            log(f"{tag} ptxas: {line.strip()}")
    out = {"seconds": seconds, "nvcc_seconds": nvcc}
    if lib != _build.LIB_NAME:
        return out
    _build.load_library()
    for kind, match in (("persistent", "persistent_kernel"),
                        ("unculled", "baked_unculled_kernel"),
                        ("culled", "baked_culled_kernel"),
                        ("dynculled", "dynculled_kernel")):
        out[f"{kind}_ptxas"] = _ptxas_kernels(report, match)
        for rep in out[f"{kind}_ptxas"]:
            log(f"{tag} {kind} {rep['kernel']}: {rep.get('registers')} "
                f"registers, {rep.get('stack')} bytes stack, "
                f"{rep.get('spill_stores')} / {rep.get('spill_loads')} "
                f"bytes spilled (stores / loads)")
    return out


def _ptxas_kernels(report: str, match: str) -> list[dict]:
    """Registers, stack frame and spills of each kernel whose mangled name
    holds ``match``, from ptxas's -v lines (``ops/_build.py``
    ptxas_kernels); the name shortened to its template arguments where
    c++filt demangled it."""
    from wavefront_path_tracer_tpu_torch.ops import _build

    out = []
    for rep in _build.ptxas_kernels(report, match):
        d = rep.pop("kernel")
        rep.pop("mangled")
        for ns in ("(anonymous namespace)::", "wpt::baked::", "wpt::dyn::",
                   "wpt::"):
            d = d.replace(ns, "")
        out.append({"kernel": d.split(match + "<", 1)[-1].split(">(", 1)[0],
                    **rep})
    return out


def _time_ms(fn, reps: int):
    """(mean ms per call by CUDA events, the last call's result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


# The plain versions' results of the cases checked so far, by their
# inputs (``Case.key``): the sweep and loop phases hold their forms to the
# result of an earlier phase's plain run of the same inputs instead of
# running it again (the dynamic plain version takes seconds a sample).
_PLAIN_OUT: dict = {}


def _scene_digest(host: dict) -> str:
    """A fingerprint of a scene's host tables that is the same in every
    process (the tables' own ``key`` is Python's salted ``hash``)."""
    import hashlib

    digest = hashlib.sha256()
    for name in sorted(k for k in host if k != "key"):
        digest.update(name.encode()
                      + np.ascontiguousarray(host[name]).tobytes())
    return digest.hexdigest()


class Case:
    """One kernel's inputs at one shape, built as models/fused.py builds
    them, with the kernel, its plain version and its launch counter;
    ``key`` names every input of the plain version.  ``hier`` (culled
    and dynamic culled kinds) holds hierarchy parameters of
    ``ops/bake.py`` ``bake_culled`` (or ``global_radius_factor`` of
    ``ops/dyn_tables.py`` ``pack_culled_scene``), passed to the render
    path's caches as the sweeps of ``probes/`` pass theirs."""

    def __init__(self, kind, clusters, scene, cc, width, height, spp, split,
                 kw, device, triangles=None, winner_hint=False,
                 lut_max=8192, bounces=50, hier=None):
        from wavefront_path_tracer_tpu_torch.models import fused
        from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk
        from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as dk
        from wavefront_path_tracer_tpu_torch.ops import fused_kernels as fk
        from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
        from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

        self.kind, self.spp, self.split = kind, spp, split
        self.n_pixels = width * height
        self.launches_a_run = 1    # kernel launches of one run
        self.textured = False
        self.tex_events = None     # per-ray texture event shares
        self.table_passes = 1      # reads of the tables the bound counts
        cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                           samples_per_frame=spp, max_bounces=bounces,
                           engine="fused")
        arrays = prepare_scene(scene, cfg, device, triangles)
        self.arrays, self.cc = arrays, cc
        perm, _ = fused._block_perm(width, height, 32)
        self.perm_t = torch.from_numpy(perm.astype(np.int64)).to(device)
        self.planes = fused.lane_planes(self.perm_t, width, cfg.tile_rows,
                                        split, spp // split)
        cam = torch.from_numpy(fused.camera_params(
            cc.gpu_camera(), cc.view_matrix(),
            cc.inverse_projection(width, height), cfg)).to(device)
        salts = (0, 0, bounces, spp // split)
        self.salts, self.cam = salts, cam
        self.key = (kind, _scene_digest(arrays["host_scene"]), clusters,
                    winner_hint, lut_max, width, height, spp, split,
                    tuple(sorted(kw.items())), cam.cpu().numpy().tobytes(),
                    bounces, tuple(sorted((hier or {}).items())))
        eye = fused._concrete_eye(cc.view_matrix())
        hier = hier or {}
        if kind == "persistent":
            table = arrays["scene_packed"]
            n = len(scene.radii)
            self.tables = (table,)
            self.n_spheres = n
            self.n_rows = min(table.shape[0], (n + 7) // 8 * 8)
            self.kernel = lambda: fk.fused_render_persistent(
                table, n, salts, cam, *self.planes, **kw)
            self.plain = lambda: fk.fused_render_persistent_reference(
                table, n, salts, cam, *self.planes, **kw)
            self.launches = lambda: fk.LAUNCHES
        elif kind == "dynculled":
            tab = fused._dyn_tables(arrays, clusters, camera_pos=eye,
                                    lut_max=lut_max, **hier)
            self.tab = tab
            self.textured = tab.textured
            self.tables = (tab.spheres, tab.boxes, tab.super_boxes, tab.slab,
                           tab.triangles, tab.tri_boxes, tab.tri_super_boxes,
                           tab.tri_slab, tab.sphere_tex, tab.images.centres,
                           tab.images.words)
            self.kernel = lambda: dk.fused_render_dynculled(
                tab, salts, cam, *self.planes, **kw)
            self.plain = lambda: dk.fused_render_dynculled_reference(
                tab, salts, cam, *self.planes, **kw)
            self.launches = lambda: dk.LAUNCHES
        else:
            baked = fused._baked_scene(arrays, clusters, camera_pos=eye,
                                       winner_hint=winner_hint,
                                       lut_max=lut_max, **hier)
            self.baked = baked
            self.textured = baked.textured
            self.tables = (baked.items, baked.cluster_boxes,
                           baked.cluster_ranges, baked.super_boxes,
                           baked.super_ranges, baked.tri_items,
                           baked.tri_cluster_boxes, baked.tri_cluster_ranges,
                           baked.tri_super_boxes, baked.tri_super_ranges,
                           baked.consts, baked.tex_items,
                           baked.images.centres, baked.images.words)
            self.kernel = lambda: bk.fused_render_baked(
                baked, salts, cam, *self.planes, **kw)
            self.plain = lambda: bk.fused_render_baked_reference(
                baked, salts, cam, *self.planes, **kw)
            self.launches = lambda: bk.LAUNCHES[kind]

    def results(self, out):
        """(radiance tensors, [rays, iterations, supers, clusters]) of a
        run's output."""
        return out[:3], out[3].tolist()

    def image(self, out):
        """(P, 3) sample-averaged radiance in natural pixel order."""
        lanes = torch.stack([r.reshape(-1) for r in out[:3]], dim=-1)
        lanes = lanes[:self.n_pixels * self.split].reshape(
            self.split, self.n_pixels, 3).sum(dim=0)
        img = torch.empty_like(lanes)
        img[self.perm_t] = lanes
        return (img / self.spp).cpu().numpy()

    def lane_bytes(self) -> int:
        """The lane planes in and out of one launch, and the camera."""
        counters = 1 if self.kind == "persistent" else 3
        return self.planes[0].numel() * 4 * (5 + 3 + counters) + 24 * 4

    def has_clusters(self) -> bool:
        return bool(self._hierarchies())

    def _hierarchies(self):
        """(n_clusters, n_supers, items per cluster, FLOPS per pair,
        children per entered super) of each hierarchy that has clusters;
        n_supers is 0 for a flat sweep."""
        if self.kind == "dynculled":
            t = self.tab
            out = [(t.n_clusters, t.n_supers, t.cluster_size,
                    FLOPS_PAIR["dynculled"], 16),
                   (t.n_tri_clusters, t.n_tri_supers, t.cluster_size,
                    FLOPS_TRI, 16)]
        else:
            b = self.baked
            out = []
            for boxes, ranges, sranges, ops in (
                    (b.cluster_boxes, b.cluster_ranges, b.super_ranges,
                     FLOPS_PAIR["culled"]),
                    (b.tri_cluster_boxes, b.tri_cluster_ranges,
                     b.tri_super_ranges, FLOPS_TRI)):
                n, n_sup = boxes.shape[0], sranges.shape[0]
                items = float(ranges[:, 1].sum()) / max(n, 1)
                out.append((n, n_sup, items, ops, n / max(n_sup, 1)))
        return [h for h in out if h[0] > 0]

    def bound(self, stats, probe=None) -> dict:
        """The least time the card could take for this launch's work: the
        larger of its bytes over the memory rate and its FP32 operations
        over the card's issue rate (:func:`_fp32_rate`; each input read
        once, each output written once; the pairs and boxes that this
        run's rays needed).  Cluster
        entries are attributed to the one hierarchy that has clusters
        (every scene of this script has at most one).  A textured launch
        adds the texture step for the checker and image events a ray of
        the plain version's run met (``tex_events``, per ray).  With a
        stage ``probe`` the work holds its duplicate where the counters
        give it: the entered clusters' pairs (entry), the boxes (cond),
        the globals' pairs (dyn global), the entered sphere clusters'
        pairs (entry2), the cluster boxes (cond2); a duplicated raygen,
        shade, sky add or trip vote, and the prepass count (hint_count),
        are not counted (so that the bound stays a least time)."""
        rays, _iters, supers, clusters = (float(v) for v in stats)
        n_bytes = (self.lane_bytes() + self.table_passes * sum(
            t.numel() * t.element_size() for t in self.tables))
        if self.kind == "persistent":
            pairs = rays * self.n_rows
            ops = pairs * FLOPS_PAIR["persistent"] + rays * FLOPS_RAY
        elif self.kind == "unculled":
            b = self.baked
            pairs = rays * (b.n_items + b.n_triangles)
            ops = rays * (b.n_items * FLOPS_PAIR["unculled"]
                          + b.n_triangles * FLOPS_TRI + FLOPS_RAY)
        else:
            if self.kind == "dynculled":
                sph = self.tab.spheres[:self.tab.n_globals, 0]
                n_globals = int((~torch.isnan(sph)).sum())
            else:
                n_globals = self.baked.n_globals
            hiers = self._hierarchies()
            if len(hiers) > 1:
                raise AssertionError("cluster entries of two hierarchies "
                                     "cannot be told apart")
            pairs = rays * n_globals
            ops = pairs * FLOPS_PAIR[self.kind] + rays * (
                FLOPS_RAY + FLOPS_RAY_SHIFT[self.kind]
                + FLOPS_SLAB * len(hiers))
            for n, n_sup, items, pair_ops, children in hiers:
                pairs += clusters * items
                ops += clusters * items * pair_ops
                boxes = (rays * n_sup + supers * children if n_sup
                         else rays * n)
                ops += boxes * FLOPS_BOX
                if probe in ("dbl_entry", "dyn_dbl_entry") or (
                        probe == "dbl_entry2" and pair_ops != FLOPS_TRI):
                    ops += clusters * items * pair_ops
                if probe in ("dbl_cond", "dyn_dbl_cond"):
                    ops += boxes * FLOPS_BOX
                if probe == "dbl_cond2":
                    ops += (supers * children if n_sup else rays * n) \
                        * FLOPS_BOX
            if probe == "dyn_dbl_global":
                ops += rays * n_globals * FLOPS_PAIR[self.kind]
        if self.textured:
            checker, image = self.tex_events or (0.0, 0.0)
            ops += rays * (checker * FLOPS_CHECKER + image * FLOPS_IMAGE)
        t_bytes, t_ops = n_bytes / PEAK_BYTES, ops / _fp32_rate()
        return {"pairs": pairs, "ops": ops, "bytes": n_bytes,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _check(label, case, reps: int = 0) -> dict:
    """The kernel against its plain version on the same CUDA tensors:
    radiance words and all four counters bit-identical.  With ``reps``,
    also the CUDA-event times of the kernel (mean of ``reps`` calls) and
    of the plain version (one call)."""
    from wavefront_path_tracer_tpu_torch.utils.parity import parity_report

    from wavefront_path_tracer_tpu_torch.ops import textures

    before = case.launches()
    k = case.kernel()
    torch.cuda.synchronize()
    if case.launches() != before + 1:
        raise AssertionError(f"{label}: the wrapper did not count its launch")
    if not reps and case.key in _PLAIN_OUT:
        p = _PLAIN_OUT[case.key]          # untimed: its time is not read
    else:
        textures.EVENTS.update(checker=0, image=0)
        plain_ms, p = _time_ms(case.plain, 1)
        _PLAIN_OUT[case.key] = p
        if case.textured:
            rays = max(p[3].tolist()[0], 1)
            case.tex_events = (textures.EVENTS["checker"] / rays,
                               textures.EVENTS["image"] / rays)
    stats_k, stats_p = k[3].tolist(), p[3].tolist()
    bit_exact = stats_k == stats_p and all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(k[:3], p[:3]))
    rep = parity_report(case.image(k), case.image(p))
    rep.update(case=label, kernel=case.kind, stats_kernel=stats_k,
               stats_plain=stats_p, bit_exact=bit_exact,
               textured=case.textured, tex_events=case.tex_events)
    if reps:
        rep["kernel_ms"], _ = _time_ms(case.kernel, reps)
        rep["plain_ms"] = plain_ms
        rep.update(case.bound(stats_k))
    log(f"[kernel-vs-plain] {label}: {json.dumps(rep)}")
    if not bit_exact:
        raise AssertionError(f"{label}: kernel and plain version differ")
    if (case.kind in ("culled", "dynculled") and case.has_clusters()
            and not stats_k[3] > 0):
        raise AssertionError(f"{label}: no cluster was entered")
    return rep


def _smoke_scene():
    from wavefront_path_tracer_tpu_torch.cli import build_camera, build_parser
    from wavefront_path_tracer_tpu_torch.scene import get_scene

    # The CLI's default scene and view (thin lens on).
    return (get_scene("book_one_final", seed=42),
            build_camera(build_parser().parse_args([])))


def phase_kernel_vs_plain(device, part=None) -> list[dict]:
    """Phase 3: the book's cases (``part`` "book"), then the mesh cases
    (``part`` "mesh"); both when ``part`` is None."""
    if part == "mesh":
        return phase_mesh_vs_plain(device)
    scene, cc = _smoke_scene()
    opts = {"rr_start": 3, "clamp": 0.5, "sampler": "stratified"}
    cases = [
        ("persistent 160x90@4spp default", "persistent", 0, {}, 1),
        ("persistent 160x90@4spp rr3/clamp0.5/stratified/split2",
         "persistent", 0, opts, 2),
        ("culled16 160x90@4spp default", "culled", 16, {}, 1),
        ("culled16 160x90@4spp rr3/clamp0.5/stratified/split2", "culled",
         16, opts, 2),
        ("culled2 (two-level) 160x90@4spp default", "culled", 2, {}, 1),
        ("unculled 160x90@4spp default", "unculled", 0, {}, 1),
    ]
    out = []
    for label, kind, clusters, kw, split in cases:
        case = Case(kind, clusters, scene, cc, 160, 90, 4, split, kw, device)
        out.append(_check(label, case))
    two_level = out[4]["stats_kernel"]
    if not two_level[2] > 0:
        raise AssertionError("the two-level case entered no super")
    # Every sphere twice: each hit on a doubled sphere is an exact tie of
    # two items of one cluster, which the smaller index must win.
    case = Case("culled", 16, _doubled(scene), cc, 160, 90, 4, 1, {}, device)
    out.append(_check("culled16 book_one_final doubled 160x90@4spp (exact "
                      "ties)", case))
    return out if part == "book" else out + phase_mesh_vs_plain(device)


def _book():
    """The CLI's default scene and view as (scene, triangles, camera)."""
    scene, cc = _smoke_scene()
    return scene, None, cc


def _doubled(scene):
    """The scene with every sphere twice, each copy beside its twin."""
    return scene.permuted(np.repeat(np.arange(scene.num_spheres), 2))


def _cli_camera(scene: str):
    from wavefront_path_tracer_tpu_torch.cli import build_camera, build_parser

    return build_camera(build_parser().parse_args(["--scene", scene]))


def _terrain():
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        mesh_terrain_scene,
    )

    scene, tris = mesh_terrain_scene()         # seed 7, 5,000 triangles
    return scene, tris, CameraController.book_one_final()


def _knot():
    from wavefront_path_tracer_tpu_torch.scene import knot_camera, knot_scene

    scene, tris = knot_scene(50000)
    return scene, tris, knot_camera()


def phase_mesh_vs_plain(device) -> list[dict]:
    """Phase 3's mesh cases: the dynamic culled kernel on terrain (two
    option sets), the knot (rolled triangle supers), procedural 10,000
    spheres in clusters of 32 (rolled sphere supers) and book_bubble (a
    negative radius, all globals); the baked kernels on terrain."""
    from wavefront_path_tracer_tpu_torch.scene import get_scene

    opts = {"rr_start": 3, "clamp": 0.5, "sampler": "stratified"}
    terrain, tris, cc = _terrain()
    knot, knot_tris, knot_cc = _knot()
    cases = [
        ("dynculled16 terrain 160x90@4spp default", "dynculled", 16,
         (terrain, tris, cc), 4, {}, 1),
        ("dynculled16 terrain 160x90@4spp rr3/clamp0.5/stratified/split2",
         "dynculled", 16, (terrain, tris, cc), 4, opts, 2),
        ("dynculled16 knot50k 160x90@2spp (rolled triangle supers)",
         "dynculled", 16, (knot, knot_tris, knot_cc), 2, {}, 1),
        ("dynculled32 procedural10000 160x90@4spp (rolled sphere supers)",
         "dynculled", 32, (get_scene("procedural", n=10000, seed=42), None,
                           _cli_camera("procedural")), 4, {}, 1),
        ("dynculled16 book_bubble 160x90@4spp (negative radius)",
         "dynculled", 16, (get_scene("book_bubble"), None,
                           _cli_camera("book_bubble")), 4, {}, 1),
        ("culled16 terrain 160x90@4spp default", "culled", 16,
         (terrain, tris, cc), 4, {}, 1),
        ("unculled terrain 160x90@4spp default", "unculled", 0,
         (terrain, tris, cc), 4, {}, 1),
    ]
    out = []
    for label, kind, clusters, (scene, t, cam), spp, kw, split in cases:
        case = Case(kind, clusters, scene, cam, 160, 90, spp, split, kw,
                    device, triangles=t)
        rep = _check(label, case)
        if "rolled" in label and not rep["stats_kernel"][2] > 0:
            raise AssertionError(f"{label}: no super was entered")
        out.append(rep)
    return out


def phase_golden(device) -> dict:
    from wavefront_path_tracer_tpu_torch.renderer import render
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        get_scene,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
    from wavefront_path_tracer_tpu_torch.utils.image import rmse

    z = np.load(GOLDEN, allow_pickle=False)
    meta = {"scene": "book_one_final", "width": 400, "height": 225,
            "spp": 1000, "max_bounces": 50, "engine": "megakernel",
            "intersector": "bruteforce"}
    stored = json.loads(str(z["meta"]))
    if stored != meta:
        raise AssertionError(f"golden meta {stored} != expected {meta}")
    out = {}
    for label, kw in (("bruteforce", {}),
                      ("baked/cull16", {"intersector": "baked",
                                        "baked_clusters": 16})):
        cfg = RenderConfig(width=400, height=225, samples_per_pixel=1000,
                           samples_per_frame=200, max_bounces=50,
                           engine="fused", **kw)
        t0 = time.perf_counter()
        res = render(get_scene("book_one_final"),
                     CameraController.book_one_final(), cfg, device=device)
        seconds = time.perf_counter() - t0
        err = rmse(res.image, z["image"])
        log(f"[golden] {label}: book_one_final 400x225@1000spp display "
            f"RMSE {err!r} (gate {GOLDEN_GATE}) in {seconds:.2f} s, "
            f"{res.rays_traced:.0f} rays")
        if not err < GOLDEN_GATE:
            raise AssertionError(f"golden RMSE {err} >= {GOLDEN_GATE}")
        out[label] = {"rmse": err, "seconds": seconds,
                      "rays": res.rays_traced}
    return out


# The launch counts of every kernel wrapper, the shipped form's among
# them, kept with the bench, which records the forms each row ran.
from wavefront_path_tracer_tpu_torch.bench import (  # noqa: E402
    SHIPPED,
    read_launches as _read_launches,
    require_shipped as _require_shipped,
    reset_launches as _reset_launches,
)


def phase_main_paths(device, smi: str) -> dict:
    """Each path through the CLI: warm-up, then a timed run whose launch
    counts are read alone; that path's kernel must have run."""
    from wavefront_path_tracer_tpu_torch import cli

    out = {}
    for kind, spec in KERNELS.items():
        if "argv" not in spec:
            continue
        out_png = os.path.join(OUT_DIR, f"smoke_1080p_{kind}.png")
        argv = ["--device", device.type, "--scene", "book_one_final",
                "--width", str(MAIN_WIDTH), "--height", str(MAIN_HEIGHT),
                "--spp", str(MAIN_SPP), "--spf", str(MAIN_SPP),
                "--max-bounces", "50", *spec["argv"], "--out", out_png,
                "--quiet"]
        cli.run(argv)                                  # warm-up
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        _, result = cli.run(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_launches()
        img = result.accumulated / result.samples
        if launches[kind] < 1:
            raise AssertionError(f"the {kind} path launched no {kind} kernel")
        _require_shipped(f"the {kind} path", kind, launches)
        if not np.isfinite(img).all() or not img.mean() > 0.01:
            raise AssertionError(f"bad 1080p image ({kind}): mean "
                                 f"{img.mean()}")
        mrays = result.rays_traced / result.wall_time_s / 1e6
        log(f"[main-path] {kind} ({' '.join(spec['argv'])}): cli "
            f"{MAIN_WIDTH}x{MAIN_HEIGHT}@{MAIN_SPP}spp, 50 bounces: "
            f"{seconds:.3f} s end to end, render {result.wall_time_s:.3f} s, "
            f"{result.rays_traced:.0f} rays, {mrays:.1f} Mrays/s, "
            f"launches {launches}, image mean {img.mean():.4f} [{smi}]")
        out[kind] = {"seconds_end_to_end": seconds,
                     "render_seconds": result.wall_time_s,
                     "rays": result.rays_traced, "mrays_per_s": mrays,
                     "launches": launches[kind], "all_launches": launches,
                     "image_mean": float(img.mean())}
    return out


def phase_full_size(device, smi: str) -> dict:
    """The checks of phase 3 at the main paths' planes, the plain
    versions' times there, and each kernel's time at MAIN_SPP samples per
    lane beside its bound."""
    scene, cc = _smoke_scene()
    checks = {kind: [] for kind in ("persistent", "culled", "unculled")}
    for kind, clusters, spp in (("persistent", 0, 1), ("persistent", 0, 2),
                                ("culled", 16, 1), ("unculled", 0, 1)):
        case = Case(kind, clusters, scene, cc, MAIN_WIDTH, MAIN_HEIGHT, spp,
                    1, {}, device)
        rep = _check(f"{kind} {MAIN_WIDTH}x{MAIN_HEIGHT}@{spp}spp default",
                     case, reps=5)
        log(f"[timing] {kind} {MAIN_WIDTH}x{MAIN_HEIGHT}@{spp}spp "
            f"book_one_final, 50 bounces: kernel {rep['kernel_ms']!r} ms, "
            f"plain {rep['plain_ms']!r} ms, bound {rep['bound_ms']!r} ms "
            f"({rep['bound_by']}) [{smi}]")
        checks[kind].append(rep)
    timed = {}
    for kind, clusters in (("persistent", 0), ("culled", 16),
                           ("unculled", 0)):
        case = Case(kind, clusters, scene, cc, MAIN_WIDTH, MAIN_HEIGHT,
                    MAIN_SPP, 1, {}, device)
        case.kernel()                                  # warm-up
        ms, out = _time_ms(case.kernel, 3)
        stats = out[3].tolist()
        rep = {"kernel_ms": ms, "stats": stats, **case.bound(stats),
               "clusters_per_ray": stats[3] / stats[0],
               "warp_fullness": stats[0] / (32 * stats[1])}
        log(f"[timing] {kind} {MAIN_WIDTH}x{MAIN_HEIGHT}@{MAIN_SPP}spp "
            f"book_one_final, 50 bounces: kernel {ms!r} ms, bound "
            f"{rep['bound_ms']!r} ms ({rep['bound_by']}), rays {stats[0]}, "
            f"loop trips {stats[1]} (warps {rep['warp_fullness']:.4f} "
            f"full), supers {stats[2]}, clusters {stats[3]} "
            f"({rep['clusters_per_ray']:.4f} per ray) [{smi}]")
        timed[kind] = rep
    return {"checks": checks, "timed": timed}


def _frame(renderer, kind: str, label: str, smi: str) -> dict:
    """Warm-up frame, then a timed one whose launch counts are read
    alone: ``kind``'s kernel must have run, and the image is finite with
    a mean above 0.01."""
    renderer.render_frame()                            # warm-up
    renderer.reset_accumulation()
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    result = renderer.render_frame()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_launches()
    img = result.accumulated / result.samples
    if launches[kind] < 1:
        raise AssertionError(f"{label} launched no {kind} kernel")
    _require_shipped(label, kind, launches)
    if not np.isfinite(img).all() or not img.mean() > 0.01:
        raise AssertionError(f"bad image ({label}): mean {img.mean()}")
    mrays = result.rays_traced / result.wall_time_s / 1e6
    cfg = renderer.config
    log(f"[mesh-row] {label}: {cfg.width}x{cfg.height}@"
        f"{cfg.samples_per_pixel}spp, 50 bounces, {cfg.intersector}/"
        f"clusters {cfg.baked_clusters}: render {result.wall_time_s:.4f} s "
        f"({seconds:.4f} s with sync), {result.rays_traced:.0f} rays, "
        f"{mrays:.2f} Mrays/s, launches {launches}, image mean "
        f"{img.mean():.4f} [{smi}]")
    return {"render_seconds": result.wall_time_s, "seconds": seconds,
            "rays": result.rays_traced, "mrays_per_s": mrays,
            "launches": launches[kind], "all_launches": launches,
            "image_mean": float(img.mean()), "image": img}


def phase_mesh_rows(device, smi: str) -> dict:
    """The three mesh rows through ``Renderer`` (phase 7), the CLI once
    on terrain with ``--intersector auto``, and the terrain agreement of
    the dynamic, baked culled and baked unculled kernels."""
    from wavefront_path_tracer_tpu_torch import cli
    from wavefront_path_tracer_tpu_torch.profile_frame import (
        MESH_ROWS,
        row_renderer,
    )
    from wavefront_path_tracer_tpu_torch.utils.image import (
        display_transform,
        write_png,
    )
    from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

    out = {}
    for name, (_scene, _w, _h, _spp, intersector) in MESH_ROWS.items():
        kind = "culled" if intersector == "baked" else "dynculled"
        rep = _frame(row_renderer(name, device=device), kind, name, smi)
        write_png(os.path.join(OUT_DIR, f"mesh_{name}.png"),
                  display_transform(rep["image"], 1))
        out[name] = rep
    rep = _frame(row_renderer("terrain_baked", device=device,
                              baked_clusters=0),
                 "unculled", "terrain_baked_unculled", smi)
    out["terrain_baked_unculled"] = rep

    argv = ["--device", device.type, "--scene", "mesh_terrain",
            "--intersector", "auto", "--width", str(MESH_SIZE[0]),
            "--height", str(MESH_SIZE[1]), "--spp", "32", "--spf", "32",
            "--max-bounces", "50", "--quiet",
            "--out", os.path.join(OUT_DIR, "mesh_terrain_cli_auto.png")]
    _reset_launches()
    t0 = time.perf_counter()
    renderer, result = cli.run(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_launches()
    cfg = renderer.config
    img = result.accumulated / result.samples
    log(f"[mesh-cli] --scene mesh_terrain --intersector auto -> "
        f"{cfg.intersector}/clusters {cfg.baked_clusters}: "
        f"{cfg.width}x{cfg.height}@32spp {seconds:.3f} s end to end "
        f"(first run: bake and build included), render "
        f"{result.wall_time_s:.4f} s, "
        f"{result.rays_traced / result.wall_time_s / 1e6:.2f} Mrays/s, "
        f"launches {launches} [{smi}]")
    if launches["dynculled"] < 1 or cfg.intersector != "bruteforce":
        raise AssertionError("--intersector auto on mesh_terrain did not "
                             "run the dynamic culled kernel")
    if not np.isfinite(img).all() or not img.mean() > 0.01:
        raise AssertionError(f"bad image (cli auto): mean {img.mean()}")
    out["cli_auto"] = {"seconds_end_to_end": seconds,
                       "render_seconds": result.wall_time_s,
                       "rays": result.rays_traced, "launches": launches}

    agreement = {}
    trio = {"dynculled": out["terrain_dynamic"],
            "culled": out["terrain_baked"],
            "unculled": out["terrain_baked_unculled"]}
    for a, b in (("dynculled", "culled"), ("dynculled", "unculled"),
                 ("culled", "unculled")):
        rep = check_parity(trio[a]["image"], trio[b]["image"],
                           trio[a]["rays"], trio[b]["rays"])
        log(f"[mesh-agree] terrain 800x448@32spp {a} vs {b}: "
            f"{json.dumps(rep)}")
        agreement[f"{a}/{b}"] = rep
    for rep in out.values():
        rep.pop("image", None)
    out["agreement"] = agreement
    out["face_rays"] = _face_rays(device, smi)
    return out


def _face_rays(device, smi: str) -> dict:
    """The rays of a terrain frame (800x448@1spp, 50 bounces, the dynamic
    culled plain version on the card, clusters of 16) that are parallel
    to an axis and start on a face plane of a box of the scene's tables:
    their slab terms are NaN, and box_enters enters them."""
    from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as dk
    from wavefront_path_tracer_tpu_torch.ops import fused_kernels as fk
    from wavefront_path_tracer_tpu_torch.ops.baked_kernels import on_face

    terrain, tris, cc = _terrain()
    case = Case("dynculled", 16, terrain, cc, *MESH_SIZE, 1, 1, {}, device,
                triangles=tris)
    tab = case.tab
    boxes = torch.cat([
        tab.boxes[:tab.n_clusters, :6], tab.super_boxes[:tab.n_supers, :6],
        tab.slab[0:1, :6], tab.tri_boxes[:tab.n_tri_clusters, :6],
        tab.tri_super_boxes[:tab.n_tri_supers, :6], tab.tri_slab[0:1, :6]])
    counts = {"rays": 0, "axis_parallel": 0, "on_face": 0}

    def intersect(ox, oy, oz, dx, dy, dz):
        inv = (1.0 / dx, 1.0 / dy, 1.0 / dz)
        par = torch.isinf(inv[0]) | torch.isinf(inv[1]) | torch.isinf(inv[2])
        counts["rays"] += ox.numel()
        idx = torch.nonzero(par)[:, 0]
        counts["axis_parallel"] += idx.numel()
        if idx.numel():
            face = on_face(boxes[:, 0:3], boxes[:, 3:6], ox[idx], oy[idx],
                           oz[idx], inv[0][idx], inv[1][idx], inv[2][idx])
            counts["on_face"] += int(face.any(dim=1).sum())
        return dk.dynculled_intersect_reference(tab, ox, oy, oz, dx, dy, dz)

    t0 = time.perf_counter()
    fk.persistent_reference(intersect, case.salts, case.cam, *case.planes)
    torch.cuda.synchronize()
    counts["seconds"] = time.perf_counter() - t0
    counts["boxes"] = boxes.shape[0]
    log(f"[face-rays] terrain {MESH_SIZE[0]}x{MESH_SIZE[1]}@1spp, 50 "
        f"bounces, dynamic culled/16 plain version: {counts['rays']} "
        f"rays, {counts['axis_parallel']} with a zero direction component, "
        f"{counts['on_face']} of them starting on a face plane of one of "
        f"{counts['boxes']} boxes [{smi}]")
    return counts


def _mesh_specs() -> list:
    """(kind, clusters, scene name, (scene, triangles, camera), the row's
    samples a pixel) of each mesh kernel at the mesh rows' planes; the
    first is the kernels line's dynamic culled case."""
    terrain = _terrain()
    return [("dynculled", 16, "terrain", terrain, 32),
            ("dynculled", 16, "knot50k", _knot(), 8),
            ("culled", 16, "terrain", terrain, 32),
            ("unculled", 0, "terrain", terrain, 32)]


def phase_mesh_full_size(device, smi: str) -> dict:
    """The kernels line's mesh case (dynamic culled on terrain) bit for
    bit against its plain version at the mesh rows' planes (1 spp), with
    times and bound; the other mesh kernels' times and bounds there (their
    checks: phase meshplain); then each at its row's samples per lane
    beside its bound."""
    w, h = MESH_SIZE
    checks, plain_elsewhere, timed = [], [], []
    for i, (kind, clusters, scene_name, (scene, t, cam), row_spp) in (
            enumerate(_mesh_specs())):
        case = Case(kind, clusters, scene, cam, w, h, 1, 1, {}, device,
                    triangles=t)
        label = f"{kind} {scene_name} {w}x{h}@1spp default"
        if i == 0:
            rep = _check(label, case, reps=3)
            plain = f"plain {rep['plain_ms']!r} ms"
            checks.append(rep)
        else:
            case.kernel()                              # warm-up
            ms, res = _time_ms(case.kernel, 3)
            stats = res[3].tolist()
            rep = {"case": label, "kernel": kind, "kernel_ms": ms,
                   "stats_kernel": stats, **case.bound(stats)}
            plain = "plain version in phase meshplain, untimed"
            plain_elsewhere.append(rep)
        rep["scene"] = scene_name
        log(f"[timing] {kind} {w}x{h}@1spp {scene_name}, 50 bounces: kernel "
            f"{rep['kernel_ms']!r} ms, {plain}, bound "
            f"{rep['bound_ms']!r} ms ({rep['bound_by']}) [{smi}]")
        case = Case(kind, clusters, scene, cam, w, h, row_spp, 1, {}, device,
                    triangles=t)
        ms, res = _time_ms(case.kernel, 1)
        stats = res[3].tolist()
        trep = {"kind": kind, "scene": scene_name, "spp": row_spp,
                "kernel_ms": ms, "stats": stats, **case.bound(stats),
                "clusters_per_ray": stats[3] / stats[0],
                "supers_per_ray": stats[2] / stats[0],
                "warp_fullness": stats[0] / (32 * stats[1])}
        log(f"[timing] {kind} {w}x{h}@{row_spp}spp {scene_name}, 50 "
            f"bounces: kernel {ms!r} ms, bound {trep['bound_ms']!r} ms "
            f"({trep['bound_by']}), rays {stats[0]}, loop trips {stats[1]} "
            f"(warps {trep['warp_fullness']:.4f} full), supers {stats[2]}, "
            f"clusters {stats[3]} ({trep['clusters_per_ray']:.4f} per ray), "
            f"{stats[0] / ms / 1e3:.2f} Mrays/s [{smi}]")
        timed.append(trep)
    return {"checks": checks, "kernel_1spp": plain_elsewhere, "timed": timed}


def phase_mesh_plain(device) -> list[dict]:
    """The other mesh kernels of phase meshfull (dynamic culled on the
    knot, baked culled/16 and unculled on terrain) bit for bit against
    their plain versions at the mesh rows' planes (800x448, 1 spp),
    untimed."""
    w, h = MESH_SIZE
    out = []
    for kind, clusters, scene_name, (scene, t, cam), _spp in (
            _mesh_specs()[1:]):
        case = Case(kind, clusters, scene, cam, w, h, 1, 1, {}, device,
                    triangles=t)
        rep = _check(f"{kind} {scene_name} {w}x{h}@1spp default", case)
        rep["scene"] = scene_name
        out.append(rep)
    return out


TEX_OPTS = {"rr_start": 3, "clamp": 0.5, "sampler": "stratified"}
TEX_PAIR_SIZE = (400, 224, 64)   # the GATE_SWEEP.json texture rows' size


def _book_checker():
    from wavefront_path_tracer_tpu_torch.scene import get_scene

    return get_scene("book_checker"), None, _cli_camera("book_checker")


def _from_scene_file(path: str):
    """(scene, triangles, camera) of a scene file, with the CLI's camera
    layers (its camera block over the reference camera)."""
    from wavefront_path_tracer_tpu_torch.cli import (
        build_camera,
        build_parser,
        build_scene,
    )

    args = build_parser().parse_args(["--scene-file", path])
    scene, tris, file_cam = build_scene(args)
    return scene, tris, build_camera(args, file_cam)


def _textured_mesh_file(name: str = "tex_mesh") -> str:
    """A scene file that this script writes under OUT_DIR/``name`` (one
    name a process, since phases apart run at once): a checker ground, a
    checker sphere, a glass sphere and an OBJ torus knot (1,000
    triangles, also written here), with a camera block."""
    from wavefront_path_tracer_tpu_torch.scene import torus_knot

    folder = os.path.join(OUT_DIR, name)
    os.makedirs(folder, exist_ok=True)
    verts, faces = torus_knot(1000)
    with open(os.path.join(folder, "knot.obj"), "w") as f:
        f.write("".join(f"v {x} {y} {z}\n" for x, y, z in verts))
        f.write("".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces))
    doc = {
        "camera": {"look_from": [0, 2.2, 6.5], "look_at": [0, 0.9, 0],
                   "vfov": 38, "defocus_angle": 0},
        "spheres": [
            {"center": [0, -1000, 0], "radius": 1000,
             "material": {"type": "lambertian", "albedo": [0.5, 0.5, 0.5],
                          "texture": {"checker": [0.9, 0.9, 0.9],
                                      "scale": 4.0}}},
            {"center": [-2.2, 0.8, 0.5], "radius": 0.8,
             "material": {"type": "metal", "albedo": [0.8, 0.3, 0.2],
                          "fuzz": 0.1,
                          "texture": {"checker": [0.1, 0.2, 0.8],
                                      "scale": 12.0}}},
            {"center": [2.2, 0.8, 0.5], "radius": 0.8,
             "material": {"type": "dielectric", "ior": 1.5}},
        ],
        "objs": [{"path": "knot.obj", "scale": 0.9,
                  "translate": [0, 1.1, -0.5]}],
    }
    path = os.path.join(folder, "scene.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def phase_textures(device) -> list[dict]:
    """Phase 9: the textured kernels against their plain versions at
    160x90@4spp, bit for bit."""
    book = _book_checker()
    example = _from_scene_file(os.path.join(ROOT, "examples", "scene.json"))
    mesh = _from_scene_file(_textured_mesh_file())
    cases = [
        ("culled16 book_checker 160x90@4spp default", "culled", 16, book,
         {}, 1, {}),
        ("culled16 book_checker 160x90@4spp rr3/clamp0.5/stratified/split2",
         "culled", 16, book, TEX_OPTS, 2, {}),
        ("culled16 book_checker 160x90@4spp winner_hint", "culled", 16,
         book, {}, 1, {"winner_hint": True}),
        ("culled16 book_checker 160x90@4spp tex_lut_max=512", "culled", 16,
         book, {}, 1, {"lut_max": 512}),
        ("unculled book_checker 160x90@4spp default", "unculled", 0, book,
         {}, 1, {}),
        ("dynculled16 book_checker 160x90@4spp default", "dynculled", 16,
         book, {}, 1, {}),
        ("culled16 examples/scene.json 160x90@4spp default", "culled", 16,
         example, {}, 1, {}),
        ("culled16 textured mesh 160x90@4spp default", "culled", 16, mesh,
         {}, 1, {}),
        ("dynculled16 textured mesh 160x90@4spp default", "dynculled", 16,
         mesh, {}, 1, {}),
    ]
    out = []
    for label, kind, clusters, (scene, tris, cam), kw, split, bake_kw in cases:
        case = Case(kind, clusters, scene, cam, 160, 90, 4, split, kw,
                    device, triangles=tris, **bake_kw)
        if not case.textured:
            raise AssertionError(f"{label}: the tables are not textured")
        if "winner_hint" in bake_kw and not case.baked.winner_hint:
            raise AssertionError(f"{label}: the winner hint is off")
        rep = _check(label, case)
        checker, image = rep["tex_events"]
        if not checker > 0 or ("book_checker" in label and not image > 0):
            raise AssertionError(f"{label}: no texture event {checker, image}")
        out.append(rep)
    return out


def _texture_agreement(device, scene, cc) -> dict:
    """The three textured intersects (baked culled/16, baked unculled,
    dynamic culled/16) pairwise on book_checker at the texture gate's
    scale (400x224@64spp, 50 bounces), beside the same three on
    book_one_final (no textures).  The statistical rule's image limits
    (mean, display RMSE) and the ray counts must hold; the diverged-pixel
    share is recorded: the unculled intersect's generic quadratic flips
    near-tie winners of the culled ones' slimmed quadratic on a few of the
    64 x 50 events of many pixels, with or without textures."""
    from wavefront_path_tracer_tpu_torch.renderer import render
    from wavefront_path_tracer_tpu_torch.scene import get_scene
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
    from wavefront_path_tracer_tpu_torch.utils.parity import (
        DISPLAY_RMSE_TOL,
        MEAN_TOL,
        RAYS_REL_TOL,
        parity_report,
    )

    w, h, spp = TEX_PAIR_SIZE
    paths = (("culled16", {"intersector": "baked", "baked_clusters": 16}),
             ("unculled", {"intersector": "baked", "baked_clusters": 0}),
             ("dynculled16", {"intersector": "bruteforce",
                              "baked_clusters": 16}))
    out = {}
    for name, sc in (("book_checker", scene),
                     ("book_one_final", get_scene("book_one_final"))):
        images = {}
        for label, kw in paths:
            cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                               samples_per_frame=spp, max_bounces=50,
                               engine="fused", **kw)
            res = render(sc, cc, cfg, device=device)
            images[label] = (res.accumulated / res.samples,
                             res.rays_traced)
        for a, b in (("culled16", "unculled"), ("culled16", "dynculled16"),
                     ("unculled", "dynculled16")):
            (ia, ra), (ib, rb) = images[a], images[b]
            key = f"{name} {w}x{h}@{spp}spp {a} vs {b}"
            rep = parity_report(ia, ib)
            rep["rays_rel_diff"] = abs(ra - rb) / max(rb, 1.0)
            log(f"[tex-agree] {key}: {json.dumps(rep)}")
            if not (rep["finite"] and rep["mean_diff"] < MEAN_TOL
                    and rep["display_rmse"] < DISPLAY_RMSE_TOL
                    and rep["rays_rel_diff"] < RAYS_REL_TOL):
                raise AssertionError(f"{key}: {rep}")
            out[key] = rep
    return out


def phase_textures_full(device, smi: str) -> dict:
    """Phase 10: book_checker through the CLI at 1080p@32spp, the textured
    kernels bit for bit at the 1080p planes, the three textured intersects
    pairwise at 400x224@64spp, and each textured kernel's time at
    1080p@32spp beside its bound and the untextured headline kernel's."""
    from wavefront_path_tracer_tpu_torch import cli

    out = {"cli": {}}
    for label, kind, flags in (
            ("culled", "culled", ["--intersector", "baked", "--clusters",
                                  "16"]),
            ("culled_hint", "culled", ["--intersector", "baked",
                                       "--clusters", "16", "--winner-hint"]),
            ("dynculled", "dynculled", ["--intersector", "bruteforce",
                                        "--clusters", "16"])):
        argv = ["--device", device.type, "--scene", "book_checker",
                "--width", str(MAIN_WIDTH), "--height", str(MAIN_HEIGHT),
                "--spp", str(MAIN_SPP), "--spf", str(MAIN_SPP),
                "--max-bounces", "50", *flags, "--quiet",
                "--out", os.path.join(OUT_DIR, f"book_checker_{label}.png")]
        cli.run(argv)                                  # warm-up
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        renderer, result = cli.run(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_launches()
        img = result.accumulated / result.samples
        if launches[kind] != 1:
            raise AssertionError(f"book_checker {label}: launches {launches}")
        if not np.isfinite(img).all() or not img.mean() > 0.01:
            raise AssertionError(f"bad book_checker image ({label})")
        mrays = result.rays_traced / result.wall_time_s / 1e6
        log(f"[tex-cli] book_checker {' '.join(flags)}: {MAIN_WIDTH}x"
            f"{MAIN_HEIGHT}@{MAIN_SPP}spp, 50 bounces: {seconds:.3f} s end "
            f"to end, render {result.wall_time_s:.4f} s, "
            f"{result.rays_traced:.0f} rays, {mrays:.1f} Mrays/s, launches "
            f"{launches}, image mean {img.mean():.4f} [{smi}]")
        out["cli"][label] = {"seconds_end_to_end": seconds,
                             "render_seconds": result.wall_time_s,
                             "rays": result.rays_traced,
                             "mrays_per_s": mrays,
                             "launches": launches[kind],
                             "all_launches": launches,
                             "image_mean": float(img.mean())}

    scene, _tris, cc = _book_checker()
    checks = []
    for kind in ("culled", "dynculled"):
        case = Case(kind, 16, scene, cc, MAIN_WIDTH, MAIN_HEIGHT, 1, 1, {},
                    device)
        # The culled plain run's texture steps, kept for the plain step's
        # time over a frame's hits (_texture_step).
        with (texstep.recording() if kind == "culled"
              else contextlib.nullcontext([])) as recorded:
            rep = _check(f"{kind}16 book_checker {MAIN_WIDTH}x{MAIN_HEIGHT}"
                         "@1spp default", case, reps=3)
        if kind == "culled":
            calls = recorded
        log(f"[timing] textured {kind}16 book_checker {MAIN_WIDTH}x"
            f"{MAIN_HEIGHT}@1spp: kernel {rep['kernel_ms']!r} ms, plain "
            f"{rep['plain_ms']!r} ms, bound {rep['bound_ms']!r} ms "
            f"({rep['bound_by']}), texture events a ray {rep['tex_events']} "
            f"[{smi}]")
        checks.append(rep)
    out["checks"] = checks
    events = checks[0]["tex_events"]

    out["agreement"] = _texture_agreement(device, scene, cc)

    # 1080p@32spp: the untextured headline first and last, the textured
    # kernels between; the bounds take the texture events a ray of the
    # 1 spp plain run (the same scene and camera).
    book, book_cc = _smoke_scene()
    timed = []
    for label, kind, clusters, textured, bake_kw in (
            ("headline book_one_final culled16", "culled", 16, False, {}),
            ("book_checker culled16", "culled", 16, True, {}),
            ("book_checker culled16 winner_hint", "culled", 16, True,
             {"winner_hint": True}),
            ("book_checker dynculled16", "dynculled", 16, True, {}),
            ("book_checker unculled", "unculled", 0, True, {}),
            ("headline book_one_final culled16 (again)", "culled", 16, False,
             {})):
        case = Case(kind, clusters, scene if textured else book,
                    cc if textured else book_cc, MAIN_WIDTH, MAIN_HEIGHT,
                    MAIN_SPP, 1, {}, device, **bake_kw)
        case.tex_events = events if textured else None
        case.kernel()                                  # warm-up
        ms, res = _time_ms(case.kernel, 3)
        stats = res[3].tolist()
        rep = {"label": label, "kind": kind, "textured": textured,
               "kernel_ms": ms, "stats": stats, **case.bound(stats),
               "clusters_per_ray": stats[3] / stats[0]}
        log(f"[timing] {label} {MAIN_WIDTH}x{MAIN_HEIGHT}@{MAIN_SPP}spp, 50 "
            f"bounces: kernel {ms!r} ms, bound {rep['bound_ms']!r} ms "
            f"({rep['bound_by']}), rays {stats[0]}, supers {stats[2]}, "
            f"clusters {stats[3]} ({rep['clusters_per_ray']:.4f} per ray), "
            f"{stats[0] / ms / 1e3:.2f} Mrays/s [{smi}]")
        timed.append(rep)
    head = (timed[0]["kernel_ms"] + timed[-1]["kernel_ms"]) / 2
    log(f"[tex-price] textured culled16 kernel {timed[1]['kernel_ms']!r} ms "
        f"vs untextured headline {head!r} ms (mean of the two runs around "
        f"it): {timed[1]['kernel_ms'] / head - 1:+.2%}; winner hint "
        f"{timed[2]['kernel_ms']!r} ms ({timed[2]['kernel_ms'] / timed[1]['kernel_ms'] - 1:+.2%}) [{smi}]")
    out["timed"] = timed
    out["step"] = _texture_step(device, smi, events, calls)
    return out


TEX_AB_TURNS = 9           # turns of the texture step's A/B


def _texture_step(device, smi: str, events, calls) -> dict:
    """Row 5, the texture step, on its own (probes/texstep.py): ptxas's
    and the SASS's readings of every render kernel's textured and
    untextured instantiation (listings in OUT_DIR/tex_sass); then
    book_checker at 1080p@32spp through baked culled/16, baked unculled
    and dynamic culled/16, each through its textured and its untextured
    instantiation on one bake in TEX_AB_TURNS turns (the counters must be
    equal, else the A/B is void and the phase fails): the median of the
    turns' paired differences is the step's own time (the difference of
    the two leasts beside it), beside its bound (its operations for the
    ``events`` a ray of the 1 spp plain run, at the row's rays); and the
    plain step (ops/textures.py apply_textures) over the frame's hits:
    one call over the hits of the culled plain run's recorded ``calls``,
    MAIN_SPP times."""
    from wavefront_path_tracer_tpu_torch.utils import sass

    out = {"rows": {}, "sass": {}}
    if sass.cuobjdump() is None:
        log("[tex-sass] cuobjdump not found: the instantiations' SASS not "
            "read")
    else:
        out["sass"] = texstep.sass_readings(os.path.join(OUT_DIR, "tex_sass"))
        for key, reps in out["sass"].items():
            for label, rep in reps.items():
                log(texstep.sass_line(key, label, rep) + f" [{smi}]")
    out["hits"] = sum(a[6].numel() for a in calls)
    out["plain_ms"] = texstep.replay_ms(calls, MAIN_SPP)
    log(f"[tex-plain] apply_textures (ops/textures.py) over the "
        f"{out['hits']} hits of the 1080p@1spp culled plain run's "
        f"{len(calls)} calls in one call, {MAIN_SPP} times: "
        f"{out['plain_ms']!r} ms [{smi}]")
    for name in texstep.ROWS:
        row = texstep.Row(name, MAIN_WIDTH, MAIN_HEIGHT, MAIN_SPP, 50, device)
        rep = texstep.ab(row, TEX_AB_TURNS)
        rep.pop("outs")
        rep.update(texstep.step_bound(rep["stats"][0], events, _fp32_rate(),
                                      row.tex_bytes))
        log(f"[tex-ab] book_checker {name} {MAIN_WIDTH}x{MAIN_HEIGHT}@"
            f"{MAIN_SPP}spp, 50 bounces: the texture step's own time "
            f"{rep['own_ms']!r} ms (median of {TEX_AB_TURNS} turns' paired "
            f"differences; least textured {rep['textured_ms']!r}, least "
            f"untextured {rep['untextured_ms']!r}, their difference "
            f"{rep['own_least_ms']!r}; turns {rep['textured_turns']} / "
            f"{rep['untextured_turns']}), bound "
            f"{rep['bound_ms']!r} ms ({rep['bound_by']}); counters "
            f"{rep['stats']} equal [{smi}]")
        out["rows"][name] = rep
        del row
    return out


class SegCase(Case):
    """The recluster path's inputs at one shape (models/fused.py
    ``render_pixels_recluster``, block lane order, padding lanes): its
    kernel is the segmented render through the segment kernels, its plain
    version the same render through their plain versions, on the same
    CUDA tensors."""

    def __init__(self, kind, clusters, scene, cc, width, height, spp, kw,
                 device, triangles=None, recluster=2, bounces=50,
                 probe=None):
        from wavefront_path_tracer_tpu_torch.models import fused
        from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk
        from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as dk
        from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

        super().__init__(kind, clusters, scene, cc, width, height, spp, 1,
                         {} if probe is None else {"probe": probe}, device,
                         triangles=triangles, bounces=bounces)
        self.key = ("segment", recluster) + self.key
        # The segment kernel's stage probe (phase stage), passed to every
        # launch of the kernel and of its plain version.
        self.probe = probe or ()
        self.cfg = RenderConfig(
            width=width, height=height, samples_per_pixel=spp,
            samples_per_frame=spp, max_bounces=bounces, engine="fused",
            recluster=recluster, rr_start_bounce=kw.get("rr_start", 0),
            clamp=kw.get("clamp", 0.0),
            sampler=kw.get("sampler", "random"))
        self.segments = len(fused._segment_schedule(recluster, bounces))
        self.launches_a_run = spp * self.segments
        self.view = cc.view_matrix()
        self.inv_proj = cc.inverse_projection(width, height)
        if kind == "dynculled":
            self.seg_tables = self.tab
            self.table_kw = {"dyn": self.tab}
            self.segment = dk.fused_segment_dynculled
            self.segment_plain = dk.fused_segment_dynculled_reference
            self.launches = lambda: dk.SEGMENT_LAUNCHES
            self.coop_launches = lambda: dk.SEGMENT_COOP_LAUNCHES
        else:
            self.seg_tables = self.baked
            self.table_kw = {"baked": self.baked}
            self.segment = bk.fused_segment_baked
            self.segment_plain = bk.fused_segment_baked_reference
            self.launches = lambda: bk.LAUNCHES[f"segment_{kind}"]
            self.coop_launches = lambda: bk.COOP_LAUNCHES[f"segment_{kind}"]
        # The segment kernel's forms: each lane on its own thread, and the
        # shipped one, the warp's lanes in step (the wrappers' default).
        self.forms = {"serial": bk.SWEEP_SERIAL, "coop": bk.SWEEP_COOP}
        # The tables are read once a launch.
        self.table_passes = spp * self.segments
        self.kernel = lambda: fused.render_pixels_recluster(
            self.perm_t, self.arrays, self.cc.gpu_camera(), self.view,
            self.inv_proj, self.cfg, 0, 0, self.spp, with_stats=True,
            probe=self.probe, **self.table_kw)
        self.plain = lambda: self.render(segment=self.segment_plain)

    def render(self, cfg=None, segment=None, order=None):
        """The segmented render through ``segment`` (the kernel's wrapper
        by default) with the lanes ordered by ``order`` (the coherence
        sort by default), with the case's probe."""
        from wavefront_path_tracer_tpu_torch.models import fused

        return fused._recluster(
            segment or self.segment, order or fused.coherence_order,
            self.seg_tables, self.perm_t, self.arrays, self.cc.gpu_camera(),
            self.view, self.inv_proj, cfg or self.cfg, 0, 0, self.spp, True,
            probe=self.probe)

    def results(self, out):
        return out[:1], _seg_stats(out)

    def timed_frame(self, form: str = "coop"):
        """One segmented render with the segment kernel in form ``form``
        and the case's probe, each launch timed (probes/_stage.py
        segment_frame: CUDA events a launch, behind a spin): (radiance,
        [rays, iterations, supers, clusters], each launch's ms in issue
        order)."""
        from wavefront_path_tracer_tpu_torch.probes import _stage

        return _stage.segment_frame(
            self.table_kw, self.perm_t, self.arrays, self.cc.gpu_camera(),
            self.view, self.inv_proj, self.cfg, self.spp, self.probe,
            segment=self.form(form))

    def segment_ms(self, runs: int = 3) -> float:
        """The mean over ``runs`` frames of the sum of a frame's segment
        launch times (:meth:`timed_frame`, the shipped form)."""
        return sum(sum(self.timed_frame()[2]) for _ in range(runs)) / runs

    def form(self, name: str):
        """The segment kernel's wrapper in form ``name`` (``forms``)."""
        sweep = self.forms[name]
        return lambda *args, **kw: self.segment(*args, sweep=sweep, **kw)

    def image(self, out):
        img = torch.empty_like(out[0])
        img[self.perm_t] = out[0]
        return (img / self.spp).cpu().numpy()

    def alive_lanes(self) -> list[int]:
        """The lanes alive at the start of each segment launch of one
        render through the kernels (a run of its own, which reads each
        count back before the launch)."""
        alive = []

        def segment(tables, salts, ids, state, counts, **kw):
            alive.append(int((state[12] > 0).sum()))
            return self.segment(tables, salts, ids, state, counts, **kw)

        self.render(segment=segment)
        return alive

    def lane_bytes(self) -> int:
        """The state traffic of this render's launches, from the lanes
        alive at the start of each (common.cuh trace_segment): a live
        lane reads 13 state words, pix, sample, bounce and 3 counters
        (76 B) and writes back the 13 words, bounce and the counters
        (68 B); a dead lane reads its alive word (4 B) and returns; a
        warp with a live lane reads and writes its loop trips (8 B; the
        least count of such warps, one for each 32 live lanes)."""
        n_pad = -(-self.n_pixels // 1024) * 1024
        alive = self.alive_lanes()
        live = sum(alive)
        warps = sum(-(-a // 32) for a in alive)
        return (live * (76 + 68) + (len(alive) * n_pad - live) * 4
                + warps * 8)


def _keep_order(ids, state, lo, inv_ext):
    """The lanes as they are: the recluster loop without the sort."""
    return ids, state


def _seg_stats(out) -> list:
    st = out[2]
    return [int(out[1]), int(st["iterations"]), int(st["supers_entered"]),
            int(st["clusters_entered"])]


def _device_split(fn):
    """(ms of the port's kernels, ms of all other device work, the
    result) of one call of ``fn``, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    ours = sum(e.device_time for e in events
               if any(k in e.name for k in KERNEL_NAMES)) / 1e3
    return ours, sum(e.device_time for e in events) / 1e3 - ours, out


def _same_seg(a, b) -> bool:
    """Two segmented renders' radiance words and four counters equal."""
    return _seg_stats(a) == _seg_stats(b) and torch.equal(
        a[0].view(torch.int32), b[0].view(torch.int32))


def _check_seg(label, case, timed: bool = False) -> dict:
    """The segmented render through the segment kernels against the same
    render through their plain versions, on the same CUDA tensors:
    radiance words and [rays, iterations, supers, clusters]
    bit-identical, in the shipped form (the wrapper's default: the warp's
    lanes in step) and in the per-thread one; the kernel launched once a
    segment, in the form asked for.  With ``timed``, the shipped render
    runs under torch.profiler (the segment kernels' device time and the
    rest's), the plain render under CUDA events, and the bound counts the
    bytes from a run that reads the live lanes at each launch."""
    from wavefront_path_tracer_tpu_torch.utils.parity import parity_report

    before, coop_before = case.launches(), case.coop_launches()
    if timed:
        kernel_ms, other_ms, k = _device_split(case.kernel)
    else:
        k = case.kernel()
        torch.cuda.synchronize()
    want = case.spp * case.segments
    if (case.launches() - before, case.coop_launches() - coop_before) != (
            want, want):
        raise AssertionError(f"{label}: {case.launches() - before} segment "
                             f"launches ({case.coop_launches() - coop_before}"
                             f" in the shipped form), not {want}")
    coop_before = case.coop_launches()
    serial = case.render(segment=case.form("serial"))
    torch.cuda.synchronize()
    if case.coop_launches() != coop_before:
        raise AssertionError(f"{label}: the serial form counted as shipped")
    plain_ms, p = _time_ms(case.plain, 1)
    stats_k, stats_p = _seg_stats(k), _seg_stats(p)
    forms = {"coop": _same_seg(k, p), "serial": _same_seg(serial, p)}
    bit_exact = all(forms.values())
    rep = parity_report(case.image(k), case.image(p))
    rep.update(case=label, kernel=f"segment_{case.kind}",
               stats_kernel=stats_k, stats_plain=stats_p,
               bit_exact=bit_exact, forms_bit_exact=forms, launches=want)
    if timed:
        rep.update(kernel_ms=kernel_ms, other_device_ms=other_ms,
                   plain_ms=plain_ms, **case.bound(stats_k))
    log(f"[seg-vs-plain] {label}: {json.dumps(rep)}")
    if not bit_exact:
        raise AssertionError(f"{label}: kernel and plain version differ")
    if case.has_clusters() and not stats_k[3] > 0:
        raise AssertionError(f"{label}: no cluster was entered")
    return rep


def _check_seg_state(label, case) -> None:
    """Two segments of sample 0 with the coherence sort between them, the
    plain version and the kernel in each form on clones of the same state:
    the state, ids and counters after each, bit for bit."""
    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.ops import fused_kernels as fk

    fns = (case.segment_plain, case.form("coop"), case.form("serial"))
    tables = case.seg_tables
    n_pad = -(-case.n_pixels // 1024) * 1024
    ids, state = fused.segment_state(case.perm_t, n_pad, case.cfg, 0, 0,
                                     case.cc.gpu_camera(), case.view,
                                     case.inv_proj)
    lo, inv_ext = fused._scene_box(case.arrays)
    kw = {"rr_start": case.cfg.rr_start_bounce, "clamp": case.cfg.clamp}
    counts = torch.zeros((fk.SEG_COUNTS, n_pad), dtype=torch.int32,
                         device=state.device)
    for i, k in enumerate(fused._segment_schedule(case.cfg.recluster,
                                                  50)[:2]):
        if i:
            ids, state = fused.coherence_order(ids, state, lo, inv_ext)
        outs = [fn(tables, (0, 50, k, 0), ids.clone(), state.clone(),
                   counts.clone(), **kw) for fn in fns]
        torch.cuda.synchronize()
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for out in outs[1:] for a, b in zip(out, outs[0]))
        alive = int((outs[0][1][12] > 0).sum())
        log(f"[seg-state] {label} segment {i} (k={k}): state, ids and "
            f"counters of both forms bit-identical to the plain version's "
            f"{same}, {alive} lanes alive after")
        if not same:
            raise AssertionError(f"{label}: segment {i} state differs")
        ids, state, counts = outs[0]


def phase_segments(device) -> list[dict]:
    """Phase 11 (``seg``): both segment kernels against their plain
    versions at 160x90@4spp with padding lanes, recluster 2, 50 bounces:
    book_one_final baked culled/16 (default, and roulette/clamp/
    stratified AA), baked unculled, dynamic culled/16 on terrain and on
    the knot at 2 spp, book_checker culled/16 (textured); the state of
    two segments bit for bit; recluster 1, recluster 2 and no sort
    giving the same radiance words and per-ray counters (the loop trips
    per warp printed beside them); and ``--recluster``
    through the CLI on each intersector, a mesh and a textured scene."""
    book, book_cc = _smoke_scene()
    terrain, tris, cc = _terrain()
    knot, knot_tris, knot_cc = _knot()
    checker = _book_checker()
    cases = [
        ("seg culled16 book_one_final 160x90@4spp default", "culled", 16,
         (book, None, book_cc), 4, {}),
        ("seg culled16 book_one_final 160x90@4spp rr3/clamp0.5/stratified",
         "culled", 16, (book, None, book_cc), 4, TEX_OPTS),
        ("seg culled16 book_one_final doubled 160x90@4spp default (exact "
         "ties)", "culled", 16, (_doubled(book), None, book_cc), 4, {}),
        ("seg unculled book_one_final 160x90@4spp default", "unculled", 0,
         (book, None, book_cc), 4, {}),
        ("seg dynculled16 terrain 160x90@4spp default", "dynculled", 16,
         (terrain, tris, cc), 4, {}),
        ("seg dynculled16 knot50k 160x90@2spp default", "dynculled", 16,
         (knot, knot_tris, knot_cc), 2, {}),
        ("seg culled16 book_checker 160x90@4spp default", "culled", 16,
         checker, 4, {}),
    ]
    out = []
    for label, kind, clusters, (scene, t, cam), spp, kw in cases:
        case = SegCase(kind, clusters, scene, cam, 160, 90, spp, kw, device,
                       triangles=t)
        if "book_checker" in label and not case.textured:
            raise AssertionError(f"{label}: the tables are not textured")
        rep = _check_seg(label, case)
        if "default" in label:
            _check_seg_state(label, case)
        out.append(rep)
    for kind, clusters, (scene, t, cam) in (
            ("culled", 16, (book, None, book_cc)),
            ("dynculled", 16, (terrain, tris, cc))):
        case = SegCase(kind, clusters, scene, cam, 160, 90, 4, {}, device,
                       triangles=t)
        runs = {"recluster 2": case.render(),
                "recluster 1": case.render(case.cfg.replace(recluster=1)),
                "recluster 2, no sort": case.render(order=_keep_order)}
        ref = runs["recluster 2"]
        # The loop trips per warp depend on which lanes share a warp at
        # each launch: the one counter that K and the sort may move.
        per_ray = lambda r: [_seg_stats(r)[i] for i in (0, 2, 3)]  # noqa
        same = {name: torch.equal(r[0].view(torch.int32),
                                  ref[0].view(torch.int32))
                and per_ray(r) == per_ray(ref)
                for name, r in runs.items()}
        trips = {name: _seg_stats(r)[1] for name, r in runs.items()}
        log(f"[seg-invariance] {kind}16 160x90@4spp: radiance words and "
            f"rays, supers and clusters equal to recluster 2's: {same}, "
            f"stats {_seg_stats(ref)}; loop trips per warp {trips}")
        if not all(same.values()):
            raise AssertionError(f"{kind}: recluster 1/2/no sort differ")
        _check_no_waits(f"{kind}16 160x90@4spp", case)
    _segments_through_cli(device)
    return out


def _check_no_waits(label, case) -> None:
    """The segmented render, given its matrices on the card, under CUDA's
    sync debug mode, which raises on any call that waits for the device:
    the host loop queues every sample's work without waiting."""
    from wavefront_path_tracer_tpu_torch.models import fused

    dev = case.perm_t.device
    view, inv_proj = (torch.as_tensor(m, dtype=torch.float32, device=dev)
                      for m in (case.view, case.inv_proj))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused.render_pixels_recluster(
            case.perm_t, case.arrays, case.cc.gpu_camera(), view, inv_proj,
            case.cfg, 0, 0, case.spp, **case.table_kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"[seg-waits] {label}: the recluster loop ran under sync debug "
        f"mode 'error' without a wait for the device")


def _segments_through_cli(device) -> None:
    """``--recluster K`` through the CLI at 160x90@4spp on each culling
    intersector, a mesh and a textured scene: the segment kernel of the
    path launches, and the image is finite; brute force without clusters
    refuses, as the reference does."""
    from wavefront_path_tracer_tpu_torch import cli

    base = ["--device", device.type, "--width", "160", "--height", "90",
            "--spp", "4", "--spf", "4", "--max-bounces", "50", "--quiet",
            "--out", os.path.join(OUT_DIR, "seg_cli.png")]
    for kind, flags in (
            ("segment_unculled", ["--intersector", "baked", "--clusters",
                                  "0", "--recluster", "1"]),
            ("segment_dynculled", ["--intersector", "bruteforce",
                                   "--clusters", "16", "--recluster", "2"]),
            ("segment_dynculled", ["--scene", "mesh_demo", "--intersector",
                                   "bruteforce", "--clusters", "16",
                                   "--recluster", "2"]),
            ("segment_culled", ["--scene", "book_checker", "--intersector",
                                "baked", "--clusters", "16", "--recluster",
                                "2"])):
        _reset_launches()
        _, result = cli.run(base + flags)
        torch.cuda.synchronize()
        launches = _read_launches()
        img = result.accumulated / result.samples
        log(f"[seg-cli] {' '.join(flags)}: launches {launches}, image mean "
            f"{img.mean():.4f}")
        if launches[kind] < 1 or not np.isfinite(img).all() \
                or not img.mean() > 0.01:
            raise AssertionError(f"--recluster via the CLI, {flags}: "
                                 f"{launches}, mean {img.mean()}")
        _require_shipped(f"--recluster via the CLI, {flags}", kind,
                         launches)
    try:
        cli.run(base + ["--intersector", "bruteforce", "--recluster", "2"])
    except NotImplementedError as exc:
        if "culling intersector" not in str(exc):
            raise
    else:
        raise AssertionError("--recluster with brute force and no clusters "
                             "did not refuse")


# The segmented rows: (label, kind, row or CLI flags, clusters).
SEG_ROWS = (
    ("knot50k_dynamic", "dynculled", (0, 1, 2)),
    ("terrain_dynamic", "dynculled", (0, 2)),
    ("terrain_baked", "culled", (0, 2)),
    ("headline", "culled", (0, 2)),
)


def _schedule(cfg) -> tuple:
    """The segment lengths of a configuration; (max_bounces,) without
    recluster."""
    from wavefront_path_tracer_tpu_torch.models import fused

    if not cfg.recluster:
        return (cfg.max_bounces,)
    return fused._segment_schedule(cfg.recluster, cfg.max_bounces)


def _seg_frame(renderer, label: str, kind: str, recluster: int,
               smi: str) -> dict:
    """A warm-up frame, a timed frame whose launch counts are read alone,
    and a frame under torch.profiler: frame time, Mrays/s, the device
    time of the segment kernels and of the rest (sort, gathers, raygen,
    scatter) and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from wavefront_path_tracer_tpu_torch.profile_frame import _union_us

    renderer.render_frame()                            # warm-up
    renderer.reset_accumulation()
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    result = renderer.render_frame()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_launches()
    img = result.accumulated / result.samples
    seg_kind = f"segment_{kind}"
    want = seg_kind if recluster else kind
    if launches[want] < 1:
        raise AssertionError(f"{label} recluster {recluster} launched no "
                             f"{want} kernel: {launches}")
    _require_shipped(f"{label} recluster {recluster}", want, launches)
    if not np.isfinite(img).all() or not img.mean() > 0.01:
        raise AssertionError(f"bad image ({label}): mean {img.mean()}")
    renderer.reset_accumulation()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        renderer.render_frame()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t1) * 1e3
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = _union_us((e.time_range.start, e.time_range.end)
                        for e in events) / 1e3
    ours = sorted((e for e in events
                   if any(k in e.name for k in KERNEL_NAMES)),
                  key=lambda e: e.time_range.start)
    kernel_ms = sum(e.device_time for e in ours) / 1e3
    other_ms = sum(e.device_time for e in events) / 1e3 - kernel_ms
    # The launches in issue order, summed by their index in the schedule
    # (segment i of every sample).
    ks = _schedule(renderer.config)
    per_segment = [0.0] * len(ks)
    for i, e in enumerate(ours):
        per_segment[i % len(per_segment)] += e.device_time / 1e3
    mrays = result.rays_traced / result.wall_time_s / 1e6
    rep = {"row": label, "recluster": recluster,
           "render_seconds": result.wall_time_s, "seconds": seconds,
           "rays": result.rays_traced, "mrays_per_s": mrays,
           "launches": launches[want], "all_launches": launches,
           "kernel_ms": kernel_ms, "other_device_ms": other_ms,
           "segments": list(ks), "kernel_ms_by_segment": per_segment,
           "profiled_frame_ms": prof_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / prof_ms,
           "device_ops": len(events),
           "image_mean": float(img.mean()), "image": img}
    log(f"[seg-row] {label} recluster {recluster}: frame "
        f"{result.wall_time_s * 1e3:.2f} ms, {mrays:.2f} Mrays/s, "
        f"{result.rays_traced:.0f} rays, launches {launches[want]}; "
        f"profiled frame {prof_ms:.2f} ms, {len(events)} device kernels "
        f"and copies: kernels {kernel_ms:.2f} ms "
        f"(by segment {ks}: {[round(v, 2) for v in per_segment]}), "
        f"other device work (sort, gathers, raygen) {other_ms:.2f} ms, "
        f"device busy {busy_ms / prof_ms:.1%} [{smi}]")
    return rep


def phase_segments_full(device, smi: str) -> dict:
    """Phase 12 (``segfull``): the segment kernels bit for bit at the
    knot's planes and the 1080p book's (culled and unculled) at 1 spp with
    kernel and plain times and the bound; the segmented rows beside their recluster-0
    forms (frame time, Mrays/s, segment-kernel and other device time,
    launches, busy share); and the golden gate for baked/cull16 at
    recluster 2."""
    from wavefront_path_tracer_tpu_torch.profile_frame import row_renderer
    from wavefront_path_tracer_tpu_torch.renderer import Renderer, render
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        get_scene,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
    from wavefront_path_tracer_tpu_torch.utils.image import rmse
    from wavefront_path_tracer_tpu_torch.utils.parity import (
        DISPLAY_RMSE_TOL,
        MEAN_TOL,
        RAYS_REL_TOL,
        parity_report,
    )

    book, book_cc = _smoke_scene()
    knot, knot_tris, knot_cc = _knot()
    w, h = MESH_SIZE
    checks = {}
    for name, kind, clusters, scene, t, cam, width, height in (
            ("culled", "culled", 16, book, None, book_cc, MAIN_WIDTH,
             MAIN_HEIGHT),
            ("unculled", "unculled", 0, book, None, book_cc, MAIN_WIDTH,
             MAIN_HEIGHT),
            ("dynculled", "dynculled", 16, knot, knot_tris, knot_cc, w, h)):
        case = SegCase(kind, clusters, scene, cam, width, height, 1, {},
                       device, triangles=t)
        rep = _check_seg(f"seg {kind}{clusters or ''} {width}x{height}@1spp "
                         f"default", case, timed=True)
        log(f"[timing] segment {kind}{clusters or ''} {width}x{height}@1spp, "
            f"50 bounces, "
            f"{case.segments} segments: segment kernels "
            f"{rep['kernel_ms']!r} ms, other device work "
            f"{rep['other_device_ms']!r} ms, plain {rep['plain_ms']!r} ms, "
            f"bound {rep['bound_ms']!r} ms ({rep['bound_by']}; "
            f"{rep['bytes']:.0f} B, {rep['ops']:.0f} operations) [{smi}]")
        checks[name] = rep

    # What the sort buys: the segment kernels' device time with the
    # coherence sort and with the lanes left in block order (the same
    # rays, the same results), in turns: sort, no sort, no sort, sort.
    sort_gain = {}
    for name, kind, scene, t, cam, width, height, spp in (
            ("headline", "culled", book, None, book_cc, MAIN_WIDTH,
             MAIN_HEIGHT, 4),
            ("knot50k_dynamic", "dynculled", knot, knot_tris, knot_cc, w, h,
             8)):
        case = SegCase(kind, 16, scene, cam, width, height, spp, {}, device,
                       triangles=t)
        case.kernel()                                  # warm-up
        times = {"sort": [], "no sort": []}
        for label in ("sort", "no sort", "no sort", "sort"):
            fn = case.kernel if label == "sort" else (
                lambda: case.render(order=_keep_order))
            times[label].append(_device_split(fn)[0])
        rep = {k: sum(v) / len(v) for k, v in times.items()}
        log(f"[seg-sort] {name} {width}x{height}@{spp}spp recluster 2: "
            f"segment kernels with the sort {rep['sort']!r} ms, without "
            f"{rep['no sort']!r} ms ({rep['sort'] / rep['no sort'] - 1:+.2%}); "
            f"runs {times} [{smi}]")
        sort_gain[name] = {"spp": spp, **rep, "runs": times}

    # The segment kernels' bound at the samples the segmented rows run:
    # the headline at 32 spp and the knot at 8, recluster 2.
    row_bounds = {}
    for name, kind, scene, t, cam, width, height, spp in (
            ("headline", "culled", book, None, book_cc, MAIN_WIDTH,
             MAIN_HEIGHT, MAIN_SPP),
            ("knot50k_dynamic", "dynculled", knot, knot_tris, knot_cc, w, h,
             8)):
        case = SegCase(kind, 16, scene, cam, width, height, spp, {}, device,
                       triangles=t)
        kernel_ms, other_ms, res = _device_split(case.kernel)
        rep = {"spp": spp, "kernel_ms": kernel_ms,
               "other_device_ms": other_ms, "stats": _seg_stats(res),
               **case.bound(_seg_stats(res))}
        log(f"[seg-bound] {name} {width}x{height}@{spp}spp recluster 2, 50 "
            f"bounces, {case.segments} segments a sample: segment kernels "
            f"{kernel_ms!r} ms, other device work {other_ms!r} ms, bound "
            f"{rep['bound_ms']!r} ms ({rep['bound_by']}; {rep['bytes']:.0f} "
            f"B, {rep['ops']:.0f} operations) [{smi}]")
        row_bounds[name] = rep

    rows = []
    images, agreement = {}, {}
    for label, kind, reclusters in SEG_ROWS:
        for k in reclusters:
            if label == "headline":
                cfg = RenderConfig(
                    width=MAIN_WIDTH, height=MAIN_HEIGHT,
                    samples_per_pixel=MAIN_SPP, samples_per_frame=MAIN_SPP,
                    max_bounces=50, engine="fused", intersector="baked",
                    baked_clusters=16, recluster=k)
                renderer = Renderer(book, book_cc, cfg, device=device)
            else:
                renderer = row_renderer(label, device=device, recluster=k)
            rep = _seg_frame(renderer, label, kind, k, smi)
            images[(label, k)] = (rep.pop("image"), rep["rays"])
            rows.append(rep)
    # The segment path's raygen differs from the persistent kernels' by
    # ulps, so the two agree by the statistical rule's image limits and
    # ray counts; the diverged-pixel share is recorded (50 bounces give
    # a near-tie flip many chances, as in phase 10).
    for label, _kind, _reclusters in SEG_ROWS:
        (a, ra), (b, rb) = images[(label, 0)], images[(label, 2)]
        rep = parity_report(b, a)
        rep["rays_rel_diff"] = abs(rb - ra) / max(ra, 1.0)
        log(f"[seg-agree] {label} recluster 2 vs 0: {json.dumps(rep)}")
        if not (rep["finite"] and rep["mean_diff"] < MEAN_TOL
                and rep["display_rmse"] < DISPLAY_RMSE_TOL
                and rep["rays_rel_diff"] < RAYS_REL_TOL):
            raise AssertionError(f"{label} recluster 2 vs 0: {rep}")
        agreement[label] = rep

    cfg = RenderConfig(width=400, height=225, samples_per_pixel=1000,
                       samples_per_frame=200, max_bounces=50, engine="fused",
                       intersector="baked", baked_clusters=16, recluster=2)
    z = np.load(GOLDEN, allow_pickle=False)
    t0 = time.perf_counter()
    res = render(get_scene("book_one_final"),
                 CameraController.book_one_final(), cfg, device=device)
    seconds = time.perf_counter() - t0
    err = rmse(res.image, z["image"])
    log(f"[golden] baked/cull16 recluster 2: book_one_final 400x225@1000spp "
        f"display RMSE {err!r} (gate {GOLDEN_GATE}) in {seconds:.2f} s, "
        f"{res.rays_traced:.0f} rays [{smi}]")
    if not err < GOLDEN_GATE:
        raise AssertionError(f"recluster golden RMSE {err} >= {GOLDEN_GATE}")
    return {"checks": checks, "sort_gain": sort_gain,
            "row_bounds": row_bounds, "rows": rows,
            "agreement": agreement,
            "golden": {"rmse": err, "seconds": seconds,
                       "rays": res.rays_traced}}


# The probes (queue 2 items 14, 10, 7 and 13): their entries in the
# kernels line, each with the variant that its numbers there are of.
PROBE_KERNELS = {
    "pair_ceiling": {"name": "pair_ceiling C6 (table through L1)",
                     "source": SOURCE + "probe_pairs.cu",
                     "replaces": "exp/pair_ceiling.py:89"},
    "tripair": {"name": "tripair T1 (Moller-Trumbore, 11-field carry)",
                "source": SOURCE + "probe_tripair.cu",
                "replaces": "exp/tripair.py:233"},
    "hbm_bw": {"name": "hbm_bw stream (cp.async double buffer, 32 KB)",
               "source": SOURCE + "probe_stream.cu",
               "replaces": "exp/hbm_bw.py:108"},
    "gated": {"name": "run_gated C8 pattern, per-thread gating",
              "source": SOURCE + "probe_pairs.cu",
              "replaces": "exp/micro_r2.py:1106"},
    # Queue 2 items 8 (its C45/C7 part), 9, 11 and 12.
    "micro_slope": {"name": "micro_slope C45 (device table through L1, "
                            "ten attribute selects)",
                    "source": SOURCE + "probe_designs.cu",
                    "replaces": "exp/micro_slope.py:56"},
    "bf16_issue": {"name": "bf16_issue f32 chains (FMUL then FADD)",
                   "source": SOURCE + "probe_issue.cu",
                   "replaces": "exp/bf16_issue.py:66"},
    "run_pairs": {"name": "run_pairs A (constant bank, ten attribute "
                          "selects)",
                  "source": SOURCE + "probe_designs.cu",
                  "replaces": "exp/micro_r2.py:273"},
    "matmul": {"name": "matmul_bench (256,128)x(128,256) DEFAULT (TF32 "
                       "mma.sync, cluster-shared acc)",
               "source": SOURCE + "probe_mma.cu",
               "replaces": "exp/micro_r2.py:301"},
}
PROBE_REPS = 4             # reps of a probe kernel's timed call
PROBE_PASSES = 1           # passes of the stream's timed call
PROBE_PRODUCTS = 64        # products of a matmul row's timed call
# The reference's names that run every run_pairs design (micro_r2.NAMES).
RUN_PAIRS_NAMES = ("A", "B", "C", "C2", "C3", "Q", "Q2", "Q4", "Q8", "W",
                   "W5", "W6", "W7", "C4", "C5", "C45", "C6", "C7", "A2")
# The design command line's rep points here (its default is 50 -> 350;
# the slope widens a window under 20 ms itself, and the constant bank's
# 8-lane forms take 8 ms a rep).
DESIGN_REPS = ("--reps-lo", "2", "--reps-hi", "14")
# micro_slope's, in the reference's 1:9 ratio (its default 2000 -> 18000
# takes minutes at full width).
SLOPE_REPS = ("--reps-lo", "2", "--reps-hi", "18")
# The gated sweeps' (default 200 -> 1400), cut so that the full-width bit
# checks of probe_pairs.cu's kernels (0.8 s) add no time to the phase:
# W8's window stays near 66 ms, C8's near 27 ms.
GATED_REPS = ("--reps-lo", "200", "--reps-hi", "1000")


def _probe_modules():
    from wavefront_path_tracer_tpu_torch.probes import bf16_issue, hbm_bw
    from wavefront_path_tracer_tpu_torch.probes import matmul_r2, micro_r2
    from wavefront_path_tracer_tpu_torch.probes import pair_ceiling, tripair
    from wavefront_path_tracer_tpu_torch.probes import run_pairs

    return (pair_ceiling, tripair, hbm_bw, micro_r2, run_pairs, bf16_issue,
            matmul_r2)


def _probe_launch_counts() -> dict:
    pc, tp, hb, m, rp, bi, mr = _probe_modules()
    slope = sum(v for (d, _p, _n), v in rp.LAUNCHES.items()
                if d in ("C45", "C7"))
    return {"pair_ceiling": sum(pc.LAUNCHES.values()),
            "tripair": sum(tp.LAUNCHES.values()),
            "hbm_bw": sum(hb.LAUNCHES.values()),
            "gated": sum(m.LAUNCHES.values()),
            "micro_slope": slope,
            "bf16_issue": sum(bi.LAUNCHES.values()),
            "run_pairs": sum(rp.LAUNCHES.values()),
            "matmul": sum(mr.LAUNCHES.values())}


def _reset_probe_launches() -> None:
    for module in _probe_modules():
        for key in module.LAUNCHES:
            module.LAUNCHES[key] = 0


def _counted(run) -> tuple:
    """(``run()``'s readings, the probe launch counts it made alone)."""
    _reset_probe_launches()
    readings = run()
    return readings, _probe_launch_counts()


def _same_bits(label: str, k, p, hits: bool = True) -> float:
    """Raise unless the kernel's output ``k`` is the plain version's
    ``p`` bit for bit (and, with ``hits``, some ray hit); the largest
    absolute difference (0.0)."""
    same = torch.equal(k.view(torch.int32), p.view(torch.int32))
    err = float((k.double() - p.double()).abs().max())
    log(f"[probe-vs-plain] {label}: bit-identical {same}, max abs err "
        f"{err!r}, {int((k < 1e29).sum())} of {k.numel()} rays hit")
    if not same:
        raise AssertionError(f"{label}: kernel and plain version differ")
    if hits and not bool((k < 1e29).any()):
        raise AssertionError(f"{label}: no ray hit anything")
    return err


def _design_forms(mangled: str) -> tuple:
    """(group, the run_pairs forms [(design, place, lanes)] that the
    probe_designs.cu kernel ``mangled`` runs), read from its template
    arguments; (None, []) for another function."""
    import re

    _pc, _tp, _hb, _m, rp, _bi, _mr = _probe_modules()
    m = re.search(r"design_(ray_major|sphere_major|tile_gated)"
                  r"I((?:Li-?\d+E)+)E", mangled)
    if not m:
        return None, []
    args = [int(a) for a in re.findall(r"Li(-?\d+)E", m[2])]
    names = {k: d for d, k in rp.KERNEL_IDS.items() if d != "A2d"}
    place = {k: p for p, k in rp.PLACE_IDS.items()}[args[1]]
    lanes = args[2] if m[1] == "sphere_major" else 1
    forms = [(names[args[0]], place, lanes)]
    if forms[0] == ("C6d", "const", 8):
        forms.append(("A2d", "const", 8))     # the same kernel
    return m[1], [f for f in forms if (f[1], f[2]) in rp.forms(f[0])]


def _mma_row(mangled: str):
    """The matmul_bench row (index of ``matmul_r2.ROWS``) whose
    csrc/probe_mma.cu kernel ``mangled`` is, read from its ``Row``
    template arguments (shape and precision); None for another
    function."""
    import re

    _pc, _tp, _hb, _m, _rp, _bi, mr = _probe_modules()
    m = re.search(r"probe_mmaI.*?RowILi(\d+)ELi(\d+)ELi(\d+)ELi\d+ELi\d+E"
                  r"Li(\d+)E", mangled)
    if not m:
        return None
    shape, prec = tuple(int(v) for v in m.groups()[:3]), int(m[4])
    names = {0: "tf32", 1: "fp32", 2: "bf16"}
    return next(r for r, (_n, sh, p) in enumerate(mr.ROWS)
                if sh == shape and p == names[prec])


def _sass_per_pair(smi: str, n_rays: int) -> dict:
    """SASS instructions a pair of the pair ceiling's kernels (C6, A2:
    csrc/probe_pairs.cu ``probe_pair_sweep``), of the six gated sweeps
    (``probe_gated``: W8 and C8 under each gating, their pairs the
    entered ones, ``micro_r2.pairs_per_rep``), of every run_pairs form of
    csrc/probe_designs.cu and of the four triangle forms
    (csrc/probe_tripair.cu), all read alike from the built library
    (``cuobjdump -sass``, ``utils/sass.py``): the kernel's sweep loop (the
    innermost loop that holds a square root, ``inner_loop``, or for the
    triangle forms a reciprocal, MUFU.RCP, the fast path of their IEEE
    divide; Q2's, which has none, the innermost loop, whose pairs
    are Q's: the same kernel template, unroll and rays a thread), the
    pairs it holds (its square roots or reciprocals), the instructions a
    pair there, the uniform datapath's instructions and the table loads
    (LDC, ULDC, LDG, LDS) among them, and ptxas's registers, stack and
    spills; beside them the time the kernels line's call (``n_rays``
    rays, PROBE_REPS reps) would take at full issue of those
    instructions a pair (ungated forms).  The matmul rows
    (csrc/probe_mma.cu) give their mma instructions (HMMA) in the whole
    kernel and in the innermost loop that holds one, with ptxas's
    registers and spills.  Keyed "C6", "A2", "gated PATTERN GATING",
    "design place lanes", "tripair FORM" and "matmul ROW"; {} without
    cuobjdump.  Each kernel's listing goes to ``OUT_DIR/probe_sass/``."""
    import re

    from wavefront_path_tracer_tpu_torch.ops import _build
    from wavefront_path_tracer_tpu_torch.probes import _slope
    from wavefront_path_tracer_tpu_torch.utils import sass

    if sass.cuobjdump() is None:
        log("[probe-sass] cuobjdump not found: instructions a pair not "
            "measured")
        return {}
    _pc, tp, _hb, m, rp, _bi, mr = _probe_modules()
    lib, report, _ = _build.build()
    ptx = {r["mangled"]: r for match in ("probe_pair_sweep", "probe_gated",
                                         "design_", "probe_tripair",
                                         "probe_mma")
           for r in _build.ptxas_kernels(report, match)}
    rate = _slope.issue_rate(_slope.card())
    dump = os.path.join(OUT_DIR, "probe_sass")
    os.makedirs(dump, exist_ok=True)
    tri_forms = {("0", "0"): "T1", ("0", "1"): "T1p", ("1", "0"): "T2",
                 ("1", "1"): "T2p"}
    reps, q2 = {}, None
    for name, n in sass.counts(lib).items():
        marker, pairs_per_rep = "MUFU.RSQ", m.S * n_rays
        if "probe_pair_sweepI" in name:
            group = "pair_ceiling"
            const = re.search(r"probe_pair_sweepILb([01])E", name)[1]
            forms = [("A2",) if const == "1" else ("C6",)]
        elif "probe_gatedI" in name:
            generic, gate = re.search(r"probe_gatedILb([01])ELi(\d+)E",
                                      name).groups()
            pattern = "W8" if generic == "1" else "C8"
            group, pairs_per_rep = "gated", m.pairs_per_rep(pattern, n_rays)
            forms = [("gated", pattern, m.GATINGS[int(gate)])]
        elif "probe_tripairI" in name:
            group, marker = "tripair", "MUFU.RCP"
            pairs_per_rep = tp.NTRI // 2 * n_rays
            forms = [("tripair", tri_forms[tuple(re.findall(
                r"Lb([01])E", name)[:2])])]
        elif "probe_mmaI" in name:
            group, forms = "matmul", [("matmul", _mma_row(name))]
        else:
            group, forms = _design_forms(name)
        if not forms:
            continue
        listing = sass.listings(lib)[name]
        with open(os.path.join(dump, "_".join(map(str, forms[0]))
                               + ".sass"), "w") as f:
            f.write(listing)
        rep = {"function": name, "group": group, "instructions": n,
               **{k: ptx.get(name, {}).get(k) for k in (
                   "registers", "stack", "spill_stores", "spill_loads")}}
        if group == "matmul":
            ops = sass.opcodes(listing)
            hmma = sorted({o for o in ops if o.startswith("HMMA")})
            loop = sass.inner_loop(listing, hmma[0]) if hmma else []
            rep.update(mma=hmma, mma_in_kernel=sum(
                o.startswith("HMMA") for o in ops), loop=len(loop),
                mma_in_loop=sum(sass.opcode(t).startswith("HMMA")
                                for t in loop))
            reps[" ".join(map(str, forms[0]))] = rep
            continue
        body = sass.inner_loop(listing, marker)
        if forms[0][0] == "Q2":
            body, q2 = sass.inner_loop(listing), forms
        ops = [sass.opcode(t) for t in body]
        rep.update(body=len(ops), pairs_in_body=ops.count(marker),
                   pairs_per_rep=pairs_per_rep,
                   uniform=sum(o.startswith("U") for o in ops),
                   loads={k: sum(o.split(".")[0] == k for o in ops)
                          for k in ("LDC", "ULDC", "LDG", "LDS")})
        for form in forms:
            reps[" ".join(map(str, form))] = rep
    if q2 is not None:
        reps[" ".join(map(str, q2[0]))]["pairs_in_body"] = (
            reps.get("Q const 1", {}).get("pairs_in_body", 0))
    for key, rep in reps.items():
        if rep["group"] == "matmul":
            log(f"[probe-sass] {key} ({mr.ROWS[int(key.split()[1])][0]}): "
                f"{rep['instructions']} SASS instructions, "
                f"{rep['mma_in_kernel']} mma ({', '.join(rep['mma'])}), "
                f"{rep['mma_in_loop']} of them in the innermost loop that "
                f"holds one ({rep['loop']} instructions); ptxas "
                f"{rep['registers']} registers, {rep['stack']} bytes stack, "
                f"{rep['spill_stores']} / {rep['spill_loads']} bytes "
                f"spilled [{smi}]")
            continue
        pairs = rep["pairs_in_body"]
        rep["per_pair"] = rep["body"] / pairs if pairs else None
        ungated = key.split()[0] not in rp.TILE_GATED or key == "W0 const 1"
        rep["issue_bound_ms"] = (rep["per_pair"] * rep["pairs_per_rep"]
                                 * PROBE_REPS / rate * 1e3
                                 if rep["per_pair"] and ungated else None)
        per = f"{rep['per_pair']:.2f}" if rep["per_pair"] else "-"
        log(f"[probe-sass] {key}: {rep['instructions']} SASS instructions, "
            f"sweep loop {rep['body']} for {pairs} pairs ({per} a pair; "
            f"{rep['uniform']} on the uniform datapath; loads "
            f"{json.dumps(rep['loads'])}); issue-bound "
            f"{rep['issue_bound_ms']!r} ms at {PROBE_REPS} reps x {n_rays} "
            f"rays; ptxas {rep['registers']} registers, {rep['stack']} "
            f"bytes stack, {rep['spill_stores']} / {rep['spill_loads']} "
            f"bytes spilled [{smi}]")
    missing = [k for k in ("C6", "A2") if k not in reps] + [
        f"gated {p} {g}" for p in m.PATTERNS for g in m.GATINGS
        if f"gated {p} {g}" not in reps] + [
        f"{d} {p} {n}" for d in rp.DESIGNS if d not in ("C6", "A2")
        for p, n in rp.forms(d) if f"{d} {p} {n}" not in reps] + [
        f"tripair {f}" for f in tp.FORMS if f"tripair {f}" not in reps] + [
        f"matmul {r}" for r in range(len(mr.ROWS))
        if f"matmul {r}" not in reps]
    if missing:
        raise AssertionError(f"no kernel found for {missing}")
    return reps


def _probe_timed(label, kernel, plain, bound) -> dict:
    """A probe kernel's CUDA-event time (mean of 5 calls after a warm-up)
    and its plain version's (one call) on the same inputs, beside the
    bound of the same work; the kernel checked against the plain version
    on the way (``bound`` gives the check: bits or a tolerance)."""
    k = kernel()
    ms, k = _time_ms(kernel, 5)
    plain_ms, p = _time_ms(plain, 1)
    rep = {"case": label, "kernel_ms": ms, "plain_ms": plain_ms, **bound}
    rep["max_abs_err"] = (_same_bits(label, k, p) if rep.pop("bits")
                          else float((k.double() - p.double()).abs().max()))
    return rep


@functools.cache
def _fp32_rate() -> float:
    """FP32 operations a second that bound a kernel built -fmad=false:
    the card's issue rate (``_slope.fp32_issue_rate``, its SM count x 128
    x its maximum SM clock), since each such operation is one issued
    instruction; the 67 TFLOP/s spec counts an FFMA as two.  Read from
    the card once a process."""
    from wavefront_path_tracer_tpu_torch.probes import _slope

    return _slope.issue_rate(_slope.card())


def _bound(ops: float, n_bytes: float, bits: bool = True,
           peak: float | None = None) -> dict:
    """The least time of ``ops`` operations and ``n_bytes`` bytes: the
    larger of the bytes over the memory rate and the operations over
    ``peak`` (default: FP32 at the card's issue rate, :func:`_fp32_rate`).
    """
    peak = _fp32_rate() if peak is None else peak
    t_ops, t_bytes = ops / peak, n_bytes / PEAK_BYTES
    return {"ops": ops, "bytes": n_bytes, "bits": bits,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _bits(t):
    """``t`` as integers of its width, for bit-for-bit comparisons."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t


def _check_new_probes(device, rays1, rays, errs: dict) -> None:
    """Queue 2 items 8 (C45/C7), 9, 11 and 12 against their plain versions
    on the card: the designs' branchless square root equal to sqrtf on
    every float, and the texture step's sinf_fast (fastmath.cuh) equal to
    sinf on every float it claims; every run_pairs design in each of its
    forms bit for bit at 2 reps over the full-width rays and over the
    reference's 1024 rays
    alone (the plain version's copy 0: a ray's output depends on its
    tile alone); bf16_issue's chains over
    the full copies at 2 reps bit for bit (the fused forms against their
    own plain version, one rounding a multiply-add), the (256, 128) block
    alone equal to copy 0; matmul_bench's rows at 8
    products, every copy equal and within the stated bound of the plain
    version.  ``errs`` takes each kernel's largest difference."""
    from wavefront_path_tracer_tpu_torch.probes import _slope

    _pc, _tp, _hb, _m, rp, bi, mr = _probe_modules()
    count = torch.zeros(1, dtype=torch.int64, device=device)
    _slope.launch("wpt_probe_sqrt_mismatches", count.data_ptr())
    log(f"[probe-vs-plain] probe_math.cuh sqrt_rn against sqrtf over all "
        f"2^32 floats: {int(count.item())} differ")
    if int(count.item()):
        raise AssertionError("sqrt_rn is not sqrtf")
    count = torch.zeros(2, dtype=torch.int64, device=device)
    _slope.launch("wpt_probe_sin_mismatches", count.data_ptr())
    claimed, differ = (int(v) for v in count.tolist())
    log(f"[probe-vs-plain] fastmath.cuh sinf_fast against sinf over the "
        f"{claimed} of all 2^32 floats that it claims (|x| < "
        f"{texstep.SIN_FAST_MAX!r}, or NaN; the texture step's checker sends "
        f"the others to sinf): "
        f"{differ} differ")
    if differ or claimed != texstep.SIN_FAST_CLAIMED:
        raise AssertionError(f"sinf_fast is not sinf ({differ} differ) or "
                             f"claims {claimed} floats, not "
                             f"{texstep.SIN_FAST_CLAIMED}")
    for design in rp.DESIGNS:
        if design in ("C6", "A2"):           # the pair ceiling's kernels
            continue
        tab = rp.table_for(design, device)
        plain = rp.design_reference(tab, rays, 2, design)
        key = "micro_slope" if design in ("C45", "C7") else "run_pairs"
        for place, lanes in rp.forms(design):
            label = (f"run_pairs {design} {place} {lanes} lane(s) "
                     f"{rays.shape[1]} rays 2 reps")
            k = rp.design_sweep(tab, rays, 2, design, place, lanes)
            errs[key] = max(errs[key], _same_bits(label, k, plain,
                                                  hits=design != "W2"))
            one = rp.design_sweep(tab, rays1, 2, design, place, lanes)
            errs[key] = max(errs[key], _same_bits(
                f"run_pairs {design} {place} {lanes} lane(s) "
                f"{rays1.shape[1]} rays 2 reps", one,
                plain[:rays1.shape[1]], hits=design != "W2"))
    for form in bi.FORMS:
        x = bi.make_x(form, bi.COPIES[form], device)
        k = bi.chains(x, 2, form)
        p = bi.chains_reference(x, 2, form)
        ok = torch.equal(_bits(k), _bits(p))
        one = bi.chains(bi.make_x(form, 1, device), 2, form)
        ok = ok and torch.equal(_bits(one), _bits(k[:bi.ROWS]))
        err = float((k.double() - p.double()).abs().max())
        note = ""
        if form in bi.FUSED:
            unfused = bi.chains_reference(x, 2, form.replace("_fma", ""))
            apart = float((k.double() - unfused.double()).abs().max())
            note = (f"; another rounding than the unfused chains, max abs "
                    f"diff {apart!r}")
        log(f"[probe-vs-plain] bf16_issue {form} {x.numel()} elements 2 "
            f"reps: bits {ok}, max abs err {err!r}{note}")
        if not ok:
            raise AssertionError(f"bf16_issue {form}: kernel and plain "
                                 f"version differ")
        errs["bf16_issue"] = max(errs["bf16_issue"], err)
    for row, (a, b) in enumerate(mr.inputs(device)):
        k = mr.matmul(a, b, 8, row)
        p = mr.matmul_reference(a, b, 8, row)
        diff = (k[0] - p).abs()
        bound = mr.tolerance(a, b, 8, row, p)
        ok = bool((diff <= bound).all()) and bool((k == k[:1]).all())
        log(f"[probe-vs-plain] matmul {mr.ROWS[row][0]} 8 products, "
            f"{k.shape[0]} copies: within the bound {ok}, max abs "
            f"err {float(diff.max())!r} (largest bound "
            f"{float(bound.max())!r})")
        if not ok:
            raise AssertionError(f"matmul row {row}: kernel and plain "
                                 f"version differ beyond the bound")
        errs["matmul"] = max(errs["matmul"], float(diff.max()))


ISSUE_REPS = 400           # reps of bf16_issue's timed call


def _time_new_probes(device, rays, ray_bytes: int) -> dict:
    """The kernels line's calls of items 8, 9, 11 and 12 at full width,
    beside their plain versions and bounds (torch.matmul's loop over the
    kernel's copies beside the matmul row, as ``library_ms``; the loop
    over one copy and the batched loop replayed from a CUDA graph
    beside it)."""
    _pc, _tp, _hb, m, rp, bi, mr = _probe_modules()
    n = rays.shape[1]
    timed = {}
    for key, design in (("run_pairs", "A"), ("micro_slope", "C45")):
        tab = rp.table_for(design, device)
        ops = (m.S * n * PROBE_REPS * rp.flops_pair(design)
               + n * PROBE_REPS * 4)       # dxm and the three adds a rep
        timed[key] = _probe_timed(
            f"run_pairs {design}",
            lambda tab=tab, d=design: rp.design_sweep(tab, rays,
                                                      PROBE_REPS, d),
            lambda tab=tab, d=design: rp.design_reference(tab, rays,
                                                          PROBE_REPS, d),
            _bound(ops, tab.numel() * 4 + ray_bytes))
    x = bi.make_x("f32", bi.COPIES["f32"], device)
    timed["bf16_issue"] = _probe_timed(
        "bf16_issue f32", lambda: bi.chains(x, ISSUE_REPS, "f32"),
        lambda: bi.chains_reference(x, ISSUE_REPS, "f32"),
        _bound(bi.CHAIN * 2 * x.numel() * ISSUE_REPS, 2 * x.nbytes))
    row = 4
    a, b = mr.inputs(device)[row]
    _name, (mm, kk, nn), _prec = mr.ROWS[row]
    copies = mr.copies(row)
    timed["matmul"] = _probe_timed(
        f"matmul {mr.ROWS[row][0]} {PROBE_PRODUCTS} products",
        lambda: mr.matmul(a, b, PROBE_PRODUCTS, row),
        lambda: mr.matmul_reference(a, b, PROBE_PRODUCTS, row),
        _bound(2 * mm * kk * nn * PROBE_PRODUCTS * copies,
               a.nbytes + b.nbytes + copies * mm * nn * 4, bits=False,
               peak=PEAK_TF32))
    timed["matmul"]["library_ms"], _ = _time_ms(
        lambda: mr.library_loop(a, b, PROBE_PRODUCTS, row, copies), 5)
    timed["matmul"]["library_one_copy_ms"], _ = _time_ms(
        lambda: mr.library_loop(a, b, PROBE_PRODUCTS, row), 5)
    replay, _ = mr.library_graph(a, b, PROBE_PRODUCTS, row, copies)
    replay()
    timed["matmul"]["library_graph_ms"], _ = _time_ms(replay, 5)
    timed["matmul"]["copies"] = copies
    return timed


def phase_probes(device, smi: str) -> dict:
    """Phase 13 (``probes``): the four probe kernels (csrc/probe_pairs.cu,
    probe_tripair.cu, probe_stream.cu).  Each kernel against its plain
    version on the card: the pair ceiling's C6 and A2, the gated sweeps'
    two patterns under the three gatings, and the four triangle forms bit
    for bit at 2 reps over the reference's 1024 rays and over the
    full-width copies (``micro_r2.RAY_COPIES``); the stream's two
    kernels at each chunk size within the stated float32 summation bound
    of the float64 sums.  One timed call of each kernels-line variant at
    full width, beside its plain version and its bound (and torch.sum for
    the stream).  Then each probe's command line at its defaults, with the
    launch counts set to 0 just before and read just after; every rate
    beside the card's name, power limit and clock; a rate above the
    card's spec (pairs x operations over 67 TFLOP/s, bytes over 3.35
    TB/s) fails the phase."""
    from wavefront_path_tracer_tpu_torch.probes import _slope

    pc, tp, hb, m, rp, bi, mr = _probe_modules()
    card = _slope.card()
    tab = torch.from_numpy(m.PACKED_SM).to(device)
    rays1 = m.ray_planes(device)
    rays = m.ray_planes(device, m.RAY_COPIES)
    errs = {k: 0.0 for k in PROBE_KERNELS}
    # probe_pairs.cu's eight kernels over the reference's 1024 rays and
    # over the full-width copies (a thread's rays and a warp's row come
    # from the launch's layout, which the copies cover in full).
    t0 = time.perf_counter()
    for planes in (rays1, rays):
        plain = pc.pair_sweep_reference(tab, planes, 2)
        for variant in pc.VARIANTS:
            errs["pair_ceiling"] = max(errs["pair_ceiling"], _same_bits(
                f"pair_ceiling {variant} {planes.shape[1]} rays 2 reps",
                pc.pair_sweep(tab, planes, 2, variant), plain))
        for pattern in m.PATTERNS:
            cond = torch.from_numpy(m.cond_table(pattern)).to(device)
            plain = m.gated_reference(tab, cond, planes, 2,
                                      m.PATTERNS[pattern][2])
            for gating in m.GATINGS:
                errs["gated"] = max(errs["gated"], _same_bits(
                    f"gated {pattern} {gating} {planes.shape[1]} rays 2 "
                    f"reps", m.gated_sweep(tab, cond, planes, 2, pattern,
                                           gating), plain))
    log(f"[probe-vs-plain] probe_pairs.cu at 1024 and {rays.shape[1]} "
        f"rays: {time.perf_counter() - t0:.1f} s")
    tri_rays1 = tp.ray_planes(device)
    tri_rays = tp.ray_planes(device, m.RAY_COPIES)
    for form, (ttab, pk) in tp.tables(device).items():
        for planes in (tri_rays1, tri_rays):
            errs["tripair"] = max(errs["tripair"], _same_bits(
                f"tripair {form} {planes.shape[1]} rays 2 reps",
                tp.tripair_sweep(ttab, pk, planes, 2, form),
                tp.tripair_reference(ttab, pk, planes, 2, form)))
    data = hb.make_data(256, device)
    exact = hb.exact_sums(data, 3)
    for kind in hb.KINDS:
        for chunk_kb in hb.CHUNKS_KB:
            out = hb.stream(data, 3, 64, chunk_kb, kind)
            grid = hb.stream_grid(kind, chunk_kb, data.shape[0])
            bound = hb.tolerance(data, 3, chunk_kb, grid)
            err = float((out.double() - exact).abs().max())
            plain_err = float((out - hb.stream_reference(
                data, 3, 64, chunk_kb)).abs().max())
            errs["hbm_bw"] = max(errs["hbm_bw"], plain_err)
            log(f"[probe-vs-plain] hbm_bw {kind} {chunk_kb} KB 256 MB 3 "
                f"passes 64 fma: max abs err {err!r} against the float64 "
                f"sums (bound {bound!r}), {plain_err!r} against the plain "
                f"version")
            if not err <= bound:
                raise AssertionError(f"hbm_bw {kind} {chunk_kb} KB: error "
                                     f"{err} above the bound {bound}")
    _check_new_probes(device, rays1, rays, errs)

    # The kernels line's calls: full width, PROBE_REPS reps.
    n = rays.shape[1]
    ray_bytes = rays.numel() * 4 + n * 4
    timed = {}
    pairs = m.S * n * PROBE_REPS
    timed["pair_ceiling"] = _probe_timed(
        "pair_ceiling C6", lambda: pc.pair_sweep(tab, rays, PROBE_REPS),
        lambda: pc.pair_sweep_reference(tab, rays, PROBE_REPS),
        _bound(pairs * pc.FLOPS_PAIR + n * PROBE_REPS * pc.FLOPS_RAY_REP,
               tab.numel() * 4 + ray_bytes))
    ttab, pk = tp.tables(device)["T1"]
    pairs = tp.NTRI // 2 * n * PROBE_REPS
    timed["tripair"] = _probe_timed(
        "tripair T1", lambda: tp.tripair_sweep(ttab, pk, tri_rays,
                                               PROBE_REPS),
        lambda: tp.tripair_reference(ttab, pk, tri_rays, PROBE_REPS, "T1"),
        _bound(pairs * tp.FLOPS_PAIR["T1"],
               (ttab.numel() + pk.numel()) * 4 + ray_bytes))
    cond = torch.from_numpy(m.cond_table("C8")).to(device)
    pairs = m.pairs_per_rep("C8", n) * PROBE_REPS
    timed["gated"] = _probe_timed(
        "gated C8 thread", lambda: m.gated_sweep(tab, cond, rays, PROBE_REPS,
                                                 "C8"),
        lambda: m.gated_reference(tab, cond, rays, PROBE_REPS, False),
        _bound(pairs * m.FLOPS_SLIM + n * PROBE_REPS * pc.FLOPS_RAY_REP,
               tab.numel() * 4 + cond.numel() * 4 + ray_bytes))
    timed["hbm_bw"] = _probe_timed(
        "hbm_bw async 32 KB", lambda: hb.stream(data, PROBE_PASSES, 0, 32),
        lambda: hb.stream_reference(data, PROBE_PASSES, 0, 32),
        _bound(data.numel() * PROBE_PASSES, data.nbytes * PROBE_PASSES
               + 8 * 128 * 4, bits=False))
    view = data.reshape(-1, 8, 128)
    timed["hbm_bw"]["library_ms"], _ = _time_ms(
        lambda: torch.sum(view, dim=0), 5)
    timed.update(_time_new_probes(device, rays, ray_bytes))
    for key, rep in timed.items():
        extra = "".join(f", {k} {rep[k]!r}" for k in (
            "copies", "library_one_copy_ms", "library_graph_ms") if k in rep)
        log(f"[probe-timing] {rep['case']}: kernel {rep['kernel_ms']!r} ms, "
            f"plain {rep['plain_ms']!r} ms, bound {rep['bound_ms']!r} ms "
            f"({rep['bound_by']}), library "
            f"{rep.get('library_ms')!r} ms{extra} [{smi}]")
    sass = _sass_per_pair(smi, n)
    spilled = [k for k, r in sass.items()
               if r["spill_stores"] or r["spill_loads"]]
    if spilled:
        raise AssertionError(f"probe kernels that spill: {spilled}")

    # The probes' command lines: the main path, each with the launch
    # counts set to 0 just before it and read just after it.
    from wavefront_path_tracer_tpu_torch.probes import micro_slope

    runs = {"pair_ceiling": lambda: pc.run([]),
            "tripair": lambda: tp.run([]), "hbm_bw": lambda: hb.run([]),
            "gated": lambda: m.run(["C8", "C9", *GATED_REPS]),
            "run_pairs": lambda: m.run([*RUN_PAIRS_NAMES, *DESIGN_REPS]),
            "micro_slope": lambda: micro_slope.run(list(SLOPE_REPS)),
            "bf16_issue": lambda: bi.run([]), "matmul": lambda: mr.run([])}
    readings, launches = {}, {}
    for key, run in runs.items():
        readings[key], counts = _counted(run)
        launches[key] = counts[key]
    log(f"[probe-launches] each probe's command line alone: "
        f"{json.dumps(launches)}")
    for key, count in launches.items():
        if not count > 0:
            raise AssertionError(f"{key}: its kernel was not launched")
    impossible = []
    for r in readings["run_pairs"] + readings["micro_slope"]:
        if r["fp32_rate"] > PEAK_FP32:
            impossible.append(f"run_pairs {r.get('design', r.get('pattern'))}"
                              f" {r.get('place', r.get('gating'))}")
    for r in readings["bf16_issue"]:
        if r["gops"] > r["peak_gops"]:
            impossible.append(f"bf16_issue {r['form']}")
    for r in readings["matmul"]:
        if max(r["tflops"], r["library_tflops"], r["library_batched_tflops"],
               r["library_graph_tflops"]) > r["peak_tflops"]:
            impossible.append(f"matmul {r['name']}")
    for r in readings["pair_ceiling"]:
        if r["fp32_rate"] > PEAK_FP32:
            impossible.append(f"pair_ceiling {r['variant']}")
    for r in readings["tripair"]:
        if r["fp32_rate"] > PEAK_FP32:
            impossible.append(f"tripair {r['form']}")
    for r in readings["gated"]:
        if r["fp32_rate"] > PEAK_FP32:
            impossible.append(f"gated {r['pattern']} {r['gating']}")
    for r in readings["hbm_bw"]:
        if r["gb_s"] * 1e9 > PEAK_BYTES:
            impossible.append(f"hbm_bw {r['kind']} {r.get('chunk_kb')} KB "
                              f"{r.get('fmas')} fma")
    log(f"[probe-spec] readings above the card's spec: {impossible} "
        f"[{card}]")
    if impossible:
        raise AssertionError(f"readings above the card's spec: {impossible}")
    return {"card": card, "max_abs_err": errs, "timed": timed,
            "launches": launches, "readings": readings, "sass": sass}


def _ceiling_shares(record: dict) -> list:
    """Each book and mesh kernel's time beside the time its pairs take at
    the measured pair ceiling (C6 for spheres, T1 for triangles: the mesh
    rows' pairs are counted at the triangle rate), and beside its spec
    bound; also beside the ceiling that the bench holds
    (``bench.PAIR_CEILING``), so that readings stay comparable across a
    change of C6's or T1's kernel."""
    from wavefront_path_tracer_tpu_torch.bench import PAIR_CEILING

    ceil = {r["variant"]: r["gpairs"] * 1e9
            for r in record["probes"]["readings"]["pair_ceiling"]}
    tri = {r["form"]: r["gpairs"] * 1e9
           for r in record["probes"]["readings"]["tripair"]}
    timed = record["full_size"]["timed"]
    rows = [(f"{kind} book 1080p@32spp", timed[kind], ceil["C6"], False)
            for kind in ("culled", "persistent", "unculled")]
    for rep in record["mesh_full_size"]["timed"]:
        rows.append((f"{rep['kind']} {rep['scene']} 800x448@{rep['spp']}spp",
                     rep, tri["T1"], True))
    out = []
    for label, rep, rate, triangles in rows:
        at_ceiling = rep["pairs"] / rate * 1e3
        share = {"case": label, "kernel_ms": rep["kernel_ms"],
                 "pairs": rep["pairs"], "ceiling_ms": at_ceiling,
                 "ceiling_share": at_ceiling / rep["kernel_ms"],
                 "bound_ms": rep["bound_ms"],
                 "bound_share": rep["bound_ms"] / rep["kernel_ms"]}
        bench_ms = rep["pairs"] / PAIR_CEILING[
            "triangle" if triangles else "sphere"] * 1e3
        share.update(bench_ceiling_ms=bench_ms,
                     bench_ceiling_share=bench_ms / rep["kernel_ms"])
        log(f"[ceiling-share] {json.dumps(share)}")
        out.append(share)
    return out


# The windows that the divergence counts read, at the middle of each
# frame's lane order: (image blocks of 32x32, samples a pixel).  The
# dynamic rows' plain version (a rolled sweep of many small launches)
# takes about 3 s a sample on the card whatever the window's width, so
# both dynamic rows are counted at 2 samples (terrain runs 32, the knot
# 8), and the headline over 4 blocks at 8 (its plain version's time goes
# with the samples; cut so that the whole smoke stays inside its time
# limit).
DIVERGENCE_WINDOWS = {"headline": (4, 8), "terrain_dynamic": (4, 2),
                      "knot50k_dynamic": (4, 2)}


def _sweep_cells(device) -> dict:
    """The cells that chose each culled kernel's sweep form, at their
    sizes, in clusters of 16: for the baked culled kernel the headline and
    its winner-hint form (book_one_final) and book_checker (textured) at
    1080p@32spp and terrain_baked (triangles) at 800x448@32spp; for the
    dynamic culled kernel the two dynamic mesh rows, terrain_dynamic
    (800x448@32spp, a rolled triangle sweep) and knot50k_dynamic
    (800x448@8spp, incoherent rays, 196 supers), and book_checker at
    1080p@32spp (textured, a flat sphere sweep)."""
    book, book_cc = _smoke_scene()
    checker, _tris, checker_cc = _book_checker()
    terrain, tris, terrain_cc = _terrain()
    knot, knot_tris, knot_cc = _knot()
    full = (MAIN_WIDTH, MAIN_HEIGHT, MAIN_SPP, 1, {}, device)
    return {
        "headline": Case("culled", 16, book, book_cc, *full),
        "book_checker": Case("culled", 16, checker, checker_cc, *full),
        "winner_hint": Case("culled", 16, book, book_cc, *full,
                            winner_hint=True),
        "terrain_baked": Case("culled", 16, terrain, terrain_cc, *MESH_SIZE,
                              MAIN_SPP, 1, {}, device, triangles=tris),
        "terrain_dynamic": Case("dynculled", 16, terrain, terrain_cc,
                                *MESH_SIZE, MAIN_SPP, 1, {}, device,
                                triangles=tris),
        "knot50k_dynamic": Case("dynculled", 16, knot, knot_cc, *MESH_SIZE,
                                8, 1, {}, device, triangles=knot_tris),
        "book_checker_dynamic": Case("dynculled", 16, checker, checker_cc,
                                     *full),
    }


def _sweep_launch(case, sweep: int, planes=None):
    """The case's culled or dynamic culled kernel in sweep form
    ``sweep``, over its lane planes or ``planes``."""
    from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk
    from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as dk

    planes = case.planes if planes is None else planes
    if case.kind == "dynculled":
        return dk.fused_render_dynculled(case.tab, case.salts, case.cam,
                                         *planes, sweep=sweep)
    return bk.fused_render_baked(case.baked, case.salts, case.cam, *planes,
                                 sweep=sweep)


def _same_render(a, b) -> bool:
    """Radiance words and all four counters equal."""
    return a[3].tolist() == b[3].tolist() and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(a[:3], b[:3]))


def _dyn_forms_vs_plain(device) -> list[dict]:
    """Both sweep forms of the dynamic culled kernel against its plain
    version at 160x90 (radiance words and the four counters bit for bit):
    terrain and book_checker at 4 spp, the knot at 2, and book_one_final
    with every sphere twice at 4 (each sphere hit an exact tie of two rows,
    which the smaller index must win)."""
    from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as dk

    book, book_cc = _smoke_scene()
    terrain, tris, terrain_cc = _terrain()
    knot, knot_tris, knot_cc = _knot()
    checker, _tris, checker_cc = _book_checker()
    specs = [("terrain", terrain, tris, terrain_cc, 4),
             ("knot50k", knot, knot_tris, knot_cc, 2),
             ("book_checker", checker, None, checker_cc, 4),
             ("book_one_final doubled", _doubled(book), None, book_cc, 4)]
    out = []
    for label, scene, t, cam, spp in specs:
        case = Case("dynculled", 16, scene, cam, 160, 90, spp, 1, {}, device,
                    triangles=t)
        rep = _check(f"dynculled16 {label} 160x90@{spp}spp sweep coop",
                     case)
        if not _same_render(_sweep_launch(case, dk.SWEEP_SERIAL),
                            case.kernel()):
            raise AssertionError(f"dynculled16 {label} 160x90: sweep form "
                                 f"serial differs from coop")
        rep["serial_bit_exact"] = True
        out.append(rep)
    return out


def _divergence(label, case, tables, window, lo, smi) -> dict:
    """How the warps of ``case``'s kernel diverge over its clusters,
    counted from the plain version (``warp_divergence`` of its module)
    over the lane planes ``window`` (its first lane ``lo``) of the case's
    frame, beside the kernel's own counters over the same window (they
    must agree on rays, loop trips, supers and clusters entered)."""
    from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk
    from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as dk

    module = dk if case.kind == "dynculled" else bk
    t0 = time.perf_counter()
    counts = module.warp_divergence(tables, case.salts, case.cam, *window)
    seconds = time.perf_counter() - t0
    stats = _sweep_launch(case, module.SWEEP_COOP, window)[3].tolist()
    supers = round(counts.get("supers_per_ray", stats[2] / max(stats[0], 1))
                   * counts["rays"])
    if (counts["rays"], counts["trips"], supers,
            round(counts["clusters_per_ray"] * counts["rays"])) != tuple(
            stats):
        raise AssertionError(f"{label}: divergence count {counts} disagrees "
                             f"with the kernel's counters {stats}")
    hist = counts["entering_lanes"]
    total = max(sum(hist), 1)
    shares = {"1": hist[0] / total, "2": hist[1] / total,
              "3-8": sum(hist[2:8]) / total,
              "9-12": sum(hist[8:12]) / total,
              "13-27": sum(hist[12:27]) / total,
              "28-32": sum(hist[27:32]) / total}
    n = window[0].numel()
    rep = {**counts, "lanes": [lo, lo + n], "entering_shares": shares,
           "kernel_stats": stats,
           "card_warp_fullness": stats[0] / (32 * stats[1]),
           "seconds": seconds}
    supers_note = ""
    if "super_boxes_per_ray" in counts:
        supers_note = (f", {counts['super_boxes_per_ray']} super boxes a "
                       f"ray, {counts['supers_per_ray']:.4f} supers entered "
                       f"a ray, {counts['union_supers_per_trip']:.4f} a "
                       f"warp trip")
    log(f"[divergence] {label} lanes {lo}..{lo + n} ({n // 1024} blocks of "
        f"32x32), plain version: {counts['rays']} rays in "
        f"{counts['trips']} warp trips (warps "
        f"{counts['warp_fullness']:.4f} full; the kernel's counters over "
        f"the window agree), {counts['clusters_per_ray']:.4f} clusters a "
        f"ray, {counts['union_clusters_per_trip']:.4f} union clusters a "
        f"trip, useful lane-pairs {counts['useful_pairs']} of "
        f"{counts['issued_pairs']} issued ({counts['useful_share']:.4f})"
        f"{supers_note}; lanes entering an entered (trip, cluster): "
        f"{json.dumps(shares)}; histogram 1..32 {hist} ({seconds:.1f} s) "
        f"[{smi}]")
    return rep


def _divergences(cells: dict, device, smi: str) -> dict:
    """The divergence count of the headline and of the two dynamic mesh
    rows over DIVERGENCE_WINDOWS at the middle of each lane order (the
    lanes that ``profile_frame --row NAME --divergence`` reads)."""
    out = {}
    for name, (blocks, spp) in DIVERGENCE_WINDOWS.items():
        case = cells[name]
        w, h = ((MAIN_WIDTH, MAIN_HEIGHT) if name == "headline"
                else MESH_SIZE)
        if spp != case.spp:
            scene, tris, cc = {"headline": _book, "terrain_dynamic": _terrain,
                               "knot50k_dynamic": _knot}[name]()
            case = Case(case.kind, 16, scene, cc, w, h, spp, 1, {}, device,
                        triangles=tris)
        lanes = blocks * 1024
        lo = case.planes[0].numel() // 2 // 1024 * 1024 - lanes // 2
        window = [p.reshape(-1)[lo:lo + lanes].reshape(-1, 128)
                  for p in case.planes]
        out[name] = _divergence(
            f"{name} {w}x{h}@{case.spp}spp", case,
            case.tab if case.kind == "dynculled" else case.baked, window,
            lo, smi)
    return out


def phase_sweep(device, smi: str) -> dict:
    """Each culled kernel's sweep forms at the cells that chose the
    shipped one: warm-up runs of each form, bit for bit against the serial
    form's (T = 0: the per-thread sweep), then CUDA-event times of one
    launch each in turns (serial, cooperative, cooperative, serial), each
    run printed with the serial runs' spread; the dynamic kernel's forms
    against its plain version at 160x90; then the divergence counts."""
    from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk

    forms = {"serial": bk.SWEEP_SERIAL, "coop": bk.SWEEP_COOP}
    out = {}
    order = ["serial", "coop", "coop", "serial"]
    cells = {}
    all_cells = _sweep_cells(device)
    for cell, case in all_cells.items():
        ref = _sweep_launch(case, bk.SWEEP_SERIAL)
        for name, sweep in forms.items():
            if not _same_render(_sweep_launch(case, sweep), ref):
                raise AssertionError(f"{cell}: sweep form {name} differs "
                                     f"from the serial form")
        runs = {name: [] for name in forms}
        for name in order:
            ms, _ = _time_ms(lambda: _sweep_launch(case, forms[name]), 1)
            runs[name].append(ms)
        mean = {name: sum(v) / len(v) for name, v in runs.items()}
        serial = runs["serial"]
        spread = max(serial) - min(serial)
        stats = ref[3].tolist()
        rep = {"kind": case.kind, "spp": case.spp, "runs": runs,
               "order": order, "mean_ms": mean,
               "serial_spread_ms": spread, "stats": stats,
               "warp_fullness": stats[0] / (32 * stats[1]),
               "vs_serial": {n: m / mean["serial"] for n, m in mean.items()},
               "coop_within_spread":
                   mean["coop"] - mean["serial"] <= spread,
               **case.bound(stats)}
        w, h = ((MAIN_WIDTH, MAIN_HEIGHT) if case.n_pixels
                == MAIN_WIDTH * MAIN_HEIGHT else MESH_SIZE)
        turns = ", ".join(f"{n} {runs[n][order[:i].count(n)]!r}"
                          for i, n in enumerate(order))
        ratios = {n: round(v, 4) for n, v in rep["vs_serial"].items()}
        log(f"[sweep] {cell} {w}x{h}@{case.spp}spp {case.kind}16, runs in "
            f"turn (ms): {turns}; serial spread {spread!r} ms "
            f"({spread / mean['serial']:.4%}); mean vs serial "
            f"{json.dumps(ratios)}; bound {rep['bound_ms']!r} ms "
            f"({rep['bound_by']}); rays {stats[0]}, warps "
            f"{rep['warp_fullness']:.4f} full, supers {stats[2]}, clusters "
            f"{stats[3]}, every form bit-identical to serial [{smi}]")
        cells[cell] = rep
    out["cells"] = cells
    out["dyn_vs_plain"] = _dyn_forms_vs_plain(device)
    out["divergence"] = _divergences(all_cells, device, smi)
    return out


def _loop_forms(case) -> dict:
    """The loop forms of ``case``'s unculled kernel, the per-thread one
    (``lane``) first: the persistent kernel's ``loop`` or the unculled
    baked kernel's ``sweep``."""
    from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk
    from wavefront_path_tracer_tpu_torch.ops import fused_kernels as fk

    if case.kind == "persistent":
        return {"lane": fk.LOOP_LANE, "warp": fk.LOOP_WARP}
    return {"lane": bk.SWEEP_SERIAL, "warp": bk.SWEEP_COOP}


def _loop_launch(case, form: int, planes=None, salts=None):
    """``case``'s unculled kernel in loop form ``form``, over its lane
    planes and salts or the given ones."""
    from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk
    from wavefront_path_tracer_tpu_torch.ops import fused_kernels as fk

    planes = case.planes if planes is None else planes
    salts = case.salts if salts is None else salts
    if case.kind == "persistent":
        return fk.fused_render_persistent(case.tables[0], case.n_spheres,
                                          salts, case.cam, *planes, loop=form)
    return bk.fused_render_baked(case.baked, salts, case.cam, *planes,
                                 sweep=form)


def _loop_vs_plain(device) -> list[dict]:
    """Every loop form of the two unculled kernels against the plain
    version, radiance words and the four counters bit for bit: at 160x90@4
    spp the persistent kernel on book_one_final and on the book with every
    sphere twice (exact ties), the unculled baked kernel on book_one_final,
    book_checker (textured) and terrain (5,000 triangles); at the main
    paths' planes (1920x1080@1spp) both kernels on book_one_final."""
    book, book_cc = _smoke_scene()
    checker, _tris, checker_cc = _book_checker()
    terrain, tris, terrain_cc = _terrain()
    specs = [("persistent", "book_one_final", book, None, book_cc, 160, 90,
              4),
             ("persistent", "book_one_final doubled", _doubled(book), None,
              book_cc, 160, 90, 4),
             ("unculled", "book_one_final", book, None, book_cc, 160, 90, 4),
             ("unculled", "book_checker", checker, None, checker_cc, 160, 90,
              4),
             ("unculled", "terrain", terrain, tris, terrain_cc, 160, 90, 4),
             ("persistent", "book_one_final", book, None, book_cc,
              MAIN_WIDTH, MAIN_HEIGHT, 1),
             ("unculled", "book_one_final", book, None, book_cc, MAIN_WIDTH,
              MAIN_HEIGHT, 1)]
    out = []
    for kind, name, scene, t, cam, w, h, spp in specs:
        case = Case(kind, 0, scene, cam, w, h, spp, 1, {}, device,
                    triangles=t)
        p = _PLAIN_OUT.get(case.key)
        if p is None:
            p = _PLAIN_OUT[case.key] = case.plain()
        forms = _loop_forms(case)
        same = {f: _same_render(_loop_launch(case, form), p)
                for f, form in forms.items()}
        torch.cuda.synchronize()
        label = f"{kind} {name} {w}x{h}@{spp}spp"
        log(f"[loop-vs-plain] {label}: bit for bit with the plain version "
            f"{json.dumps(same)}; stats {p[3].tolist()}")
        if not all(same.values()):
            raise AssertionError(f"{label}: a loop form differs from the "
                                 f"plain version: {same}")
        out.append({"case": label, "forms": same, "stats": p[3].tolist()})
    return out


def _loop_cells(device) -> dict:
    """The cells that time the unculled kernels' loop forms, 50 bounces:
    the persistent and the unculled kernel on book_one_final and the
    unculled on book_checker at 1920x1080@32spp, the unculled on terrain
    at 800x448@32spp (profile_frame LOOP_CELLS)."""
    book, book_cc = _smoke_scene()
    checker, _tris, checker_cc = _book_checker()
    terrain, tris, terrain_cc = _terrain()
    full = (MAIN_WIDTH, MAIN_HEIGHT, MAIN_SPP, 1, {}, device)
    return {
        "persistent_book": Case("persistent", 0, book, book_cc, *full),
        "unculled_book": Case("unculled", 0, book, book_cc, *full),
        "unculled_book_checker": Case("unculled", 0, checker, checker_cc,
                                      *full),
        "unculled_terrain": Case("unculled", 0, terrain, terrain_cc,
                                 *MESH_SIZE, MAIN_SPP, 1, {}, device,
                                 triangles=tris),
    }


def phase_loop(device, smi: str) -> dict:
    """The unculled kernels' loop forms (per thread, trace_lane; in step,
    trace_warp, with the triangle rows staged): every form against the
    plain version at 160x90 and the main paths' planes; then at each cell
    warm-up runs of every form, bit for bit with the lane form's, and
    CUDA-event times of one launch each in turns (lane, warp, warp, lane),
    each run printed with the lane runs' spread, the bound and the warps'
    fullness; and the count model on the
    card: the trips of the loop of trips (the kernel's iterations) beside
    those of a loop that regroups its lanes at every sample end (the sum of
    the iterations of one launch a sample)."""
    out = {"vs_plain": _loop_vs_plain(device), "cells": {}}
    for cell, case in _loop_cells(device).items():
        forms = _loop_forms(case)
        ref = _loop_launch(case, forms["lane"])
        for name, form in forms.items():
            if not _same_render(_loop_launch(case, form), ref):
                raise AssertionError(f"{cell}: loop form {name} differs from "
                                     f"the lane form")
        order = ["lane", "warp", "warp", "lane"]
        runs = {name: [] for name in forms}
        for name in order:
            ms, _ = _time_ms(lambda: _loop_launch(case, forms[name]), 1)
            runs[name].append(ms)
        mean = {name: sum(v) / len(v) for name, v in runs.items()}
        lane = runs["lane"]
        spread = max(lane) - min(lane)
        stats = ref[3].tolist()
        frame, base, bounces, n = case.salts
        by_sample = sum(
            int(_loop_launch(case, forms["warp"],
                             salts=(frame, base + s, bounces, 1))[3][1])
            for s in range(n))
        rep = {"kind": case.kind, "spp": case.spp, "runs": runs,
               "order": order, "mean_ms": mean, "lane_spread_ms": spread,
               "vs_lane": {f: m / mean["lane"] for f, m in mean.items()},
               "stats": stats, "warp_fullness": stats[0] / (32 * stats[1]),
               "sample_trips": by_sample,
               "model_warp_over_lane": stats[1] / by_sample,
               **case.bound(stats)}
        w, h = ((MAIN_WIDTH, MAIN_HEIGHT) if case.n_pixels
                == MAIN_WIDTH * MAIN_HEIGHT else MESH_SIZE)
        seen = {f: 0 for f in forms}
        turns = []
        for f in order:
            turns.append(f"{f} {runs[f][seen[f]]!r}")
            seen[f] += 1
        ratios = {f: round(v, 4) for f, v in rep["vs_lane"].items()}
        log(f"[loop] {cell} {w}x{h}@{case.spp}spp {case.kind}, runs in turn "
            f"(ms): {', '.join(turns)}; lane spread {spread!r} ms "
            f"({spread / mean['lane']:.4%}); mean vs lane "
            f"{json.dumps(ratios)}; bound {rep['bound_ms']!r} ms "
            f"({rep['bound_by']}); rays {stats[0]}, loop trips {stats[1]} "
            f"(warps {rep['warp_fullness']:.4f} full), trips regrouped at "
            f"every sample end {by_sample} (model warp / lane "
            f"{rep['model_warp_over_lane']:.4f}); every form bit-identical "
            f"to lane [{smi}]")
        out["cells"][cell] = rep
    return out


# The cells that time the segment kernels' forms (phase segform), at
# recluster 2 and 50 bounces: (name, kind, clusters, scene, size, spp).
# The unculled kernel is timed on the book at 1 spp and on terrain (its
# triangle rows staged in the form in step) at 1 spp.
SEGFORM_CELLS = (
    ("knot50k_dynamic", "dynculled", 16, "knot", MESH_SIZE, 8),
    ("terrain_dynamic", "dynculled", 16, "terrain", MESH_SIZE, MAIN_SPP),
    ("headline", "culled", 16, "book", (MAIN_WIDTH, MAIN_HEIGHT), MAIN_SPP),
    ("terrain_baked", "culled", 16, "terrain", MESH_SIZE, MAIN_SPP),
    ("unculled_book", "unculled", 0, "book", (MAIN_WIDTH, MAIN_HEIGHT), 1),
    ("unculled_terrain", "unculled", 0, "terrain", MESH_SIZE, 1),
)


def phase_segform(device, smi: str) -> dict:
    """The segment kernels' two forms (each lane on its own thread,
    trace_segment; the warp's lanes in step, trace_segment_warp, the
    shipped one) at SEGFORM_CELLS: both forms' frames bit for bit with each
    other, then one whole frame of segment launches in each form in turns
    (serial, in step, in step, serial), every launch timed by CUDA events,
    the frame's launches summed by their index in the segment schedule;
    each run, the serial runs' spread and the frame's bound printed."""
    scenes = {"book": _book, "terrain": _terrain, "knot": _knot}
    order = ["serial", "coop", "coop", "serial"]
    out = {}
    for cell, kind, clusters, scene_name, (w, h), spp in SEGFORM_CELLS:
        scene, tris, cam = scenes[scene_name]()
        case = SegCase(kind, clusters, scene, cam, w, h, spp, {}, device,
                       triangles=tris)
        ref = case.timed_frame("serial")                # warm-up, both
        coop = case.timed_frame("coop")
        if coop[1] != ref[1] or not torch.equal(
                coop[0].view(torch.int32), ref[0].view(torch.int32)):
            raise AssertionError(f"segform {cell}: the forms differ")
        runs = {name: [] for name in case.forms}
        by_index = {name: [] for name in case.forms}
        n_seg = case.segments
        for name in order:
            ms = case.timed_frame(name)[2]
            runs[name].append(sum(ms))
            by_index[name].append([sum(ms[i::n_seg]) for i in range(n_seg)])
        mean = {n: sum(v) / len(v) for n, v in runs.items()}
        mean_index = {n: [sum(col) / len(col) for col in zip(*v)]
                      for n, v in by_index.items()}
        serial = runs["serial"]
        spread = max(serial) - min(serial)
        stats = ref[1]
        bound = case.bound(stats)
        rep = {"kind": kind, "spp": spp, "size": [w, h], "runs": runs,
               "order": order, "mean_ms": mean, "serial_spread_ms": spread,
               "by_index_ms": by_index, "mean_by_index_ms": mean_index,
               "schedule": list(_schedule(case.cfg)),
               "coop_over_serial": mean["coop"] / mean["serial"],
               "coop_over_serial_by_index": [
                   c / max(s, 1e-9) for c, s in zip(mean_index["coop"],
                                                    mean_index["serial"])],
               "stats": stats, **bound,
               "over_bound": {n: m / bound["bound_ms"]
                              for n, m in mean.items()}}
        turns = ", ".join(f"{n} {runs[n][order[:i].count(n)]!r}"
                          for i, n in enumerate(order))
        log(f"[segform] {cell} {w}x{h}@{spp}spp {kind}{clusters or ''} "
            f"recluster 2, 50 bounces: frame of segment launches in turn "
            f"(ms): {turns}; serial spread {spread!r} ms "
            f"({spread / mean['serial']:.4%}); in step / serial "
            f"{rep['coop_over_serial']:.4f}; by schedule index "
            f"{rep['schedule']}: serial "
            f"{[round(v, 3) for v in mean_index['serial']]}, in step "
            f"{[round(v, 3) for v in mean_index['coop']]} (ratios "
            f"{[round(v, 4) for v in rep['coop_over_serial_by_index']]}); "
            f"bound {bound['bound_ms']!r} ms ({bound['bound_by']}), serial "
            f"{rep['over_bound']['serial']:.1f}x and in step "
            f"{rep['over_bound']['coop']:.1f}x the bound; stats {stats}; "
            f"both forms bit-identical [{smi}]")
        out[cell] = rep
    return out


# Phase oracle: the same-stream rows of golden/GATE_SWEEP.json (the
# flags of exp/gate_sweep.py's SAME_STREAM, the variant against the
# megakernel oracle, both on the card at 400x224@64 spp, 50 bounces).
ORACLE_TPU = os.path.join(ROOT, "golden", "oracle_tpu_same_stream.npz")
ORACLE_GATE = 2e-3
SS_SIZE = ("--width", "400", "--height", "224", "--spp", "64")
BAKED16 = ("--intersector", "baked", "--clusters", "16")
DYN16 = ("--intersector", "bruteforce", "--clusters", "16")
SAME_STREAM_ROWS = (
    ("baked_cull16", BAKED16, 2e-3),
    ("dynculled", DYN16, 2e-3),
    ("winner_hint", BAKED16 + ("--winner-hint",), 2e-3),
    ("lane_split2", BAKED16 + ("--lane-split", "2"), 2e-3),
    ("rotate_cols2", BAKED16 + ("--rotate-cols", "2"), 2e-3),
    ("recluster2", BAKED16 + ("--recluster", "2"), 2e-3),
    ("recluster2_dyn", DYN16 + ("--recluster", "2"), 2e-3),
    ("stratified_ss", BAKED16 + ("--sampler", "stratified"), 2e-3),
    ("negradius_baked", ("--scene", "book_bubble") + BAKED16, 2e-3),
    ("textures_baked", ("--scene", "book_checker") + BAKED16, 3e-3),
    ("textures_dyn", ("--scene", "book_checker") + DYN16, 3e-3),
)
# The twelfth same-stream row, wavefront_matsplit, runs apart from these:
# it reads 0.0 against the card's megakernel.
# The mesh readings: fused against the megakernel at 200x112@8 spp (the
# megakernel sweeps every triangle for every ray: 40 blocks of 128 a
# bounce on terrain and on the cut-down knot).
MESH_READ = (200, 112, 2)
MESH_READ_ROWS = (
    ("terrain_baked", "terrain", {"intersector": "baked",
                                  "baked_clusters": 16}),
    ("terrain_dynamic", "terrain", {"intersector": "bruteforce",
                                    "baked_clusters": 16}),
    ("knot5k_dynamic", "knot5k", {"intersector": "bruteforce",
                                  "baked_clusters": 16}),
)


def _agreement(test, oracle_display) -> dict:
    """The parity rule's metrics of a render against an oracle's display
    image (squared back to sample-averaged radiance)."""
    from wavefront_path_tracer_tpu_torch.utils.parity import parity_report

    oracle = np.asarray(oracle_display, np.float64) ** 2
    return parity_report(test.accumulated / test.samples, oracle)


def _validate(argv) -> dict:
    """``validate.run`` on the card, the row's seconds added."""
    from wavefront_path_tracer_tpu_torch import validate

    t0 = time.perf_counter()
    out = validate.run(list(argv) + ["--device", "cuda"])
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_oracle(device, smi: str, part=None) -> dict:
    """Phase 17 (``oracle``): the port's megakernel against the TPU's
    same-stream oracle, the same-stream rows, the mesh readings and the
    cached-golden validate flow; every failure is raised at the end.
    ``part`` "tpu": the oracle, the rows on its scene and sampler,
    wavefront_matsplit and the cached-golden flow; "scenes": the rows
    that have an oracle of their own (stratified, book_bubble,
    book_checker) and the mesh readings; both when None."""
    failures = []
    out = {"rows": {}, "mesh": {}}
    # The TPU's readings of the rows, printed beside the card's.
    with open(os.path.join(ROOT, "golden", "GATE_SWEEP.json")) as f:
        tpu = {r["name"]: r["rmse"] for r in json.load(f)["rows"]}
    run_tpu, run_scenes = part in (None, "tpu"), part in (None, "scenes")
    caches = {}
    for name in ((("book_one_final",) if run_tpu else ()) + ((
            "book_one_final_stratified", "book_bubble", "book_checker")
            if run_scenes else ())):
        caches[name] = os.path.join(OUT_DIR, f"oracle_cuda_{name}.npz")
        if os.path.exists(caches[name]):
            os.remove(caches[name])
    if run_tpu:
        _oracle_tpu(out, caches, failures, smi)
    for name, flags, gate in SAME_STREAM_ROWS:
        scene = flags[1] if flags[0] == "--scene" else "book_one_final"
        key = scene + ("_stratified" if "stratified" in flags else "")
        if key in caches:
            _oracle_row(out, caches[key], name, flags, gate, tpu, failures,
                        smi)
    if run_tpu:
        _oracle_matsplit(out, caches, tpu, failures, smi)
    if run_scenes:
        _oracle_mesh(out, device, smi)
    if run_tpu:
        # validate's cached-golden flow.
        res = _validate(("--spp", "1000", "--engine", "fused",
                         "--intersector", "baked", "--clusters", "16",
                         "--oracle-cache", GOLDEN))
        out["golden"] = {**res["row"], "seconds": res["seconds"]}
        log(f"[oracle] validate cached golden: {json.dumps(res['row'])} in "
            f"{res['seconds']:.2f} s [{smi}]")
        if not res["row"]["pass"]:
            failures.append(f"golden RMSE {res['row']['rmse']} >= 1e-3")
    shares = [r["diverged_share"] for name, r in out["rows"].items()
              if name != "wavefront_matsplit"]
    log(f"[oracle] F4: diverged share of the fused rows against the "
        f"megakernel at 50 bounces, 64 spp: {min(shares)!r} to "
        f"{max(shares)!r} [{smi}]")
    if failures:
        raise AssertionError("phase oracle: " + "; ".join(failures))
    return out


def _oracle_tpu(out, caches, failures, smi) -> None:
    """The oracle itself, against the JAX megakernel's TPU render; its
    render becomes the oracle of the rows on its scene and sampler."""
    res = _validate(SS_SIZE + ("--engine", "megakernel", "--intersector",
                               "bruteforce", "--oracle-cache", ORACLE_TPU,
                               "--gate", repr(ORACLE_GATE)))
    row, test = res["row"], res["test"]
    agree = _agreement(test, res["oracle_image"])
    out["oracle"] = {**row, "seconds": res["seconds"],
                     "render_seconds": test.wall_time_s,
                     "rays": test.rays_traced, **agree}
    log(f"[oracle] megakernel book_one_final 400x224@64spp, 50 bounces: "
        f"display RMSE {row['rmse']!r} against the TPU megakernel "
        f"(gate {ORACLE_GATE}); diverged share {agree['diverged_share']!r}, "
        f"|mean diff| {agree['mean_diff']!r}; render "
        f"{test.wall_time_s:.3f} s, {test.rays_traced:.0f} rays "
        f"({test.mrays_per_s:.2f} Mrays/s) [{smi}]")
    if not row["pass"]:
        failures.append(f"oracle RMSE {row['rmse']} >= {ORACLE_GATE}")
    # validate's metadata is the TPU artifact's.
    np.savez_compressed(caches["book_one_final"], image=test.image,
                        meta=np.load(ORACLE_TPU)["meta"],
                        platform=np.asarray("cuda"))


def _oracle_row(out, cache, name, flags, gate, tpu, failures, smi) -> None:
    """One same-stream row against the card's megakernel (rendered into
    ``cache`` where it is not there yet)."""
    res = _validate(SS_SIZE + flags + (
        "--engine", "fused", "--gate", repr(gate), "--oracle-spf", "64",
        "--oracle-cache", cache))
    row, test = res["row"], res["test"]
    agree = _agreement(test, res["oracle_image"])
    out["rows"][name] = {**row, "seconds": res["seconds"], **agree}
    log(f"[oracle] {name}: {row['engine']} on {row['scene']} "
        f"{row['config']} against {row['oracle']}: display RMSE "
        f"{row['rmse']!r} (gate {gate}; TPU "
        f"{tpu[name]!r}), diverged share "
        f"{agree['diverged_share']!r}, |mean diff| "
        f"{agree['mean_diff']!r}; {res['seconds']:.2f} s with the "
        f"oracle's render where not cached [{smi}]")
    if not row["pass"]:
        failures.append(f"{name}: RMSE {row['rmse']} >= {gate}")


def _oracle_matsplit(out, caches, tpu, failures, smi) -> None:
    """wavefront_matsplit against the card's megakernel and the TPU's."""
    from wavefront_path_tracer_tpu_torch.utils.image import rmse

    # wavefront_matsplit: the wavefront engine with material_split holds
    # the megakernel's streams and arithmetic, so it must read 0.0 against
    # the card's megakernel, and stay under its row's gate against the TPU
    # render (which the card's megakernel is held to above).
    res = _validate(SS_SIZE + (
        "--engine", "wavefront", "--intersector", "bruteforce",
        "--material-split", "--gate", repr(ORACLE_GATE), "--oracle-spf",
        "64", "--oracle-cache", caches["book_one_final"]))
    row, test = res["row"], res["test"]
    tpu_rmse = rmse(test.image, np.load(ORACLE_TPU)["image"])
    out["rows"]["wavefront_matsplit"] = {
        **row, "seconds": res["seconds"], "rays": test.rays_traced,
        "tpu_rmse": tpu_rmse, **_agreement(test, res["oracle_image"])}
    log(f"[oracle] wavefront_matsplit: {row['engine']} on {row['scene']} "
        f"{row['config']} against {row['oracle']}: display RMSE "
        f"{row['rmse']!r} (must be 0.0; TPU {tpu['wavefront_matsplit']!r}); "
        f"against the TPU megakernel {tpu_rmse!r} (gate {ORACLE_GATE}); "
        f"render {test.wall_time_s:.3f} s, {test.rays_traced:.0f} rays "
        f"({test.mrays_per_s:.3f} Mrays/s) [{smi}]")
    if row["rmse"] != 0.0:
        failures.append(f"wavefront_matsplit: RMSE {row['rmse']} against "
                        "the card's megakernel, not 0.0")
    if not tpu_rmse < ORACLE_GATE:
        failures.append(f"wavefront_matsplit: RMSE {tpu_rmse} >= "
                        f"{ORACLE_GATE} against the TPU megakernel")


def _oracle_mesh(out, device, smi) -> None:
    """The mesh rows' scenes, fused against the megakernel: readings."""
    from wavefront_path_tracer_tpu_torch.renderer import Renderer
    from wavefront_path_tracer_tpu_torch.scene import knot_camera, knot_scene
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
    from wavefront_path_tracer_tpu_torch.utils.image import rmse

    w, h, spp = MESH_READ
    scenes = {"terrain": _terrain(),
              "knot5k": knot_scene(5000) + (knot_camera(),)}
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                       samples_per_frame=spp, max_bounces=50)
    mk = {}
    for scene_name, (scene, tris, cam) in scenes.items():
        t0 = time.perf_counter()
        mk[scene_name] = Renderer(scene, cam, cfg.replace(
            engine="megakernel", intersector="bruteforce"), tris,
            device=device).render()
        log(f"[oracle] megakernel {scene_name} ({len(tris.v0)} triangles) "
            f"{w}x{h}@{spp}spp: {time.perf_counter() - t0:.2f} s, "
            f"{mk[scene_name].rays_traced:.0f} rays")
    for name, scene_name, kw in MESH_READ_ROWS:
        scene, tris, cam = scenes[scene_name]
        test = Renderer(scene, cam, cfg.replace(engine="fused", **kw), tris,
                        device=device).render()
        oracle = mk[scene_name]
        agree = _agreement(test, oracle.image)
        rep = {"display_rmse": rmse(test.image, oracle.image),
               "rays": test.rays_traced, "oracle_rays": oracle.rays_traced,
               **agree}
        out["mesh"][name] = rep
        log(f"[oracle] mesh reading {name} {w}x{h}@{spp}spp fused against "
            f"the megakernel: display RMSE {rep['display_rmse']!r}, "
            f"diverged share {agree['diverged_share']!r}, |mean diff| "
            f"{agree['mean_diff']!r}, rays {test.rays_traced:.0f} against "
            f"{oracle.rays_traced:.0f} (no gate) [{smi}]")


# Phase wavefront: the wavefront engine and the BVH (plain PyTorch on the
# card, models/wavefront.py and ops/bvh_traverse.py), held bit for bit to
# the megakernel.
WF_SIZE = (400, 224, 4)
WF_BVH_SIZE = (200, 112, 2)
WF_BVH_TERRAIN_SIZE = (100, 56, 2)
WF_RATE_SIZE = (400, 224, 2)
WF_CASES = (("bruteforce", {}), ("ray_chunk", {"ray_chunk": 16384}),
            ("material_split", {"material_split": True}),
            ("roulette", {"rr_start_bounce": 5}))


def _renders_identical(a, b) -> bool:
    """Two renders' radiance words and ray counts are identical."""
    return (np.array_equal(a.accumulated.view(np.uint32),
                           b.accumulated.view(np.uint32))
            and a.rays_traced == b.rays_traced)


def _render_timed(scene, tris, cam, cfg, device):
    from wavefront_path_tracer_tpu_torch.renderer import Renderer

    r = Renderer(scene, cam, cfg, tris, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = r.render()
    res.seconds = time.perf_counter() - t0
    return res


def _traversal_checks(scene, cam, device, smi) -> dict:
    """One BVH nearest-hit call on a 400x224 frame's primary rays, with
    the unfinished lanes read back every step, every CHECK_EVERY steps
    (the shipped interval) and every 64: the same bits, and the time of
    each by CUDA events."""
    from wavefront_path_tracer_tpu_torch.ops import bvh_traverse
    from wavefront_path_tracer_tpu_torch.ops.raygen import generate_rays
    from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    w, h, _spp = WF_SIZE
    cfg = RenderConfig(width=w, height=h, intersector="bvh",
                       engine="wavefront")
    arrays = prepare_scene(scene, cfg, device)
    pix = torch.arange(w * h, device=device)
    view = torch.as_tensor(cam.view_matrix(), device=device)
    inv_proj = torch.as_tensor(cam.inverse_projection(w, h), device=device)
    o, d = generate_rays(pix, w, h, 0, 0, cam.gpu_camera(), view, inv_proj)
    tables = [arrays[k] for k in ("centers", "radii", "bvh_min", "bvh_max",
                                  "bvh_left_first", "bvh_prim_count")]
    shipped = bvh_traverse.CHECK_EVERY
    out, ref = {}, None
    try:
        for every in (1, shipped, 64):
            bvh_traverse.CHECK_EVERY = every
            bvh_traverse.intersect_bvh(o, d, *tables)            # warm
            ms, res = _time_ms(lambda: bvh_traverse.intersect_bvh(
                o, d, *tables, check_depth_first=False), 3)
            if ref is None:
                ref = res
            elif not all(torch.equal(x, y) for x, y in zip(res, ref)):
                raise AssertionError(f"traversal with CHECK_EVERY={every} "
                                     "differs from every step")
            out[every] = ms
    finally:
        bvh_traverse.CHECK_EVERY = shipped
    log(f"[wavefront] BVH traversal of {w}x{h} primary rays "
        f"(book_one_final, {int(ref[2].sum())} hits): "
        + ", ".join(f"read back every {k} steps {v:.3f} ms"
                    for k, v in out.items())
        + f"; bit-identical [{smi}]")
    return {str(k): v for k, v in out.items()}


def phase_wavefront(device, smi: str) -> dict:
    """Phase ``wavefront``: the wavefront engine against the megakernel,
    bit for bit (radiance words and rays) on book_one_final at
    400x224@4spp, 50 bounces, with brute force, ray_chunk 16384,
    material_split and roulette from bounce 5; the BVH on both engines,
    bit for bit with each other, at 200x112@2spp, and against brute force
    by the parity rule; terrain's triangle BVH against brute force by the
    parity rule; the traversal's read-back interval; one --stage-timing
    CLI run; the engine's Mrays/s with brute force and the BVH at
    400x224."""
    from wavefront_path_tracer_tpu_torch import cli
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
    from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

    scene, _none, cam = _book()
    failures, out = [], {"bit": {}, "parity": {}}
    w, h, spp = WF_SIZE
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                       samples_per_frame=spp, max_bounces=50,
                       intersector="bruteforce")
    _render_timed(scene, None, cam, cfg.replace(
        width=32, height=16, engine="wavefront"), device)       # warm
    mk = {}
    for name, kw in WF_CASES:
        key = "roulette" if "rr_start_bounce" in kw else "default"
        if key not in mk:
            mk[key] = _render_timed(scene, None, cam, cfg.replace(
                engine="megakernel", **kw), device)
        wf = _render_timed(scene, None, cam, cfg.replace(
            engine="wavefront", **kw), device)
        same = _renders_identical(wf, mk[key])
        out["bit"][name] = {"same": same, "rays": wf.rays_traced,
                            "seconds": wf.seconds,
                            "mrays_per_s": wf.mrays_per_s,
                            "megakernel_seconds": mk[key].seconds}
        log(f"[wavefront] {name}: wavefront vs megakernel book_one_final "
            f"{w}x{h}@{spp}spp, 50 bounces: bit-identical {same}, "
            f"{wf.rays_traced:.0f} rays; wavefront {wf.seconds:.3f} s "
            f"({wf.mrays_per_s:.3f} Mrays/s), megakernel "
            f"{mk[key].seconds:.3f} s [{smi}]")
        if not same:
            failures.append(f"{name}: wavefront differs from the megakernel")

    # The BVH on both engines, and against brute force.
    bw, bh, bspp = WF_BVH_SIZE
    sizes = {"book_one_final": WF_BVH_SIZE, "terrain": WF_BVH_TERRAIN_SIZE}
    renders = {}
    for label, scene_, tris, cam_ in (("book_one_final", scene, None, cam),
                                      ("terrain", *_terrain())):
        sw, sh, sspp = sizes[label]
        small = cfg.replace(width=sw, height=sh, samples_per_pixel=sspp,
                            samples_per_frame=sspp)
        for engine, intersector in (("wavefront", "bvh"),
                                    ("wavefront", "bruteforce"),
                                    ("megakernel", "bvh")):
            if label == "terrain" and engine == "megakernel":
                continue
            renders[label, engine, intersector] = _render_timed(
                scene_, tris, cam_, small.replace(
                    engine=engine, intersector=intersector), device)
    same = _renders_identical(renders["book_one_final", "wavefront", "bvh"],
                      renders["book_one_final", "megakernel", "bvh"])
    out["bit"]["bvh"] = {"same": same}
    log(f"[wavefront] bvh: wavefront vs megakernel book_one_final "
        f"{bw}x{bh}@{bspp}spp: bit-identical {same} [{smi}]")
    if not same:
        failures.append("bvh: wavefront differs from the megakernel")
    for label in ("book_one_final", "terrain"):
        bvh = renders[label, "wavefront", "bvh"]
        brute = renders[label, "wavefront", "bruteforce"]
        sw, sh, sspp = sizes[label]
        try:
            rep = check_parity(bvh.accumulated / sspp,
                               brute.accumulated / sspp, bvh.rays_traced,
                               brute.rays_traced)
        except AssertionError as exc:
            rep = {"failed": str(exc)}
            failures.append(f"{label}: bvh against bruteforce: {exc}")
        rep.update(bvh_seconds=bvh.seconds, bruteforce_seconds=brute.seconds,
                   bvh_mrays_per_s=bvh.mrays_per_s,
                   bruteforce_mrays_per_s=brute.mrays_per_s)
        out["parity"][label] = rep
        log(f"[wavefront] {label} {sw}x{sh}@{sspp}spp wavefront bvh vs "
            f"bruteforce: {rep}; bvh {bvh.seconds:.3f} s, bruteforce "
            f"{brute.seconds:.3f} s [{smi}]")

    out["traversal_ms"] = _traversal_checks(scene, cam, device, smi)

    # One --stage-timing CLI run of the wavefront engine.
    argv = ["--device", device.type, "--scene", "book_one_final",
            "--width", str(w), "--height", str(h), "--spp", "2", "--spf",
            "1", "--max-bounces", "50", "--engine", "wavefront",
            "--stage-timing", "--quiet",
            "--out", os.path.join(OUT_DIR, "smoke_wavefront_staged.png")]
    renderer, result = cli.run(argv)
    stages = renderer.stage_timer.averages_us()
    out["stage_us"] = stages
    log(f"[wavefront] cli {' '.join(argv[2:-3])}: kernels: "
        f"{renderer.stage_timer.report()} (running averages per call, us; "
        f"{result.rays_traced:.0f} rays in the last frame) [{smi}]")
    if set(stages) != {"generate", "extend", "shade", "miss", "compact"}:
        failures.append(f"stage timer stages {sorted(stages)}")

    # The engine's rate with brute force and with the BVH.
    rw, rh, rspp = WF_RATE_SIZE
    out["rate"] = {}
    for intersector in ("bruteforce", "bvh"):
        res = _render_timed(scene, None, cam, cfg.replace(
            width=rw, height=rh, samples_per_pixel=rspp,
            samples_per_frame=rspp, engine="wavefront",
            intersector=intersector), device)
        out["rate"][intersector] = {"mrays_per_s": res.mrays_per_s,
                                    "rays": res.rays_traced,
                                    "render_seconds": res.wall_time_s}
        log(f"[wavefront] rate: wavefront/{intersector} book_one_final "
            f"{rw}x{rh}@{rspp}spp, 50 bounces: {res.rays_traced:.0f} rays "
            f"in {res.wall_time_s:.3f} s = {res.mrays_per_s:.3f} Mrays/s "
            f"[{smi}]")
        if not (np.isfinite(res.accumulated).all()
                and res.accumulated.mean() > 0.01):
            failures.append(f"rate render {intersector}: bad image")
    if failures:
        raise AssertionError("phase wavefront: " + "; ".join(failures))
    return out


# Phase bench: the port's bench as a user runs it, at its defaults, and
# its sweep over every engine at a small size.
BENCH_ALL = ("--all", "--width", "160", "--height", "90", "--spp", "8")
BENCH_TIMEOUT = 600
UTILIZATION_MAX = 1.05


def _start_bench(argv) -> Child:
    return Child(["-m", "wavefront_path_tracer_tpu_torch.bench", *argv],
                 "bench " + " ".join(argv))


def _bench_result(child: Child) -> tuple:
    """(exit code, the JSON line, seconds) of a bench child, which is
    killed with its worker if it outlasts BENCH_TIMEOUT; its other lines
    go to standard error."""
    rc, text, seconds = child.wait(BENCH_TIMEOUT)
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    sys.stderr.write("".join(ln + "\n" for ln in text.splitlines()
                             if not ln.startswith("{")))
    sys.stderr.flush()
    if not lines:
        raise AssertionError(f"{child.label} printed no JSON line (rc {rc})")
    return rc, json.loads(lines[-1]), seconds


def _run_bench(argv) -> tuple:
    """(exit code, the JSON line, seconds) of the bench run as a child."""
    return _bench_result(_start_bench(argv))


def _bench_row_failures(label: str, row: dict, kind: str) -> list:
    """What is wrong with one fused row of the bench's line."""
    bad = []
    forms = row.get("forms", {})
    if not forms.get(kind) or forms.get(SHIPPED[kind]) != forms[kind]:
        bad.append(f"{label}: forms {forms} (want {kind} launches, all "
                   f"{SHIPPED[kind]})")
    counters = row.get("counters", {})
    for key in ("rays", "iterations", "clusters_entered"):
        if not counters.get(key, 0) > 0:
            bad.append(f"{label}: counter {key} = {counters.get(key)}")
    util = row.get("device_utilization")
    if util is None or not 0 < util <= UTILIZATION_MAX:
        bad.append(f"{label}: device_utilization {util}")
    if not (row.get("value") or 0) > 0:
        bad.append(f"{label}: value {row.get('value')}")
    return bad


def phase_bench(device, smi: str, all_child: Child | None = None) -> dict:
    """Phase ``bench``: the bench at its defaults, then ``--all`` small
    (``all_child``: that run, started beside the first phases)."""
    from wavefront_path_tracer_tpu_torch.bench import MESH_ROWS

    rc, line, seconds = _run_bench([])
    log(f"[bench] {json.dumps(line)}")
    log(f"[bench] default run: exit {rc} in {seconds:.1f} s [{smi}]")
    failures = []
    if rc != 0 or "error" in line:
        failures.append(f"exit {rc}, error {line.get('error')}")
    failures += _bench_row_failures("headline", line, "culled")
    mesh = line.get("mesh", {})
    for key, _scene, _w, _h, _spp, intersector in MESH_ROWS:
        row = mesh.get(key)
        if row is None or "error" in row:
            failures.append(f"mesh row {key}: {row}")
            continue
        failures += _bench_row_failures(
            key, row, "culled" if intersector == "baked" else "dynculled")
    beside = "" if all_child is None else ", beside the first phases"
    rc_all, line_all, all_seconds = _bench_result(
        all_child or _start_bench(list(BENCH_ALL)))
    for row in line_all.get("all", []):
        log(f"[bench] --all {row.get('config')}: "
            + (f"FAILED {row['error']}" if "error" in row else
               f"{row['mrays_per_s']:.3f} Mrays/s, {row['rays']:.0f} rays "
               f"in {row['seconds']:.3f} s") + f"{beside} [{smi}]")
    log(f"[bench] {' '.join(BENCH_ALL)}: exit {rc_all} in "
        f"{all_seconds:.1f} s{beside}; best {line_all.get('metric')} "
        f"{line_all.get('value')} [{smi}]")
    rows = line_all.get("all", [])
    if rc_all != 0 or len(rows) != 6 or any("error" in r for r in rows):
        failures.append(f"--all: exit {rc_all}, rows {rows}")
    if failures:
        raise AssertionError("phase bench: " + "; ".join(failures))
    return {"default": line, "seconds": seconds, "all": line_all,
            "all_seconds": all_seconds}


# Phase app: the interactive session, the AOVs, the live window and the
# checkpoints on the card.
APP_SIZE = (400, 224)


def _http_get(port: int, path: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read()


def phase_app(device, smi: str) -> dict:
    """Phase ``app``: the session, the AOVs against the CPU's, a frame of
    the card through the preview server, and checkpoint/resume."""
    from wavefront_path_tracer_tpu_torch import cli
    from wavefront_path_tracer_tpu_torch.aov import render_aovs
    from wavefront_path_tracer_tpu_torch.app import (
        InteractiveSession,
        final_image,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
    from wavefront_path_tracer_tpu_torch.utils.image import (
        display_transform,
        read_png,
        to_u8,
    )
    from wavefront_path_tracer_tpu_torch.utils.parity import check_parity
    from wavefront_path_tracer_tpu_torch.utils.preview_server import (
        PreviewServer,
    )

    out, failures = {}, []
    w, h = APP_SIZE
    scene, _none, cam = _book()
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=8,
                       samples_per_frame=2, max_bounces=50, engine="fused",
                       intersector="bruteforce")

    # The session: two frames, a camera move (accumulation restarts).
    session = InteractiveSession(scene, cam, cfg, device=device)
    session.step()                                     # warm-up
    session.renderer.reset_accumulation()
    _reset_launches()
    samples = [session.step().samples, session.step().samples]
    pos = session.camera.camera.position.copy()
    session.key_event("w", True)
    moved = session.step()
    session.key_event("w", False)
    launches = _read_launches()
    samples.append(moved.samples)
    image = final_image(session)
    out["session"] = {"samples": samples, "launches": launches,
                      "mrays_per_s": moved.mrays_per_s}
    log(f"[app] session book_one_final {w}x{h}, 2 spp a frame: samples "
        f"{samples} (a camera move restarts at 2), camera moved "
        f"{not np.allclose(pos, session.camera.camera.position)}, "
        f"{launches['persistent']} persistent launches, "
        f"{moved.mrays_per_s:.1f} Mrays/s [{smi}]")
    if samples != [2, 4, 2] or np.allclose(pos,
                                           session.camera.camera.position):
        failures.append(f"session samples {samples}")
    if launches["persistent"] != 3:
        failures.append(f"session launches {launches}")
    _require_shipped("session", "persistent", launches)
    if image is None or not np.isfinite(image).all() or image.shape != (
            h, w, 3):
        failures.append("session final image")

    # The AOVs on the card against the CPU's.
    aov_cfg = cfg.replace(samples_per_pixel=4, samples_per_frame=4)
    t0 = time.perf_counter()
    card = render_aovs(scene, cam, aov_cfg, device=device)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = render_aovs(scene, cam, aov_cfg, device="cpu")
    host_s = time.perf_counter() - t0
    out["aov"] = {"seconds": card_s, "cpu_seconds": host_s}
    planes = {"albedo": (card["albedo"], host["albedo"]),
              "normal": (card["normal"] * 0.5 + 0.5,
                         host["normal"] * 0.5 + 0.5),
              "coverage": (card["coverage"][..., None].repeat(3, -1),
                           host["coverage"][..., None].repeat(3, -1))}
    for name, (a, b) in planes.items():
        try:
            out["aov"][name] = check_parity(a, b)
        except AssertionError as exc:
            out["aov"][name] = {"failed": str(exc)}
            failures.append(f"aov {name}: {exc}")
    hit = (card["coverage"] > 0) & (host["coverage"] > 0)
    depth_rel = float(np.max(np.abs(card["depth"][hit] - host["depth"][hit])
                             / host["depth"][hit]))
    out["aov"]["depth_max_rel"] = depth_rel
    log(f"[app] AOVs book_one_final {w}x{h}@4spp on the card "
        f"({card_s:.2f} s) against the CPU ({host_s:.2f} s): "
        f"{json.dumps({k: out['aov'][k] for k in planes})}; depth max "
        f"relative difference {depth_rel!r} [{smi}]")

    # A frame of the card through the live window.
    server = PreviewServer(port=0, host="127.0.0.1")
    try:
        res = session.renderer.render_frame() or moved
        frame = display_transform(res.accumulated, res.samples)
        server.publish(frame, samples=res.samples,
                       target_spp=cfg.samples_per_pixel,
                       mrays_per_s=res.mrays_per_s, fps=0.0, frame=1,
                       done=False)
        png = os.path.join(OUT_DIR, "smoke_app_served.png")
        with open(png, "wb") as f:
            f.write(_http_get(server.port, "/frame.png"))
        status = json.loads(_http_get(server.port, "/status.json"))
        served = np.array_equal(read_png(png), to_u8(frame))
    finally:
        server.close()
    out["served"] = {"equal": served, "status": status}
    log(f"[app] preview server 127.0.0.1:{server.port}: /frame.png of a "
        f"card frame ({res.samples} spp) equal to the published image "
        f"{served}; /status.json {json.dumps(status)} [{smi}]")
    if not served or status["samples"] != res.samples:
        failures.append("preview server frame or status")

    # Checkpoint at 2 spp, resume to 4, against one render of 4.
    ck = {n: os.path.join(OUT_DIR, f"smoke_app_{n}.npz")
          for n in ("half", "resumed", "whole")}
    base = ["--device", device.type, "--width", str(w), "--height", str(h),
            "--spf", "1", "--max-bounces", "50", "--intersector", "baked",
            "--clusters", "16", "--quiet",
            "--out", os.path.join(OUT_DIR, "smoke_app_ckpt.png")]
    cli.run(base + ["--spp", "2", "--checkpoint", ck["half"]])
    _r, resumed = cli.run(base + ["--spp", "4", "--resume", ck["half"],
                                  "--checkpoint", ck["resumed"]])
    _r, whole = cli.run(base + ["--spp", "4", "--checkpoint", ck["whole"]])
    same = (resumed.samples == whole.samples == 4 and np.array_equal(
        resumed.accumulated.view(np.uint32),
        whole.accumulated.view(np.uint32)) and np.array_equal(
        np.load(ck["resumed"])["accumulated"].view(np.uint32),
        np.load(ck["whole"])["accumulated"].view(np.uint32)))
    out["checkpoint"] = {"bit_identical": same}
    log(f"[app] --checkpoint at 2 spp, --resume to 4 (baked/16 "
        f"{w}x{h}, a frame a sample): bit for bit with one render of 4 "
        f"{same} [{smi}]")
    if not same:
        failures.append("checkpoint/resume differs from one render")
    if failures:
        raise AssertionError("phase app: " + "; ".join(failures))
    return out


# Phase multi: the sharded and multi-process paths (parallel/) on the card.
MULTI_TIMEOUT = 300        # seconds a child process may take
MULTI_TURNS = ("one", "mesh", "mesh", "one")


def _multi_mesh_devices(n: int) -> list:
    """n entries of a mesh: distinct cards where the machine has two or
    more (card i % count), else cuda:0 n times."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def _sync_cards() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _shard_kernel_ms(arrays, cam, cfg, tiles: int, samples: int) -> tuple:
    """(ms of the one-device render's kernel launch, ms of the mesh's
    launches summed) of a fused render without recluster: each launch
    through ``fused.launch_planes``, the call that ``render_pixels``
    makes, with its lane split, timed alone by CUDA events on planes and
    a camera built beforehand, so that no host work falls between the
    events."""
    from wavefront_path_tracer_tpu_torch.models import fused

    view = cam.view_matrix()
    inv_proj = cam.inverse_projection(cfg.width, cfg.height)
    tables = fused.scene_tables(cfg, arrays, view)
    device = arrays["centers"].device
    cam_params = torch.from_numpy(fused.camera_params(
        cam.gpu_camera(), view, inv_proj, cfg)).to(device)
    perm, _inv = fused._block_perm(cfg.width, cfg.height, cfg.block_tiles)
    perm = torch.from_numpy(perm.astype(np.int64)).to(device)

    def timed(idx, base: int, n: int) -> float:
        split = fused._effective_split(cfg.lane_split, n)
        planes = fused.lane_planes(idx, cfg.width, cfg.tile_rows, split,
                                   n // split)
        return _time_ms(lambda: fused.launch_planes(
            planes, arrays, cam_params, cfg, 0, base, n // split,
            **tables), 1)[0]

    spp = cfg.samples_per_pixel
    per_tile, per_shard = perm.numel() // tiles, spp // samples
    one = timed(perm, 0, spp)
    mesh = sum(timed(perm[t * per_tile:(t + 1) * per_tile], s * per_shard,
                     per_shard)
               for t in range(tiles) for s in range(samples))
    return one, mesh


def _multi_case(device, label, scene, tris, cam, cfg, tiles, samples,
                kind, smi) -> dict:
    """One sharded render against the one-device render on ``device``: a
    warm-up of each, then both in turns (one, mesh, mesh, one), host
    clock between synchronisations of every card, the launch counts of
    the first mesh turn read alone; without recluster, the kernels'
    launches also timed alone (:func:`_shard_kernel_ms`).  Bit for bit
    with one sample shard, within rtol 1e-5, atol 1e-6 otherwise; equal
    rays."""
    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.parallel import (
        make_mesh,
        render_samples_sharded,
    )
    from wavefront_path_tracer_tpu_torch.renderer import prepare_scene

    arrays = prepare_scene(scene, cfg, device, tris)
    mesh = make_mesh(tiles * samples, sample_axis=samples,
                     devices=_multi_mesh_devices(tiles * samples))
    args = (cam.gpu_camera(), cam.view_matrix(),
            cam.inverse_projection(cfg.width, cfg.height), cfg, 0, 0,
            cfg.samples_per_pixel)
    runs = {"one": lambda: fused.render_samples(arrays, *args),
            "mesh": lambda: render_samples_sharded(mesh, arrays, *args)}
    out, seconds, launches = {}, {"one": [], "mesh": []}, None
    for which in ("one", "mesh"):
        runs[which]()
    for which in MULTI_TURNS:
        _sync_cards()
        if which == "mesh" and launches is None:
            _reset_launches()
        t0 = time.perf_counter()
        rad, rays = runs[which]()
        _sync_cards()
        seconds[which].append(time.perf_counter() - t0)
        if which == "mesh" and launches is None:
            launches = _read_launches()
        out[which] = (rad.cpu().numpy(), int(rays))
    kernel_ms = (None, None) if cfg.recluster else _shard_kernel_ms(
        arrays, cam, cfg, tiles, samples)
    (one, one_rays), (sharded, rays) = out["one"], out["mesh"]
    bits = samples == 1
    same = (np.array_equal(one.view(np.uint32), sharded.view(np.uint32))
            if bits else np.allclose(sharded, one, rtol=1e-5, atol=1e-6))
    rec = {"case": label, "mesh": mesh.shape,
           "devices": [str(d) for d in mesh.distinct_devices()],
           "bit_for_bit": bits, "agrees": bool(same), "rays": rays,
           "one_device_rays": one_rays,
           "max_abs_err": float(np.abs(sharded - one).max()),
           "launches": launches[kind], "shipped": launches[SHIPPED[kind]],
           "seconds": seconds["mesh"], "one_device_seconds": seconds["one"],
           "kernel_ms": kernel_ms[1], "one_device_kernel_ms": kernel_ms[0]}
    kernels = ("" if cfg.recluster else
               f"; kernel launches alone: mesh {kernel_ms[1]!r} ms, one "
               f"device {kernel_ms[0]!r} ms")
    log(f"[multi] {label} over {tiles}x{samples} on {rec['devices']}: "
        f"{'bit for bit' if bits else 'within rtol 1e-5, atol 1e-6'} "
        f"{same}, max abs err {rec['max_abs_err']!r}, rays {rays} "
        f"(one device {one_rays}); {kind} launches {launches[kind]} "
        f"({SHIPPED[kind]} {launches[SHIPPED[kind]]}); seconds mesh "
        f"{seconds['mesh']!r}, one device {seconds['one']!r}{kernels} "
        f"[{smi}]")
    return rec


def _wait_children(children) -> dict:
    """Each child's (exit code, output); every child is waited for, and
    one that outlasts MULTI_TIMEOUT (counted from now) is killed."""
    deadline = time.monotonic() + MULTI_TIMEOUT
    out = {}
    for child in children:
        rc, text, _seconds = child.wait(deadline - time.monotonic())
        out[child.label] = (rc, text)
    return out


def phase_multi(device, smi: str, bench_line: dict | None) -> dict:
    """Phase ``multi``: the headline, terrain_dynamic and the segmented
    headline sharded over meshes against one-device renders; the dry
    run's five passes over four entries of cuda:0; two worker processes
    over gloo on cuda:0 and a world of one over NCCL; NCCL's refusal of
    more ranks than cards; and the bench with ``--mesh 1x1``."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from wavefront_path_tracer_tpu_torch.parallel import multihost
    from wavefront_path_tracer_tpu_torch.parallel.dryrun import (
        dryrun_multichip,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    failures = []
    count = torch.cuda.device_count()
    log(f"[multi] {count} card(s): meshes take "
        + ("distinct cards, card i % count" if count >= 2 else
           "cuda:0 for every entry") + f" [{smi}]")
    head = RenderConfig(width=MAIN_WIDTH, height=MAIN_HEIGHT,
                        samples_per_pixel=MAIN_SPP,
                        samples_per_frame=MAIN_SPP, max_bounces=50,
                        engine="fused", intersector="baked",
                        baked_clusters=16, block_tiles=32)
    terrain = head.replace(width=MESH_SIZE[0], height=MESH_SIZE[1],
                           intersector="bruteforce")
    book, ter = _book(), _terrain()
    cases = []
    for label, (scene, tris, cam), cfg, tiles, samples, kind in (
            ("headline", book, head, 4, 1, "culled"),
            ("headline", book, head, 2, 2, "culled"),
            ("terrain_dynamic", ter, terrain, 4, 1, "dynculled"),
            ("headline recluster 2", book, head.replace(recluster=2), 2, 1,
             "segment_culled")):
        rec = _multi_case(device, label, scene, tris, cam, cfg, tiles,
                          samples, kind, smi)
        cases.append(rec)
        if not (rec["agrees"] and rec["rays"] == rec["one_device_rays"]
                and rec["launches"] > 0
                and rec["shipped"] == rec["launches"]):
            failures.append(f"{label} {tiles}x{samples}: {rec}")

    # Two ranks over gloo sharing the card, and a world of one over NCCL,
    # as child processes while the dry run runs here.
    init_dir = tempfile.mkdtemp(prefix="multi_init_", dir=OUT_DIR)
    worker = ["-m", "wavefront_path_tracer_tpu_torch.parallel.dryrun",
              "--worker"]
    t0 = time.perf_counter()
    started = [Child(
        worker + [str(r), f"file://{init_dir}/gloo", "--backend", "gloo",
                  "--device", device.type], f"gloo rank {r}")
        for r in (0, 1)]
    started.append(Child(
        worker + ["0", f"file://{init_dir}/nccl", "--world-size", "1",
                  "--backend", "nccl", "--device", device.type],
        "nccl rank 0"))
    try:
        passes = dryrun_multichip(4, devices=[device] * 4)
        dry_seconds = time.perf_counter() - t0
    finally:
        children = _wait_children(started)
    children_seconds = time.perf_counter() - t0
    log(f"[multi] dryrun_multichip(4, [{device}] x 4): {len(passes)} passes "
        f"in {dry_seconds:.1f} s, beside the child processes [{smi}]")
    for label, (rc, text) in children.items():
        rank = label.split()[-1]
        for line in text.splitlines():
            if line.startswith(f"process {rank}:"):
                log(f"[multi] {label.split()[0]}: {line}")
        if (rc != 0 or f"process {rank}: OK" not in text
                or f"process {rank}: default mesh on {device}" not in text):
            failures.append(f"{label}: exit {rc}\n{text[-4000:]}")
    log(f"[multi] two gloo ranks on {device} and a world of one over NCCL, "
        f"at once: {children_seconds:.1f} s (process start included) "
        f"[{smi}]")
    # NCCL takes a card a rank: more ranks than cards must raise.
    ranks = count + 1
    try:
        multihost.initialize(f"file://{init_dir}/refused", ranks, 0, "nccl")
        failures.append(f"{ranks} NCCL ranks on {count} card(s) were not "
                        "refused")
        dist.destroy_process_group()
    except RuntimeError as e:
        log(f"[multi] {ranks} NCCL ranks on {count} card(s) refused: {e}")
    finally:
        shutil.rmtree(init_dir, ignore_errors=True)

    if bench_line is None:
        _rc, bench_line, _s = _run_bench(["--no-mesh-row"])
    rc, mesh_line, bench_seconds = _run_bench(["--mesh", "1x1"])
    head_rays = bench_line.get("counters", {}).get("rays")
    mesh_rays = mesh_line.get("counters", {}).get("rays")
    log(f"[multi] bench --mesh 1x1: exit {rc}, {mesh_line.get('metric')} "
        f"{mesh_line.get('value')} Mrays/s, {mesh_rays} rays, in "
        f"{bench_seconds:.1f} s; the bench phase's headline "
        f"{bench_line.get('value')} Mrays/s, {head_rays} rays [{smi}]")
    if (rc != 0 or "error" in mesh_line or not head_rays
            or mesh_rays != head_rays
            or not mesh_line.get("metric", "").endswith(
                "/mesh1x1, book_one_final)")):
        failures.append(f"bench --mesh 1x1: exit {rc}, {mesh_line}")
    if failures:
        raise AssertionError("phase multi: " + "; ".join(failures))
    return {"cards": count, "cases": cases, "dryrun": passes,
            "dryrun_seconds": dry_seconds,
            "children": {k: {"rc": rc_, "tail": t[-2000:]}
                         for k, (rc_, t) in children.items()},
            "children_seconds": children_seconds,
            "bench_mesh": mesh_line, "bench_mesh_seconds": bench_seconds}


# The differential stage probes (phases stageplain, stage and segstage):
# every probe instantiation (ops/stage_probes.py KERNEL_PROBES,
# csrc/baked_probe*.cu and dynculled_probe*.cu) on a scene of each kind at
# STAGE_SIZE, held to its plain version and to the unprobed kernel; the
# plain runs are phase stageplain's, in the window (cut to 4 bounces: the
# plain versions' time goes with the bounces of their slowest ray).  A
# segment kernel's case is a segmented render (recluster 2) at that size.
STAGE_SIZE = (160, 90, 4)
STAGE_BOUNCES = 4
# The kernels (KERNEL_PROBES keys) with their cluster size.  The winner
# hint is off above 64 estimated clusters (ops/bake.py HINT_MAX_CLUSTERS),
# so the hinted kernel takes the textured mesh's 1,012 triangles in
# clusters of 32 and terrain's 5,000 in clusters of 128.
STAGE_KERNELS = (("culled", 16), ("culled_hint", 16), ("unculled", 0),
                 ("dynculled", 16), ("segment_culled", 16),
                 ("segment_dynculled", 16))
HINT_CLUSTERS = {"texmesh": 32, "terrain": 128}
PERSISTENT_KERNELS = ("culled", "culled_hint", "unculled", "dynculled")
SEGMENT_KERNELS = ("segment_culled", "segment_dynculled")
# The shares of phase stageplain, a process each in the window: (scenes,
# kernels).
STAGE_PARTS = {
    "book": (("book", "book_checker", "texmesh"), PERSISTENT_KERNELS),
    "terrain": (("terrain",), PERSISTENT_KERNELS),
    "seg": (("book", "book_checker", "texmesh", "terrain"), SEGMENT_KERNELS),
}
# The reference's probe point of each name (ops/pallas_kernels.py).
PROBE_POINTS = {"dbl_raygen": 2611, "dbl_shade": 2685, "dbl_accum": 2673,
                "dbl_loopcond": 2550, "dbl_entry": 1423, "dbl_cond": 1379,
                "dyn_dbl_entry": 2219, "dyn_dbl_cond": 2128,
                "dyn_dbl_global": 2074, "dbl_entry2": 1426,
                "dbl_cond2": 1385, "hint_count": 1353}
# The --stage-timing tables: (label, scene, size, kernel, CLI flags); the
# dynamic table through models/fused.py stage_timing (the CLI prints the
# reference's note for brute force).
STAGE_TABLES = (
    ("headline", "book_one_final", (MAIN_WIDTH, MAIN_HEIGHT, MAIN_SPP),
     "culled", ["--intersector", "baked", "--clusters", "16"]),
    ("unculled", "book_one_final", (MAIN_WIDTH, MAIN_HEIGHT, MAIN_SPP),
     "unculled", ["--intersector", "baked", "--clusters", "0"]),
    ("terrain_dynamic", "terrain", (*MESH_SIZE, 32), "dynculled", None),
)
# The probe variants of probes/iterprobe.py that are not in its defaults
# (the reference's exp/iterprobe.py takes any PROBE name), run at its
# defaults in phase stage.
ITERPROBE_NEW = "full,dbl_entry2,dbl_cond2"


def _stage_scene(name: str, part: str = ""):
    if name == "texmesh":
        return _from_scene_file(_textured_mesh_file(f"tex_mesh_stage{part}"))
    return {"book": _book, "book_checker": _book_checker,
            "terrain": _terrain}[name]()


def _stage_case(kernel, clusters, scene, tris, cam, probe, device):
    """The Case (SegCase for a segment kernel) of ``kernel`` (a
    KERNEL_PROBES key) with ``probe`` (None: unprobed) at STAGE_SIZE, its
    launches read from the probe's own count."""
    w, h, spp = STAGE_SIZE
    if kernel in SEGMENT_KERNELS:
        case = SegCase(kernel[len("segment_"):], clusters, scene, cam, w, h,
                       spp, {}, device, triangles=tris,
                       bounces=STAGE_BOUNCES, probe=probe)
    else:
        hint = kernel == "culled_hint"
        case = Case("culled" if hint else kernel, clusters, scene, cam, w, h,
                    spp, 1, {} if probe is None else {"probe": probe},
                    device, triangles=tris, winner_hint=hint,
                    bounces=STAGE_BOUNCES)
        if hint and not case.baked.winner_hint:
            raise AssertionError(f"the bake in clusters of {clusters} has "
                                 f"no winner hint")
    if probe is not None:
        case.launches = (lambda key=f"{kernel}/{probe}":
                         _read_launches()[key])
    return case


def _stage_cases(device, parts):
    """(label, scene, kernel, probe, Case) of every probe instantiation of
    the STAGE_PARTS ``parts`` (the unprobed kernel first of each, probe
    None)."""
    from wavefront_path_tracer_tpu_torch.ops import stage_probes

    w, h, spp = STAGE_SIZE
    for part in parts:
        scenes, kernels = STAGE_PARTS[part]
        for name in scenes:
            scene, tris, cam = _stage_scene(name, part)
            for kernel, clusters in STAGE_KERNELS:
                if kernel not in kernels:
                    continue
                if kernel == "culled_hint":
                    clusters = HINT_CLUSTERS.get(name, clusters)
                for probe in (None, *stage_probes.KERNEL_PROBES[kernel]):
                    case = _stage_case(kernel, clusters, scene, tris, cam,
                                       probe, device)
                    label = (f"{kernel}/{clusters} {probe or 'unprobed'} "
                             f"{name} {w}x{h}@{spp}spp {STAGE_BOUNCES} "
                             f"bounces")
                    yield label, name, kernel, probe, case


def phase_stage_plain(device, part=None) -> list[dict]:
    """Phase stageplain: the plain versions of every probe instantiation
    (phase stage's cases) of ``part`` (all without one), each timed; their
    results go to ``_PLAIN_OUT`` for phase stage."""
    parts = (part,) if part is not None else tuple(STAGE_PARTS)
    out = []
    for label, _name, _kernel, probe, case in _stage_cases(device, parts):
        if probe is None:
            continue
        plain_ms, _PLAIN_OUT[case.key] = _time_ms(case.plain, 1)
        out.append({"case": label, "plain_ms": plain_ms})
        log(f"[stage-plain] {label}: plain version {plain_ms:.1f} ms")
    return out


def _stage_check(label, case, probe, base) -> tuple:
    """A probe kernel against its plain version (bit for bit, radiance
    words and counters) and against the unprobed kernel's results
    ``base`` (bit for bit; dbl_accum's radiance within its tolerance;
    hint_count's supers higher by its prepass entries, at least one and
    at most its clusters entered)."""
    from wavefront_path_tracer_tpu_torch.ops import stage_probes

    before = case.launches()
    k = case.kernel()
    torch.cuda.synchronize()
    if case.launches() != before + case.launches_a_run:
        raise AssertionError(f"{label}: the wrapper counted "
                             f"{case.launches() - before} launches, not "
                             f"{case.launches_a_run}")
    p = _PLAIN_OUT.get(case.key)
    if p is None:
        p = _PLAIN_OUT[case.key] = case.plain()
    (rad_k, stats_k), (rad_p, stats_p), (rad_b, stats_b) = (
        case.results(k), case.results(p), case.results(base))
    plain_bits = stats_k == stats_p and all(
        torch.equal(_bits(a), _bits(b)) for a, b in zip(rad_k, rad_p))
    err_plain = max(float((a.double() - b.double()).abs().max())
                    for a, b in zip(rad_k, rad_p))
    err_base = max(float((a.double() - b.double()).abs().max())
                   for a, b in zip(rad_k, rad_b))
    if probe == "dbl_accum":
        rtol = stage_probes.ACCUM_RTOL_PER_SAMPLE * STAGE_SIZE[2]
        base_ok = all(torch.allclose(a, b, rtol=rtol,
                                     atol=stage_probes.ACCUM_ATOL)
                      for a, b in zip(rad_k, rad_b))
    else:
        base_ok = all(torch.equal(_bits(a), _bits(b))
                      for a, b in zip(rad_k, rad_b))
    prepass = stats_k[2] - stats_b[2]
    if probe == "hint_count":
        base_ok = (base_ok and 0 < prepass <= stats_k[3]
                   and stats_k[:2] + stats_k[3:] == stats_b[:2] + stats_b[3:])
    else:
        base_ok = base_ok and stats_k == stats_b
    rep = {"case": label, "kernel": case.kind, "probe": probe,
           "stats": stats_k, "bit_exact_plain": plain_bits,
           "max_abs_err": err_plain, "equal_unprobed": base_ok,
           "max_abs_err_unprobed": err_base}
    if probe == "hint_count":
        rep["prepass_entries"] = prepass
    log(f"[stage-check] {json.dumps(rep)}")
    if not plain_bits:
        raise AssertionError(f"{label}: the probe kernel and its plain "
                             f"version differ")
    if not base_ok:
        raise AssertionError(f"{label}: the probe kernel and the unprobed "
                             f"kernel differ")
    if (case.kind != "unculled" and case.has_clusters()
            and not stats_k[3] > 0):
        raise AssertionError(f"{label}: no cluster was entered")
    return rep, k


def _stage_symbols():
    """(kernel, probe or None, key, mangled symbol) of every probe kernel
    and of its kernel's unprobed instantiation, for every kind."""
    from wavefront_path_tracer_tpu_torch.ops import stage_probes

    for kernel, probes in stage_probes.KERNEL_PROBES.items():
        if not probes:
            continue
        for tris in (False, True):
            for tex in (False, True):
                for probe in (None, *probes):
                    bits = 0 if probe is None else stage_probes.PROBES[probe]
                    yield (kernel, probe,
                           f"{kernel} tris={int(tris)} tex={int(tex)}",
                           stage_probes.kernel_symbol(kernel, tris, tex,
                                                      bits))


def _stage_sass() -> dict:
    """Each probe kernel's SASS instructions against its unprobed
    kernel's (utils/sass.py), without the NOPs that pad a kernel's end (a
    counting probe adds one add, which the padding can hide): a duplicate
    that nvcc merged away would leave them equal.  {} where the machine
    has no cuobjdump."""
    from wavefront_path_tracer_tpu_torch.ops import _build
    from wavefront_path_tracer_tpu_torch.utils import sass

    if sass.cuobjdump() is None:
        log("[stage-sass] cuobjdump not found: probe SASS not counted "
            "(each probe's share is printed beside its registers)")
        return {}
    # The unprobed kernels are the shipped library's, the probe kernels the
    # stage probes' library's.
    libs = [_build.build(lib)[0]
            for lib in (_build.LIB_NAME, _build.PROBE_LIB_NAME)]
    counts = {k: v for lib in libs for k, v in sass.counts(lib).items()}
    work = {k: v for lib in libs for k, v in sass.work_counts(lib).items()}
    out, base = {}, None
    for _kernel, probe, key, sym in _stage_symbols():
        found = [name for name in counts if sym in name]
        if len(found) != 1:
            raise AssertionError(f"{len(found)} SASS functions match {sym}")
        n, w = counts[found[0]], work[found[0]]
        if probe is None:
            base = (n, w)
            continue
        out[f"{key} {probe}"] = {"base": base[0], "probe": n,
                                 "base_without_nops": base[1],
                                 "probe_without_nops": w}
        log(f"[stage-sass] {key} {probe}: {n} SASS instructions, unprobed "
            f"{base[0]} (+{n - base[0]}); without NOPs {w}, unprobed "
            f"{base[1]} (+{w - base[1]})")
        if not w > base[1]:
            raise AssertionError(f"{key} {probe}: the probe kernel is no "
                                 f"longer than the unprobed one ({w} <= "
                                 f"{base[1]} without NOPs)")
    return out


def _stage_ptxas() -> dict:
    """ptxas's registers and spills of every probe kernel and its unprobed
    kernel, from the builds' reports (a probe that spills more than its
    base reads an upper bound of its stage's share)."""
    from wavefront_path_tracer_tpu_torch.ops import _build

    report = _build.build()[1] + _build.build(_build.PROBE_LIB_NAME)[1]
    out = {}
    for _kernel, probe, key, sym in _stage_symbols():
        reps = _build.ptxas_kernels(report, sym)
        if len(reps) != 1:
            raise AssertionError(f"ptxas reported {len(reps)} kernels for "
                                 f"{sym}")
        rep = {k: reps[0].get(k) for k in (
            "registers", "stack", "spill_stores", "spill_loads")}
        key = f"{key} {probe or 'unprobed'}"
        out[key] = rep
        log(f"[stage-ptxas] {key}: {rep['registers']} registers, "
            f"{rep['stack']} bytes stack, {rep['spill_stores']} / "
            f"{rep['spill_loads']} bytes spilled")
    return out


def _table_probes(kind: str) -> list:
    """The probes of the --stage-timing table of ``kind``'s path
    (models/fused.py stage_stages: the reference's stages, which
    dbl_entry2 and dbl_cond2 are not)."""
    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(engine="fused", **{
        "culled": {"intersector": "baked", "baked_clusters": 16},
        "unculled": {"intersector": "baked", "baked_clusters": 0},
        "dynculled": {"intersector": "bruteforce", "baked_clusters": 16},
    }[kind])
    return [probe for _label, probe in fused.stage_stages(cfg, {})]


def _stage_table(device, smi, label, scene_name, size, kind, argv) -> dict:
    """One --stage-timing table with the launch counts set to 0 just
    before it and read just after: every probe of the table must have
    launched as often as models/fused.py time_probes launches it (its
    check run and STAGE_REPS timed runs), the shares must be at least 0,
    those below the drift marked, and the residual must close the
    budget."""
    import contextlib
    import io
    import re

    from wavefront_path_tracer_tpu_torch import cli
    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.renderer import Renderer
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    w, h, spp = size
    buf = io.StringIO()
    _reset_launches()
    t0 = time.perf_counter()
    if argv is not None:
        png = os.path.join(OUT_DIR, f"smoke_stage_{label}.png")
        with contextlib.redirect_stderr(buf):
            cli.run(["--device", device.type, "--scene", scene_name,
                     "--width", str(w), "--height", str(h), "--spp",
                     str(spp), "--spf", str(spp), "--max-bounces", "50",
                     *argv, "--stage-timing", "--out", png, "--quiet"])
    else:
        scene, tris, cc = _stage_scene(scene_name)
        cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                           samples_per_frame=spp, max_bounces=50,
                           engine="fused", intersector="bruteforce",
                           baked_clusters=16)
        renderer = Renderer(scene, cc, cfg, tris, device=device)
        base, rows = fused.stage_timing(
            renderer.scene_arrays, cc.gpu_camera(), cc.view_matrix(),
            cc.inverse_projection(w, h), cfg, n_samples=min(spp, 32))
        cli.print_stage_table(base, rows, min(spp, 32), file=buf)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    all_launches = _read_launches()
    probes = _table_probes(kind)
    launches = {n: all_launches[f"{kind}/{n}"] for n in probes}
    rows = {}
    for line in buf.getvalue().splitlines():
        m = re.match(r"  (.+?)\s+(-?[\d.]+) ms(?:\s+(-?[\d.]+)%( \*)?)?$",
                     line)
        if m:
            rows[m[1]] = {"ms": float(m[2]),
                          "share": None if m[3] is None
                          else float(m[3]) / 100,
                          "unresolved": m[4] is not None}
    for name, row in rows.items():
        note = ""
        if row["unresolved"]:
            note = (f"  (below the {fused.STAGE_DRIFT:.0%} between-call "
                    f"drift: not resolved)")
        log(f"[stage-table] {label} ({scene_name} {w}x{h}@{spp}spp, "
            f"{kind}): {name:34s} {row['ms']:9.2f} ms"
            + ("" if row["share"] is None else f"  {row['share']:6.1%}")
            + f"{note} [{smi}]")
    shares = [r["share"] for n, r in rows.items() if n != "base render"]
    expected = len(probes) + 1
    if len(shares) != expected or "base render" not in rows:
        raise AssertionError(f"{label}: {len(shares)} stage rows, not "
                             f"{expected}: {buf.getvalue()}")
    *probed, residual = shares
    # Each share is printed to 0.05%.
    if (min(shares) < 0
            or abs(residual - max(0.0, 1.0 - sum(probed)))
            > 0.0005 * len(shares)):
        raise AssertionError(f"{label}: shares {shares}: the residual "
                             f"does not close the budget")
    *marks, residual_marked = [r["unresolved"] for n, r in rows.items()
                               if n != "base render"]
    if residual_marked or any(
            s > fused.STAGE_DRIFT + 0.0005 if m
            else s < fused.STAGE_DRIFT - 0.0005
            for s, m in zip(probed, marks)):
        raise AssertionError(f"{label}: the drift marks {marks} do not "
                             f"match the shares {probed}")
    wrong = {n: v for n, v in launches.items() if v != 1 + fused.STAGE_REPS}
    if wrong:
        raise AssertionError(f"{label}: probes launched {wrong} times, not "
                             f"{1 + fused.STAGE_REPS} each")
    log(f"[stage-table] {label}: {seconds:.1f} s; probe launches "
        f"{launches}; base kernel launches {all_launches[kind]}")
    return {"rows": rows, "launches": launches, "seconds": seconds}


def _stage_scripts(smi) -> dict:
    """probes/iterprobe.py and probes/dynprobe.py once each at their
    defaults, in this process, then iterprobe with the culled probes
    that its defaults leave out (ITERPROBE_NEW), with the launch counts
    set to 0 just before it and read just after."""
    import contextlib
    import io

    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.probes import dynprobe, iterprobe

    out = {}
    for name, script, argv in (
            ("iterprobe", iterprobe, []), ("dynprobe", dynprobe, []),
            ("iterprobe_new", iterprobe, ["--variants", ITERPROBE_NEW])):
        buf = io.StringIO()
        _reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = script.main(argv)
        launches = {k: v for k, v in _read_launches().items()
                    if "/" in k and v}
        lines = buf.getvalue().splitlines()
        for line in lines:
            if not line.startswith("{"):
                log(f"[stage-script] {name}: {line}")
        if rc != 0:
            raise AssertionError(f"{name} exited {rc}")
        out[name] = {"seconds": time.perf_counter() - t0,
                     "launches": launches,
                     "variants": [json.loads(ln) for ln in lines
                                  if ln.startswith("{")]}
        log(f"[stage-script] {name}: probe launches {launches}")
    want = {f"culled/{v}": 1 + fused.STAGE_REPS
            for v in ITERPROBE_NEW.split(",")[1:]}
    if out["iterprobe_new"]["launches"] != want:
        raise AssertionError(f"iterprobe {ITERPROBE_NEW}: probe launches "
                             f"{out['iterprobe_new']['launches']}, not "
                             f"{want}")
    return out


def _stage_refusal(device) -> None:
    """A bitmask with no instantiation (two probes at once), past the
    wrapper's own check: the C entry point must refuse it and the wrapper
    raise; so must the unculled segment's entry point refuse any probe."""
    from wavefront_path_tracer_tpu_torch.ops import stage_probes

    probe_bits = stage_probes.probe_bits
    w, h, spp = STAGE_SIZE
    scene, tris, cam = _book()
    cases = {
        "two bits at once": next(c for *_r, c in _stage_cases(device,
                                                              ("book",))),
        "a probe of the unculled segment": SegCase(
            "unculled", 0, scene, cam, w, h, spp, {}, device,
            bounces=STAGE_BOUNCES, probe="dbl_entry"),
    }
    for what, case in cases.items():
        try:
            stage_probes.probe_bits = lambda *_a: (
                3 if what.startswith("two") else stage_probes.PROBES[
                    "dbl_entry"])
            try:
                case.kernel()
            except RuntimeError as exc:
                log(f"[stage-check] {what} refused by the kernel: {exc}")
            else:
                raise AssertionError(f"the kernel accepted {what}")
        finally:
            stage_probes.probe_bits = probe_bits


def phase_stage(device, smi: str) -> dict:
    """Phase stage: the differential stage probes.  Every probe kernel
    against its plain version and the unprobed kernel (STAGE_SIZE), its
    SASS against the unprobed kernel's, ptxas's registers and spills;
    the --stage-timing tables (STAGE_TABLES) and the probe scripts."""
    seconds = {}
    t0 = time.perf_counter()
    out = {"sass": _stage_sass(), "ptxas": _stage_ptxas(), "checks": [],
           "timed": {}, "seconds": seconds}
    seconds["sass and ptxas"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    base = None
    for label, name, kernel, probe, case in _stage_cases(
            device, tuple(STAGE_PARTS)):
        if probe is None:
            base = case.kernel()
            continue
        rep, k = _stage_check(label, case, probe, base)
        if name == "book":
            # The kernels line's entry: this case's kernel time (mean of 5
            # calls; a segment kernel's: the mean of 3 frames' sums of its
            # launches) beside its bound.
            if kernel in SEGMENT_KERNELS:
                rep["kernel_ms"] = case.segment_ms()
            else:
                rep["kernel_ms"], _ = _time_ms(case.kernel, 5)
            rep.update(case.bound(case.results(k)[1], probe=probe))
            out["timed"][f"{kernel}/{probe}"] = rep
        out["checks"].append(rep)
    _stage_refusal(device)
    seconds["checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["tables"] = {label: _stage_table(device, smi, label, *spec)
                     for label, *spec in STAGE_TABLES}
    seconds["tables"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["scripts"] = _stage_scripts(smi)
    seconds["scripts"] = time.perf_counter() - t0
    log(f"[stage] seconds by step: "
        f"{json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    return out


# Phase segstage: the segment kernels' probes at K=2 (recluster 2, 50
# bounces) on the rows that run them: (cell, kernel, clusters, scene,
# size, spp).
SEGSTAGE_CELLS = (
    ("headline", "segment_culled", 16, "book", (MAIN_WIDTH, MAIN_HEIGHT),
     MAIN_SPP),
    ("knot50k_dynamic", "segment_dynculled", 16, "knot", MESH_SIZE, 8),
)


def phase_segstage(device, smi: str) -> dict:
    """Phase segstage: each segment probe's share of a segmented frame's
    segment-kernel time (probes/_stage.py segment_shares: the summed CUDA
    event time of the frame's launches, base and probe in turns, least of
    STAGE_REPS, every probed frame bit for bit with the base's) at
    SEGSTAGE_CELLS, with the launch counts set to 0 just before each cell
    and read just after; then hint_count on book_checker with the winner
    hint (1920x1080@32spp): the prepass entries per ray, as
    supers(probed) - supers(base), beside the clusters entered per ray
    with and without the hint."""
    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.ops import stage_probes
    from wavefront_path_tracer_tpu_torch.probes import _stage
    from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    scenes = {"book": _book, "knot": _knot, "book_checker": _book_checker}
    out = {}
    for cell, kernel, clusters, scene_name, (w, h), spp in SEGSTAGE_CELLS:
        scene, tris, cc = scenes[scene_name]()
        cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                           samples_per_frame=spp, max_bounces=50,
                           engine="fused", intersector=(
                               "baked" if kernel == "segment_culled"
                               else "bruteforce"),
                           baked_clusters=clusters, recluster=2,
                           block_tiles=32)
        arrays = prepare_scene(scene, cfg, device, tris)
        probes = stage_probes.KERNEL_PROBES[kernel]
        _reset_launches()
        t0 = time.perf_counter()
        stats, base, turns = _stage.segment_shares(
            arrays, cc.gpu_camera(), cc.view_matrix(),
            cc.inverse_projection(w, h), cfg, probes, spp,
            reps=fused.STAGE_REPS)
        seconds = time.perf_counter() - t0
        all_launches = _read_launches()
        launches = {p: all_launches[f"{kernel}/{p}"] for p in probes}
        frame = spp * len(fused._segment_schedule(2, 50))
        want = (1 + fused.STAGE_REPS) * frame
        if any(n != want for n in launches.values()):
            raise AssertionError(f"segstage {cell}: probe launches "
                                 f"{launches}, not {want} each")
        rows = {p: {"base_ms": tb, "probe_ms": tp,
                    "share": (tp - tb) / tb} for p, tb, tp in turns}
        for p, row in rows.items():
            mark = ("" if row["share"] >= fused.STAGE_DRIFT
                    else f"  (below the {fused.STAGE_DRIFT:.0%} drift: not "
                         f"resolved)")
            log(f"[segstage] {cell} {w}x{h}@{spp}spp {kernel}/{clusters} "
                f"K=2: {p:16s} {row['probe_ms']!r} ms against "
                f"{row['base_ms']!r} ms in its turns: share "
                f"{row['share']:.2%}{mark} [{smi}]")
        log(f"[segstage] {cell}: segment launches a frame {frame}, base "
            f"{base!r} ms (least of every turn), stats {stats}, probe "
            f"launches {launches}, {seconds:.1f} s; every probed frame bit "
            f"for bit with the base's [{smi}]")
        out[cell] = {"kernel": kernel, "size": [w, h], "spp": spp,
                     "stats": stats, "base_ms": base, "rows": rows,
                     "launches": launches, "launches_a_frame": frame,
                     "seconds": seconds}

    # hint_count: one base and one probed render of book_checker with the
    # winner hint, and one without the hint, through render_pixels.
    scene, tris, cc = _book_checker()
    w, h, spp = MAIN_WIDTH, MAIN_HEIGHT, MAIN_SPP
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                       samples_per_frame=spp, max_bounces=50,
                       engine="fused", intersector="baked",
                       baked_clusters=16, block_tiles=32)
    arrays = prepare_scene(scene, cfg, device, tris)
    perm, _ = fused._block_perm(w, h, 32)
    pix = torch.from_numpy(perm.astype(np.int64)).to(device)
    view = cc.view_matrix()

    def render(config, probe=()):
        tables = fused.scene_tables(config, arrays, view)
        rad, rays, st = fused.render_pixels(
            pix, arrays, cc.gpu_camera(), view,
            cc.inverse_projection(w, h), config, 0, 0, spp,
            with_stats=True, probe=probe, **tables)
        return rad, [int(rays)] + [int(st[k]) for k in (
            "iterations", "supers_entered", "clusters_entered")]

    hinted = cfg.replace(winner_hint=True)
    if not fused.scene_tables(hinted, arrays, view)["baked"].winner_hint:
        raise AssertionError("book_checker's bake has no winner hint")
    _reset_launches()
    rad_b, stats_b = render(hinted)
    rad_p, stats_p = render(hinted, "hint_count")
    torch.cuda.synchronize()
    launches = _read_launches()["culled_hint/hint_count"]
    fused._check_probe_render("hint_count", rad_p, stats_p, rad_b, stats_b,
                              spp)
    _rad_u, stats_u = render(cfg)
    rays = stats_b[0]
    prepass = stats_p[2] - stats_b[2]
    hint = {"stats_base": stats_b, "stats_probed": stats_p,
            "stats_unhinted": stats_u, "prepass_entries": prepass,
            "prepass_per_ray": prepass / rays,
            "clusters_per_ray": stats_b[3] / rays,
            "clusters_per_ray_unhinted": stats_u[3] / stats_u[0],
            "prepass_share_of_clusters": prepass / max(stats_b[3], 1),
            "launches": launches}
    log(f"[segstage] hint_count book_checker {w}x{h}@{spp}spp baked/16 "
        f"--winner-hint: {prepass} prepass entries over {rays} rays "
        f"({hint['prepass_per_ray']:.4f} a ray, "
        f"{hint['prepass_share_of_clusters']:.2%} of the "
        f"{hint['clusters_per_ray']:.4f} clusters entered a ray; without "
        f"the hint {hint['clusters_per_ray_unhinted']:.4f}); the probed "
        f"render's radiance words, rays, iterations and clusters equal the "
        f"base's; probe launches {launches} [{smi}]")
    if launches != 1 or prepass <= 0:
        raise AssertionError(f"segstage hint_count: {launches} launches, "
                             f"{prepass} prepass entries")
    out["hint_count"] = hint
    return out

# Phase hier: the hierarchy parameters of ops/bake.py bake_culled and the
# dynamic tables' cluster sizes (rows 2 and 3 at table shapes the other
# phases do not give them), and the sweeps of probes/ that choose them.
HIER_SIZE = (160, 90, 4)
HIER_BOUNCES = 4
HIER_REPS = 10             # calls of a kernel's timed run
# (label, sweep, kernel kind, scene, cluster size, the bake's or the
# table's parameters ({}: the render path's own tables), the wrapper's
# options)
HIER_CASES = (
    ("super_gate gate 0 x super 8", "super_gate", "culled", "book", 16,
     {"super_gate": 0, "super_factor": 8}, {}),
    ("super_gate gate 0 x super 4", "super_gate", "culled", "book", 16,
     {"super_gate": 0, "super_factor": 4}, {}),
    ("super_gate gate 0 x super 16", "super_gate", "culled", "book", 16,
     {"super_gate": 0, "super_factor": 16}, {}),
    ("super_gate global factor 3", "super_gate", "culled", "book", 16,
     {"global_radius_factor": 3.0}, {}),
    ("super_gate global factor 0 (all globals)", "super_gate", "culled",
     "book", 16, {"global_radius_factor": 0.0}, {}),
    ("sweep10k 16x8", "sweep10k", "culled", "procedural", 16, {}, {}),
    ("sweep10k 32x8", "sweep10k", "culled", "procedural", 32, {}, {}),
    ("sweep10k 64x8", "sweep10k", "culled", "procedural", 64, {}, {}),
    ("sweep10k 32x16", "sweep10k", "culled", "procedural", 32,
     {"super_factor": 16}, {}),
    ("cullstats baked lanes", "cullstats", "culled", "book", 16, {},
     {"lane_counts": True}),
    ("rr_floor_sweep rr 3 floor 0.25", "rr_floor_sweep", "culled", "book",
     16, {}, {"rr_start": 3, "rr_floor": 0.25}),
    ("dynsweep clusters 8", "dynsweep", "dynculled", "book", 8, {}, {}),
    ("dynsweep clusters 32", "dynsweep", "dynculled", "book", 32, {}, {}),
    ("dynsweep clusters 64", "dynsweep", "dynculled", "book", 64, {}, {}),
    ("dynnocull all globals", "dynnocull", "dynculled", "book", 16,
     {"global_radius_factor": 0.0}, {}),
    ("cullstats dynamic lanes procedural/8", "cullstats_dyn", "dynculled",
     "procedural", 8, {}, {"lane_counts": True}),
    ("meshscale knot 2000", "meshscale", "dynculled", "knot2000", 16, {},
     {}),
    ("meshscale knot 8000", "meshscale", "dynculled", "knot8000", 16, {},
     {}),
)
_CUT = ["--width", str(HIER_SIZE[0]), "--height", str(HIER_SIZE[1]),
        "--spp", str(HIER_SIZE[2])]
# Each sweep: its kernel, the case whose kernel time stands for it on the
# kernels line, the cases it runs, and its command lines at a cut size.
# The sweeps' bakes and tables come from the render path's caches, which
# the cases filled: sweep10k runs first, while its four bakes of 10,001
# spheres are still there.
HIER_SWEEPS = {
    "sweep10k": ("culled", "sweep10k 32x16", "sweep10k",
                 [["sweep10k", *_CUT, "--reps", "1"]]),
    "super_gate": ("culled", "super_gate gate 0 x super 4", "super_gate", [
        ["super_gate", "--configs", "48x8,0x8,0x4,0x16",
         "--global-radius-factor", "10,3,0", *_CUT, "--reps", "1"]]),
    "dynsweep": ("dynculled", "dynsweep clusters 8", "dynsweep",
                 [["dynsweep", *_CUT, "--reps", "1"]]),
    "dynnocull": ("dynculled", "dynnocull all globals", "dynnocull",
                  [["dynnocull", *_CUT, "--reps", "1"]]),
    "cullstats": ("culled", "cullstats baked lanes", "cullstats",
                  [["cullstats", *_CUT]]),
    "cullstats bruteforce": ("dynculled",
                             "cullstats dynamic lanes procedural/8",
                             "cullstats_dyn",
                             [["cullstats", *_CUT, "--intersector",
                               "bruteforce", "--scene", "procedural",
                               "--clusters", "8"]]),
    "meshscale": ("dynculled", "meshscale knot 8000", "meshscale",
                  [["meshscale", "2000", "8000", "--reps", "1"]]),
    "knotbench": ("dynculled", "meshscale knot 8000", "meshscale",
                  [["knotbench", "8000", "160x90", "4", "--reps", "1"],
                   ["knotbench", "8000", "160x90", "4", "recluster=2",
                    "--reps", "1"]]),
    "rr_floor_sweep": ("culled", "rr_floor_sweep rr 3 floor 0.25",
                       "rr_floor_sweep",
                       [["rr_floor_sweep", "--gate-spp", "8", "--gate-spf",
                         "8", "--time-size", "160x90", "--time-spp", "4",
                         "--reps", "1"]]),
}


def _hier_scene(name: str, scenes: dict):
    """(scene, triangles, camera) of a HIER_CASES scene name, made once."""
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        get_scene,
        knot_camera,
        knot_scene,
    )

    if name not in scenes:
        if name.startswith("knot"):
            scene, tris = knot_scene(int(name[len("knot"):]))
            scenes[name] = (scene, tris, knot_camera())
        else:
            scenes[name] = (get_scene({"book": "book_one_final"}.get(
                name, name)), None, CameraController.book_one_final())
    return scenes[name]


def _hier_cases(device):
    """(label, sweep, Case) of every HIER_CASES entry at HIER_SIZE."""
    w, h, spp = HIER_SIZE
    scenes = {}
    for label, sweep, kind, name, clusters, hier, kw in HIER_CASES:
        scene, tris, cam = _hier_scene(name, scenes)
        yield label, sweep, Case(kind, clusters, scene, cam, w, h, spp, 1,
                                  kw, device, triangles=tris,
                                  bounces=HIER_BOUNCES, hier=hier)


def _hier_check(label, case) -> dict:
    """The kernel against its plain version's result (phase hier's plain
    part, or run here): radiance words, the four counters and, with
    ``lane_counts``, each lane's counters bit for bit; then the kernel's
    time (CUDA events, the mean of HIER_REPS calls) beside its bound."""
    from wavefront_path_tracer_tpu_torch.utils.parity import parity_report

    before = case.launches()
    k = case.kernel()
    torch.cuda.synchronize()
    if case.launches() != before + 1:
        raise AssertionError(f"{label}: the wrapper did not count its launch")
    p = _PLAIN_OUT.get(case.key)
    if p is None:
        p = _PLAIN_OUT[case.key] = case.plain()
    stats_k, stats_p = k[3].tolist(), p[3].tolist()
    bit_exact = stats_k == stats_p and all(
        torch.equal(_bits(a), _bits(b)) for a, b in zip(k[:3], p[:3]))
    lanes_exact = len(k) < 5 or torch.equal(k[4], p[4])
    rep = parity_report(case.image(k), case.image(p))
    rep.update(case=label, kernel=case.kind, stats_kernel=stats_k,
               stats_plain=stats_p, bit_exact=bit_exact,
               lanes_exact=lanes_exact)
    rep["kernel_ms"], _ = _time_ms(case.kernel, HIER_REPS)
    rep.update(case.bound(stats_k))
    log(f"[hier-check] {json.dumps(rep)}")
    if not (bit_exact and lanes_exact):
        raise AssertionError(f"{label}: kernel and plain version differ")
    if case.has_clusters() and not stats_k[3] > 0:
        raise AssertionError(f"{label}: no cluster was entered")
    return rep


def _hier_sweep(argvs, kind: str, device) -> dict:
    """Run a sweep's command lines in this process, with the launch
    counts set to 0 just before and read just after: {launches of its
    kernel, of the dynamic segment kernel, seconds, records}."""
    import importlib

    _reset_launches()
    t0 = time.perf_counter()
    records = []
    for module, *argv in argvs:
        mod = importlib.import_module(
            f"wavefront_path_tracer_tpu_torch.probes.{module}")
        records.append(mod.run(mod.build_parser().parse_args(
            [*argv, "--device", device.type])))
    torch.cuda.synchronize()
    launches = _read_launches()
    return {"launches": launches[kind],
            "segment_launches": launches["segment_dynculled"],
            "seconds": time.perf_counter() - t0, "records": records}


def phase_hier(device, smi: str, part=None) -> dict:
    """Phase hier.  Part "plain" (untimed, in the window): the plain
    version of every HIER_CASES case, each timed once, its result handed
    back.  Part "kernels": each case's kernel bit for bit against it and
    timed, then every sweep of HIER_SWEEPS at a cut size with its
    kernel's launches read alone; each must launch its kernel, the
    two-level bakes must enter supers, and knotbench's recluster=2 must
    run the dynamic segment kernel."""
    out = {}
    if part in (None, "plain"):
        out["plain"] = []
        for label, _sweep, case in _hier_cases(device):
            plain_ms, _PLAIN_OUT[case.key] = _time_ms(case.plain, 1)
            out["plain"].append({"case": label, "plain_ms": plain_ms})
            log(f"[hier-plain] {label}: plain version {plain_ms:.1f} ms")
    if part in (None, "kernels"):
        out["checks"] = []
        for label, sweep, case in _hier_cases(device):
            rep = _hier_check(label, case)
            rep["sweep"] = sweep
            two_level = case.kind == "culled" and bool(
                case.baked.super_ranges.shape[0])
            if two_level and not rep["stats_kernel"][2] > 0:
                raise AssertionError(f"{label}: no super was entered")
            out["checks"].append(rep)
        out["sweeps"] = {}
        for name, (kind, _case, _cases, argvs) in HIER_SWEEPS.items():
            run = _hier_sweep(argvs, kind, device)
            log(f"[hier-sweep] {name}: {run['launches']} launches of the "
                f"{kind} kernel, {run['seconds']:.1f} s [{smi}]")
            if not run["launches"] > 0:
                raise AssertionError(f"{name}: its kernel was not launched")
            out["sweeps"][name] = run
        if not out["sweeps"]["knotbench"]["segment_launches"] > 0:
            raise AssertionError("knotbench recluster=2: no segment launch")
    return out


def _hier_kernels(record: dict) -> list[dict]:
    """The kernels line's entries of phase hier: one a sweep, its kernel
    (row 2 or 3) at the configuration that stands for it: its time alone
    and its bound at HIER_SIZE, its plain version's (in the window), the
    largest error over the sweep's cases, its launches from the sweep's
    own run at a cut size."""
    hier = record["hier"]
    plain = {r["case"]: r["plain_ms"] for r in hier["plain"]}
    checks = {r["case"]: r for r in hier["checks"]}
    out = []
    for name, (kind, case, cases, _argvs) in HIER_SWEEPS.items():
        rep = checks[case]
        out.append({
            "name": f"{KERNELS[kind]['name']} in probes.{name} ({case})",
            "route": "cuda", "source": KERNELS[kind]["source"],
            "replaces": KERNELS[kind]["replaces"],
            "launches": hier["sweeps"][name]["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in hier["checks"]
                               if r["sweep"] == cases),
            "ms": rep["kernel_ms"], "plain_ms": plain[case],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": None,
        })
    return out


# Phase drivers: the last nine drivers of probes/ and examples/, each at
# a cut size and held to its own invariant.  Every output goes under
# DRIVERS_DIR; golden/ is only read.
DRIVERS_DIR = os.path.join(OUT_DIR, "drivers")
GATE_ROWS = "baked_cull16,golden_baked_cull16"
GATE_TIMEOUT = 400         # seconds a gate row's process may take
GOLDEN_CUT = (6, 2)        # make_golden's samples and batch
# Set where this script builds the stage probes' library beside the
# window: a process apart then waits for that build instead of its own.
PROBE_BUILD_ENV = "WPT_SMOKE_PROBE_BUILD"


def _golden_hashes() -> dict:
    import hashlib
    from pathlib import Path

    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(Path(ROOT, "golden").iterdir())}


def _await_probe_library() -> None:
    """Wait up to APART_TIMEOUT for the stage probes' library that the
    script which started this process builds beside the window; without
    that build (``--phases drivers`` alone) nothing is waited for."""
    from wavefront_path_tracer_tpu_torch.ops import _build

    if os.environ.get(PROBE_BUILD_ENV) != "1":
        return
    path = (_build.BUILD_ROOT / _build._digest(_build.PROBE_LIB_NAME)
            / _build.PROBE_LIB_NAME)
    t0 = time.perf_counter()
    while not path.exists() and time.perf_counter() - t0 < APART_TIMEOUT:
        time.sleep(1.0)
    log(f"[drivers] the probes' library there after "
        f"{time.perf_counter() - t0:.1f} s of waiting")


class _Interrupt(Exception):
    """Stands for a kill of make_golden after its first batch."""


def _make_golden_resume(dev: str) -> dict:
    """make_golden at GOLDEN_CUT on the card, once whole, once stopped
    after its first batch and resumed from its checkpoint: the two
    artifacts' images bit for bit, the checkpoint gone."""
    from wavefront_path_tracer_tpu_torch import renderer
    from wavefront_path_tracer_tpu_torch.probes import make_golden as mg

    saved = (mg.SPP, mg.BATCH, mg.CKPT_DIR, renderer.Renderer)
    mg.SPP, mg.BATCH = GOLDEN_CUT
    mg.CKPT_DIR = os.path.join(DRIVERS_DIR, "make_golden_ckpt")
    whole = os.path.join(DRIVERS_DIR, "golden_whole.npz")
    parted = os.path.join(DRIVERS_DIR, "golden_resumed.npz")
    ckpt = mg.checkpoint_path(parted)
    for path in (whole, parted, ckpt, mg.checkpoint_path(whole)):
        if os.path.exists(path):
            os.remove(path)

    class Stopped(renderer.Renderer):
        def render_frame(self):
            if self.progress.frame == 1:
                raise _Interrupt
            return super().render_frame()

    try:
        first = mg.run(mg.build_parser().parse_args(
            [whole, "--device", dev]))
        renderer.Renderer = Stopped
        try:
            mg.run(mg.build_parser().parse_args(
                [parted, "--device", dev]))
            raise AssertionError("make_golden: the interruption never came")
        except _Interrupt:
            pass
        renderer.Renderer = saved[3]
        if not os.path.exists(ckpt) or os.path.exists(parted):
            raise AssertionError("make_golden: no checkpoint after one batch")
        resumed = mg.run(mg.build_parser().parse_args(
            [parted, "--device", dev]))
    finally:
        mg.SPP, mg.BATCH, mg.CKPT_DIR, renderer.Renderer = saved
    a, b = np.load(whole), np.load(parted)
    same = bool(np.array_equal(a["image"], b["image"])
                and str(a["meta"]) == str(b["meta"]))
    if resumed["resumed_at"] != GOLDEN_CUT[1] or not same \
            or os.path.exists(ckpt):
        raise AssertionError(f"make_golden: resumed at "
                             f"{resumed['resumed_at']}, images equal {same}")
    return {"whole_seconds": first["seconds"],
            "resumed_at": resumed["resumed_at"], "bit_exact": same,
            "platform": str(b["platform"])}


def _drivers_steps(device) -> list:
    """(name, kernel kinds it must launch, run) of each driver; run
    returns its record and raises where its invariant fails."""
    import importlib

    dev = device.type

    def mod(name):
        pkg = "examples" if name == "turntable" else "probes"
        return importlib.import_module(
            f"wavefront_path_tracer_tpu_torch.{pkg}.{name}")

    def run(name, argv):
        m = mod(name)
        return m.run(m.build_parser().parse_args([*argv, "--device", dev]))

    def gate_sweep():
        out = os.path.join(DRIVERS_DIR, "GATE_SWEEP.json")
        rc = mod("gate_sweep").main([
            "--only", GATE_ROWS, "--out", out, "--cache-dir",
            os.path.join(DRIVERS_DIR, "gate_cache"), "--timeout",
            str(GATE_TIMEOUT), "--device", dev])
        with open(out) as f:
            rows = json.load(f)["rows"]
        kinds = {r["name"].startswith("golden_") for r in rows}
        if rc != 0 or kinds != {True, False} or not all(
                r.get("ok") and r.get("pass") for r in rows):
            raise AssertionError(f"gate_sweep: exit {rc}, rows {rows}")
        return {"rows": [{k: r.get(k) for k in ("name", "config", "engine",
                                                "rmse", "gate", "pass",
                                                "wall_s")} for r in rows]}

    def matsplit():
        rows = run("matsplit_ab", ["64", "32", "2", "1"])
        if any(r["rmse"] != 0.0 for r in rows):
            raise AssertionError(f"matsplit_ab: {rows}")
        return {"rows": rows}

    def knotprobe():
        _await_probe_library()
        return run("knotprobe", ["2000", "64x32", "2"])

    def turntable():
        from wavefront_path_tracer_tpu_torch.utils.image import read_gif_info

        gif = os.path.join(DRIVERS_DIR, "turntable.gif")
        rec = run("turntable", ["--frames", "3", "--width", "64",
                                "--height", "36", "--spp", "4", "--out",
                                gif])
        info = read_gif_info(gif)
        if info["frames"] != 3 or (info["width"], info["height"]) != (64, 36):
            raise AssertionError(f"turntable: the GIF holds {info}")
        return {"seconds": rec["seconds"], "gif": info}

    return [
        ("gate_sweep", (), gate_sweep),
        ("make_golden", (), lambda: _make_golden_resume(dev)),
        ("matsplit_ab", (), matsplit),
        ("clamp_bias", (), lambda: {"rows": run(
            "clamp_bias", ["--spp", "16", "--width", "32", "--height",
                           "18"])}),
        ("variance10", ("culled",), lambda: run(
            "variance10", ["--runs", "3", "--procs", "1", "--width", "64",
                           "--height", "32", "--spp", "4"])),
        ("texlut", ("unculled",), lambda: run(
            "texlut", ["512", "8192", "--width", "64", "--height", "32",
                       "--spp", "4"])),
        ("bounce0", ("culled",), lambda: run(
            "bounce0", ["--width", "64", "--height", "64", "--spp", "2"])),
        ("turntable", ("unculled",), turntable),
        ("knotprobe", tuple(f"dynculled/{p}" for p in (
            "dbl_raygen", "dyn_dbl_entry", "dyn_dbl_cond", "dyn_dbl_global",
            "dbl_shade", "dbl_accum", "dbl_loopcond")), knotprobe),
    ]


def phase_drivers(device, smi: str) -> dict:
    """Each driver of ``_drivers_steps`` in this process, its output in
    DRIVERS_DIR, the launch counts set to 0 just before it and read just
    after (each must launch its kernels); then golden/ must hash as it
    did before."""
    import contextlib

    os.makedirs(DRIVERS_DIR, exist_ok=True)
    before = _golden_hashes()
    out = {}
    for name, kinds, step in _drivers_steps(device):
        path = os.path.join(DRIVERS_DIR, f"{name}.log")
        _reset_launches()
        t0 = time.perf_counter()
        with open(path, "w") as f, contextlib.redirect_stdout(f):
            rec = step()
        torch.cuda.synchronize()
        launches = _read_launches()
        rec.update(seconds=time.perf_counter() - t0,
                   launches={k: launches[k] for k in kinds})
        log(f"[drivers] {name}: {rec['seconds']:.1f} s, launches "
            f"{rec['launches']} [{smi}]")
        missing = [k for k in kinds if not launches[k] > 0]
        if missing:
            raise AssertionError(f"{name}: no launch of {missing}")
        out[name] = rec
    after = _golden_hashes()
    if after != before:
        raise AssertionError(f"drivers: golden/ changed: {before} -> {after}")
    out["golden_unchanged"] = sorted(after)
    log(f"[drivers] golden/ unchanged ({len(after)} files); gate rows "
        f"{json.dumps(out['gate_sweep']['rows'])}; matsplit rmse "
        f"{[r['rmse'] for r in out['matsplit_ab']['rows']]}; make_golden "
        f"resumed at {out['make_golden']['resumed_at']} bit for bit")
    return out


PHASES = ("kernels", "golden", "main", "full", "mesh", "meshfull",
          "meshplain", "tex", "texfull", "seg", "segfull", "probes",
          "sweep", "loop", "segform", "oracle", "wavefront", "bench", "app",
          "multi", "stageplain", "stage", "segstage", "hier", "drivers")
# Phases, and parts of phases (PARTS: shares of a phase's cases), that
# time nothing.  With more than one phase to run, WINDOW runs here first
# while each of APART runs beside it in a process of its own, and the
# bench's ``--all`` as a child; the other phases wait until all of them
# have ended, so that no timed phase shares the card.  A phase apart hands
# back its record and its plain versions' results (``_PLAIN_OUT``).
PARTS = {"kernels": ("book", "mesh"), "oracle": ("tpu", "scenes"),
         "stageplain": tuple(STAGE_PARTS), "hier": ("plain", "kernels")}
WINDOW = (("kernels", "book"),)
APART = (("kernels", "mesh"), ("meshplain", None), ("tex", None),
         ("seg", None), ("oracle", "tpu"), ("oracle", "scenes"),
         *(("stageplain", part) for part in STAGE_PARTS), ("hier", "plain"),
         ("drivers", None))
APART_TIMEOUT = 600        # seconds a phase apart may take


def _label(phase: str, part) -> str:
    return phase if part is None else f"{phase}/{part}"


def _apart_path(label: str, suffix: str) -> str:
    return os.path.join(OUT_DIR, f"chip_smoke_{label.replace('/', '_')}."
                        f"{suffix}")


def _merge(old, new):
    """A phase's record with one more part's added."""
    if old is None:
        return new
    if isinstance(old, list):
        return old + new
    out = dict(old)
    for key, value in new.items():
        out[key] = ({**out[key], **value} if isinstance(value, dict)
                    and isinstance(out.get(key), dict) else value)
    return out


def _end_window(children: dict, all_child, keys: dict, record: dict,
                device, t_window: float) -> None:
    """Wait for the phases apart and the bench's ``--all``, print their
    output, and take each one's record into ``record`` and its plain
    results into ``_PLAIN_OUT``; a phase apart that failed or outlasted
    APART_TIMEOUT fails the run."""
    for (phase, part), child in children.items():
        label = _label(phase, part)
        rc, text, seconds = child.wait(
            APART_TIMEOUT - (time.perf_counter() - child.t0))
        sys.stdout.write(text)
        sys.stdout.flush()
        if rc != 0:
            raise AssertionError(f"phase {label}, in a process of its own: "
                                 f"exit {rc}")
        with open(_apart_path(label, "json")) as f:
            apart = json.load(f)
        record[keys[phase]] = _merge(record.get(keys[phase]),
                                     apart[keys[phase]])
        record["phase_seconds"][label] = apart["phase_seconds"][label]
        plain = _apart_path(label, "plain")
        if os.path.exists(plain):
            _PLAIN_OUT.update(torch.load(plain, map_location=device,
                                         weights_only=False))
            os.remove(plain)          # a hand-off, not a result
        log(f"[phase] {label} done in {apart['phase_seconds'][label]:.1f} s "
            f"in a process of its own, beside "
            f"{', '.join(_label(*w) for w in WINDOW)} ({seconds:.1f} s with "
            f"its start)")
    if all_child is not None:
        all_child.wait(BENCH_TIMEOUT - (time.perf_counter() - all_child.t0))
    if children or all_child is not None:
        beside = ([_label(*c) for c in children]
                  + (["bench --all"] if all_child else []))
        log(f"[window] {', '.join(_label(*w) for w in WINDOW)} here and "
            f"{', '.join(beside)} beside: "
            f"{time.perf_counter() - t_window:.1f} s")


def _stage_kernels(record: dict) -> list[dict]:
    """The kernels line's entries of the stage probes: one a kernel and
    probe, its numbers from book_one_final at STAGE_SIZE (the kernel's
    time alone in phase stage, its plain version's in the window), its
    launches from its main path's run: its --stage-timing table's, the
    iterprobe run of dbl_entry2 and dbl_cond2, or phase segstage's."""
    from wavefront_path_tracer_tpu_torch.ops import stage_probes

    stage, segstage = record["stage"], record["segstage"]
    plain = {r["case"]: r["plain_ms"] for r in record["stage_plain"]}
    tables = {spec[2]: stage["tables"][label]["launches"]
              for label, *spec in STAGE_TABLES}
    iter_new = stage["scripts"]["iterprobe_new"]["launches"]
    cells = {c[1]: segstage[c[0]]["launches"] for c in SEGSTAGE_CELLS}
    names = {"culled": KERNELS["culled"]["name"],
             "culled_hint": "fused_render_baked/baked_culled_intersect "
                            "with the winner hint",
             "unculled": "fused_render_baked/baked_intersect",
             "dynculled": "fused_render_dynculled/"
                          "make_dynamic_culled_intersect",
             "segment_culled": "fused_segment_baked/_segment_impl over "
                               "baked_culled_intersect",
             "segment_dynculled": "fused_segment_dynculled/_segment_impl"}
    second = ("dbl_entry2", "dbl_cond2")
    out = []
    for kind, probes in stage_probes.KERNEL_PROBES.items():
        for probe in probes:
            src = {"culled": "baked_probe2.cu" if probe in second
                   else "baked_probe.cu",
                   "culled_hint": "baked_probe2.cu",
                   "unculled": "baked_probe_unculled.cu",
                   "dynculled": "dynculled_probe.cu",
                   "segment_culled": "baked_probe_seg2.cu"
                   if probe in second else "baked_probe_seg.cu",
                   "segment_dynculled": "dynculled_probe_seg.cu"}[kind]
            if kind in cells:
                launches = cells[kind][probe]
            elif kind == "culled_hint":
                launches = segstage["hint_count"]["launches"]
            elif probe in second:
                launches = iter_new[f"{kind}/{probe}"]
            else:
                launches = tables[kind][probe]
            rep = stage["timed"][f"{kind}/{probe}"]
            out.append({
                "name": f"{names[kind]} with the stage probe {probe}",
                "route": "cuda", "source": SOURCE + src,
                "replaces": REPLACES + str(PROBE_POINTS[probe]),
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in stage["checks"]
                                   if r["case"].startswith(
                                       f"{kind}/") and r["probe"] == probe),
                "ms": rep["kernel_ms"], "plain_ms": plain[rep["case"]],
                "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                "library_ms": None,
            })
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ", ".join(PHASES)
                    + " (device and build always run, and build may be "
                    "named; the closing JSON "
                    "lines need them all)")
    ap.add_argument("--part", default=None,
                    help="with one phase of PARTS, run only that share of "
                    "its cases: " + "; ".join(
                        f"{k}: {', '.join(v)}" for k, v in PARTS.items()))
    ap.add_argument("--record", default=os.path.join(OUT_DIR,
                                                     "chip_smoke.json"),
                    help="where to write the JSON record of the run")
    ap.add_argument("--plain-out", default=None,
                    help="where to save the plain versions' results of the "
                    "cases checked (torch.save)")
    args = ap.parse_args(argv)
    # "build" names the build, which runs with every subset.
    phases = set(args.phases.split(",")) - {"", "build"}
    if phases - set(PHASES):
        raise SystemExit(f"unknown phases {sorted(phases - set(PHASES))}")
    if args.part is not None and (len(phases) != 1 or args.part not in
                                  PARTS.get(next(iter(phases)), ())):
        raise SystemExit(f"--part {args.part}: takes one phase of {PARTS}")
    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        return _smoke(phases, args.part, args.record, args.plain_out)
    finally:
        _kill_tree(os.getpid(), spare_root=True)


def _smoke(phases: set, part, record_path: str, plain_out) -> int:
    name, smi = phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()
    build = phase_build()
    record = {"card": smi, "device": name, "build_seconds": build["seconds"],
              **{k: v for k, v in build.items() if k.endswith("_ptxas")}}
    # The stage probes' library, built in a thread beside the window (it
    # times nothing) and waited for at its end.
    probe_build = None
    if phases & {"stage", "segstage"}:
        from wavefront_path_tracer_tpu_torch.ops import _build

        pool = ThreadPoolExecutor(1)
        probe_build = pool.submit(phase_build, _build.PROBE_LIB_NAME)
        pool.shutdown(wait=False)
        os.environ[PROBE_BUILD_ENV] = "1"     # for the processes apart
    # The window (see WINDOW) and the processes beside it.
    concurrent = len(phases) > 1
    window = [w for w in WINDOW if concurrent and w[0] in phases]
    children = {}
    for phase, share in APART:
        if concurrent and phase in phases:
            label = _label(phase, share)
            children[(phase, share)] = Child(
                [os.path.abspath(__file__), "--phases", phase,
                 "--record", _apart_path(label, "json"),
                 "--plain-out", _apart_path(label, "plain")]
                + (["--part", share] if share else []), "phase " + label)
    all_child = (_start_bench(list(BENCH_ALL))
                 if concurrent and "bench" in phases else None)
    t_window = time.perf_counter()
    steps = (("kernels", "parity",
              lambda part: phase_kernel_vs_plain(device, part)),
             ("golden", "golden", lambda part: phase_golden(device)),
             ("main", "main_paths",
              lambda part: phase_main_paths(device, smi)),
             ("full", "full_size", lambda part: phase_full_size(device, smi)),
             ("mesh", "mesh_rows", lambda part: phase_mesh_rows(device, smi)),
             ("meshfull", "mesh_full_size",
              lambda part: phase_mesh_full_size(device, smi)),
             ("meshplain", "mesh_plain",
              lambda part: phase_mesh_plain(device)),
             ("tex", "textures", lambda part: phase_textures(device)),
             ("texfull", "textures_full",
              lambda part: phase_textures_full(device, smi)),
             ("seg", "segments", lambda part: phase_segments(device)),
             ("segfull", "segments_full",
              lambda part: phase_segments_full(device, smi)),
             ("probes", "probes", lambda part: phase_probes(device, smi)),
             ("sweep", "sweep", lambda part: phase_sweep(device, smi)),
             ("loop", "loop", lambda part: phase_loop(device, smi)),
             ("segform", "segform", lambda part: phase_segform(device, smi)),
             ("oracle", "oracle",
              lambda part: phase_oracle(device, smi, part)),
             ("wavefront", "wavefront",
              lambda part: phase_wavefront(device, smi)),
             ("bench", "bench",
              lambda part: phase_bench(device, smi, all_child)),
             ("app", "app", lambda part: phase_app(device, smi)),
             ("multi", "multi", lambda part: phase_multi(
                 device, smi, record.get("bench", {}).get("default"))),
             ("stageplain", "stage_plain",
              lambda part: phase_stage_plain(device, part)),
             ("stage", "stage", lambda part: phase_stage(device, smi)),
             ("segstage", "segstage",
              lambda part: phase_segstage(device, smi)),
             ("hier", "hier", lambda part: phase_hier(device, smi, part)),
             ("drivers", "drivers", lambda part: phase_drivers(device, smi)))
    keys = {phase: key for phase, key, _run in steps}
    runs = {phase: run for phase, _key, run in steps}
    record["phase_seconds"] = {}

    def run_step(phase: str, share) -> None:
        label = _label(phase, share)
        t0 = time.perf_counter()
        record[keys[phase]] = _merge(record.get(keys[phase]),
                                     runs[phase](share))
        record["phase_seconds"][label] = time.perf_counter() - t0
        log(f"[phase] {label} done in "
            f"{record['phase_seconds'][label]:.1f} s")

    for phase, share in window:
        run_step(phase, share)
    _end_window(children, all_child, keys, record, device, t_window)
    if probe_build is not None:
        record["probe_build"] = probe_build.result()
    # A phase runs here unless the window and the processes apart ran it;
    # where they ran some of its parts, the others run here.
    covered = set(window) | set(children)
    for phase, _key, _run in steps:
        if phase not in phases:
            continue
        if not any(c[0] == phase for c in covered):
            run_step(phase, part)
            continue
        for share in PARTS.get(phase, ()):
            if (phase, share) not in covered:
                run_step(phase, share)
    if plain_out is not None:
        torch.save(dict(_PLAIN_OUT), plain_out)
    record["seconds_total"] = time.perf_counter() - t_start
    with open(record_path, "w") as f:
        json.dump(record, f, indent=1)
    log(f"[total] {record['seconds_total']:.1f} s after the device check "
        f"(build {build['seconds']:.1f} s); by phase "
        + json.dumps({k: round(v, 1)
                      for k, v in record["phase_seconds"].items()}))
    if phases != set(PHASES):
        log(f"[partial] ran {sorted(phases)}; no closing lines")
        return 0

    parity, main_paths = record["parity"], record["main_paths"]
    full, mesh = record["full_size"], record["mesh_rows"]
    head, brute = main_paths["culled"], full["timed"]
    log(f"[headline] baked/cull16 cli {MAIN_WIDTH}x{MAIN_HEIGHT}@{MAIN_SPP}"
        f"spp: render {head['render_seconds']:.3f} s, "
        f"{head['mrays_per_s']:.1f} Mrays/s, "
        f"{brute['culled']['clusters_per_ray']:.4f} clusters entered per "
        f"ray; kernel {brute['culled']['kernel_ms']!r} ms vs brute-force "
        f"kernel {brute['persistent']['kernel_ms']!r} ms at that shape; "
        f"1080p@1spp kernel {full['checks']['culled'][0]['kernel_ms']!r} ms "
        f"vs plain {full['checks']['culled'][0]['plain_ms']!r} ms [{smi}]")
    mesh_checks = record["mesh_full_size"]["checks"] + record["mesh_plain"]
    tex, tex_full = record["textures"], record["textures_full"]
    kernels = []
    for kind, spec in KERNELS.items():
        reps = [r for r in parity + tex + tex_full["checks"]
                if r["kernel"] == kind]
        reps += [r for r in mesh_checks if r["kernel"] == kind]
        if kind == "textured":
            # ms and bound: the textured culled kernel at 1080p@32spp;
            # plain_ms: its plain version at the 1080p planes, 1 spp.
            # The step's own: its time in that kernel (the median of the
            # textured/untextured A/B's paired differences), its bound,
            # and ops/textures.py's step over that frame's hits.
            timed = tex_full["timed"][1]
            step = tex_full["step"]
            own = step["rows"]["culled16"]
            kernels.append({
                "name": spec["name"], "route": "cuda",
                "source": spec["source"], "replaces": spec["replaces"],
                "launches": tex_full["cli"]["culled"]["launches"],
                "max_abs_err": max(r["max_abs_err"] for r in
                                   tex + tex_full["checks"]),
                "ms": timed["kernel_ms"],
                "plain_ms": tex_full["checks"][0]["plain_ms"],
                "bound_ms": timed["bound_ms"],
                "bound_by": timed["bound_by"],
                "library_ms": None,
                "own_ms": own["own_ms"],
                "own_least_ms": own["own_least_ms"],
                "step_bound_ms": own["bound_ms"],
                "step_plain_ms": step["plain_ms"],
            })
            continue
        if kind.startswith("segment_"):
            seg = record["segments_full"]
            reps = [r for r in record["segments"] + list(
                seg["checks"].values()) if r["kernel"] == kind]
            main_check = seg["checks"][kind[len("segment_"):]]
            launches = (main_paths[kind]["launches"] if "argv" in spec
                        else next(r["launches"] for r in seg["rows"]
                                  if r["row"] == "knot50k_dynamic"
                                  and r["recluster"] == 2))
        elif kind == "dynculled":
            main_check = mesh_checks[0]            # terrain 800x448@1spp
            launches = mesh["terrain_dynamic"]["launches"]
        else:
            reps += full["checks"][kind]
            main_check = full["checks"][kind][0]   # 1080p@1spp
            launches = main_paths[kind]["launches"]
        kernels.append({
            "name": spec["name"], "route": "cuda",
            "source": spec["source"], "replaces": spec["replaces"],
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in reps),
            "ms": main_check["kernel_ms"],
            "plain_ms": main_check["plain_ms"],
            "bound_ms": main_check["bound_ms"],
            "bound_by": main_check["bound_by"],
            "library_ms": None,
        })
    record["ceiling_shares"] = _ceiling_shares(record)
    probes = record["probes"]
    for key, spec in PROBE_KERNELS.items():
        rep = probes["timed"][key]
        kernels.append({
            "name": spec["name"], "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"],
            "launches": probes["launches"][key],
            "max_abs_err": max(probes["max_abs_err"][key],
                               rep["max_abs_err"]),
            "ms": rep["kernel_ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep.get("library_ms"),
        })
    kernels += _stage_kernels(record)
    kernels += _hier_kernels(record)
    with open(record_path, "w") as f:
        json.dump(record, f, indent=1)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
