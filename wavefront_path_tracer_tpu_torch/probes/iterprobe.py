"""Each stage's share of the fused baked culled kernel's time, by the
differential stage probes (the port of ``exp/iterprobe.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.iterprobe \
        [--variants full,dbl_entry,...] [--device cuda|cpu]

At the reference's defaults: book_one_final at 1920x1080, 32 spp, 50
bounces, baked culled in clusters of 16, block order, its camera.  Each
variant is one render (``models/fused.py`` ``render_pixels``) with one
probe of ``ops/stage_probes.py`` (``full``: none), whose share of the
time is (t_probe - t_full) / t_full, the two timed in turns; printed
with Mrays/s, ptxas's registers and spill bytes of the probe's kernel
(a probe that spills more reads an upper bound) and the card's name and
power limit.  ``--variants`` takes any probe of the culled kernel, as
the reference's takes any ``PROBE`` name: ``dbl_entry2`` (an entered
sphere cluster's whole quadratic again) and ``dbl_cond2`` (the cluster
conds from shifted box corners) too; ``hint_count`` counts the winner
hint's prepass, which this unhinted render does not run, and is refused
with ``ops/stage_probes.py`` probe_bits' message.  The reference's
``dbl_scope`` re-stages a TPU scratch scope that the port does not have
and is refused by name, as are its other names that the port lacks
(``ops/stage_probes.py`` NOT_PORTED).
"""

from __future__ import annotations

from wavefront_path_tracer_tpu_torch.probes import _stage

VARIANTS = "full,dbl_entry,dbl_cond,dbl_shade,dbl_raygen,dbl_accum,dbl_loopcond"


def build_parser():
    return _stage.parser(__doc__, variants=VARIANTS, scene="book_one_final",
                         intersector="baked", clusters=16, width=1920,
                         height=1080, spp=32)


def main(argv=None) -> int:
    return _stage.main(build_parser(), argv)


if __name__ == "__main__":
    raise SystemExit(main())
