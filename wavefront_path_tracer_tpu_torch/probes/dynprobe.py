"""Each stage's share of the fused dynamic culled kernel's time, by the
differential stage probes (the port of ``exp/dynprobe.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.dynprobe \
        [--variants full,dyn_dbl_entry,...] [--scene book_one_final] \
        [--clusters 16] [--spp 64] [--device cuda|cpu]

At the reference's defaults: book_one_final at 400x224, 64 spp, 50
bounces, brute force with clusters of 16 (the dynamic culled intersect
over runtime tables), block order, the book's camera.  Each variant is
one render with one probe of ``ops/stage_probes.py`` (``full``: none):
the entered clusters' pair tests (``dyn_dbl_entry``), the box conds
(``dyn_dbl_cond``), the global spheres (``dyn_dbl_global``), or a stage
of the loop; its share is (t_probe - t_full) / t_full, the two timed in
turns, printed with Mrays/s, ptxas's registers and spills and the card.
The reference's ``dyn_dbl_refs`` and ``dyn_split_entry`` duplicate TPU
constructs (VMEM ref restaging, a ``pl.when`` boundary) that the port
does not have and are refused by name.
"""

from __future__ import annotations

from wavefront_path_tracer_tpu_torch.probes import _stage

VARIANTS = "full,dyn_dbl_entry,dyn_dbl_cond,dyn_dbl_global"


def build_parser():
    return _stage.parser(__doc__, variants=VARIANTS, scene="book_one_final",
                         intersector="bruteforce", clusters=16, width=400,
                         height=224, spp=64)


def main(argv=None) -> int:
    return _stage.main(build_parser(), argv)


if __name__ == "__main__":
    raise SystemExit(main())
