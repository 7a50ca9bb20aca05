"""The texture step's own time on the card: a textured/untextured A/B on
one bake (the row of ``_apply_image_textures`` in PERF.md's table of
kernels, whose port is ``csrc/common.cuh`` ``apply_textures``).

    python -m wavefront_path_tracer_tpu_torch.probes.texstep \
        [--rows culled16,unculled,dynculled16] [--width 1920] \
        [--height 1080] [--spp 32] [--bounces 50] [--turns 3] [--plain] \
        [--sass] [--device cuda|cpu] [--json FILE]

The texture step runs inside the textured instantiations of the render
kernels, so it has no launch of its own to time.  Each row runs
book_checker through its kernel twice on one bake (or dynamic table):
once through the textured instantiation, once through the untextured
one, over a copy of the tables with ``textured`` false (the kernel then
reads no texture table).  Roulette is off (``rr_start`` 0) and albedo
steers no ray, so the two trace the same rays: the counters [rays,
iterations, supers, clusters] must be equal, or the A/B is void and the
run fails.  The two are timed in turns by CUDA events, the least of
``--turns`` each.  The step's own time is the median of the turns'
paired differences (each turn's two runs back to back, so that drift
between turns moves it less than the difference of the two leasts,
which is kept beside it).

``--plain`` runs the culled row's plain version at 1 spp once, with
``ops/textures.py`` ``apply_textures`` recorded at each bounce: the
texture events a ray (``EVENTS``: checker hits, image hits) that the
bounds take, and the plain step's time over the frame's hits (one call
over all the recorded calls' hits, ``--spp`` times: as many hits as the
timed frame's).  The step's bound is its FP32 operations for those events at
the row's rays over the card's issue rate (:func:`step_bound`).
``--sass`` prints, for every shipped render kernel, its textured and
its untextured instantiation's ptxas registers, stack and spills, SASS
instructions and local loads and stores by where they lie
(``utils/sass.py`` ``spill_sites``).  ``--device cpu`` runs the
plain versions at a small size (no times).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import re
import struct

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.probes._slope import PEAK_BYTES

ROWS = {"culled16": ("baked", 16), "unculled": ("baked", 0),
        "dynculled16": ("dyn", 16)}
SCENE = "book_checker"

# FP32 operations of the texture step (common.cuh apply_textures) per
# event of ops/textures.py EVENTS, for its bound.  A checker event: s * p
# 3, the three sines, their product 2; each sine counted as the FP32
# instructions of sinf's fast path in the built kernels' SASS (the range
# reduction's multiply, its conversions to and from an integer and its
# three FMAs, then the squared argument and the polynomial's four FMAs;
# the quadrant's select and the slow path not counted).  An image event:
# the normal 6, atan2_approx 16, acos_approx with its clamp 14, u and v
# 3, the texel index 3, the decode 3.
FLOPS_SINF = 11
FLOPS_CHECKER = 3 + 3 * FLOPS_SINF + 2
FLOPS_IMAGE = 45

# The range of csrc/fastmath.cuh's sinf_fast, read from the header: it
# claims |x| < SIN_FAST_MAX and the NaNs, SIN_FAST_CLAIMED of the 2^32
# floats (the magnitudes below SIN_FAST_MAX are the bit patterns below
# its own, each with both signs; a NaN is one of 2^23 - 1 mantissas under
# each sign).
_FASTMATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "fastmath.cuh")


def _sin_fast_max() -> float:
    with open(_FASTMATH) as f:
        m = re.search(r"constexpr float kSinFastMax = ([0-9.]+)f;", f.read())
    return float(m.group(1))


SIN_FAST_MAX = _sin_fast_max()
SIN_FAST_CLAIMED = (2 * struct.unpack("<I", struct.pack("<f", SIN_FAST_MAX))[0]
                    + 2 * (2**23 - 1))


def step_ops(rays: float, events: tuple) -> float:
    """FP32 operations of the texture step over ``rays`` rays at
    ``events`` = (checker events a ray, image events a ray)."""
    checker, image = events
    return rays * (checker * FLOPS_CHECKER + image * FLOPS_IMAGE)


def step_bound(rays: float, events: tuple, rate: float,
               n_bytes: float = 0.0) -> dict:
    """The least time of the texture step over ``rays`` rays: the larger
    of its operations (:func:`step_ops`) over ``rate`` (FP32 operations a
    second: the card's issue rate, ``_slope.fp32_issue_rate``) and
    ``n_bytes`` (its tables, read once) over the memory rate."""
    ops = step_ops(rays, events)
    t_ops, t_bytes = ops / rate, n_bytes / PEAK_BYTES
    return {"ops": ops, "bytes": n_bytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


class Row:
    """One row's inputs: book_checker with the CLI's camera at one shape,
    the bake (or dynamic table) of its intersect, its untextured copy, the
    lane planes in block order, and the kernel wrapper (on the CPU its
    plain version)."""

    def __init__(self, name: str, width: int, height: int, spp: int,
                 bounces: int, device):
        from wavefront_path_tracer_tpu_torch.cli import (
            build_camera,
            build_parser,
        )
        from wavefront_path_tracer_tpu_torch.models import fused
        from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk
        from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as dk
        from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
        from wavefront_path_tracer_tpu_torch.scene import get_scene
        from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

        kind, clusters = ROWS[name]
        self.name, self.kind, self.spp = name, kind, spp
        cc = build_camera(build_parser().parse_args(["--scene", SCENE]))
        cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                           samples_per_frame=spp, max_bounces=bounces,
                           engine="fused")
        arrays = prepare_scene(get_scene(SCENE), cfg, device)
        eye = fused._concrete_eye(cc.view_matrix())
        perm, _ = fused._block_perm(width, height, 32)
        perm_t = torch.from_numpy(perm.astype(np.int64)).to(device)
        self.planes = fused.lane_planes(perm_t, width, cfg.tile_rows, 1, spp)
        self.cam = torch.from_numpy(fused.camera_params(
            cc.gpu_camera(), cc.view_matrix(),
            cc.inverse_projection(width, height), cfg)).to(device)
        self.salts = (0, 0, bounces, spp)
        if kind == "baked":
            self.tables = fused._baked_scene(arrays, clusters, camera_pos=eye)
            self.wrapper = bk.fused_render_baked
            self.reference = bk.fused_render_baked_reference
            tex = (self.tables.tex_items,)
        else:
            self.tables = fused._dyn_tables(arrays, clusters, camera_pos=eye)
            self.wrapper = dk.fused_render_dynculled
            self.reference = dk.fused_render_dynculled_reference
            tex = (self.tables.sphere_tex,)
        if not self.tables.textured:
            raise AssertionError(f"{name}: the {SCENE} tables are not "
                                 f"textured")
        images = self.tables.images
        self.tex_bytes = sum(t.numel() * t.element_size() for t in (
            *tex, images.centres, images.words))
        # The same tables with `textured` false: the wrappers launch the
        # untextured instantiation over them.
        self.plain_tables = dataclasses.replace(self.tables, textured=False)

    def tables_for(self, textured: bool):
        return self.tables if textured else self.plain_tables

    def run(self, textured: bool):
        """(rad_r, rad_g, rad_b, stats) of the kernel (the plain version
        on the CPU) through the textured or the untextured
        instantiation."""
        return self.wrapper(self.tables_for(textured), self.salts, self.cam,
                            *self.planes)


def _digest(out) -> str:
    """A fingerprint of a run's radiance words."""
    h = hashlib.sha256()
    for t in out[:3]:
        h.update(t.contiguous().view(torch.int32).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _event_ms(fn):
    """(ms of one call by CUDA events, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def ab(row: Row, turns: int) -> dict:
    """The row's A/B: the textured and the untextured instantiation in
    turns (textured first in even turns), least of ``turns`` each on the
    card; on the CPU one run each, untimed.  Raises where the counters
    differ (the A/B is void) or the radiance does not (the step did
    nothing)."""
    cuda = row.planes[0].is_cuda
    outs, times = {}, {True: [], False: []}
    if cuda:
        row.run(True)                                   # warm-up
        row.run(False)
    for turn in range(turns if cuda else 1):
        for textured in ((True, False) if turn % 2 == 0 else (False, True)):
            if cuda:
                ms, outs[textured] = _event_ms(lambda: row.run(textured))
                times[textured].append(ms)
            else:
                outs[textured] = row.run(textured)
    stats = {k: v[3].tolist() for k, v in outs.items()}
    if stats[True] != stats[False]:
        raise AssertionError(f"{row.name}: the textured and untextured runs "
                             f"trace other rays {stats}: the A/B is void")
    digests = {k: _digest(v) for k, v in outs.items()}
    if digests[True] == digests[False]:
        raise AssertionError(f"{row.name}: the texture step changed no "
                             f"radiance word")
    rep = {"row": row.name, "stats": stats[True],
           "textured_digest": digests[True],
           "untextured_digest": digests[False],
           "textured_ms": min(times[True]) if cuda else None,
           "untextured_ms": min(times[False]) if cuda else None,
           "textured_turns": times[True], "untextured_turns": times[False]}
    if cuda:
        # Each turn's two runs back to back: the median of their
        # differences, which drift between turns moves less than it
        # moves the difference of the two leasts.
        rep["own_ms"] = float(np.median(
            np.subtract(times[True], times[False])))
        rep["own_least_ms"] = rep["textured_ms"] - rep["untextured_ms"]
    rep["outs"] = outs
    return rep


@contextlib.contextmanager
def recording():
    """Within it, every call of ``ops/textures.py`` ``apply_textures`` by
    the plain versions (``ops/fused_kernels.py``) is kept, with its
    arguments, in the list it yields; ``EVENTS`` count from 0."""
    from wavefront_path_tracer_tpu_torch.ops import fused_kernels as fk
    from wavefront_path_tracer_tpu_torch.ops import textures

    calls, step = [], fk.apply_textures

    def record(*args):
        calls.append(args)
        return step(*args)

    textures.EVENTS.update(checker=0, image=0)
    fk.apply_textures = record
    try:
        yield calls
    finally:
        fk.apply_textures = step


def merged(calls) -> tuple:
    """The recorded ``calls`` as the arguments of one call over all their
    hits: the LUTs, then each per-hit tensor concatenated in call order."""
    return (calls[0][0], *(torch.cat([c[k] for c in calls])
                           for k in range(1, len(calls[0]))))


def replay_ms(calls, copies: int) -> float:
    """ms by CUDA events of ``apply_textures`` over the hits of the
    recorded ``calls`` (:func:`merged`: one call over all of them),
    ``copies`` times over (after one warm-up call)."""
    from wavefront_path_tracer_tpu_torch.ops import textures

    args = merged(calls)

    def replay(n):
        for _ in range(n):
            textures.apply_textures(*args)

    events = dict(textures.EVENTS)
    replay(1)
    ms, _ = _event_ms(lambda: replay(copies))
    textures.EVENTS.update(events)
    return ms


def plain_step(width: int, height: int, bounces: int, copies: int,
               device) -> dict:
    """The culled row's plain version at 1 spp, recorded
    (:func:`recording`): the texture events a ray, and (on the card) the
    plain step's ms over the recorded calls' hits (:func:`replay_ms`)."""
    from wavefront_path_tracer_tpu_torch.ops import textures

    row = Row("culled16", width, height, 1, bounces, device)
    with recording() as calls:
        out = row.reference(row.tables, row.salts, row.cam, *row.planes)
    rays = max(out[3].tolist()[0], 1)
    rep = {"rays": rays, "checker": textures.EVENTS["checker"],
           "image": textures.EVENTS["image"],
           "events": (textures.EVENTS["checker"] / rays,
                      textures.EVENTS["image"] / rays),
           "calls": len(calls), "hits": sum(a[6].numel() for a in calls),
           "copies": copies, "plain_ms": None}
    if row.planes[0].is_cuda:
        rep["plain_ms"] = replay_ms(calls, copies)
    return rep


def sass_readings(dump: str | None = None) -> dict:
    """{"KERNEL tris=T": {"textured": rep, "untextured": rep}} for every
    shipped render kernel of the built library (``utils/sass.py``
    ``tex_pairs``): ptxas's registers, stack and spill bytes, the SASS
    instructions, and the LDL and STL instructions by site
    (``spill_sites``); each listing written under ``dump``."""
    from wavefront_path_tracer_tpu_torch.ops import _build
    from wavefront_path_tracer_tpu_torch.utils import sass

    lib, report, _ = _build.build()
    listings = sass.listings(lib)
    counts = sass.counts(lib)
    ptx = {r["mangled"]: r for match in sass.RENDER_KERNELS
           for r in _build.ptxas_kernels(report, match)}
    out = {}
    for key, names in sass.tex_pairs(listings).items():
        out[key] = {}
        for label, name in zip(("textured", "untextured"), names):
            rep = {k: ptx.get(name, {}).get(k) for k in (
                "registers", "stack", "spill_stores", "spill_loads")}
            rep.update(function=name, instructions=counts[name],
                       sites=sass.spill_sites(listings[name]))
            out[key][label] = rep
            if dump:
                os.makedirs(dump, exist_ok=True)
                path = os.path.join(dump, f"{key.replace(' ', '_')}_"
                                          f"{label}.sass")
                with open(path, "w") as f:
                    f.write(listings[name])
    return out


def sass_line(key: str, label: str, rep: dict) -> str:
    sites = rep["sites"]
    where = "; ".join(f"{op} " + "/".join(str(sites[op][s]) for s in sites[op])
                      for op in ("LDL", "STL"))
    return (f"[tex-sass] {key} {label}: {rep['registers']} registers, "
            f"{rep['stack']} bytes stack, {rep['spill_stores']} / "
            f"{rep['spill_loads']} bytes spilled (stores / loads), "
            f"{rep['instructions']} SASS instructions; {where} "
            f"(outside/loop/sweep/tail)")


def run(args) -> dict:
    from wavefront_path_tracer_tpu_torch.renderer import resolve_device

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    card = rate = None
    if cuda:
        from wavefront_path_tracer_tpu_torch.probes import _slope

        card = _slope.card()
        rate = _slope.issue_rate(card)
    out = {"card": card, "rows": {}, "shape": [args.width, args.height,
                                               args.spp, args.bounces]}
    if args.sass and cuda:
        out["sass"] = sass_readings()
        for key, reps in out["sass"].items():
            for label, rep in reps.items():
                print(sass_line(key, label, rep), flush=True)
    plain = None
    if args.plain:
        plain = plain_step(args.width, args.height, args.bounces, args.spp,
                           device)
        out["plain"] = plain
        print(f"[tex-plain] {SCENE} culled16 {args.width}x{args.height}@1spp"
              f" plain version: {plain['rays']} rays, {plain['checker']} "
              f"checker and {plain['image']} image events "
              f"({plain['events'][0]!r}, {plain['events'][1]!r} a ray) in "
              f"{plain['calls']} calls; apply_textures over their "
              f"{plain['hits']} hits in one call, {plain['copies']} times: "
              f"{plain['plain_ms']!r} ms [{card}]", flush=True)
    for name in args.rows.split(","):
        row = Row(name, args.width, args.height, args.spp, args.bounces,
                  device)
        rep = ab(row, args.turns)
        rep.pop("outs")
        if plain is not None and cuda:
            rep.update(step_bound(rep["stats"][0], plain["events"], rate,
                                  row.tex_bytes))
        out["rows"][name] = rep
        own = (f"own {rep['own_ms']!r} ms (median of the turns' "
               f"differences; of the leasts {rep['own_least_ms']!r}), textured "
               f"{rep['textured_ms']!r}, untextured "
               f"{rep['untextured_ms']!r} (turns "
               f"{rep['textured_turns']} / {rep['untextured_turns']})"
               if cuda else "untimed")
        bound = (f"; bound {rep['bound_ms']!r} ms ({rep['bound_by']})"
                 if "bound_ms" in rep else "")
        print(f"[tex-ab] {SCENE} {name} {args.width}x{args.height}@"
              f"{args.spp}spp, {args.bounces} bounces: {own}{bound}; "
              f"counters {rep['stats']} equal; radiance "
              f"{rep['textured_digest']} vs {rep['untextured_digest']} "
              f"[{card}]", flush=True)
        del row
        if cuda:
            torch.cuda.empty_cache()
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="comma list of " + ", ".join(ROWS))
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--bounces", type=int, default=50)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--plain", action="store_true",
                    help="the plain step's events and time (1 spp plain "
                    "render of the culled row)")
    ap.add_argument("--sass", action="store_true",
                    help="ptxas's and the SASS's readings of every render "
                    "kernel's textured and untextured instantiation")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu: plain versions)")
    ap.add_argument("--json", default=None, help="write the record here")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.rows and set(args.rows.split(",")) - set(ROWS):
        raise SystemExit(f"unknown rows in {args.rows!r}")
    rec = run(args)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
