"""SASS instruction counts of the built kernels, from ``cuobjdump -sass``.

    python -m wavefront_path_tracer_tpu_torch.utils.sass [LIB [OTHER_LIB]]

With one library (by default the one ``ops/_build.py`` builds), prints
each render kernel's instruction count.  With two, prints the render
kernels that both hold side by side, matched by their demangled names
with the namespaces and a trailing probe argument of 0 taken out (so a
build whose kernels carry the stage probes' template argument matches
one whose kernels do not), and exits 1 where a count differs.  The
counts include every instruction of the kernel's listing (set-up, loops,
slow paths, and the NOPs that pad its end: :func:`work_counts` leaves
those out).  Needs ``cuobjdump`` (the CUDA toolkit's) and, to match two
builds, ``c++filt``.
"""

from __future__ import annotations

import functools
import os
import re
import shutil
import subprocess
import sys

from wavefront_path_tracer_tpu_torch.ops import _build

# The render kernels, by the names their sources give them.
RENDER_KERNELS = ("persistent_kernel", "baked_culled_kernel",
                  "baked_unculled_kernel", "dynculled_kernel")


def cuobjdump() -> str | None:
    """The toolkit's cuobjdump, or None where the machine has none."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return tool if os.path.exists(tool) else None


@functools.lru_cache(maxsize=4)
def listings(lib) -> dict:
    """{mangled name: SASS listing} of every function in ``lib`` (one
    ``cuobjdump`` a library a process: it takes tens of seconds)."""
    tool = cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump not found: no SASS to count")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    return {part.splitlines()[0].strip(): part
            for part in sass.split("Function : ")[1:]}


def counts(lib) -> dict:
    """{mangled name: SASS instructions} of every function in ``lib``."""
    return {name: len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+\S", part,
                                 re.M))
            for name, part in listings(lib).items()}


def work_counts(lib) -> dict:
    """:func:`counts` without the NOPs, which pad a function's end to its
    alignment and so may hide an instruction that a variant adds."""
    return {name: n - len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+NOP\b",
                                     listings(lib)[name], re.M))
            for name, n in counts(lib).items()}


# A listing's instruction lines (address, text before the ``;``), its
# labels, and a branch to a label or an address.
_LINE = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", re.M)
_LABEL = re.compile(r"^\s*(\.L_x_\d+):", re.M)
_BRA = re.compile(r"^(?:@!?U?P\w+\s+)?BRA(?:\.\S+)?\s+(?:`\((\.L_x_\d+)\)|"
                  r"(0x[0-9a-f]+))")


def inner_loop(listing: str, marker: str | None = None) -> list[str]:
    """The instructions of the function's innermost loop: the shortest
    span from a backward branch's target to the branch, among the
    branches before the function's last ``EXIT`` (after it lie the slow
    paths and the closing self-branch) whose span holds ``marker`` (an
    opcode, e.g. ``MUFU.RSQ``) where one is given; [] where there is
    none."""
    addrs, labels = _instructions(listing)
    exits = [k for k, (_a, t) in enumerate(addrs) if opcode(t) == "EXIT"]
    best = None
    for k, (addr, text) in enumerate(addrs[:exits[-1] if exits else 0]):
        m = _BRA.match(text)
        if not m:
            continue
        target = labels.get(m[1]) if m[1] else int(m[2], 16)
        if target is None or target >= addr:
            continue
        body = [t for a, t in addrs[:k + 1] if a >= target]
        if marker is not None and not any(opcode(t) == marker
                                          for t in body):
            continue
        if best is None or len(body) < len(best):
            best = body
    return best or []


def _instructions(listing: str) -> tuple[list[tuple[int, str]], dict]:
    """([(address, text)] of every instruction, {label: address})."""
    labels, pending, addrs = {}, [], []
    for m in re.finditer(f"{_LABEL.pattern}|{_LINE.pattern}", listing,
                         re.M):
        if m[1]:
            pending.append(m[1])
            continue
        addrs.append((int(m[2], 16), m[3]))
        for name in pending:
            labels[name] = addrs[-1][0]
        pending = []
    return addrs, labels


# Where an instruction lies, by the loops around it (spill_sites), and
# the opcodes that mark a sweep's loop: a sphere pair's square root, a
# triangle's divide.
SITES = ("outside", "loop", "sweep", "tail")
SWEEP_MARKERS = ("MUFU.RSQ", "MUFU.RCP")


def spill_sites(listing: str) -> dict:
    """The local-memory loads and stores (LDL, STL: ptxas's spills and a
    slow path's local array) of a listing by where they lie: {"LDL":
    {site: n}, "STL": {site: n}} over :data:`SITES`.  A loop is the span
    from a backward branch's target to its last branch there, among the
    branches before the function's last ``EXIT``.  "sweep" is inside a
    loop that lies inside another and holds one of
    :data:`SWEEP_MARKERS` (a render kernel's sweep, inside its loop of
    trips); "loop" inside a loop but no sweep (the per-ray and per-hit
    code of a trip, with the loops of sinf's slow-path reduction);
    "outside" before the last ``EXIT`` and in no loop; "tail" after it
    (the slow paths that the body calls or branches to)."""
    addrs, labels = _instructions(listing)
    exits = [k for k, (_a, t) in enumerate(addrs) if opcode(t) == "EXIT"]
    end = exits[-1] if exits else len(addrs)
    spans = {}
    for addr, text in addrs[:end]:
        m = _BRA.match(text)
        if not m:
            continue
        target = labels.get(m[1]) if m[1] else int(m[2], 16)
        if target is not None and target < addr:
            spans[target] = max(spans.get(target, addr), addr)
    spans = sorted(spans.items())
    sweeps = [(lo, hi) for lo, hi in spans
              if any((a, b) != (lo, hi) and a <= lo and hi <= b
                     for a, b in spans)
              and any(lo <= a <= hi and opcode(t) in SWEEP_MARKERS
                      for a, t in addrs[:end])]
    out = {op: dict.fromkeys(SITES, 0) for op in ("LDL", "STL")}
    for k, (addr, text) in enumerate(addrs):
        op = opcode(text).split(".")[0]
        if op not in out:
            continue
        if k > end:
            site = "tail"
        elif any(lo <= addr <= hi for lo, hi in sweeps):
            site = "sweep"
        elif any(lo <= addr <= hi for lo, hi in spans):
            site = "loop"
        else:
            site = "outside"
        out[op][site] += 1
    return out


def tex_pairs(names) -> dict:
    """The textured and untextured instantiations of each shipped render
    kernel among the mangled ``names``: {"KERNEL tris=T": (textured,
    untextured)} for each kernel of ``ops/stage_probes.py``
    ``KERNEL_PROBES`` (the persistent loop's and the segments') and each
    kind of scene (spheres, with triangles) where both are there, by
    ``kernel_symbol``, which differ in the kTex argument alone.  Raises
    where a symbol matches more than one name."""
    from wavefront_path_tracer_tpu_torch.ops import stage_probes

    names = list(names)
    out = {}
    for kernel in stage_probes.KERNEL_PROBES:
        for tris in (False, True):
            found = []
            for tex in (True, False):
                sym = stage_probes.kernel_symbol(kernel, tris, tex, 0)
                hits = [n for n in names if sym in n]
                if len(hits) > 1:
                    raise ValueError(f"{len(hits)} functions match {sym}")
                found.append(hits[0] if hits else None)
            if all(found):
                out[f"{kernel} tris={int(tris)}"] = tuple(found)
    return out


def opcodes(listing: str) -> list[str]:
    """The opcodes (:func:`opcode`) of every instruction of a listing, in
    order."""
    return [opcode(m[2]) for m in _LINE.finditer(listing)]


def opcode(text: str) -> str:
    """An instruction's opcode with its modifiers (``MUFU.RSQ``,
    ``LDG.E.CONSTANT``), its predicate taken off."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def normalized(demangled: str) -> str:
    """A demangled kernel name without namespaces, spaces or a trailing
    template argument of 0 (the unprobed kernels' kProbe)."""
    name = demangled
    for ns in ("(anonymous namespace)::", "wpt::baked::", "wpt::dyn::",
               "wpt::"):
        name = name.replace(ns, "")
    name = name.split("(", 1)[0]
    name = name.replace(" ", "").removeprefix("void")
    return re.sub(r",0>$", ">", name)


def render_counts(lib) -> dict:
    """{normalized name: instructions} of the render kernels of ``lib``."""
    found = {n: c for n, c in counts(lib).items()
             if any(k in n for k in RENDER_KERNELS)}
    names = list(found)
    return {normalized(d): found[n]
            for n, d in zip(names, _build.demangle(names))}


def main(argv=None) -> int:
    libs = list(sys.argv[1:] if argv is None else argv)
    if not libs:
        libs = [_build.build()[0]]
    tables = [render_counts(lib) for lib in libs]
    if len(tables) == 1:
        for name, n in sorted(tables[0].items()):
            print(f"{n:7d}  {name}")
        return 0
    a, b = tables[:2]
    differ = 0
    for name in sorted(set(a) & set(b)):
        same = a[name] == b[name]
        differ += not same
        print(f"{a[name]:7d} {b[name]:7d}  {'same' if same else 'DIFFER'}  "
              f"{name}")
    print(f"{len(set(a) & set(b))} kernels in both, {differ} differ; "
          f"{len(set(a) - set(b))} only in the first, "
          f"{len(set(b) - set(a))} only in the second")
    return 1 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main())
