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
    labels, pending, addrs = {}, [], []
    for m in re.finditer(f"{_LABEL.pattern}|{_LINE.pattern}", listing,
                         re.M):
        if m[1]:
            pending.append(m[1])
            continue
        addr = int(m[2], 16)
        addrs.append((addr, m[3]))
        for name in pending:
            labels[name] = addr
        pending = []
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
