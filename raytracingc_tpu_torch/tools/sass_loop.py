"""Issued instructions per (ray, triangle) pair in a search kernel's MT loop,
read from the SASS of the built kernel library.

    python -m raytracingc_tpu_torch.tools.sass_loop [--kernel search_brute_kernelILi8ELb0E]

Runs the CUDA toolkit's ``cuobjdump -sass`` on the library that
``ops/_build.py`` builds, takes the entry function whose mangled name holds
``--kernel`` (default: K1 at 8 lanes a ray over a staged table) and finds
its loops that hold an ``MUFU.RCP``, the start of the IEEE reciprocal of
``det`` that every MT test makes once. For each innermost such loop it
counts what one pass issues on the fast path: every instruction from the
loop's head to its back branch, less those that a forward branch skips
around the reciprocal's slow-path call (``CALL.REL.NOINC``, taken only for
``|det|`` near the ends of the float range), over the pass's MT tests (its
``MUFU.RCP`` outside the skipped ranges). chip_smoke.py's ``MT_OPS`` counts
61 operations per test; the difference is the reciprocal's refinement and
range check, the shared-memory loads, the running best and the loop itself.
Needs ``cuobjdump`` (the card's machine has it); :func:`loop_counts` works
on any listing.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")
_BRA = re.compile(r"^(@!?U?P\w+\s+)?BRA(\.[\w.]+)?\s+(0x[0-9a-f]+)")


def functions(sass: str) -> dict:
    """``{mangled name: [(address, instruction), ...]}`` of a listing."""
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _LINE.search(ln)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def loop_counts(code: list) -> list:
    """The innermost loops of ``code`` (one function's ``(address,
    instruction)`` list) that hold an ``MUFU.RCP``: ``{"head", "end",
    "instructions", "skipped", "tests", "per_pair"}`` each, addresses as
    ints, ``per_pair`` the fast path's issued instructions per MT test."""
    addrs = [a for a, _ in code]
    loops = []
    for a, ins in code:
        m = _BRA.match(ins)
        if not m or int(m.group(3), 16) > a:
            continue
        head = int(m.group(3), 16)
        body = [(x, i) for x, i in code if head <= x <= a]
        if any(i.startswith("MUFU.RCP") or " MUFU.RCP" in i for _, i in body):
            loops.append((head, a, body))
    inner = [lp for lp in loops
             if not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1]
                        and (o[0], o[1]) != (lp[0], lp[1]) for o in loops)]
    out = []
    for head, end, body in inner:
        skipped = set()
        for x, ins in body:
            m = _BRA.match(ins)
            if not m or not m.group(1):
                continue
            tgt = int(m.group(3), 16)
            inside = [y for y in addrs if x < y < tgt]
            if tgt <= end and any("CALL" in i for y, i in body if y in inside):
                skipped.update(inside)
        n = len(body) - len(skipped)
        tests = sum(1 for x, i in body if "MUFU.RCP" in i and x not in skipped)
        out.append(dict(head=head, end=end, instructions=n, skipped=len(skipped),
                        tests=tests, per_pair=n / max(tests, 1)))
    return out


def cuobjdump() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "cuobjdump"), shutil.which("cuobjdump")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("cuobjdump not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH)")


def kernel_loops(kernel: str, library=None) -> tuple[str, list]:
    """``(mangled name, loop_counts)`` of the first entry function of the
    kernel library (built if needed) whose name holds ``kernel``."""
    if library is None:
        from raytracingc_tpu_torch.ops import _build

        library = _build.build()
    sass = subprocess.run([cuobjdump(), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    for name, code in functions(sass).items():
        if kernel in name:
            return name, loop_counts(code)
    raise RuntimeError(f"no entry function holding {kernel!r} in {library}")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m raytracingc_tpu_torch.tools.sass_loop",
                                description=__doc__.splitlines()[0])
    p.add_argument("--kernel", default="search_brute_kernelILi8ELb0E",
                   help="text of the entry function's mangled name")
    args = p.parse_args(argv)
    name, loops = kernel_loops(args.kernel)
    for lp in loops:
        print(f"{name}: loop {lp['head']:#x}-{lp['end']:#x}, {lp['instructions']} "
              f"instructions issued a pass ({lp['skipped']} skipped around the slow "
              f"path), {lp['tests']} MT test(s): {lp['per_pair']:.1f} a pair")
    return 0


if __name__ == "__main__":
    sys.exit(main())
