#!/usr/bin/env python3
"""Compares two trees' kernels as ptxas compiled them: registers, stack and spills.

Builds each tree's kernel library (into that tree's own ``_build``, or
reuses it) and lists, kernel by kernel, ``ptxas``'s register and spill
lines from the build logs, each kernel named by its demangled name. A
template argument that only restates the default (a trailing argument
equal to the first, as ``flash_tc_kernel<128, 128, false, 128>`` for the
``<128, 128, false>`` of a tree without the argument) is dropped, so the
instances two trees share line up. Prints one JSON line: the kernels only
in the second tree, those only in the first, and those whose lines differ
(empty when every shared instance compiled as before). Run on the card,
where ``nvcc`` is:

    git archive <parent> | tar -x -C _tree_check/parent
    python3 tools/ptxas_compare.py _tree_check/parent .

Exits 1 if a shared kernel's lines differ.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def library_log(tree: Path) -> str:
    """The build log of ``tree``'s kernel library, built in a process of
    its own (each tree imports its own ``repro_torch``)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from repro_torch.kernels import build; "
            "print(build.build().with_suffix('.log'))")
    out = subprocess.run([sys.executable, "-c", code, str(tree / "src")], capture_output=True, text=True, check=True)
    return Path(out.stdout.strip().splitlines()[-1]).read_text()


def _normalise(name: str) -> str:
    name = re.sub(r"\(anonymous namespace\)::", "", name)
    m = re.match(r"(.*?)<(.*)>(\(.*)$", name)
    if m:
        args = [a.strip() for a in m.group(2).split(",")]
        if len(args) > 1 and args[-1] == args[0]:
            args = args[:-1]
        name = f"{m.group(1)}<{', '.join(args)}>"
    return name


def kernels(log: str) -> dict:
    """Each kernel's ptxas register, stack and spill lines, by its
    normalised demangled name."""
    sys.path.insert(0, str(HERE))
    from chip_smoke import ptxas_lines

    out = {}
    for ln in ptxas_lines(log):
        name, text = ln.split(" | ", 1)
        if "Used " in text or "stack frame" in text:
            out.setdefault(_normalise(name), []).append(text)
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    first, second = (kernels(library_log(Path(t).resolve())) for t in args)
    differ = {k: {"first": first[k], "second": second[k]} for k in sorted(first.keys() & second.keys())
              if first[k] != second[k]}
    print(json.dumps(dict(first=args[0], second=args[1], shared=len(first.keys() & second.keys()),
                          only_in_second=sorted(second.keys() - first.keys()),
                          only_in_first=sorted(first.keys() - second.keys()), differ=differ)), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
