#!/usr/bin/env python3
"""Where the local-memory spills of a built kernel library sit, read from
its SASS.

Run on a machine with the CUDA toolkit, after the kernels are built::

    python3 tools/sass_spill.py build/kernels/paged_prefill-<digest>.so [NAME ...]

For every kernel of the library whose name contains one of the NAMEs (all
kernels if none is given) it prints the spill stores (``STL``) and loads
(``LDL``) by the part of the kernel they sit in, in the SASS's address
order: before any ``setmaxnreg`` (the code every thread runs), after
``setmaxnreg.inc`` (the warpgroups that raise their registers: the
consumers) and after ``setmaxnreg.dec`` (the warpgroup that lowers them:
the producer), then each spill instruction with its registers and stack
offset. A kernel without ``setmaxnreg`` has one part. The parts follow the
address order of ptxas' layout, which places each warpgroup's code after
its ``setmaxnreg``; code that both branches share would be counted in the
part laid out before it.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(default):
        return default
    raise RuntimeError("cuobjdump not found: it comes with the CUDA toolkit")


def functions(sass: str):
    """(name, body) of each function in ``cuobjdump -sass`` output."""
    parts = re.split(r"\n\s*Function : ", sass)
    for part in parts[1:]:
        name, _, body = part.partition("\n")
        yield name.strip(), body


def spills(body: str) -> dict:
    """The spill instructions of one function by part (see the module
    docstring): {"entry" | "inc" | "dec": [instruction text, ...]}."""
    part = "entry"
    out = {"entry": [], "inc": [], "dec": []}
    for line in body.splitlines():
        m = re.search(r"/\*[0-9a-f]+\*/\s+(.*?)\s*;", line)
        if not m:
            continue
        ins = m.group(1)
        if "USETMAXREG" in ins:
            part = "dec" if "DEALLOC" in ins else "inc"
        elif re.match(r"(@!?U?P\w+\s+)?(STL|LDL)\b", ins):
            out[part].append(ins)
    return out


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    lib, names = argv[0], argv[1:]
    sass = subprocess.run([cuobjdump(), "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    for name, body in functions(sass):
        if names and not any(n in name for n in names):
            continue
        parts = spills(body)
        counts = {k: (sum("STL" in i for i in v), sum("LDL" in i for i in v))
                  for k, v in parts.items()}
        print(f"{name}: " + ", ".join(
            f"{k} {st} STL / {ld} LDL" for k, (st, ld) in counts.items()))
        for k, ins in parts.items():
            for i in ins:
                print(f"  {k}: {i}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
