#!/usr/bin/env python
"""Amalgamation codegen: produce dist/glu_tpu_single.py.

Python analog of the reference's generate.py (reference generate.py:7-29),
which inlines local #includes to ship copy-paste single headers in dist/
(reference README.md:19-30). Here the whole glu_tpu package is flattened
into one importable Python file: modules are concatenated in dependency
order with intra-package (relative) imports stripped — lazy in-function
relative imports resolve to module-level names that exist once the full
file has executed, exactly like include guards make the reference's
amalgamation self-contained.

Run manually at release time:  python generate.py
"""

from __future__ import annotations

import pathlib
import re

ROOT = pathlib.Path(__file__).parent
PKG = ROOT / "glu_tpu"
DIST = ROOT / "dist"

# dependency order (later modules may lazily reference earlier ones)
MODULES = [
    "utils/errors.py",
    "utils/math.py",
    "utils/dtypes.py",
    "utils/timing.py",
    "utils/buffers.py",
    "utils/debug.py",
    "ops/_segments.py",
    "ops/reference.py",
    "ops/reduce.py",
    "ops/scan.py",
    "ops/radix_sort.py",
    "parallel/dist_sort.py",
    "parallel/dist_primitives.py",
]

_REL_IMPORT = re.compile(r"^\s*from\s+\.+[\w.]*\s+import\s+.*(\(.*)?$")

HEADER = '''"""glu_tpu single-file distribution — GENERATED by generate.py, do not edit.

Copy this one file into your project and `import glu_tpu_single as glu`.
Equivalent of the reference's dist/*.hpp amalgamated headers
(reference generate.py, dist/, README.md:19-30).
"""

from __future__ import annotations

'''


def strip_module(path: pathlib.Path) -> str:
    out = []
    in_rel_import_paren = False
    for line in path.read_text().splitlines():
        if in_rel_import_paren:
            if ")" in line:
                in_rel_import_paren = False
            continue
        if line.startswith("from __future__"):
            continue
        if _REL_IMPORT.match(line):
            if "(" in line and ")" not in line:
                in_rel_import_paren = True
            continue
        out.append(line)
    return "\n".join(out).strip() + "\n"


def main() -> None:
    DIST.mkdir(exist_ok=True)
    parts = [HEADER]
    for mod in MODULES:
        src = PKG / mod
        parts.append(f"\n# {'=' * 70}\n# inlined from glu_tpu/{mod}\n# {'=' * 70}\n\n")
        parts.append(strip_module(src))
    target = DIST / "glu_tpu_single.py"
    target.write_text("".join(parts))
    print(f"wrote {target} ({target.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
