"""Lint: no bare ``print(`` calls inside distegnn_tpu_torch/ (the port's
counterpart of ``scripts/check_no_print.py``).

Runtime output goes through ``obs.log()`` (distegnn_tpu_torch/obs/trace.py)
— it keeps stdout line-compatible, prefixes non-zero process indices,
always flushes, and mirrors every message into the structured event stream
so ``python -m distegnn_tpu_torch.obs.report`` sees it. A bare print does
none of that and is invisible to the run report.

Escape hatches, both deliberate and auditable:
  - a line comment ``# noqa: obs-print`` (the logger's own print, harness
    contract lines that tests and parent processes parse from stdout);
  - ``_ALLOWLIST`` / ``_ALLOW_DIRS`` below for whole files and packages
    that are command lines rather than library code: their stdout IS the
    interface.

    python -m distegnn_tpu_torch.scripts.check_no_print

Exit codes: 0 clean, 1 violations (one ``path:line: text`` per offending
line).
"""

from __future__ import annotations

import os
import re
import sys

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# `print(` not preceded by a word char or '.' (so `pprint(`, `x.print(` and
# def-lines don't match); comments are stripped line-wise before matching
_PRINT_RE = re.compile(r"(?<![\w.])print\s*\(")
_NOQA = "noqa: obs-print"

# whole-file allowlist: command lines whose stdout IS the interface
_ALLOWLIST = frozenset({
    "obs/report.py",  # python -m distegnn_tpu_torch.obs.report
})
# whole packages of command lines (one BENCH / JSON line on stdout)
_ALLOW_DIRS = ("scripts/",)


def _strip_comment(line: str) -> str:
    """Drop a trailing # comment (good enough for a lint: '#' inside string
    literals can false-negative a match, never false-positive one)."""
    i = line.find("#")
    return line if i < 0 else line[:i]


def find_violations(package_dir: str = PACKAGE):
    """[(relpath, lineno, line)] of bare prints outside the escape hatches."""
    out = []
    for root, _dirs, files in os.walk(package_dir):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            rel = os.path.relpath(path, package_dir).replace(os.sep, "/")
            if rel in _ALLOWLIST or rel.startswith(_ALLOW_DIRS):
                continue
            with open(path, encoding="utf-8") as f:
                for lineno, line in enumerate(f, 1):
                    if _NOQA in line:
                        continue
                    if _PRINT_RE.search(_strip_comment(line)):
                        out.append((rel, lineno, line.rstrip()))
    return out


def main(argv=None) -> int:
    import argparse

    argparse.ArgumentParser(
        prog="python -m distegnn_tpu_torch.scripts.check_no_print",
        description="lint: no bare print( in distegnn_tpu_torch/"
    ).parse_args(argv)
    violations = find_violations()
    for rel, lineno, line in violations:
        print(f"distegnn_tpu_torch/{rel}:{lineno}: bare print — use "
              f"obs.log() (or '# noqa: obs-print'): {line.strip()}")
    if violations:
        print(f"\n{len(violations)} bare print(s); see the docstring of "
              "distegnn_tpu_torch/scripts/check_no_print.py for the escape "
              "hatches")
        return 1
    print("check_no_print: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
