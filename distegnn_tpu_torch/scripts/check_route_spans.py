#!/usr/bin/env python
"""Lint: every transport route handler of the port runs inside a
``serve/http`` span carrying a ``request_id`` (the port's counterpart of
``scripts/check_route_spans.py``).

The request-tracing contract hangs off one chokepoint: ``Gateway.dispatch`` mints the request id and
opens the ``serve/http`` span, and every ``do_*`` HTTP verb method on the
handler class forwards straight to it. A handler that answers on its own
("bare") produces requests that are invisible to the waterfall stitcher
and the SLO monitor — exactly the silent hole this lint exists to catch.

Checked, by AST walk over distegnn_tpu_torch/serve/transport.py:
  1. every ``do_*`` method on every request-handler class is a pure
     forward: its only statement is a ``....dispatch(self, ...)`` call;
  2. every ``dispatch`` method that do_* methods forward to
     - calls ``mint_request_id`` and assigns ``<handler>.request_id``,
     - opens ``with obs.span("serve/http", ..., request_id=...)``,
     - performs its route handling (the ``_handle`` call) INSIDE that
       span, so the span's duration and status cover the whole request.

    python -m distegnn_tpu_torch.scripts.check_route_spans

Exit codes: 0 clean, 1 violations (one ``path:line: text`` per finding).
"""

from __future__ import annotations

import ast
import os
import sys

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PACKAGE)
TRANSPORT = os.path.join(PACKAGE, "serve", "transport.py")


def _is_dispatch_forward(stmt: ast.stmt) -> bool:
    """True for ``<anything>.dispatch(self, ...)`` as a bare statement."""
    if not isinstance(stmt, ast.Expr) or not isinstance(stmt.value, ast.Call):
        return False
    fn = stmt.value.func
    if not (isinstance(fn, ast.Attribute) and fn.attr == "dispatch"):
        return False
    args = stmt.value.args
    return bool(args) and isinstance(args[0], ast.Name) and args[0].id == "self"


def _span_call(node: ast.AST):
    """The ``obs.span("serve/http", ...)`` Call under a with-item, if any."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    named_span = (isinstance(fn, ast.Attribute) and fn.attr == "span") or \
                 (isinstance(fn, ast.Name) and fn.id == "span")
    if not named_span or not node.args:
        return None
    first = node.args[0]
    if isinstance(first, ast.Constant) and first.value == "serve/http":
        return node
    return None


def _calls_name(tree: ast.AST, name: str) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Name) and fn.id == name) or \
                    (isinstance(fn, ast.Attribute) and fn.attr == name):
                return True
    return False


def _assigns_request_id(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        tgt.attr == "request_id":
                    return True
    return False


def _check_dispatch(fn: ast.FunctionDef, rel: str):
    """Violations for one dispatch method."""
    out = []
    if not _calls_name(fn, "mint_request_id"):
        out.append((rel, fn.lineno,
                    f"{fn.name} never mints a request id "
                    "(mint_request_id call missing)"))
    if not _assigns_request_id(fn):
        out.append((rel, fn.lineno,
                    f"{fn.name} never stashes handler.request_id "
                    "(the X-Request-Id echo reads it)"))
    span_withs = []
    for node in ast.walk(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                call = _span_call(item.context_expr)
                if call is not None:
                    span_withs.append((node, call))
    if not span_withs:
        out.append((rel, fn.lineno,
                    f"{fn.name} opens no obs.span(\"serve/http\") — "
                    "requests here are invisible to the waterfall/SLOs"))
        return out
    for _, call in span_withs:
        if not any(kw.arg == "request_id" for kw in call.keywords):
            out.append((rel, call.lineno,
                        "serve/http span carries no request_id= attr"))
    # the route handling must happen INSIDE the span, or its duration and
    # status cover nothing
    handled_inside = any(_calls_name(w, "_handle") for w, _ in span_withs)
    if _calls_name(fn, "_handle") and not handled_inside:
        out.append((rel, fn.lineno,
                    f"{fn.name} calls _handle OUTSIDE the serve/http span"))
    return out


def find_violations(path: str = TRANSPORT):
    """[(relpath, lineno, message)] against the tracing contract."""
    rel = os.path.relpath(path, REPO).replace(os.sep, "/")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)

    out = []
    do_methods, dispatches = [], []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if item.name.startswith("do_"):
                    do_methods.append(item)
                elif item.name == "dispatch":
                    dispatches.append(item)

    if not do_methods:
        out.append((rel, 1, "no do_* HTTP verb methods found — transport "
                            "layout changed under the lint; update "
                            "scripts/check_route_spans.py"))
    for m in do_methods:
        body = [s for s in m.body
                if not (isinstance(s, ast.Expr)
                        and isinstance(s.value, ast.Constant))]  # docstring
        if len(body) != 1 or not _is_dispatch_forward(body[0]):
            out.append((rel, m.lineno,
                        f"bare handler {m.name}: must forward to "
                        "gateway.dispatch(self, ...) and nothing else"))

    if not dispatches:
        out.append((rel, 1, "no dispatch method found — the serve/http "
                            "span chokepoint is gone"))
    for d in dispatches:
        out.extend(_check_dispatch(d, rel))
    return out


def main(argv=None) -> int:
    import argparse

    argparse.ArgumentParser(
        prog="python -m distegnn_tpu_torch.scripts.check_route_spans",
        description="lint: every HTTP handler of serve/transport.py runs "
                    "inside a serve/http span with a request id"
    ).parse_args(argv)
    violations = find_violations()
    for rel, lineno, msg in violations:
        print(f"{rel}:{lineno}: {msg}")
    if violations:
        print(f"\n{len(violations)} route-span violation(s); see the "
              "docstring of distegnn_tpu_torch/scripts/check_route_spans.py "
              "for the contract")
        return 1
    print("check_route_spans: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
