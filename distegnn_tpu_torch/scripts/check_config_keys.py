#!/usr/bin/env python
"""Lint: every serving-control config key of the port ships a typed default
AND a validation branch — the two halves of the schema cannot drift apart
(the port's counterpart of ``scripts/check_config_keys.py``).

The config contract routes every serve-layer knob through ``config._DEFAULTS`` (so hand-built ``ConfigDict(_DEFAULTS)``
configs always carry it) and through ``validate_config`` (so a typo'd or
out-of-range value fails at load time, not as a silent attribute miss deep
in the gateway). A key present in one side but not the other is exactly
the hole this lint exists to catch: a default nobody validates, or a
validator guarding a knob nobody can set.

Checked, by AST walk over distegnn_tpu_torch/config.py, for each section in
``SECTIONS`` (the serve sub-mappings that own a known-key guard) and each
TOP-LEVEL section in ``TOP_SECTIONS`` (same contract, rooted at
``_DEFAULTS`` itself and bound via ``<var> = cfg.get("<section>")``):
  1. the section exists in the defaults mapping and in
     ``validate_config`` (bound via ``<var> = <recv>.get("<section>")``);
  2. the section's validator rejects unknown keys
     (``for key in <var>: if key not in <tuple>``);
  3. every default key is named by the validator (in the known-keys tuple
     or a ``<var>.get("key")`` / ``<var>["key"]`` access, or a dotted path
     of ``_UNPORTED``, whose refusal is that key's validation branch) — and
     every key the validator names has a default.
Plus two cross-module checks: ``serve/autoscale.py``'s and
``promote/promoter.py``'s in-code ``_DEFAULTS`` fallbacks carry exactly
the same knob set as their config sections (both docstrings promise this
file keeps them in lockstep).

Plus one coverage check over ``configs/*.yaml``: every top-level section
(mapping-valued key) a shipped config sets must be a ``_DEFAULTS`` section
that ``validate_config`` actually reads — a yaml section nobody validates
is a whole subtree of knobs that typo silently.

    python -m distegnn_tpu_torch.scripts.check_config_keys

Exit codes: 0 clean, 1 violations (one ``path:line: text`` per finding).
"""

from __future__ import annotations

import ast
import os
import sys

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PACKAGE)
CONFIG = os.path.join(PACKAGE, "config.py")
AUTOSCALE = os.path.join(PACKAGE, "serve", "autoscale.py")
PROMOTER = os.path.join(PACKAGE, "promote", "promoter.py")
CONFIGS = os.path.join(REPO, "configs")

# serve.<section> mappings whose validators own an unknown-key guard
SECTIONS = ("worker", "supervisor", "autoscale", "priority", "stream",
            "tiled")

# top-level _DEFAULTS mappings with the same lockstep contract, bound in
# validate_config via <var> = cfg.get("<section>")
TOP_SECTIONS = ("promote",)


def _const_str(node: ast.AST):
    return node.value if (isinstance(node, ast.Constant)
                          and isinstance(node.value, str)) else None


def _str_tuple(node: ast.AST):
    """frozenset of element strings for a tuple/list of string constants,
    else None."""
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    vals = [_const_str(e) for e in node.elts]
    if vals and all(v is not None for v in vals):
        return frozenset(vals)
    return None


def _dict_get(node: ast.Dict, key: str):
    for k, v in zip(node.keys, node.values):
        if _const_str(k) == key:
            return v
    return None


def _find_defaults_dict(tree: ast.Module):
    """The literal _DEFAULTS dict node, or None."""
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if any(isinstance(t, ast.Name) and t.id == "_DEFAULTS"
               for t in targets):
            return node.value if isinstance(node.value, ast.Dict) else None
    return None


def _section_keys(parent: ast.Dict, sections, label: str, rel: str):
    """{section: ({key: lineno}, section_lineno)} for each named sub-mapping
    of ``parent``, plus violations for missing/non-literal sections."""
    out, violations = {}, []
    for section in sections:
        sec = _dict_get(parent, section)
        if not isinstance(sec, ast.Dict):
            violations.append((rel, parent.lineno,
                               f"_DEFAULTS {label}{section} is missing or "
                               f"not a literal mapping"))
            continue
        keys = {}
        for k in sec.keys:
            name = _const_str(k)
            if name is not None:
                keys[name] = k.lineno
        out[section] = (keys, sec.lineno)
    return out, violations


def _defaults_sections(tree: ast.Module, rel: str):
    """serve sub-sections + top-level sections of _DEFAULTS:
    ({section: ...}, {section: ...}, top-level key set, violations)."""
    defaults = _find_defaults_dict(tree)
    if defaults is None:
        return {}, {}, None, [(rel, 1,
                               "no literal _DEFAULTS mapping — config "
                               "layout changed under the lint; update "
                               "check_config_keys.py")]
    top_keys = {_const_str(k) for k in defaults.keys} - {None}
    serve = _dict_get(defaults, "serve")
    if not isinstance(serve, ast.Dict):
        out, violations = {}, [(rel, 1, "_DEFAULTS has no literal 'serve' "
                                        "mapping — config layout changed "
                                        "under the lint; update "
                                        "check_config_keys.py")]
    else:
        out, violations = _section_keys(serve, SECTIONS, "serve.", rel)
    top, top_viol = _section_keys(defaults, TOP_SECTIONS, "", rel)
    return out, top, top_keys, violations + top_viol


def _unported_paths(tree: ast.Module):
    """The dotted paths of the module-level ``_UNPORTED`` table: keys the
    port refuses off their JAX defaults (a refusal is a validation branch)."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_UNPORTED"
                for t in node.targets) and isinstance(node.value,
                                                      (ast.Tuple, ast.List)):
            return {_const_str(e.elts[0]) for e in node.value.elts
                    if isinstance(e, (ast.Tuple, ast.List)) and e.elts
                    and _const_str(e.elts[0])}
    return set()


def _find_validate(tree: ast.Module):
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and \
                node.name == "validate_config":
            return node
    return None


def _validated_sections(fn: ast.FunctionDef, sections):
    """{section: (validated key set, has unknown-key guard, lineno)} by
    tracking ``<var> = <recv>.get("<section>")`` bindings through the
    function, for any section name in ``sections``."""
    # string-tuple environment: aknown = ("enable", ...), known = (...), ...
    env = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            vals = _str_tuple(node.value)
            if vals is not None:
                env[node.targets[0].id] = vals

    # section variable bindings: a = s.get("autoscale"), w = s.get("worker")
    var_of = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Call):
            call = node.value
            if isinstance(call.func, ast.Attribute) and \
                    call.func.attr == "get" and call.args:
                section = _const_str(call.args[0])
                if section in sections:
                    var_of[section] = (node.targets[0].id, node.lineno)

    def _refs(tree: ast.AST, var: str) -> bool:
        return any(isinstance(n, ast.Name) and n.id == var
                   for n in ast.walk(tree))

    out = {}
    for section, (var, lineno) in var_of.items():
        validated, guarded = set(), False
        for node in ast.walk(fn):
            # <var>.get("key", ...) / <var>["key"]
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "get" and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == var and node.args:
                key = _const_str(node.args[0])
                if key is not None:
                    validated.add(key)
            if isinstance(node, ast.Subscript) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == var:
                key = _const_str(node.slice)
                if key is not None:
                    validated.add(key)
            if not isinstance(node, ast.For):
                continue
            # for key in <var>: ... key not in <tuple> -> unknown-key guard
            if isinstance(node.iter, ast.Name) and node.iter.id == var:
                for cmp_ in ast.walk(node):
                    if isinstance(cmp_, ast.Compare) and any(
                            isinstance(op, ast.NotIn) for op in cmp_.ops):
                        comp = cmp_.comparators[0]
                        vals = _str_tuple(comp)
                        if vals is None and isinstance(comp, ast.Name):
                            vals = env.get(comp.id)
                        if vals is not None:
                            guarded = True
                            validated |= vals
            # for key in <known tuple>: ... <var>[key] range checks
            else:
                vals = _str_tuple(node.iter)
                if vals is None and isinstance(node.iter, ast.Name):
                    vals = env.get(node.iter.id)
                if vals is not None and _refs(node, var):
                    validated |= vals
        out[section] = (validated, guarded, lineno)
    return out


def _module_defaults_keys(path: str):
    """Knob names of a module-level _DEFAULTS dict (autoscale/promoter
    in-code fallbacks)."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    node_value = _find_defaults_dict(tree)
    if node_value is not None:
        keys = {_const_str(k) for k in node_value.keys}
        keys.discard(None)
        return keys, node_value.lineno
    return None, 1


def _lockstep_module(out, module_path: str, section: str, cfg_keys):
    """Flag drift between a module's in-code _DEFAULTS fallback and the
    config section it mirrors."""
    mrel = os.path.relpath(module_path, REPO).replace(os.sep, "/")
    mod_keys, m_line = _module_defaults_keys(module_path)
    if mod_keys is None:
        out.append((mrel, m_line,
                    "no module-level _DEFAULTS dict found — the in-code "
                    "fallback knob set is gone"))
    elif mod_keys != set(cfg_keys):
        out.append((mrel, m_line,
                    f"module _DEFAULTS drifted from config {section}: "
                    f"only-in-module={sorted(mod_keys - set(cfg_keys))} "
                    f"only-in-config={sorted(set(cfg_keys) - mod_keys)}"))


def _validated_top_level(fn: ast.FunctionDef):
    """Top-level config sections validate_config reads: ``cfg.get("X")``
    bindings plus ``cfg.<section>`` attribute access (cfg = first param)."""
    if not fn.args.args:
        return set()
    cfg = fn.args.args[0].arg
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "get" and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == cfg and node.args:
            key = _const_str(node.args[0])
            if key is not None:
                out.add(key)
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == cfg:
            out.add(node.attr)
    out.discard("get")
    return out


def _yaml_top_sections(configs_dir: str):
    """[(relpath, section)] for every mapping-valued top-level key in
    configs/*.yaml — scalar keys (seed: 43) are not sections."""
    import yaml

    out = []
    for fname in sorted(os.listdir(configs_dir)):
        if not fname.endswith((".yaml", ".yml")):
            continue
        path = os.path.join(configs_dir, fname)
        with open(path, encoding="utf-8") as f:
            doc = yaml.safe_load(f) or {}
        if not isinstance(doc, dict):
            continue
        rel = os.path.relpath(path, REPO).replace(os.sep, "/")
        for key, value in doc.items():
            if isinstance(value, dict):
                out.append((rel, str(key)))
    return out


def _check_parity(out, rel, validate, validated, defaults, sections, label):
    """Default-vs-validator key parity for one family of sections; ``label``
    prefixes section names in messages ('serve.' or '')."""
    for section in sections:
        if section not in defaults:
            continue  # already reported by _defaults_sections
        keys, _sec_line = defaults[section]
        if section not in validated:
            out.append((rel, validate.lineno,
                        f"validate_config never reads {label}{section} "
                        f"(expected <var> = <recv>.get({section!r}))"))
            continue
        seen, guarded, v_line = validated[section]
        if not guarded:
            out.append((rel, v_line,
                        f"{label}{section} validator has no unknown-key "
                        f"rejection loop (for key in <var>: ... not in ...)"))
        for key in sorted(set(keys) - seen):
            out.append((rel, keys[key],
                        f"{label}{section}.{key} has a default but no "
                        f"validation branch in validate_config"))
        for key in sorted(seen - set(keys)):
            out.append((rel, v_line,
                        f"validate_config names {label}{section}.{key} but "
                        f"_DEFAULTS ships no typed default for it"))


def find_violations(config_path: str = CONFIG,
                    autoscale_path: str = AUTOSCALE,
                    promoter_path: str = PROMOTER,
                    configs_dir: str = CONFIGS):
    """[(relpath, lineno, message)] against the schema-lockstep contract.
    Pass None for autoscale_path / promoter_path / configs_dir to disable
    the cross-module and yaml-coverage checks."""
    rel = os.path.relpath(config_path, REPO).replace(os.sep, "/")
    with open(config_path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=config_path)

    defaults, top_defaults, top_keys, out = _defaults_sections(tree, rel)

    validate = _find_validate(tree)
    if validate is None:
        out.append((rel, 1, "no validate_config function found"))
        return out
    validated = _validated_sections(validate, SECTIONS + TOP_SECTIONS)
    for path in _unported_paths(tree):
        *head, key = path.split(".")
        section = (head[1] if head[:1] == ["serve"] and len(head) == 2
                   else head[0] if len(head) == 1 else None)
        if section in validated:
            validated[section][0].add(key)

    _check_parity(out, rel, validate, validated, defaults, SECTIONS, "serve.")
    _check_parity(out, rel, validate, validated, top_defaults, TOP_SECTIONS,
                  "")

    if autoscale_path and "autoscale" in defaults:
        _lockstep_module(out, autoscale_path, "serve.autoscale",
                         defaults["autoscale"][0])
    if promoter_path and "promote" in top_defaults:
        _lockstep_module(out, promoter_path, "promote",
                         top_defaults["promote"][0])

    if configs_dir and top_keys is not None:
        vtop = _validated_top_level(validate)
        for yrel, section in _yaml_top_sections(configs_dir):
            if section not in top_keys:
                out.append((yrel, 1,
                            f"top-level section '{section}:' is not a "
                            f"_DEFAULTS section — hand-built configs will "
                            f"never carry it"))
            elif section not in vtop:
                out.append((yrel, 1,
                            f"top-level section '{section}:' has no "
                            f"registered validator (validate_config never "
                            f"reads cfg.{section})"))
    return out


def main(argv=None) -> int:
    import argparse

    argparse.ArgumentParser(
        prog="python -m distegnn_tpu_torch.scripts.check_config_keys",
        description="lint: the port's config defaults and validators agree"
    ).parse_args(argv)
    violations = find_violations()
    for rel, lineno, msg in violations:
        print(f"{rel}:{lineno}: {msg}")
    if violations:
        print(f"\n{len(violations)} config-key violation(s); see the "
              "docstring of distegnn_tpu_torch/scripts/check_config_keys.py "
              "for the contract")
        return 1
    print("check_config_keys: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
