"""The port's three lints (``distegnn_tpu_torch/scripts/check_no_print.py``,
``check_route_spans.py``, ``check_config_keys.py``), the flags of every
port command line, and the event stream of a training run, on the CPU.

Bounds: each lint is clean over the port; on planted violations it finds
exactly what the JAX package's lint (``scripts/check_*.py``) finds, finding
for finding; a planted violation in a copy of the port is found and nothing
else. Every ``python -m distegnn_tpu_torch.scripts.<name> --help`` lists the
JAX script's flags, plus ``--device`` where the script touches a device.
A short training run through each package's entry point writes ``log``
events that carry the same messages (numbers masked, the port's ``[train]``
prefix dropped): the port's runtime messages go through ``obs.log``.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import contextlib
import glob
import importlib
import io
import json
import os
import re
import shutil
import sys

import pytest
import yaml

from distegnn_tpu_torch.scripts import check_config_keys as pkeys
from distegnn_tpu_torch.scripts import check_no_print as pprint_lint
from distegnn_tpu_torch.scripts import check_route_spans as pspans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "distegnn_tpu_torch")


def _jax_lint(name):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


# ---- the lints over the port ----------------------------------------------------------

@pytest.mark.parametrize("lint", [pprint_lint, pspans, pkeys],
                         ids=["no_print", "route_spans", "config_keys"])
def test_lint_is_clean_over_the_port(lint):
    assert lint.find_violations() == []
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert lint.main([]) == 0
    assert out.getvalue().endswith(": clean\n")


# ---- planted violations: the same findings as JAX's lints -----------------------------

PRINTS = {
    "a.py": 'print("x")\n',
    "b.py": ('x.print(1)\npprint(2)\n# print(3)\ny = 1  # print(4)\n'
             'print(5)  # noqa: obs-print\nz = 0; print (6)\n'),
    "sub/c.py": 'def f():\n    print(f"{1}")\n    return "print("\n',
    "sub/d.txt": 'print("not python")\n',
}


def test_print_lint_finds_what_jax_finds(tmp_path):
    for rel, text in PRINTS.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    want = _jax_lint("check_no_print").find_violations(str(tmp_path))
    got = pprint_lint.find_violations(str(tmp_path))
    assert got == want
    assert [(r, n) for r, n, _ in got] == [("a.py", 1), ("b.py", 6),
                                           ("sub/c.py", 2), ("sub/c.py", 3)]


def test_print_lint_finds_a_print_planted_in_the_port(tmp_path):
    copy = tmp_path / "pkg"
    shutil.copytree(PORT, copy, ignore=shutil.ignore_patterns(
        "_build", "__pycache__", "csrc"))
    target = copy / "serve" / "engine.py"
    lines = target.read_text().split("\n")
    lines.insert(10, 'print("planted")')
    target.write_text("\n".join(lines))
    got = pprint_lint.find_violations(str(copy))
    assert got == [("serve/engine.py", 11, 'print("planted")')]


SPANS = {
    "bare": (
        "class Handler:\n"
        "    def do_GET(self):\n"
        "        self.send_response(200)\n"
        "\n"
        "class Gateway:\n"
        "    def dispatch(self, handler, method):\n"
        "        self._handle(handler, method, '/', 'predict')\n"
        "    def _handle(self, h, m, p, r):\n"
        "        pass\n"),
    "no_request_id": (
        "class Handler:\n"
        "    def do_POST(self):\n"
        "        self.gateway.dispatch(self, 'POST')\n"
        "\n"
        "class Gateway:\n"
        "    def dispatch(self, handler, method):\n"
        "        rid = mint_request_id(handler)\n"
        "        with obs.span('serve/http', method=method):\n"
        "            self._handle(handler, method)\n"),
    "outside": (
        "class Handler:\n"
        "    def do_GET(self):\n"
        "        '''doc'''\n"
        "        self.gateway.dispatch(self, 'GET')\n"
        "\n"
        "class Gateway:\n"
        "    def dispatch(self, handler, method):\n"
        "        handler.request_id = mint_request_id(handler)\n"
        "        with obs.span('serve/http', request_id=handler.request_id):\n"
        "            pass\n"
        "        self._handle(handler, method)\n"),
    "empty": "x = 1\n",
}


@pytest.mark.parametrize("case", sorted(SPANS))
def test_route_span_lint_finds_what_jax_finds(tmp_path, case):
    bad = tmp_path / "transport.py"
    bad.write_text(SPANS[case])
    want = _jax_lint("check_route_spans").find_violations(str(bad))
    got = pspans.find_violations(str(bad))
    assert got == want and got


def test_route_span_lint_finds_a_bare_handler_planted_in_the_port(tmp_path):
    src = open(os.path.join(PORT, "serve", "transport.py")).read()
    forward = 'def do_GET(self):\n            gateway.dispatch(self, "GET")'
    assert src.count(forward) == 1, "the port's do_GET changed shape"
    bad = tmp_path / "transport.py"
    bad.write_text(src.replace(forward, "def do_GET(self):\n"
                               "            self.send_response(200)"))
    got = pspans.find_violations(str(bad))
    assert [msg for _, _, msg in got] == [
        "bare handler do_GET: must forward to gateway.dispatch(self, ...) "
        "and nothing else"]


CONFIGS = {
    "default_without_validation": (
        '_DEFAULTS: dict = {\n'
        '    "serve": {\n'
        '        "autoscale": {"enable": False, "bogus": 1},\n'
        '    },\n'
        '}\n'
        '\n'
        'def validate_config(cfg):\n'
        '    s = cfg.get("serve")\n'
        '    a = s.get("autoscale")\n'
        '    for key in a:\n'
        '        if key not in ("enable",):\n'
        '            raise ValueError(key)\n'),
    "validation_without_default": (
        '_DEFAULTS = {"serve": {"stream": {"chunk_steps": 8}},\n'
        '             "promote": {"enable": False}}\n'
        'def validate_config(cfg):\n'
        '    s = cfg.get("serve")\n'
        '    st = s.get("stream")\n'
        '    known = ("chunk_steps", "ghost")\n'
        '    for key in st:\n'
        '        if key not in known:\n'
        '            raise ValueError(key)\n'
        '    p = cfg.get("promote")\n'
        '    if p.get("enable"):\n'
        '        pass\n'),
    "no_defaults": 'def validate_config(cfg):\n    pass\n',
    "no_validator": '_DEFAULTS = {"serve": {}, "promote": {}}\n',
}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_config_key_lint_finds_what_jax_finds(tmp_path, case):
    bad = tmp_path / "config.py"
    bad.write_text(CONFIGS[case])
    kw = dict(config_path=str(bad), autoscale_path=None, promoter_path=None,
              configs_dir=None)
    want = _jax_lint("check_config_keys").find_violations(**kw)
    got = pkeys.find_violations(**kw)
    assert got == want and got


def test_config_key_lint_cross_module_and_yaml_checks_match_jax(tmp_path):
    auto = tmp_path / "autoscale.py"
    src = open(os.path.join(PORT, "serve", "autoscale.py")).read()
    auto.write_text(src.replace('_DEFAULTS: Dict[str, Any] = {',
                                '_DEFAULTS: Dict[str, Any] = {\n    '
                                '"planted": 1,', 1))
    configs = tmp_path / "configs"
    configs.mkdir()
    (configs / "ok.yaml").write_text("seed: 1\nserve:\n  max_batch: 2\n")
    (configs / "bad.yaml").write_text("nonsense:\n  a: 1\n")
    kw = dict(config_path=os.path.join(PORT, "config.py"),
              autoscale_path=str(auto), promoter_path=None,
              configs_dir=str(configs))
    want = _jax_lint("check_config_keys").find_violations(**kw)
    got = pkeys.find_violations(**kw)
    assert got == want
    assert len(got) == 2 and "planted" in got[0][2] and "nonsense" in got[1][2]


def test_config_key_lint_counts_an_unported_refusal_as_a_branch(tmp_path):
    """A key the port refuses through ``_UNPORTED`` (off its JAX default)
    is validated; JAX's lint, which knows no such table, flags it."""
    text = ('_DEFAULTS = {"serve": {"tiled": {"enable": False, "shards": 1}}}'
            '\n_UNPORTED = (("serve.tiled.shards", (1,), "not ported"),)\n'
            'def validate_config(cfg):\n'
            '    s = cfg.get("serve")\n'
            '    t = s.get("tiled")\n'
            '    for key in t:\n'
            '        if key not in ("enable",):\n'
            '            raise ValueError(key)\n')
    bad = tmp_path / "config.py"
    bad.write_text(text)
    kw = dict(config_path=str(bad), autoscale_path=None, promoter_path=None,
              configs_dir=None)
    assert not any("tiled" in m for _, _, m in pkeys.find_violations(**kw))
    assert any("serve.tiled.shards has a default but no validation branch"
               in m for _, _, m in
               _jax_lint("check_config_keys").find_violations(**kw))


# ---- every command line's flags -------------------------------------------------------

SCRIPTS = ["serve_bench", "traffic_gen", "check_no_print", "check_route_spans",
           "check_config_keys", "measure_remat_memory", "partition_quality",
           "evaluate_rollout", "evaluate_protein_equivariance"]
ON_A_DEVICE = {"serve_bench", "traffic_gen", "measure_remat_memory",
               "evaluate_rollout", "evaluate_protein_equivariance"}
_FLAG = re.compile(r"(?<![\w-])--[A-Za-z][\w-]*")


def _help_flags(main, monkeypatch, prog):
    out = io.StringIO()
    monkeypatch.setattr(sys, "argv", [prog, "--help"])
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(
            io.StringIO()):
        try:
            main(["--help"]) if main.__code__.co_argcount else main()
        except SystemExit:
            pass
    return set(_FLAG.findall(out.getvalue())) - {"--help"}


@pytest.mark.parametrize("name", SCRIPTS)
def test_help_lists_the_jax_flags(name, monkeypatch):
    sys.path.insert(0, REPO)
    try:
        jmod = importlib.import_module(f"scripts.{name}")
    finally:
        sys.path.pop(0)
    pmod = importlib.import_module(f"distegnn_tpu_torch.scripts.{name}")
    want = _help_flags(jmod.main, monkeypatch, name)
    got = _help_flags(pmod.main, monkeypatch, name)
    extra = {"--device"} if name in ON_A_DEVICE else set()
    assert got == want | extra, (got, want)


# ---- runtime messages reach the event stream ------------------------------------------

def _log_messages(events_path):
    masked = []
    for line in open(events_path):
        e = json.loads(line)
        if e.get("name") == "log":
            msg = re.sub(r"^\[train\] ", "", e["msg"])
            masked.append(re.sub(r"\d+(\.\d+)?(e-?\d+)?", "#", msg))
    return masked


def test_training_log_events_carry_jax_messages(tmp_path):
    """A two-epoch n-body run through JAX's root ``main.py`` and through
    ``python -m distegnn_tpu_torch.main``, each with its event stream on:
    both streams hold the same ``log`` messages, the closing ``Done. Best``
    included (the port printed it past the stream)."""
    sys.path.insert(0, REPO)
    try:
        import main as jmain
    finally:
        sys.path.pop(0)
    from distegnn_tpu_torch import main as pmain
    from test_torch_train import _write_nbody

    paths = {}
    for side in ("j", "p"):
        _write_nbody(str(tmp_path / side / "data" / "nbody_t"),
                     samples=(4, 2, 2))
        with open(os.path.join(REPO, "configs", "nbody_fastegnn.yaml")) as f:
            raw = yaml.safe_load(f)
        raw["model"].update(normalize=False, hidden_nf=16, n_layers=2)
        raw["data"].update(data_dir=str(tmp_path / side / "data"),
                           dataset_name="nbody_t", max_samples=10, frame_0=2,
                           frame_T=8, radius=-1.0, cutoff_rate=0.0,
                           batch_size=2, accelerate_mode="cutoff_edges")
        raw["log"].update(log_dir=str(tmp_path / side / "logs"),
                          test_interval=1)
        paths[side] = tmp_path / f"{side}.yaml"
        paths[side].write_text(yaml.safe_dump(raw))
    with contextlib.redirect_stdout(io.StringIO()):
        jmain.main(["--config_path", str(paths["j"]), "--epochs", "2"])
        pmain.main(["--config_path", str(paths["p"]), "--epochs", "2",
                    "--device", "cpu"])
    (jev,) = glob.glob(str(tmp_path / "j" / "logs" / "*" / "obs" /
                           "events.jsonl"))
    (pev,) = glob.glob(str(tmp_path / "p" / "logs" / "*" / "obs" /
                           "events.jsonl"))
    want, got = _log_messages(jev), _log_messages(pev)
    assert got == want
    assert any(m.startswith("Done. Best: {'epoch_index'") for m in got), got
