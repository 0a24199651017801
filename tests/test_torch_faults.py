"""The port's training fault kit (``testing/faults.py``) and its tiny
trainer (``testing/tiny_run.py``) against the JAX package's, on the CPU.

In process: ``corrupt_checkpoint`` changes a file as JAX's does in all
three modes (and the port's checkpoint checks catch each), an unknown mode
raises the same error; ``simulate_killed_save`` writes JAX's bytes, the
port's ``save_checkpoint`` sweeps them and ``resolve_resume`` never picks
them; ``poison_nan_batches`` NaNs every floating field of the port's
batches at the same global step as JAX's injector, once across epochs, on
the device where a batch sits; ``flaky_open`` / ``truncated_read`` count
the port loader's opens and its read retry absorbs them; ``inject_at_call``
fires right after the n-th call; ``build_graphs`` is JAX's bit for bit.

In subprocesses (``python -m distegnn_tpu_torch.testing.tiny_run --device
cpu``): the five scenarios of ``tests/test_resilience.py`` at its bounds —
SIGKILL mid-epoch with the newest step checkpoint truncated, then
``--resume auto`` reaches the control's final loss within 1e-6; SIGTERM
exits 75 with the preempt checkpoint and marker, and the resume reaches the
control's loss within 1e-6; a resume launched with another seed adopts the
checkpoint's; a NaN batch with retries rolls back and finishes finite; with
none the run is declared diverged. And the decisions of JAX's tiny_run on
SIGTERM-at-2 + resume and on poison-at-5 with 2 retries: every RESULT field
but the loss, and the exit codes, equal JAX's. All runs start together in a
module fixture (2 at a time), three of them JAX's.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import glob
import json
import os
import pickle
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import distegnn_tpu.testing as jax_testing
from distegnn_tpu.data.loader import GraphDataset as JaxGraphDataset
from distegnn_tpu.data.loader import GraphLoader as JaxGraphLoader
from distegnn_tpu.testing import faults as jfaults
from distegnn_tpu.testing.tiny_run import build_graphs as jax_build_graphs
from distegnn_tpu_torch import testing as port_testing
from distegnn_tpu_torch.config import ConfigDict
from distegnn_tpu_torch.data import loader
from distegnn_tpu_torch.data.loader import GraphDataset, GraphLoader
from distegnn_tpu_torch.testing import faults
from distegnn_tpu_torch.testing.tiny_run import build_graphs
from distegnn_tpu_torch.train.checkpoint import (CheckpointCorruptError,
                                                 resolve_resume,
                                                 save_checkpoint,
                                                 verify_checkpoint)
from distegnn_tpu_torch.train.step import TrainState, make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tiny_run's fixed layout (exp_name "run")
STATE_DIR = os.path.join("run", "state_dict")
EXIT_PREEMPTED = 75


def _state():
    model = torch.nn.Linear(3, 3)
    return TrainState(model, make_optimizer(model.parameters(), 1e-3))


# ---------------------------------------------------------- checkpoint faults

@pytest.mark.parametrize("mode", ["truncate", "garbage", "headerless"])
def test_corrupt_checkpoint_changes_a_file_as_jaxs_does(tmp_path, mode):
    """On a port checkpoint: the same bytes as JAX's injector leaves, and
    the port's integrity check rejects the file."""
    path = str(tmp_path / "state_dict" / "a.ckpt")
    save_checkpoint(path, _state(), 1)
    with open(path, "rb") as f:
        blob = f.read()
    verify_checkpoint(path)
    copy = str(tmp_path / "state_dict" / "copy.bin")
    with open(copy, "wb") as f:
        f.write(blob)
    faults.corrupt_checkpoint(path, mode)
    jfaults.corrupt_checkpoint(copy, mode)
    with open(path, "rb") as f, open(copy, "rb") as g:
        got, want = f.read(), g.read()
    assert got == want and got != blob
    with pytest.raises(CheckpointCorruptError):
        verify_checkpoint(path)


def test_corrupt_checkpoint_unknown_mode_raises_as_jaxs(tmp_path):
    path = tmp_path / "x.bin"
    path.write_bytes(b"0123456789")
    msgs = []
    for mod in (faults, jfaults):
        with pytest.raises(ValueError) as e:
            mod.corrupt_checkpoint(str(path), "melt")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "unknown corruption mode 'melt'"
    assert path.read_bytes() == b"0123456789"


def test_serve_faults_use_the_one_corrupt_checkpoint():
    from distegnn_tpu_torch.testing import serve_faults

    assert serve_faults.corrupt_checkpoint is faults.corrupt_checkpoint
    assert port_testing.corrupt_checkpoint is faults.corrupt_checkpoint


def test_killed_save_debris_is_jaxs_swept_and_never_resumed(tmp_path):
    ckpt = tmp_path / "logs" / "run" / "state_dict"
    tmp = faults.simulate_killed_save(str(ckpt))
    jtmp = jfaults.simulate_killed_save(str(tmp_path / "jax"))
    with open(tmp, "rb") as f, open(jtmp, "rb") as g:
        assert f.read() == g.read()
    assert os.path.basename(tmp) == "victim.ckpt.tmp"
    cfg = ConfigDict({"seed": 0, "train": {"resume": "auto"},
                      "log": {"log_dir": str(tmp_path / "logs")}})
    # only the debris: a fresh start
    assert resolve_resume(cfg, _state()) is None
    # a valid checkpoint beside it: that one, and the save swept the debris
    faults.simulate_killed_save(str(ckpt), name="late.ckpt")
    state = _state()
    save_checkpoint(str(ckpt / "last_model.ckpt"), state, 2, seed=0)
    assert not glob.glob(str(ckpt / "*.tmp"))
    faults.simulate_killed_save(str(ckpt))
    rr = resolve_resume(cfg, _state())
    assert rr is not None and rr.path.endswith("last_model.ckpt")
    assert rr.epoch == 2


# ---------------------------------------------------------------- data faults

def _loaders(n_epochs=3):
    """Per epoch, the port's and JAX's batches of tiny_run's graphs
    (batch 2: 4 a epoch) through each package's poison injector at global
    step 5."""
    port = faults.poison_nan_batches(
        GraphLoader(GraphDataset(build_graphs()), 2, shuffle=True, seed=0),
        at_step=5)
    jax_ = jfaults.poison_nan_batches(
        JaxGraphLoader(JaxGraphDataset(jax_build_graphs()), 2, shuffle=True,
                       seed=0), at_step=5)
    out = []
    for epoch in range(1, n_epochs + 1):
        port.set_epoch(epoch)
        jax_.set_epoch(epoch)
        out.append((list(port), list(jax_)))
    return port, jax_, out


def _has_nan(x):
    if isinstance(x, torch.Tensor):
        return bool(torch.isnan(x).any()) if x.is_floating_point() else False
    arr = np.asarray(x)
    return bool(np.isnan(arr).any()) if np.issubdtype(arr.dtype,
                                                      np.floating) else False


def test_poison_fires_once_at_jaxs_step_across_epochs():
    port, jax_, epochs = _loaders()
    assert len(port) == len(jax_) == 4
    assert port.fired == jax_.fired == 1
    flags = [[any(_has_nan(getattr(b, f)) for f in ("loc", "node_feat"))
              for b in pb] for pb, _ in epochs]
    jflags = [[_has_nan(b.loc) for b in jb] for _, jb in epochs]
    assert flags == jflags == [[False] * 4, [False, True, False, False],
                               [False] * 4]
    bad = epochs[1][0][1]
    clean = GraphLoader(GraphDataset(build_graphs()), 2, shuffle=True, seed=0)
    clean.set_epoch(2)
    ref = list(clean)[1]
    for f in ("node_feat", "node_attr", "loc", "vel", "target", "loc_mean",
              "node_mask", "edge_index", "edge_attr", "edge_mask"):
        a, b = getattr(bad, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.is_floating_point():
            assert torch.isnan(a).all(), f
        else:
            assert torch.equal(a, b), f


def test_poison_nanifies_a_batch_where_it_sits():
    """A batch on another device keeps it (``meta`` here: no card), and
    numpy dicts are poisoned too."""
    clean = GraphLoader(GraphDataset(build_graphs()), 2, shuffle=False,
                        seed=0)
    on_meta = [b.to("meta") for b in clean]
    got = list(faults.poison_nan_batches(on_meta, at_step=0))
    assert all(t.device.type == "meta" for t in vars(got[0]).values()
               if isinstance(t, torch.Tensor))
    assert got[0].loc.dtype == torch.float32
    g = build_graphs()[0]
    out = list(faults.poison_nan_batches([g, g], at_step=1, times=1))
    assert np.isnan(out[1]["loc"]).all() and not np.isnan(out[0]["loc"]).any()
    assert np.array_equal(out[1]["edge_index"], g["edge_index"])


@pytest.fixture
def pickled(tmp_path):
    graphs = build_graphs()[:3]
    path = tmp_path / "graphs.pkl"
    with open(path, "wb") as f:
        pickle.dump(graphs, f)
    return str(path), graphs


@pytest.fixture
def sleeps(monkeypatch):
    slept = []
    monkeypatch.setattr(loader.time, "sleep", slept.append)
    return slept


@pytest.mark.parametrize("inject", ["flaky_open", "truncated_read"])
def test_loader_retry_absorbs_two_faults_and_counts_calls(pickled, sleeps,
                                                          inject):
    path, graphs = pickled
    with getattr(faults, inject)(2) as calls:
        ds = GraphDataset(path)
    assert calls["n"] == 3 and sleeps == [0.1, 0.2]
    assert loader._file_open is open
    for g, ref in zip(ds.graphs, graphs):
        for k in ref:
            np.testing.assert_array_equal(g[k], ref[k])
    with getattr(jfaults, inject)(2) as jcalls:
        JaxGraphDataset(path)
    assert jcalls["n"] == calls["n"]


@pytest.mark.parametrize("inject", ["flaky_open", "truncated_read"])
def test_loader_raises_after_its_third_failed_read(pickled, sleeps, inject):
    path, _ = pickled
    with pytest.raises(OSError if inject == "flaky_open" else
                       (EOFError, pickle.UnpicklingError)):
        with getattr(faults, inject)(5) as calls:
            GraphDataset(path)
    assert calls["n"] == 3 and loader._file_open is open


def test_flaky_open_raises_the_given_error_type(pickled, sleeps):
    path, _ = pickled
    with faults.flaky_open(1, exc=PermissionError(13, "denied")) as calls:
        GraphDataset(path)
    assert calls["n"] == 2
    with pytest.raises(PermissionError):
        with faults.flaky_open(3, exc=PermissionError(13, "denied")):
            GraphDataset(path)


# ------------------------------------------------------------- process faults

def test_inject_at_call_fires_right_after_the_nth_call():
    seen = []

    def step(state, batch, generator=None):
        seen.append(("step", batch))
        return state + 1, {"loss": batch}

    wrapped = faults.inject_at_call(step, 3, lambda: seen.append("fire"))
    state = 0
    for i in range(5):
        state, m = wrapped(state, i, generator=None)
        assert m == {"loss": i}
    assert state == 5
    assert seen == [("step", 0), ("step", 1), ("step", 2), "fire",
                    ("step", 3), ("step", 4)]


def test_build_graphs_is_jaxs_bit_for_bit():
    got, want = build_graphs(), jax_build_graphs()
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


def test_testing_package_exports_jaxs_names():
    assert port_testing.__all__ == jax_testing.__all__
    for name in port_testing.__all__:
        assert callable(getattr(port_testing, name)), name


# ---------------------------------------------------- subprocess scenarios ---

def _run(pkg, log_dir, *extra):
    """One tiny_run subprocess: (rc, stdout + stderr, the RESULT json or
    None when it died before printing it)."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", f"{pkg}.testing.tiny_run", "--log-dir",
           str(log_dir)] + [str(a) for a in extra]
    if pkg == "distegnn_tpu_torch":
        cmd += ["--device", "cpu"]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=240)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            result = json.loads(line[len("RESULT "):])
    return proc.returncode, proc.stdout + proc.stderr, result


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """Every scenario's runs, the dependent ones chained (the victim, then
    what the test does to its directory, then the resume); the chains run
    2 at a time (gentle on a loaded host), JAX's first (its runs are the
    slowest)."""
    root = tmp_path_factory.mktemp("drills")
    P, J = "distegnn_tpu_torch", "distegnn_tpu"

    def kill_chain():
        d = root / "kill"
        first = _run(P, d, "--interval-s", 0.001, "--kill-at-step", 6)
        steps = sorted(glob.glob(str(d / STATE_DIR / "step_*.ckpt")))
        if steps:
            faults.corrupt_checkpoint(steps[-1], mode="truncate")
        return first, steps, _run(P, d, "--resume", "auto")

    def resume_chain(pkg, name, first_args, resume_args):
        def chain():
            d = root / name
            first = _run(pkg, d, *first_args)
            state = sorted(os.listdir(d / STATE_DIR)) \
                if os.path.isdir(d / STATE_DIR) else []
            return first, state, _run(pkg, d, *resume_args)
        return chain

    jobs = {
        "jax_sigterm": resume_chain(J, "jax_sigterm", ["--sigterm-at-step", 2],
                                    ["--resume", "auto"]),
        "jax_poison": lambda: _run(J, root / "jax_poison", "--poison-at-step",
                                   5, "--retries", 2),
        "kill": kill_chain,
        "sigterm": resume_chain(P, "sigterm", ["--sigterm-at-step", 2],
                                ["--resume", "auto"]),
        "seed": resume_chain(P, "seed", ["--seed", 7, "--sigterm-at-step", 2],
                             ["--seed", 3, "--resume", "auto"]),
        "control": lambda: _run(P, root / "control"),
        "poison": lambda: _run(P, root / "poison", "--poison-at-step", 5,
                               "--retries", 2),
        "poison0": lambda: _run(P, root / "poison0", "--poison-at-step", 2,
                                "--retries", 0),
    }
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        out = {k: f.result() for k, f in futures.items()}
    out["root"] = root
    return out


@pytest.fixture(scope="module")
def control_loss(drills):
    rc, log, result = drills["control"]
    assert rc == 0, log
    assert result is not None and result["final_train_loss"] is not None
    return result["final_train_loss"]


def test_sigkill_resume_matches_control_with_corrupt_newest(drills,
                                                            control_loss):
    (rc, log, _), steps, (rc2, log2, result) = drills["kill"]
    assert rc == -signal.SIGKILL, log
    assert len(steps) >= 2, f"expected cadence step checkpoints, got {steps}"
    assert rc2 == 0, log2
    assert "resume: skipping" in log2          # past the truncated newest
    assert "resume: restored" in log2
    assert result["start_epoch"] > 0 or result["start_step_in_epoch"] > 0
    assert abs(result["final_train_loss"] - control_loss) <= 1e-6


def test_sigterm_preempts_with_exit75_then_resumes(drills, control_loss):
    (rc, log, result), state, (rc2, log2, result2) = drills["sigterm"]
    assert rc == EXIT_PREEMPTED, log
    assert "PREEMPTED" in log
    assert result is not None and result["preempted"]
    assert "preempt_model.ckpt" in state and "PREEMPTED" in state
    assert rc2 == 0, log2
    assert "resume: restored" in log2
    assert abs(result2["final_train_loss"] - control_loss) <= 1e-6


def test_resume_adopts_checkpoint_seed(drills):
    (rc, log, _), _, (rc2, log2, _) = drills["seed"]
    assert rc == EXIT_PREEMPTED, log
    assert rc2 == 0, log2
    assert "resume: adopting seed 7" in log2


def test_divergence_rolls_back_and_recovers(drills):
    rc, log, result = drills["poison"]
    assert rc == 0, log
    assert "DIVERGED" in log and "rolling back" in log
    assert result["divergence_events"] == 1
    assert not result["diverged"]
    assert np.isfinite(result["final_train_loss"])


def test_divergence_retries_exhausted_declares_dead(drills):
    rc, log, result = drills["poison0"]
    assert rc == 0, log
    assert result["diverged"]
    logs = glob.glob(str(drills["root"] / "poison0" / "run" / "log" /
                         "log.json"))
    assert logs, "a diverged run still writes log.json"
    with open(logs[0]) as f:
        assert "diverged" in json.load(f)[0]


DECISIONS = ("start_epoch", "start_step_in_epoch", "epochs_logged",
             "divergence_events", "preempted", "diverged")


def _decisions(run):
    rc, log, result = run
    assert result is not None, log
    return rc, {k: result[k] for k in DECISIONS}


def test_sigterm_and_resume_decide_as_jaxs_tiny_run(drills):
    (first, state, resumed) = drills["sigterm"]
    (jfirst, jstate, jresumed) = drills["jax_sigterm"]
    assert _decisions(first) == _decisions(jfirst)
    assert _decisions(resumed) == _decisions(jresumed)
    assert _decisions(jfirst)[0] == EXIT_PREEMPTED
    assert _decisions(jresumed)[1]["start_step_in_epoch"] == 2
    # the same checkpoint files are left behind
    assert state == jstate


def test_poison_with_retries_decides_as_jaxs_tiny_run(drills):
    assert _decisions(drills["poison"]) == _decisions(drills["jax_poison"])
    assert _decisions(drills["poison"])[1]["divergence_events"] == 1
