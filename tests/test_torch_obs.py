"""The port's event stream and run metrics (``distegnn_tpu_torch/obs``)
against the JAX package's ``distegnn_tpu/obs``, on the CPU: the metrics
registry's snapshot and Prometheus text for the same recorded values, the
writer's buffering, ``obs.enable: false``, the sequence of event names of
one trainer schedule in both packages (JAX's compile events left out), the
report over the port's events, and the loaders' stall accounting.

Tolerance: 0 (the same pure-Python arithmetic on the same values).
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from distegnn_tpu.obs import metrics as jmetrics
from distegnn_tpu.obs import report as jreport
from distegnn_tpu_torch import obs
from distegnn_tpu_torch.obs import cudaprobe, report
from distegnn_tpu_torch.obs.metrics import MetricsRegistry
from distegnn_tpu_torch.obs.trace import EventWriter
from test_torch_resume import jax_scripted_run, port_scripted_run


def _record(reg):
    reg.counter("data/stall_s").add(0.25)
    reg.counter("data/stall_s").add(1)
    reg.gauge("mem/run_start/bytes_in_use").set(123456789)
    reg.gauge("data/prefetch_depth").add(2)
    res = reg.reservoir("train/step_ms", size=4)
    res.record_many([5.0, 1.5, 9.25])
    for v in (2.0, 7.5, 3.25):
        res.record(v)


def test_registry_snapshot_and_prometheus_text_equal_jax():
    ours, theirs = MetricsRegistry(), jmetrics.MetricsRegistry()
    _record(ours)
    _record(theirs)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.to_json() == theirs.to_json()
    assert ours.render_prometheus() == theirs.render_prometheus()
    assert ours.names() == theirs.names()
    vals = sorted([3.0, 1.0, 4.0, 1.5, 9.0])
    for q in (0, 50, 90, 99, 100):
        assert obs.percentile(vals, q) == jmetrics.percentile(vals, q)
    with pytest.raises(TypeError):
        ours.gauge("data/stall_s")


def test_writer_buffers_until_its_size_or_interval(tmp_path):
    path = str(tmp_path / "obs" / "events.jsonl")
    w = EventWriter(path, buffer_events=3, flush_interval_s=3600.0)
    w.write({"n": 1})
    w.write({"n": 2})
    assert open(path).read() == ""
    w.write({"n": 3})
    assert [json.loads(x)["n"] for x in open(path)] == [1, 2, 3]
    w.write({"n": 4})
    w.flush()
    assert len(open(path).readlines()) == 4
    w.close()
    w.write({"n": 5})                  # closed: dropped
    assert len(open(path).readlines()) == 4
    timed = EventWriter(str(tmp_path / "t.jsonl"), buffer_events=100,
                        flush_interval_s=0.0)
    timed.write({"n": 1})              # the interval has passed: flushed
    assert len(open(tmp_path / "t.jsonl").readlines()) == 1
    timed.close()


def test_disabled_stream_writes_no_file_and_spans_are_no_ops(tmp_path):
    t = obs.configure(str(tmp_path / "obs"), enable=False)
    assert not t.enabled
    with obs.span("x") as s:
        s.set(a=1)
    obs.event("y", b=2)
    assert not os.path.exists(tmp_path / "obs")


def _names(path, drop=("jax/compile",)):
    with open(path) as f:
        return [r["name"] for r in map(json.loads, f) if r["name"] not in
                drop]


@pytest.mark.parametrize("kill_at", [None, 5])
def test_trainer_event_names_are_the_jax_trainers(tmp_path, kill_at):
    """One schedule (2 epochs of 4 micro-steps, a cadence save after each,
    an evaluation after each epoch), uninterrupted and preempted at batch 5,
    through both trainers: the same event names in the same order."""
    at = -1 if kill_at is None else kill_at
    _, jdir = jax_scripted_run(tmp_path, at)
    _, pdir = port_scripted_run(tmp_path, at)
    jnames = _names(os.path.join(jdir, "obs", "events.jsonl"))
    pnames = _names(os.path.join(pdir, "obs", "events.jsonl"))
    assert pnames == jnames
    for name in ("train/run_start", "train/step", "train/epoch",
                 "ckpt/save", "ckpt/rotate", "jax/memory"):
        assert name in pnames, name
    assert ("train/preempt" in pnames) == (kill_at is not None)
    assert ("train/eval" in pnames)
    # the report: the port's summary of its stream is the JAX report's
    events, bad = report.load_events(os.path.join(pdir, "obs",
                                                  "events.jsonl"))
    assert bad == 0
    summary = report.summarize(events)
    assert summary == jreport.summarize(events)
    assert summary["steps"]["count"] == pnames.count("train/step")
    assert report.check(summary) == []
    text = report.render_text(summary, source="port")
    assert "steps:" in text and "checkpoints:" in text
    if kill_at is not None:
        assert "train/preempt" in text


def test_obs_disabled_in_the_config_writes_no_events(tmp_path):
    from distegnn_tpu_torch.config import ConfigDict
    from distegnn_tpu_torch.data.loader import GraphDataset, GraphLoader
    from distegnn_tpu_torch.data.nbody import build_nbody_graph
    from distegnn_tpu_torch.train import trainer as ptrainer
    from distegnn_tpu_torch.train.step import TrainState, make_optimizer
    from test_torch_divergence import _graphs

    model = torch.nn.Linear(3, 3)
    state = TrainState(model, make_optimizer(model.parameters(), 1e-3))
    loader = GraphLoader(GraphDataset(_graphs(build_nbody_graph)), 4)

    def step(state, batch, gen):
        state.step += 1
        return state, {"loss": torch.tensor(0.5)}

    cfg = ConfigDict({"seed": 0, "obs": {"enable": False},
                      "train": {"epochs": 1, "early_stop": 10},
                      "log": {"test_interval": 1, "log_dir": str(tmp_path),
                              "exp_name": "off"}})
    ptrainer.train(state, step, lambda b: torch.tensor(0.1), loader, loader,
                   loader, cfg, torch.device("cpu"))
    assert os.path.exists(tmp_path / "off" / "log" / "log.json")
    assert not os.path.exists(tmp_path / "off" / "obs")


def test_report_cli_renders_a_stream(tmp_path, capsys):
    t = obs.configure(str(tmp_path), buffer_events=1)
    t.event("train/step", epoch=1, step=0, dur_s=0.5, stall_s=0.25)
    t.event("train/epoch", epoch=1, dur_s=1.0, stall_s=0.25,
            loss_train=0.5)
    obs.configure(None)
    path = str(tmp_path / "events.jsonl")
    assert report.main([path, "--check"]) == 0
    out = capsys.readouterr().out
    assert "steps: 1" in out and "data stall: 0.25 s" in out
    assert report.main([path, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["steps"]["count"] == 1
    assert report.main([str(tmp_path / "none.jsonl")]) == 2


def test_memory_probe_reads_nothing_on_the_cpu_and_counts_transfers():
    from distegnn_tpu_torch.data.nbody import build_nbody_graph
    from distegnn_tpu_torch.ops.graph import pad_graphs
    from test_torch_divergence import _graphs

    cudaprobe.configure(True, "cpu")
    assert cudaprobe.device_memory_stats() == {}
    batch = pad_graphs(_graphs(build_nbody_graph)[:2])
    want = sum(v.numel() * v.element_size() for v in vars(batch).values()
               if isinstance(v, torch.Tensor))
    reg = MetricsRegistry()
    assert cudaprobe.TransferMeter(reg).h2d(batch) == want
    assert reg.snapshot()["xfer/h2d_bytes"] == want


class _Slow:
    """A loader of n integers, each taking ``dt`` seconds to produce."""

    def __init__(self, n, dt):
        self.n, self.dt = n, dt

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return self.n

    def __iter__(self):
        from distegnn_tpu_torch.data.loader import _stall_counter

        stall = _stall_counter()
        for i in range(self.n):
            time.sleep(self.dt)
            stall.add(self.dt)
            yield torch.tensor([i])


def test_prefetch_producer_time_is_not_the_trainers_stall():
    """The producer thread charges its collation to data/produce_s; the
    consumer's waits land on data/stall_s and data/prefetch_stall_s; a
    GraphLoader read in the trainer's thread charges data/stall_s."""
    from distegnn_tpu_torch.data.loader import (GraphDataset, GraphLoader,
                                                PrefetchLoader)
    from distegnn_tpu_torch.data.nbody import build_nbody_graph
    from test_torch_divergence import _graphs

    reg = obs.get_registry()

    def read():
        return {k: reg.counter(k).value for k in
                ("data/stall_s", "data/produce_s", "data/prefetch_stall_s")}

    before = read()
    got = [int(x) for x in PrefetchLoader(_Slow(4, 0.02), depth=2)]
    after = read()
    assert got == [0, 1, 2, 3]
    d = {k: after[k] - before[k] for k in after}
    assert d["data/produce_s"] == pytest.approx(0.08)
    assert d["data/stall_s"] == pytest.approx(d["data/prefetch_stall_s"])
    assert d["data/stall_s"] > 0
    assert threading.current_thread() is threading.main_thread()
    s0 = reg.counter("data/stall_s").value
    p0 = reg.counter("data/produce_s").value
    list(GraphLoader(GraphDataset(_graphs(build_nbody_graph)), 2))
    assert reg.counter("data/stall_s").value > s0
    assert reg.counter("data/produce_s").value == p0
    assert np.isfinite(reg.counter("data/stall_s").value)
