"""The port's training durability on the CPU: checkpoints that hold the
whole accumulation state, preemption by SIGTERM, cadence saves and their
rotation, ``train.resume: auto`` (falling back past a damaged file, taking
the checkpoint's seed), and the same behaviour as the JAX trainer's:
checkpoint names, manifest coordinates and the PREEMPTED marker of one
preempted schedule, and a JAX checkpoint written mid-accumulation
continued in the port.

Model: FastEGNN on 10-node n-body graphs, H=16, L=2, C=3, the plain path,
4-step accumulation.

Tolerances: 0 (``torch.equal``) wherever the port resumes its own
checkpoints: the resumed run replays the same operations on the same
values. A JAX checkpoint continued in the port: the parameters after the
next update within 1e-5 of the largest |parameter| (f32; the two packages
sum in other orders, as in ROADMAP.md's parity discipline); the
accumulated gradient as loaded within 1e-6 of its largest entry (a mean
rescaled to a sum).
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import json
import os
import shutil
import signal
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distegnn_tpu.config import ConfigDict as JaxConfigDict
from distegnn_tpu.data import GraphDataset as JaxGraphDataset
from distegnn_tpu.data import GraphLoader as JaxGraphLoader
from distegnn_tpu.data import build_nbody_graph as jax_build_nbody_graph
from distegnn_tpu.models.fast_egnn import FastEGNN as JaxFastEGNN
from distegnn_tpu.ops.graph import pad_graphs as jax_pad_graphs
from distegnn_tpu.train import TrainState as JaxTrainState
from distegnn_tpu.train import make_optimizer as jax_make_optimizer
from distegnn_tpu.train import step as jstep
from distegnn_tpu.train.checkpoint import save_checkpoint as jax_save
from distegnn_tpu.train.trainer import train as jax_train
from distegnn_tpu_torch import main as pmain
from distegnn_tpu_torch.config import ConfigDict, load_config
from distegnn_tpu_torch.convert import checkpoint_from_jax, params_from_jax
from distegnn_tpu_torch.data.loader import GraphDataset, GraphLoader
from distegnn_tpu_torch.data.nbody import build_nbody_graph
from distegnn_tpu_torch.models.fast_egnn import FastEGNN
from distegnn_tpu_torch.models.registry import get_model
from distegnn_tpu_torch.ops.graph import pad_graphs
from distegnn_tpu_torch.train import trainer as ptrainer
from distegnn_tpu_torch.train.checkpoint import (read_manifest,
                                                 restore_checkpoint,
                                                 save_checkpoint)
from distegnn_tpu_torch.train.step import (TrainState, make_optimizer,
                                           make_train_step)
from test_torch_divergence import _graphs
from test_torch_fast_egnn import numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NBODY = os.path.join(REPO, "configs", "nbody_fastegnn.yaml")
K = 4          # accumulation steps
KILL_AT = 8    # the SIGTERM lands before the 9th batch of the run


def _config(log_dir, name, **over):
    ov = {"model.hidden_nf": 16, "model.n_layers": 2,
          "model.normalize": False, "train.accumulation_steps": K,
          "train.epochs": 3, "log.test_interval": 1, "data.batch_size": 1,
          "log.log_dir": str(log_dir), "log.exp_name": name,
          "train.checkpoint_interval_s": 1e-9, "train.keep_checkpoints": 2}
    ov.update(over)
    return load_config(NBODY, ov)


class Killer:
    """A loader that sends this process SIGTERM before it yields batch
    ``at`` (counted over the whole run), then goes on."""

    def __init__(self, loader, at):
        self.loader, self.at, self.n = loader, at, 0

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            if self.n == self.at:
                os.kill(os.getpid(), signal.SIGTERM)
            self.n += 1
            yield batch


def _datasets():
    gs = _graphs(build_nbody_graph, seed=1, n_graphs=10)
    return [GraphDataset(gs[:6]), GraphDataset(gs[6:8]),
            GraphDataset(gs[8:])]


def _run(cfg, kill_at=None):
    real = pmain.make_loaders

    def loaders(*a):
        tr, va, te = real(*a)
        return (tr if kill_at is None else Killer(tr, kill_at)), va, te

    with mock.patch.object(pmain, "make_loaders", loaders):
        return pmain.run(cfg, *_datasets(), device="cpu")


def _adam(state):
    opt = state.optimizer
    return [opt.adam.state[p] for p in opt.params]


def _assert_same_state(a, b):
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    for x, y in zip(_adam(a), _adam(b)):
        # a parameter no gradient reached has no Adam state
        assert x.keys() == y.keys()
        for key in x:
            assert torch.equal(x[key], y[key]), key
    assert any(_adam(a))
    assert (a.optimizer.micro, a.optimizer.updates, a.step) == \
        (b.optimizer.micro, b.optimizer.updates, b.step)


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """A: 3 epochs of 6 micro-steps, uninterrupted. B: the same, SIGTERM
    before batch 8 (epoch 2, step 2: micro 1 of 4 after it). C: a fresh
    model resuming B's log dir with ``resume: auto`` and seed 7 (the
    checkpoint's 43 must win)."""
    root = tmp_path_factory.mktemp("drill")
    a, _, _ = _run(_config(root / "a", "a"))
    b, best_b, _ = _run(_config(root / "b", "b"), kill_at=KILL_AT)
    shutil.copytree(root / "b", root / "b_copy")
    cfg_c = _config(root / "b", "c", **{"train.resume": "auto", "seed": 7})
    c, best_c, log_c = _run(cfg_c)
    return dict(root=root, a=a, b=b, best_b=best_b, c=c,
                cfg_c=cfg_c, log_c=log_c)


def test_mid_accumulation_checkpoint_restores_the_accumulated_gradient(
        tmp_path):
    """Save at micro 2 of 4, restore into a fresh model and optimizer, run
    the 2 remaining micro-steps: parameters and Adam moments equal an
    uninterrupted run's. (Without the summed micro-gradients in the
    checkpoint the update applies only the last two.)"""
    cfg = _config(tmp_path, "x")
    gs = _graphs(build_nbody_graph, seed=2, n_graphs=4)
    batches = [pad_graphs([g]) for g in gs]

    def fresh():
        model = get_model(cfg.model,
                          generator=torch.Generator().manual_seed(0))
        t = cfg.train
        opt = make_optimizer(model.parameters(), t.learning_rate,
                             weight_decay=t.weight_decay,
                             accumulation_steps=K)
        return TrainState(model, opt), make_train_step(
            model, opt, t.mmd.weight, t.mmd.sigma, 1000)

    whole, step = fresh()
    for b in batches:
        step(whole, b)
    assert whole.optimizer.updates == 1
    part, step = fresh()
    for b in batches[:2]:
        step(part, b)
    path = str(tmp_path / "mid.ckpt")
    save_checkpoint(path, part, 0, step_in_epoch=2)
    resumed, step = fresh()
    restore_checkpoint(path, resumed)
    assert resumed.optimizer.micro == 2
    # the summed micro-gradients, None where none reached a parameter (the
    # last layer's h and Hv heads do not reach the loss)
    assert any(p.grad is not None for p in resumed.optimizer.params)
    for p, q in zip(part.optimizer.params, resumed.optimizer.params):
        assert (p.grad is None) == (q.grad is None)
        assert p.grad is None or torch.equal(p.grad, q.grad)
    for b in batches[2:]:
        step(resumed, b)
    _assert_same_state(whole, resumed)


@pytest.mark.parametrize("micro", [0, 2])
def test_an_optimizer_state_without_the_accumulation_state(tmp_path, micro):
    """A payload of an older version (no ``grads``) loads at micro 0 and is
    refused at any other micro, naming what is missing, with the state
    untouched."""
    model = torch.nn.Linear(3, 3)
    opt = make_optimizer(model.parameters(), 1e-3, accumulation_steps=K)
    sd = opt.state_dict()
    del sd["grads"]
    sd["micro"] = micro
    before = [p.detach().clone() for p in model.parameters()]
    if micro == 0:
        opt.load_state_dict(sd)
        assert all(p.grad is None for p in opt.params)
    else:
        with pytest.raises(ValueError, match="accumulation state"):
            opt.load_state_dict(sd)
        assert opt.micro == 0
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))


def test_sigterm_drill_resumes_to_the_uninterrupted_state(drill):
    _assert_same_state(drill["a"], drill["c"])
    pre = drill["best_b"]["preempted"]
    assert (pre["epoch"], pre["step_in_epoch"], pre["signal"]) == \
        (1, 3, int(signal.SIGTERM))
    b = drill["b"]
    assert b.step == KILL_AT + 1 and b.optimizer.micro == (KILL_AT + 1) % K
    ckpt = drill["root"] / "b" / "b" / "state_dict"
    marker = json.loads((ckpt / "PREEMPTED").read_text())
    assert {k: marker[k] for k in ("checkpoint", "epoch",
                                   "step_in_epoch")} == {
        "checkpoint": "preempt_model.ckpt", "epoch": 1, "step_in_epoch": 3}
    # the resumed run logs the epochs it ran, from its resume point
    assert drill["log_c"]["start_epoch"] == 1
    assert len(drill["log_c"]["loss_train"]) == 2


def test_resume_adopts_the_checkpoints_seed(drill):
    assert drill["cfg_c"].seed == 43


def test_rotation_keeps_the_newest_k_and_the_named_checkpoints(drill):
    ckpt = drill["root"] / "a" / "a" / "state_dict"
    names = sorted(os.listdir(ckpt))
    steps = [n for n in names if n.startswith("step_")]
    # 18 micro-steps, a save after each, 2 kept
    assert steps == ["step_0000000017.ckpt", "step_0000000018.ckpt"]
    assert {"best_model.ckpt", "last_model.ckpt",
            "manifest.json"} <= set(names)
    manifest = read_manifest(str(ckpt))
    assert set(manifest) == {n for n in names if n.endswith(".ckpt")}
    # a save on an epoch's last step is recorded as (epoch, 0)
    assert (manifest["step_0000000018.ckpt"]["epoch"],
            manifest["step_0000000018.ckpt"]["step_in_epoch"]) == (3, 0)
    assert (manifest["step_0000000017.ckpt"]["epoch"],
            manifest["step_0000000017.ckpt"]["step_in_epoch"]) == (2, 5)


def test_resume_auto_falls_back_past_a_truncated_newest_file(drill):
    """B's directory with its newest file (preempt_model.ckpt) cut in
    half: the resume takes the newest step checkpoint (the same state,
    micro 1 of 4) and still ends at A's state."""
    root = drill["root"]
    path = root / "b_copy" / "b" / "state_dict" / "preempt_model.ckpt"
    blob = path.read_bytes()
    mtime = os.path.getmtime(path)
    path.write_bytes(blob[:len(blob) // 2])
    os.utime(path, (mtime, mtime))
    cfg = _config(root / "b_copy", "c2", **{"train.resume": "auto"})
    c2, _, log_c2 = _run(cfg)
    _assert_same_state(drill["a"], c2)
    with open(root / "b_copy" / "c2" / "obs" / "events.jsonl") as f:
        names = [json.loads(line)["name"] for line in f]
    assert "ckpt/corrupt" in names and "ckpt/restore" in names


# ---------------------------------------------------------------- JAX parity

def _schedule_config(log_dir, name):
    return {"seed": 0,
            "train": {"epochs": 2, "early_stop": 100,
                      "checkpoint_interval_s": 1e-9, "keep_checkpoints": 2,
                      "divergence_retries": 0},
            "log": {"test_interval": 1, "log_dir": str(log_dir),
                    "exp_name": name, "wandb": {"enable": False}}}


def jax_scripted_run(log_dir, kill_at):
    """The JAX trainer on a scripted step (the step count moves, the loss
    is constant) over 8 graphs in batches of 2, SIGTERM at ``kill_at``."""
    graphs = _graphs(jax_build_nbody_graph)
    state = JaxTrainState.create({"w": jnp.zeros(3)},
                                 jax_make_optimizer(1e-3,
                                                    accumulation_steps=K))

    def step(state, batch, key):
        return state.replace(step=state.step + 1), {"loss": jnp.float32(0.5)}

    def mk(shuffle):
        return JaxGraphLoader(JaxGraphDataset(graphs), batch_size=2,
                              shuffle=shuffle, seed=0)

    _, _, best, _ = jax_train(
        state, step, lambda p, b: jnp.float32(0.1), Killer(mk(True), kill_at),
        mk(False), mk(False), JaxConfigDict(_schedule_config(log_dir, "jax")))
    return best, os.path.join(str(log_dir), "jax")


def port_scripted_run(log_dir, kill_at):
    graphs = _graphs(build_nbody_graph)
    model = torch.nn.Linear(3, 3)
    state = TrainState(model, make_optimizer(model.parameters(), 1e-3,
                                             accumulation_steps=K))

    def step(state, batch, gen):
        state.step += 1
        return state, {"loss": torch.tensor(0.5)}

    def mk(shuffle):
        return GraphLoader(GraphDataset(graphs), 2, shuffle=shuffle, seed=0)

    _, _, best, _ = ptrainer.train(
        state, step, lambda b: torch.tensor(0.1), Killer(mk(True), kill_at),
        mk(False), mk(False), ConfigDict(_schedule_config(log_dir, "port")),
        torch.device("cpu"))
    return best, os.path.join(str(log_dir), "port")


@pytest.mark.parametrize("kill_at", [2, 3, 5])
def test_preempted_schedule_leaves_what_the_jax_trainer_leaves(tmp_path,
                                                               kill_at):
    """4 micro-steps an epoch; SIGTERM mid-epoch (2, 5) and on an epoch's
    last step (3: the run stops at the boundary, before the evaluation):
    the same checkpoint names, the same (epoch, step, step_in_epoch) in
    the manifests, the same marker and ``best['preempted']`` (but its
    path)."""
    jbest, jdir = jax_scripted_run(tmp_path, kill_at)
    pbest, pdir = port_scripted_run(tmp_path, kill_at)
    jck, pck = os.path.join(jdir, "state_dict"), os.path.join(pdir,
                                                              "state_dict")
    assert sorted(os.listdir(pck)) == sorted(os.listdir(jck))

    def coords(d):
        return {n: (e["epoch"], e["step"], e["step_in_epoch"])
                for n, e in read_manifest(d).items()}

    assert coords(pck) == coords(jck)

    def marker(d):
        with open(os.path.join(d, "PREEMPTED")) as f:
            m = json.load(f)
        del m["time"]
        return m

    assert marker(pck) == marker(jck)
    for b in (jbest, pbest):
        del b["preempted"]["checkpoint"]
    assert pbest["preempted"] == jbest["preempted"]


def test_a_jax_checkpoint_saved_mid_accumulation_continues_in_the_port(
        tmp_path):
    """The JAX step runs 6 micro-steps (an update at 4), its checkpoint is
    taken at micro 2 of the second accumulation, and both packages run the
    2 remaining micro-steps from it. clip 0.3, weight decay 1e-2, MSE +
    MMD in its deterministic branch (no random draw)."""
    gs = _graphs(jax_build_nbody_graph, seed=3, n_graphs=8)
    jbatches = [jax_pad_graphs([g]) for g in gs]
    pbatches = [pad_graphs([g]) for g in _graphs(build_nbody_graph, seed=3,
                                                  n_graphs=8)]
    kw = dict(node_feat_nf=2, hidden_nf=16, virtual_channels=3, n_layers=2)
    jm = JaxFastEGNN(**kw)
    params = numpy_params(jm, jbatches[0], 4)
    hyper = dict(weight_decay=1e-2, clip_norm=0.3, accumulation_steps=K)
    mmd = (0.03, 1.5, 100)       # 100 samples x 3 channels >= 10 nodes
    tx = jax_make_optimizer(1e-3, **hyper)
    jstate = JaxTrainState.create(params, tx)
    jstep_fn = jax.jit(jstep.make_train_step(jm, tx, *mmd))
    key = jax.random.PRNGKey(0)
    for b in jbatches[:6]:
        jstate, _ = jstep_fn(jstate, b, key)
    path = str(tmp_path / "state_dict" / "step_0000000006.ckpt")
    jax_save(path, jstate, 1, seed=11, step_in_epoch=2)
    saved = jax.tree.map(np.asarray, jstate)
    for b in jbatches[6:]:
        jstate, _ = jstep_fn(jstate, b, key)

    pm = FastEGNN(**kw)
    opt = make_optimizer(pm.parameters(), 1e-3, **hyper)
    state = TrainState(pm, opt)
    rr = checkpoint_from_jax(path, state)
    assert (rr.epoch, rr.step_in_epoch, rr.seed) == (1, 2, 11)
    assert (opt.micro, opt.updates, state.step) == (2, 1, 6)
    # the loaded state: the parameters exactly, the accumulated gradient as
    # the mean x micro / k
    want_p = params_from_jax(saved.params)
    want_g = params_from_jax(jax.tree.map(
        lambda a: a * (2 / K), saved.opt_state.acc_grads))
    gmax = max(float(v.abs().max()) for v in want_g.values())
    for name, p in pm.named_parameters():
        assert torch.equal(p.detach(), want_p[name]), name
        assert float((p.grad - want_g[name]).abs().max()) <= 1e-6 * gmax, \
            name
    step = make_train_step(pm, opt, *mmd)
    for b in pbatches[6:]:
        step(state, b)
    assert opt.updates == 2 and opt.micro == 0
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    scale = max(float(v.abs().max()) for v in want.values())
    err = max(float((p.detach() - want[n]).abs().max())
              for n, p in pm.named_parameters())
    assert err <= 1e-5 * scale, f"{err:.3e} > {1e-5 * scale:.3e}"
