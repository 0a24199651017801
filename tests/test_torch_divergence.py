"""The port's divergence rollback against the JAX trainer's, on the CPU.

A non-finite epoch loss with ``train.divergence_retries`` left rolls the run
back to the last finite-loss state and retries it at ``lr_scale *=
divergence_lr_decay``; with none left it stops. The first test drives both
packages' ``train`` with the same scripted step (a finite loss, then NaN on
chosen calls) and compares what they record, exactly. The second trains a
tiny FastEGNN with one poisoned epoch and checks what the rollback restores:
the parameters, the Adam state and the gradient accumulated between updates
(bitwise), and the learning rate of the next update (0.5 x).
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import os

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
from distegnn_tpu.train.trainer import train as jax_train
from distegnn_tpu_torch.config import ConfigDict, load_config
from distegnn_tpu_torch.data.loader import GraphDataset, GraphLoader
from distegnn_tpu_torch.data.nbody import build_nbody_graph
from distegnn_tpu_torch.models.registry import get_model
from distegnn_tpu_torch.train import trainer as ptrainer
from distegnn_tpu_torch.train.step import (TrainState, make_eval_step,
                                           make_optimizer, make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GRAPHS, BATCH = 8, 4      # two micro-steps an epoch
EPOCHS = 6


def _graphs(build, seed=0, n_graphs=N_GRAPHS, n=10):
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n_graphs):
        loc = rng.normal(size=(n, 3))
        vel = rng.normal(size=(n, 3))
        charges = rng.choice([1.0, -1.0], size=(n, 1))
        graphs.append(build(loc, vel, charges, loc + 0.1 * vel, radius=-1.0,
                            cutoff_rate=0.0))
    return graphs


def _run_config(log_dir, name, retries, decay=0.5):
    return {"seed": 0,
            "train": {"epochs": EPOCHS, "early_stop": 100,
                      "divergence_retries": retries,
                      "divergence_lr_decay": decay},
            "log": {"test_interval": 2, "log_dir": str(log_dir),
                    "exp_name": name, "wandb": {"enable": False}}}


def _scripted(nan_calls, finite):
    """A step that returns a finite loss, or NaN on the calls (1-based) in
    ``nan_calls``."""
    calls = {"n": 0}

    def loss():
        calls["n"] += 1
        return float("nan") if calls["n"] in nan_calls else finite

    return loss


def _jax_run(tmp_path, retries, nan_calls):
    graphs = _graphs(jax_build_nbody_graph)
    model = JaxFastEGNN(node_feat_nf=2, hidden_nf=16, virtual_channels=3,
                        n_layers=2)
    params = model.init(jax.random.PRNGKey(0), jax_pad_graphs(graphs[:4]))
    state = JaxTrainState.create(params, jax_make_optimizer(1e-3))
    loss = _scripted(nan_calls, 0.5)

    def step(state, batch, key):
        return state.replace(step=state.step + 1), {
            "loss": jnp.float32(loss())}

    def mk(shuffle):
        return JaxGraphLoader(JaxGraphDataset(graphs), batch_size=BATCH,
                              shuffle=shuffle, seed=0)

    _, _, best, log_dict = jax_train(
        state, step, lambda p, b: jnp.float32(0.1), mk(True), mk(False),
        mk(False), JaxConfigDict(_run_config(tmp_path, "jax", retries)),
        step_factory=lambda lr_scale: step)
    return best, log_dict


def _port_run(tmp_path, retries, nan_calls):
    graphs = _graphs(build_nbody_graph)
    model = torch.nn.Linear(3, 3)
    state = TrainState(model, make_optimizer(model.parameters(), 1e-3))
    loss = _scripted(nan_calls, 0.5)

    def step(state, batch, gen):
        state.step += 1
        return state, {"loss": torch.tensor(loss())}

    def mk(shuffle):
        return GraphLoader(GraphDataset(graphs), BATCH, shuffle=shuffle,
                           seed=0)

    _, _, best, log_dict = ptrainer.train(
        state, step, lambda b: torch.tensor(0.1), mk(True), mk(False),
        mk(False), ConfigDict(_run_config(tmp_path, "port", retries)),
        torch.device("cpu"))
    return best, log_dict, state


# (retries, NaN calls, the epoch that diverges, the epoch rolled back to).
# Two micro-steps an epoch: with {4, 6, 11} epoch 2 (calls 3-4) diverges,
# then its first retry (5-6), its second retry (7-8) is finite and epoch 4
# (11-12) diverges with no retry left. With {6} epoch 3 diverges once and
# rolls back to epoch 2, an eval epoch: the snapshot is taken before the
# evaluation, so its eval entry is rewound too, in both packages.
ROLLBACK_CASES = [(2, {4, 6, 11}, 2, 1), (1, {4, 6, 11}, 2, 1),
                  (0, {4, 6, 11}, 2, 1), (2, {6}, 3, 2)]


@pytest.mark.parametrize("retries, nan_calls, epoch, back", ROLLBACK_CASES)
def test_rollback_records_what_the_jax_trainer_records(tmp_path, retries,
                                                       nan_calls, epoch,
                                                       back):
    jbest, jlog = _jax_run(tmp_path, retries, nan_calls)
    pbest, plog, pstate = _port_run(tmp_path, retries, nan_calls)
    assert plog["divergence_events"] == jlog["divergence_events"]
    for key in ("loss_train", "epochs"):
        assert len(plog[key]) == len(jlog[key]), key
    assert plog["epochs"] == jlog["epochs"]
    np.testing.assert_array_equal(plog["loss_train"], jlog["loss_train"])
    assert pbest.get("diverged") == jbest.get("diverged")
    events = plog["divergence_events"]
    n = min(retries, len(nan_calls))
    assert [e["lr_scale"] for e in events] == [0.5, 0.25][:n]
    assert [e["retries_left"] for e in events] == \
        list(range(retries - n, retries))[::-1]
    assert all(e["rolled_back_to"] == back and e["epoch"] == epoch
               for e in events)
    assert pstate.optimizer.lr_scale == 0.5 ** n
    if n < len(nan_calls):
        assert pbest["diverged"]["retries_exhausted"] == retries
    else:
        assert "diverged" not in pbest and plog["epochs"] == [4, 6]


def test_rollback_without_a_retry_budget_keeps_running_on_finite_losses(
        tmp_path):
    """With no NaN the rollback never fires: every epoch logs once."""
    jbest, jlog = _jax_run(tmp_path, 2, set())
    pbest, plog, _ = _port_run(tmp_path, 2, set())
    assert plog["divergence_events"] == jlog["divergence_events"] == []
    assert len(plog["loss_train"]) == len(jlog["loss_train"]) == EPOCHS
    assert plog["epochs"] == jlog["epochs"] == [2, 4, 6]
    assert "diverged" not in pbest and "diverged" not in jbest


def test_rollback_restores_params_adam_state_and_accumulated_grad(tmp_path):
    """A tiny FastEGNN, 3 micro-steps an epoch at accumulation 2 (so an
    epoch ends with one micro-step's gradient accumulated), epoch 2's loss
    poisoned once: the retry starts from epoch 1's end bitwise (parameters,
    Adam moments and step, ``updates``, ``micro``, ``p.grad``), and its
    first update runs at half the configured learning rate."""
    lr = 1e-3
    cfg = load_config(os.path.join(REPO, "configs", "nbody_fastegnn.yaml"), {
        "model.hidden_nf": 16, "model.n_layers": 2, "model.normalize": False,
        "train.accumulation_steps": 2, "train.learning_rate": lr,
        "train.epochs": 3, "train.divergence_retries": 2,
        "log.test_interval": 1, "log.log_dir": str(tmp_path),
        "log.exp_name": "tiny"})
    graphs = _graphs(build_nbody_graph, seed=1, n_graphs=6)
    model = get_model(cfg.model, generator=torch.Generator().manual_seed(0))
    t = cfg.train
    opt = make_optimizer(model.parameters(), lr,
                         weight_decay=t.weight_decay,
                         accumulation_steps=t.accumulation_steps)
    state = TrainState(model, opt)
    real = make_train_step(model, opt, t.mmd.weight, t.mmd.sigma,
                           t.mmd.samples)
    seen = {"calls": 0, "end_of_1": None, "checked": False}

    def grab():
        return {"params": {k: v.clone() for k, v in
                           model.state_dict().items()},
                "adam": {i: {k: v.clone()
                             for k, v in opt.adam.state[p].items()}
                         for i, p in enumerate(opt.params)
                         if p in opt.adam.state},
                "grads": [None if p.grad is None else p.grad.clone()
                          for p in opt.params],
                "counts": (opt.updates, opt.micro, state.step)}

    def step(state, batch, gen):
        seen["calls"] += 1
        n = seen["calls"]
        if n == 7:     # the retry's first micro-step: the state is epoch 1's
            now, want = grab(), seen["end_of_1"]
            for k, v in want["params"].items():
                assert torch.equal(now["params"][k], v), k
            assert now["adam"].keys() == want["adam"].keys() and want["adam"]
            for i, s in want["adam"].items():
                for k, v in s.items():
                    assert torch.equal(now["adam"][i][k], v), (i, k)
            assert any(g is not None for g in want["grads"])
            for a, b in zip(now["grads"], want["grads"]):
                assert (a is None) == (b is None)
                assert a is None or torch.equal(a, b)
            assert now["counts"] == want["counts"] == (1, 1, 3)
        state, metrics = real(state, batch, gen)
        if n == 3:
            seen["end_of_1"] = grab()
        if n == 7:     # micro 1 -> 2: this call updated, at lr * 0.5
            assert opt.micro == 0 and opt.updates == 2
            assert opt.adam.param_groups[0]["lr"] == 0.5 * lr
            seen["checked"] = True
        if n in (4, 5, 6):   # epoch 2, first try: poisoned
            metrics = dict(metrics, loss=torch.tensor(float("nan")))
        return state, metrics

    def mk(shuffle):
        return GraphLoader(GraphDataset(graphs), 2, shuffle=shuffle,
                           seed=cfg.seed)

    _, _, best, log_dict = ptrainer.train(
        state, step, make_eval_step(model), mk(True), mk(False), mk(False),
        cfg, torch.device("cpu"))
    assert seen["checked"] and seen["calls"] == 12
    assert log_dict["divergence_events"] == [
        {"epoch": 2, "loss_train": "nan", "rolled_back_to": 1,
         "lr_scale": 0.5, "retries_left": 1}]
    # epoch 1's eval entry is rewound with the rollback, as the JAX trainer
    # does (its snapshot is taken before the epoch's evaluation)
    assert len(log_dict["loss_train"]) == 3 and log_dict["epochs"] == [2, 3]
    assert all(np.isfinite(log_dict["loss_train"]))
    assert "diverged" not in best
